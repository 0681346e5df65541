"""The port's wkv6 against the reference's, on the same numpy inputs.

* ``repro_torch.kernels.wkv.ops.wkv6`` (its plain version, on the CPU)
  against ``repro.kernels.wkv.ops.wkv6``, the Pallas kernel in interpret
  mode, as ``tests/test_kernels.py::TestWkv6Kernel`` runs it: T in
  {32, 100, 256} (100 needs padding), K in {16, 64}, and the extreme-decay
  case (w down to 1e-7).
* The port's twins of ``wkv6_scan`` and ``wkv6_chunked`` against the
  reference's, with and without ``return_state``, and the model's rwkv
  block through the scan against the chunked path.

Tolerances (float32): atol 3e-4 against the Pallas kernel and the scan,
5e-4 in the extreme-decay case, the reference's own in TestWkv6Kernel;
1e-5 (atol and rtol) between the two chunked versions and between the two
scans, which run the same algorithm and differ only in the order of their
float32 sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import torch_one_thread  # noqa: F401

from repro.kernels.wkv.ops import wkv6 as jax_wkv6
from repro.models.rwkv import wkv6_chunked as jax_wkv6_chunked
from repro.models.rwkv import wkv6_scan as jax_wkv6_scan
from repro_torch.configs import get_config
from repro_torch.kernels.wkv import ops, ref
from repro_torch.kernels.wkv.wkv6 import wkv6_fwd
from repro_torch.models import LM
from repro_torch.models.blocks import layer
from repro_torch.models.rwkv import rwkv_block

pytestmark = pytest.mark.usefixtures("torch_one_thread")

SAME_ALGORITHM = {"atol": 1e-5, "rtol": 1e-5}


def _inputs(seed, B, T, H, K, w_low=0.2, scale=0.5, u_scale=0.1):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, K)).astype(np.float32) * scale for _ in range(3))
    w = rng.uniform(w_low, 0.999 if w_low > 1e-3 else 1.0, size=(B, T, H, K)).astype(np.float32)
    u = rng.normal(size=(H, K)).astype(np.float32) * u_scale
    return r, k, v, w, u


def _port(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("T", [32, 100, 256])
@pytest.mark.parametrize("K", [16, 64])
def test_ops_equal_to_pallas_kernel(T, K):
    r, k, v, w, u = _inputs(T + K, 2, T, 2, K)
    want = np.asarray(jax_wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=32))
    got = ops.wkv6(*_port(r, k, v, w, u), chunk=32)
    assert got.shape == (2, T, 2, K) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-4)
    # at the kernel's chunk (64) too, as the card's plain version runs it
    np.testing.assert_allclose(ops.wkv6(*_port(r, k, v, w, u)).numpy(), want, atol=3e-4)


def test_extreme_decay_equal_to_pallas_kernel():
    r, k, v, w, u = _inputs(0, 1, 64, 1, 16, w_low=1e-7, scale=1.0, u_scale=1.0)
    want = np.asarray(jax_wkv6(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=16))
    got = ops.wkv6(*_port(r, k, v, w, u), chunk=16).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=5e-4)


@pytest.mark.parametrize("T,chunk", [(32, 32), (100, 32), (96, 16), (130, 64)])
@pytest.mark.parametrize("return_state", [False, True])
def test_chunked_twin_equal_to_reference(T, chunk, return_state):
    r, k, v, w, u = _inputs(T, 2, T, 3, 16)
    want = jax_wkv6_chunked(*(jnp.asarray(a) for a in (r, k, v, w, u)), chunk=chunk,
                            return_state=return_state)
    got = ref.wkv6_chunked(*_port(r, k, v, w, u), chunk=chunk, return_state=return_state)
    if not return_state:
        want, got = (want,), (got,)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME_ALGORITHM)


@pytest.mark.parametrize("return_state", [False, True])
def test_scan_twin_equal_to_reference(return_state):
    r, k, v, w, u = _inputs(7, 2, 40, 2, 16)
    want = jax_wkv6_scan(*(jnp.asarray(a) for a in (r, k, v, w, u)), return_state=return_state)
    got = ref.wkv6_scan(*_port(r, k, v, w, u), return_state=return_state)
    if not return_state:
        want, got = (want,), (got,)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SAME_ALGORITHM)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 200])
def test_final_state_equal_to_scan(T):
    """The state that the decode cache takes, at lengths around the chunk:
    the chunked version at the kernel's chunk against the port's scan."""
    r, k, v, w, u = _inputs(T, 1, T, 2, 64)
    o, S = ops.wkv6(*_port(r, k, v, w, u), return_state=True)
    o_s, S_s = ref.wkv6_scan(*_port(r, k, v, w, u), return_state=True)
    assert S.shape == (1, 2, 64, 64) and S.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), o_s.numpy(), atol=3e-4)
    np.testing.assert_allclose(S.numpy(), S_s.numpy(), atol=3e-4)


def test_bf16_inputs_keep_their_type():
    r, k, v, w, u = _inputs(3, 1, 48, 2, 16)
    rb, kb, vb = (torch.from_numpy(a).bfloat16() for a in (r, k, v))
    o, S = ops.wkv6(rb, kb, vb, torch.from_numpy(w), torch.from_numpy(u), return_state=True)
    assert o.dtype == torch.bfloat16 and S.dtype == torch.float32


def test_wrapper_refuses_the_kernel_on_cpu_tensors():
    r, k, v, w, u = _port(*_inputs(1, 1, 8, 1, 64))
    with pytest.raises(ValueError, match="use_kernel=True"):
        wkv6_fwd(r, k, v, w, u, use_kernel=True)
    with pytest.raises(ValueError, match="u"):
        wkv6_fwd(r, k, v, w, u[:, :8])


def test_rwkv_block_scan_equals_chunked():
    """The model's time-mix through the stepwise scan (``chunked=False``)
    against the chunked path, on a 2-layer rwkv6-7b's first block."""
    cfg = get_config("rwkv6-7b").scaled_down(num_layers=2)
    p = layer(LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))["segments"][0], 0)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 45, cfg.d_model)).astype(np.float32))
    with torch.inference_mode():
        a = rwkv_block(p["0"]["rwkv"], cfg, x, x, return_state=True)
        b = rwkv_block(p["0"]["rwkv"], cfg, x, x, chunked=False, return_state=True)
    for got, want in zip(a[:2], b[:2]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-4)
    for name in ("S", "tm_prev", "cm_prev"):
        np.testing.assert_allclose(a[2][name].numpy(), b[2][name].numpy(), atol=3e-4)
