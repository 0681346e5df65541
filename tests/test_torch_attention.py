"""The port's flash attention plain versions against the reference.

Inputs are numpy from a seed. The reference runs on the CPU: its Pallas
kernel ``flash_attention_fwd_pallas`` in interpret mode (as
tests/test_kernels.py runs it) and its jnp oracles ``flash_attention_ref``
and ``attention_dense_ref``. The port runs its plain versions on CPU
tensors, which is what its ``flash_attention`` takes for a CPU tensor.

Tolerances are the reference's own kernel tolerances
(tests/test_kernels.py): float32 atol 2e-5, rtol 2e-4; bfloat16 atol and
rtol 3e-2. The two packages sum in another order, so the float32
tolerance is not zero; bfloat16 rounds the output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import torch_one_thread  # noqa: F401

from repro.kernels.attention.flash import flash_attention_fwd_pallas
from repro.kernels.attention.ref import attention_dense_ref
from repro.kernels.attention.ref import flash_attention_ref as jax_flash
from repro_torch.kernels.attention import flash_attention
from repro_torch.kernels.attention import ref as port_ref

attention_dense_ref_port = port_ref.attention_dense_ref
flash_attention_ref = port_ref.flash_attention_ref

F32_TOL = {"atol": 2e-5, "rtol": 2e-4}
BF16_TOL = {"atol": 3e-2, "rtol": 3e-2}

pytestmark = pytest.mark.usefixtures("torch_one_thread")

#: one compile per shape instead of one per op (eager jnp compiles each op)
jax_dense = jax.jit(attention_dense_ref, static_argnames=("scale", "causal", "window", "softcap"))


def _qkv(seed, B, S, T, nq, nkv, hd, hv=None):
    rng = np.random.default_rng(seed)
    hv = hv or hd
    return (rng.normal(size=(B, S, nq, hd)).astype(np.float32),
            rng.normal(size=(B, T, nkv, hd)).astype(np.float32),
            rng.normal(size=(B, T, nkv, hv)).astype(np.float32))


def _pallas(q, k, v, scale, **kw):
    """The reference's Pallas kernel in interpret mode, model layout."""
    out = flash_attention_fwd_pallas(*(jnp.swapaxes(jnp.asarray(t), 1, 2) for t in (q, k, v)),
                                     scale, interpret=True, **kw)
    return np.asarray(jnp.swapaxes(out, 1, 2))


def _port(fn, q, k, v, *args, **kw):
    return fn(*(torch.from_numpy(t) for t in (q, k, v)), *args, **kw).numpy()


@pytest.mark.parametrize("S,T", [(128, 128), (256, 256), (100, 100), (64, 192)])
@pytest.mark.parametrize("nq,nkv", [(4, 4), (8, 2), (6, 1)])
def test_flash_ref_matches_reference_oracles(S, T, nq, nkv):
    """GQA over ragged and unequal lengths, the sweep of test_kernels."""
    q, k, v = _qkv(S + T + nq, 2, S, T, nq, nkv, 32)
    scale, causal = 32 ** -0.5, S == T
    want = np.asarray(jax_dense(*(jnp.asarray(t) for t in (q, k, v)), scale=scale, causal=causal))
    got = _port(flash_attention_ref, q, k, v, scale, causal=causal, chunk=64)
    np.testing.assert_allclose(got, want, **F32_TOL)
    dense = _port(attention_dense_ref_port, q, k, v, scale, causal=causal)
    np.testing.assert_allclose(dense, want, **F32_TOL)


def test_flash_ref_matches_reference_flash_ref():
    """Chunk by chunk against the reference's own chunked oracle, with a
    ragged last chunk, window and soft-cap."""
    q, k, v = _qkv(13, 2, 200, 200, 8, 2, 32)
    args = (0.2, True, 48, 30.0, 64)
    want = np.asarray(jax_flash(*(jnp.asarray(t) for t in (q, k, v)), *args))
    np.testing.assert_allclose(_port(flash_attention_ref, q, k, v, *args), want, **F32_TOL)


@pytest.mark.parametrize("S,T,nq,nkv", [(100, 100, 8, 2), (64, 192, 6, 1)])
def test_flash_ref_matches_pallas_kernel(S, T, nq, nkv):
    q, k, v = _qkv(S * T + nq, 2, S, T, nq, nkv, 32)
    scale, causal = 32 ** -0.5, S == T
    want = _pallas(q, k, v, scale, causal=causal, bq=64, bk=64)
    got = _port(flash_attention_ref, q, k, v, scale, causal=causal, chunk=64)
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("window", [None, 32])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_masks_and_softcap_match_pallas_kernel(window, softcap):
    """Windowed rows whose first chunks are all masked exercise the finite
    NEG_INF: the rubbish of those chunks must be wiped, not turned into NaN."""
    q, k, v = _qkv(7, 1, 160, 160, 4, 2, 16)
    kw = {"causal": True, "window": window, "softcap": softcap}
    want = _pallas(q, k, v, 0.25, bq=32, bk=32, **kw)
    got = _port(flash_attention_ref, q, k, v, 0.25, chunk=32, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32_TOL)
    np.testing.assert_allclose(_port(attention_dense_ref_port, q, k, v, 0.25, **kw), want, **F32_TOL)


def test_head_dims_differ_match_pallas_kernel():
    """qk dim != v dim (the reference's MLA expanded form)."""
    q, k, v = _qkv(5, 1, 128, 128, 4, 4, 48, hv=16)
    want = _pallas(q, k, v, 0.2, causal=True, bq=64, bk=64)
    got = _port(flash_attention_ref, q, k, v, 0.2, causal=True)
    assert got.shape == (1, 128, 4, 16)
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_bf16_matches_pallas_kernel():
    q, k, v = _qkv(3, 1, 128, 128, 4, 4, 32)
    to_bf16 = [jnp.asarray(t, jnp.bfloat16) for t in (q, k, v)]
    out = flash_attention_fwd_pallas(*(jnp.swapaxes(t, 1, 2) for t in to_bf16), 0.18,
                                     causal=True, bq=64, bk=64, interpret=True)
    want = np.asarray(jnp.swapaxes(out, 1, 2), dtype=np.float32)
    qt, kt, vt = (torch.from_numpy(np.asarray(t, dtype=np.float32)).to(torch.bfloat16)
                  for t in to_bf16)
    got = flash_attention_ref(qt, kt, vt, 0.18, True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_entry_point_runs_plain_version_on_cpu():
    """``flash_attention`` on CPU tensors is the plain version, whatever
    ``use_kernel`` says, and matches the reference's entry point."""
    q, k, v = _qkv(11, 1, 300, 300, 6, 2, 64)
    from repro.kernels.attention import flash_attention as jax_entry

    want = np.asarray(jax_entry(*(jnp.asarray(t) for t in (q, k, v)), 0.125, True, 64, 50.0))
    for use_kernel in (True, False):
        got = _port(flash_attention, q, k, v, 0.125, causal=True, window=64, softcap=50.0,
                    use_kernel=use_kernel)
        np.testing.assert_allclose(got, want, **F32_TOL)
    assert jax.default_backend() == "cpu"
