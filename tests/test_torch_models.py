"""The port's LM against the reference's, on the same parameters.

The reference's ``LM.init`` makes the parameters; ``params_from_jax``
carries them over to the port on the CPU. Prompts are numpy from a seed.
``prefill`` (last-token logits and every layer's K/V cache) and a few
``decode_step`` positions are compared for ``smollm-135m`` (GQA, tied
embeddings), ``gemma2-27b`` (local/global windows, attention and final
soft-caps, embedding scale, GeGLU) and ``rwkv6-7b`` (RWKV-6 time-mix and
channel-mix; its cache is the recurrent state ``S``, ``tm_prev`` and
``cm_prev``), all ``scaled_down()``. One prompt of 2,064 tokens is longer
than ``FLASH_THRESHOLD``, so it takes the flash branch of ``attention`` in
both packages; rwkv prompts of 40 and 70 tokens span one partial and
several whole wkv6 chunks.

Tolerance: float32, atol 1e-4 and rtol 1e-4 on logits and caches. The two
packages multiply and sum in other orders (XLA against PyTorch's CPU
kernels); RoPE angles agree bit for bit (both are float32 products
``position * freq``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import torch_one_thread  # noqa: F401

from repro.configs import get_config as jax_get_config
from repro.models import LM as JaxLM
from repro.models.attention import FLASH_THRESHOLD as JAX_FLASH_THRESHOLD
from repro_torch.configs import get_config
from repro_torch.models import LM, params_from_jax
from repro_torch.models.attention import FLASH_THRESHOLD
from repro_torch.models.blocks import init_sublayer, init_segment

TOL = {"atol": 1e-4, "rtol": 1e-4}
ARCHS = ("smollm-135m", "gemma2-27b", "rwkv6-7b")

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def models():
    """Per arch: (reference LM, its params, port LM, carried params)."""
    out = {}
    for arch in ARCHS:
        jm = JaxLM(jax_get_config(arch).scaled_down(), dtype=jnp.float32, remat=False)
        jp = jax.jit(jm.init)(jax.random.key(0))
        pm = LM(get_config(arch).scaled_down(), dtype=torch.float32, device="cpu")
        out[arch] = (jm, jp, pm, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu"))
    return out


def _assert_caches_close(jax_caches, port_caches):
    assert len(jax_caches) == len(port_caches)
    for jc, pc in zip(jax_caches, port_caches):
        assert jc.keys() == pc.keys()
        for key in jc:
            assert jc[key].keys() == pc[key].keys()
            for name in jc[key]:
                want, got = np.asarray(jc[key][name]), pc[key][name].numpy()
                assert got.shape == want.shape and got.dtype == want.dtype, (key, name)
                np.testing.assert_allclose(got, want, err_msg=f"{key}.{name}", **TOL)


@pytest.mark.parametrize("arch,S", [("smollm-135m", 40), ("gemma2-27b", 24),
                                    ("gemma2-27b", 40), ("smollm-135m", 2064),
                                    ("rwkv6-7b", 40), ("rwkv6-7b", 70)])
def test_prefill_and_decode_match_reference(models, arch, S):
    """gemma2 at 24 tokens fills its 32-token ring part way; at 40 it wraps
    (the prefill's ring roll). 2,064 tokens take the flash branch."""
    jm, jp, pm, pp = models[arch]
    max_seq = S + 8
    tokens = np.random.default_rng(S).integers(0, pm.cfg.vocab_size, (1, S)).astype(np.int32)
    jl, jc = jax.jit(jm.prefill, static_argnames="max_seq")(
        jp, {"tokens": jnp.asarray(tokens)}, max_seq=max_seq)
    with torch.inference_mode():
        pl, pc = pm.prefill(pp, {"tokens": torch.from_numpy(tokens).long()}, max_seq=max_seq)
    assert pl.shape == (1, pm.cfg.padded_vocab)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(jc, pc)
    decode = jax.jit(jm.decode_step)
    for pos in range(S, S + 3):
        tok = np.asarray([(7 * pos) % pm.cfg.vocab_size], dtype=np.int32)
        jl, jc = decode(jp, jc, jnp.asarray(tok), jnp.int32(pos))
        with torch.inference_mode():
            pl, pc = pm.decode_step(pp, pc, torch.from_numpy(tok).long(), pos)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(jc, pc)


def test_flash_threshold_is_the_reference_s():
    assert FLASH_THRESHOLD == JAX_FLASH_THRESHOLD == 2048


@pytest.mark.parametrize("arch", ARCHS)
def test_init_has_the_reference_structure(models, arch):
    """``LM.init`` draws from a torch.Generator a tree of the reference's
    structure, shapes and dtypes, with the reference's init scale."""
    _, jp, pm, _ = models[arch]
    params = pm.init(torch.Generator().manual_seed(0))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(params)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_j] == [jax.tree_util.keystr(k) for k, _ in flat_p]
    for (path, a), (_, b) in zip(flat_j, flat_p):
        assert tuple(a.shape) == tuple(b.shape) and b.dtype == torch.float32, path
    table = params["embed"]["table"]
    assert abs(float(table.std()) - pm.cfg.padded_vocab ** -0.5) < 0.1 * pm.cfg.padded_vocab ** -0.5


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_carries_the_tree(models, arch):
    """Every leaf of the reference's tree arrives with its path, shape,
    dtype and values."""
    _, jp, _, pp = models[arch]
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    flat_p = jax.tree_util.tree_flatten_with_path(pp)[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat_j] == [jax.tree_util.keystr(k) for k, _ in flat_p]
    for (path, a), (_, b) in zip(flat_j, flat_p):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=str(path))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_layers_in_order_without_a_second_copy(arch):
    """``init_segment`` fills preallocated stacked tensors layer by layer
    and takes the random draws in the order of drawing every layer's tree
    and stacking them."""
    cfg = get_config(arch).scaled_down()
    pm = LM(cfg, device="cpu")
    seg = pm.segments[0]
    got = init_segment(torch.Generator().manual_seed(3), cfg, seg, pm.plan, torch.float32)
    gen = torch.Generator().manual_seed(3)
    layers = [{str(i): init_sublayer(gen, cfg, kind, pm.plan, torch.float32)
               for i, kind in enumerate(seg.kinds)} for _ in range(seg.repeat)]
    want = jax.tree.map(lambda *xs: torch.stack(xs), *layers)
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in flat_w] == [k for k, _ in flat_g]
    for (path, a), (_, b) in zip(flat_w, flat_g):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "recurrentgemma-2b",
                                  "arctic-480b", "seamless-m4t-large-v2"])
def test_unported_kinds_raise_naming_the_roadmap(arch):
    cfg = get_config(arch).scaled_down()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))

