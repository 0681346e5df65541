"""The port's Hopper kernels on the card, against their plain versions,
and the serving paths through them.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (the kernels have no CPU or
interpret mode). The file imports neither JAX nor the reference package,
so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import REGISTRY, HitMaskRecorder, SimulationEngine
from repro_torch.core.cms_sketch import CMSSketch
from repro_torch.kernels.attention import flash
from repro_torch.kernels.cms import cms
from repro_torch.kernels.wkv import wkv6 as wkv
from repro_torch.models import LM
from repro_torch.serving import Engine, EngineConfig
from repro_torch.state import export_state
from repro_torch.traces import make_trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _keys(rng, n, distinct=None):
    if distinct:
        return rng.integers(-2**31, 2**31, distinct)[rng.integers(0, distinct, n)].astype(np.int32)
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("width", (128, 1024, 1 << 16))
def test_kernels_match_plain(cuda_device, width):
    """Each kernel equals its plain version on the card, byte for byte."""
    rng = np.random.default_rng(width)
    for cap in (15, 255):
        table = torch.from_numpy(rng.integers(0, cap + 1, (4, width), dtype=np.int32)).to(cuda_device)
        upd = torch.from_numpy(_keys(rng, 512, distinct=40)).to(cuda_device)
        est = torch.from_numpy(_keys(rng, 33)).to(cuda_device)
        a, b = table.clone(), table.clone()
        cms.cms_update(a, upd, cap=cap)
        cms.cms_update(b, upd, cap=cap, use_kernel=False)
        assert torch.equal(a, b)
        assert torch.equal(cms.cms_estimate(a, est), cms.cms_estimate(a, est, use_kernel=False))
        va = cms.cms_update_estimate(a, upd, est, cap=cap)
        vb = cms.cms_update_estimate(b, upd, est, cap=cap, use_kernel=False)
        assert torch.equal(a, b) and torch.equal(va, vb)
    torch.cuda.synchronize()


def _same_sketch(a, b):
    assert np.array_equal(a.table.cpu().numpy(), b.table.cpu().numpy())
    assert (a._ops, a.resets, a._pending) == (b._ops, b.resets, b._pending)


def _drive(rng, sketches, pool, flush_block, steps=150):
    """The same random interleaving of increments, batches above
    ``flush_block``, estimates, lazy prefix views and explicit flushes (two
    in a row among them) on every sketch; their estimates must agree."""
    for _ in range(steps):
        op = int(rng.integers(0, 6))
        if op == 0:
            key = int(rng.choice(pool))
            for sk in sketches:
                sk.increment(key)
        elif op == 1:
            batch = rng.choice(pool, int(rng.choice([2, 30, flush_block + 1, 2 * flush_block + 37])))
            for sk in sketches:
                sk.increment_batch(batch)
        elif op == 2:
            for sk in sketches:
                sk.flush()
                sk.flush()
        else:
            keys = rng.choice(pool, int(rng.choice([0, 1, 11, 34])))
            view = op == 5
            got = [sk.estimate_batch(iter(keys.tolist()) if view else keys) for sk in sketches]
            for g in got[1:]:
                assert g.dtype == np.int32 and np.array_equal(g, got[0])
        for sk in sketches[1:]:
            _same_sketch(sk, sketches[0])


@pytest.mark.parametrize("seed,expected_entries,flush_block",
                         [(0, 16, 512), (1, 40, 48), (2, 200, 512), (3, 16, 7)])
def test_staged_sketch_equals_plain(cuda_device, seed, expected_entries, flush_block):
    """The sketch's one-C-call path on the card against the plain versions
    on the CPU and the tensor wrappers on the card, over random
    interleavings with aging resets inside flushes."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([rng.integers(0, 50, 32), rng.integers(1 << 31, 1 << 40, 32),
                           [(1 << 31) - 1, 1 << 31, -5]]).astype(np.int64)
    staged = CMSSketch(expected_entries, flush_block=flush_block)
    wrappers = CMSSketch(expected_entries, flush_block=flush_block)
    wrappers._staging = None  # the tensor wrappers on the card
    cpu = CMSSketch(expected_entries, flush_block=flush_block, device="cpu")
    assert staged._staging is not None
    _drive(rng, [cpu, staged, wrappers], pool, flush_block)
    assert cpu.resets > 0


def test_staging_edges(cuda_device):
    """Buffer growth past flush_block + 34 keys, empty calls, and two
    flushes with no estimate between them, against the CPU sketch."""
    staged, cpu = CMSSketch(64), CMSSketch(64, device="cpu")
    assert staged._staging.capacity == cms.STAGING_KEYS == 1024
    rng = np.random.default_rng(7)
    for sk in (staged, cpu):
        assert sk.estimate_batch([]).shape == (0,)
        sk.flush()  # nothing pending
    big = rng.integers(0, 1 << 40, 3000)
    keys = rng.integers(0, 1 << 40, 700)
    for sk in (staged, cpu):
        sk.increment_batch(big)
    assert np.array_equal(staged.estimate_batch(keys), cpu.estimate_batch(keys))
    assert staged._staging.capacity == 4096
    _same_sketch(staged, cpu)
    for sk in (staged, cpu):
        sk.increment_batch(big[:600])
        sk.flush()
        sk.increment_batch(big[600:1900])
        sk.flush()
        sk.increment_batch(big[:3])
        assert sk.estimate_batch([]).shape == (0,)  # flushes, scores nothing
    _same_sketch(staged, cpu)
    assert np.array_equal(staged.estimate_batch(keys[:34]), cpu.estimate_batch(keys[:34]))


class _CountingLib:
    """Counts the calls made through a ctypes library."""

    def __init__(self, lib):
        self.lib, self.calls = lib, 0

    def __getattr__(self, name):
        fn = getattr(self.lib, name)

        def call(*args):
            self.calls += 1
            return fn(*args)
        return call


def test_one_c_call_per_sketch_call_and_launches_as_the_wrappers(cuda_device):
    """Each estimate_batch and flush is one C call, and the launches per
    kernel equal the tensor wrappers' for the same calls."""
    rng = np.random.default_rng(11)
    staged, wrappers = CMSSketch(40, flush_block=48), CMSSketch(40, flush_block=48)
    wrappers._staging = None
    lib = staged._staging._lib = _CountingLib(staged._staging._lib)
    pool = rng.integers(0, 1 << 40, 200)
    counts, made = [], []
    for sk in (staged, wrappers):
        calls = np.random.default_rng(12)
        cms.reset_launch_counts()
        sk_calls = 0  # calls with work: a flush of nothing makes none
        for _ in range(300):
            sk.increment_batch(pool[: int(calls.choice([0, 1, 3, 49, 120]))])
            if calls.integers(0, 4) == 0:
                sk_calls += bool(sk._pending)
                sk.flush()
            else:
                sk_calls += 1
                sk.estimate_batch(pool[: int(calls.choice([1, 11, 34]))])
        torch.cuda.synchronize()
        counts.append(cms.launch_counts())
        made.append(sk_calls)
    assert lib.calls == made[0]
    assert counts[0] == counts[1] and all(v > 0 for v in counts[0].values()), counts
    _same_sketch(staged, wrappers)


def test_staged_calls_allocate_nothing(cuda_device):
    """1,000 estimate_batch calls, fused and not, make no device allocation."""
    sk = CMSSketch(858)
    rng = np.random.default_rng(13)
    keys = rng.integers(0, 1 << 40, (1000, 20))
    sk.increment(1)
    sk.estimate_batch(keys[0])
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    for i in range(1000):
        if i % 2:
            sk.increment(int(keys[i, 0]))
            sk.increment(int(keys[i, 1]))
        sk.estimate_batch(keys[i])
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == before


@pytest.mark.parametrize("spec", ["wtlfu-av-sampled_frequency?sketch_backend=cms",
                                  "wtlfu-qv-slru?sketch_backend=cms"])
def test_main_path_kernels_equal_plain_and_cpu(cuda_device, spec):
    """The policy on the card through the kernels == through their plain
    versions on the card == on the CPU; every kernel was launched."""
    trace = make_trace("msr2", scale=0.003)
    cap = int(trace.total_object_bytes * 0.01)
    runs = []
    cms.reset_launch_counts()
    for kw in ({}, {"sketch_kwargs": {"use_kernel": False}}, {"device": "cpu"}):
        policy = REGISTRY.build(spec, cap, expected_entries=64, **kw)
        rec = HitMaskRecorder()
        SimulationEngine(instruments=[rec]).run(policy, trace)
        runs.append((policy.stats.hits, policy.stats.admissions, rec.hits, export_state(policy)))
        if not kw:
            counts = cms.launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    assert cms.launch_counts() == counts  # the plain runs launched nothing
    for hits, admissions, bitmap, state in runs[1:]:
        assert (hits, admissions) == runs[0][:2]
        np.testing.assert_array_equal(bitmap, runs[0][2])
        for k, v in state.items():
            assert np.array_equal(v, runs[0][3][k]) if isinstance(v, np.ndarray) else v == runs[0][3][k]


#: float32: the reference's kernel tolerance (tests/test_kernels.py).
#: bfloat16: kernel and plain both compute in float32 and round once, so
#: they differ by at most one bf16 step (2**-7 relative at most).
FLASH_TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (1e-3, 2 ** -7)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,T,g,D,Dv,causal,window,softcap", [
    (1, 1, 1, 64, 64, True, None, None),
    (63, 63, 3, 128, 128, True, 256, 50.0),
    (2049, 2049, 3, 64, 64, True, None, None),
    (700, 2500, 8, 64, 128, False, 256, None),
    (300, 300, 1, 128, 64, False, None, 50.0),
])
def test_flash_kernel_matches_plain(cuda_device, dtype, S, T, g, D, Dv, causal, window, softcap):
    """The flash kernel against its plain version on the card, within
    FLASH_TOL (summation order differs)."""
    gen = torch.Generator(device=cuda_device).manual_seed(S + T + g)
    q = torch.randn((2, S, 2 * g, D), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((2, T, 2, D), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((2, T, 2, Dv), generator=gen, device=cuda_device).to(dtype)
    kw = {"causal": causal, "window": window, "softcap": softcap}
    before = flash.flash_attention_fwd.launches
    got = flash.flash_attention_fwd(q, k, v, D ** -0.5, **kw)
    want = flash.flash_attention_fwd(q, k, v, D ** -0.5, use_kernel=False, **kw)
    torch.cuda.synchronize()
    assert flash.flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype and got.shape == (2, S, 2 * g, Dv)
    atol, rtol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)


def test_flash_kernel_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        flash.flash_attention_fwd(q, q, q, 0.1)
    q = torch.zeros((1, 8, 2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        flash.flash_attention_fwd(q, q, q, 0.1)


def test_tiny_engine_on_the_card(cuda_device):
    """A 2-layer SmolLM-135M (head dim 64) serves prompts past the flash
    threshold on the card: every prefill launches the flash kernel once a
    layer, the cache saves prefill, and the plain run agrees."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("smollm-135m").scaled_down(num_layers=2, head_dim=64)
    model = LM(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    shared = [int(x) for x in rng.integers(0, cfg.vocab_size, 2100)]
    prompts = [shared + [int(x) for x in rng.integers(0, cfg.vocab_size, 4)] for _ in range(3)]
    ecfg = EngineConfig(max_seq=2200, block_size=16, cache_capacity_bytes=64 << 20,
                        cache_policy="wtlfu-av?sketch_backend=cms")
    flash.reset_launch_counts()
    out = Engine(model, params, ecfg).serve(prompts, max_new_tokens=4)
    prefills = sum(r["cached_tokens"] == 0 for r in out)
    assert flash.flash_attention_fwd.launches == cfg.num_layers * prefills > 0
    assert any(r["cached_tokens"] > 0 for r in out)
    plain = Engine(model, params, dataclasses.replace(ecfg, use_kernel=False))
    out_p = plain.serve(prompts, max_new_tokens=4)
    assert [r["tokens"] for r in out] == [r["tokens"] for r in out_p]
    for a, b in zip(out, out_p):
        torch.testing.assert_close(a["prompt_logits"], b["prompt_logits"], atol=2e-5, rtol=2e-4)


#: |kernel - plain| <= atol + rtol * |plain|. float32: the reference's
#: wkv6 tolerance (tests/test_kernels.py::TestWkv6Kernel), atol 3e-4, and
#: 5e-4 for extreme decays. bfloat16 output: both compute in float32 from the
#: same bf16 inputs and round once, so they differ by one bf16 step at most.
WKV_TOL = {torch.float32: (3e-4, 0.0), torch.bfloat16: (1e-3, 2 ** -7)}


def _wkv_inputs(gen, dev, B, T, H, dtype, w_low=0.2):
    K = wkv.HEAD_SIZE
    r, k, v = ((torch.randn((B, T, H, K), generator=gen, device=dev) * 0.5).to(dtype)
               for _ in range(3))
    hi = 0.999 if w_low > 1e-3 else 1.0
    w = (torch.rand((B, T, H, K), generator=gen, device=dev) * (hi - w_low) + w_low).to(dtype)
    u = torch.randn((H, K), generator=gen, device=dev) * 0.1
    return r, k, v, w, u


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,H,w_low", [(1, 64, 2, 0.2), (2, 100, 2, 0.2), (1, 1000, 64, 0.2),
                                         (1, 130, 2, 1e-7)])
def test_wkv6_kernel_matches_plain(cuda_device, dtype, B, T, H, w_low):
    """The wkv6 kernel's output and final state against its plain version
    on the card, within WKV_TOL (5e-4 for extreme decays in float32)."""
    gen = torch.Generator(device=cuda_device).manual_seed(T + H)
    r, k, v, w, u = _wkv_inputs(gen, cuda_device, B, T, H, dtype, w_low)
    before = wkv.wkv6_fwd.launches
    o, S = wkv.wkv6_fwd(r, k, v, w, u, return_state=True)
    o_p, S_p = wkv.wkv6_fwd(r, k, v, w, u, return_state=True, use_kernel=False)
    torch.cuda.synchronize()
    assert wkv.wkv6_fwd.launches == before + 1
    assert o.dtype == dtype and o.shape == (B, T, H, 64) and S.dtype == torch.float32
    atol, rtol = WKV_TOL[dtype]
    if dtype == torch.float32 and w_low < 1e-3:
        atol = 5e-4
    torch.testing.assert_close(o.float(), o_p.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(S, S_p, atol=WKV_TOL[torch.float32][0], rtol=0.0)


def test_wkv6_kernel_refuses_what_it_does_not_take(cuda_device):
    x = torch.zeros((1, 8, 2, 32), device=cuda_device)
    with pytest.raises(ValueError, match="K = V"):
        wkv.wkv6_fwd(x, x, x, x, torch.zeros((2, 32), device=cuda_device))
    x = torch.zeros((1, 8, 2, 64), device=cuda_device, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        wkv.wkv6_fwd(x, x, x, x, torch.zeros((2, 64), device=cuda_device))


def test_tiny_rwkv_engine_on_the_card(cuda_device):
    """A 2-layer rwkv6-7b (head size 64) serves block-aligned prompts on the
    card: every prefill launches the wkv6 kernel once a layer, a stored
    state saves prefill, and the plain run agrees."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("rwkv6-7b").scaled_down(num_layers=2, d_model=128, rwkv_head_dim=64)
    model = LM(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    rng = np.random.default_rng(0)
    shared = [int(x) for x in rng.integers(0, cfg.vocab_size, 16 * 20)]
    prompts = [shared] + [shared + [int(x) for x in rng.integers(0, cfg.vocab_size, 4)]
                          for _ in range(2)]
    ecfg = EngineConfig(max_seq=512, block_size=16, cache_capacity_bytes=64 << 20,
                        cache_policy="wtlfu-av?sketch_backend=cms")
    wkv.reset_launch_counts()
    eng = Engine(model, params, ecfg)
    out = eng.serve(prompts, max_new_tokens=4)
    prefills = sum(r["cached_tokens"] == 0 for r in out)
    assert wkv.wkv6_fwd.launches == cfg.num_layers * prefills > 0
    assert eng.prefill_tokens_saved > 0
    plain = Engine(model, params, dataclasses.replace(ecfg, use_kernel=False))
    out_p = plain.serve(prompts, max_new_tokens=4)
    assert wkv.wkv6_fwd.launches == cfg.num_layers * prefills
    assert [r["tokens"] for r in out] == [r["tokens"] for r in out_p]
    for a, b in zip(out, out_p):
        torch.testing.assert_close(a["prompt_logits"], b["prompt_logits"], atol=1e-4, rtol=1e-4)
