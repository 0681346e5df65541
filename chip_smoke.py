#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels
against their plain versions.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

It imports nothing of JAX and nothing of the JAX package ``repro``. It
builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
with ``nvcc`` (one ``nvcc`` per library, started together, into each
library's ``_build/``) and runs five phases; any failure raises and the
script exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``), the build;
2. kernels: each CMS kernel against its plain PyTorch version on the card,
   byte for byte, over widths, batch sizes, caps and key mixes; the flash
   attention kernel against its plain version over head dims, GQA groups,
   masks, soft-cap, lengths and dtypes, within ``FLASH_TOL``;
   then each kernel timed with CUDA events at its path's shapes beside its
   plain version and one PyTorch library call of the same function;
3. main path, kernel against plain: ``msr2`` at scale 0.02 through nine
   admission x eviction combos on ``sketch_backend=cms``, once through the
   kernels and once with ``use_kernel=False``, byte-identical;
4. full size: ``wtlfu-av-sampled_frequency?sketch_backend=cms`` over the
   whole ``msr2`` trace (900,000 accesses) with the launch counts reset
   just before and read just after, held against the same run through the
   plain versions on the CPU;
5. serving: SmolLM-135M at full width (random weights from ``SEED``) behind
   the size-aware prefix cache (``wtlfu-av?sketch_backend=cms``) serves 32
   prompts of 2,308-3,588 tokens, with the launch counts reset just before
   and read just after; every prefill runs the flash kernel in each of the
   30 layers. The same traffic on a fresh engine through the kernels'
   plain versions must give the same tokens, cache hits and stats.

The line before the last is a JSON object of the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import REGISTRY, AccessTrace, HitMaskRecorder, SimulationEngine  # noqa: E402
from repro_torch.kernels.attention import flash  # noqa: E402
from repro_torch.kernels.attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.cms import cms  # noqa: E402
from repro_torch.kernels.cms.ref import row_indexes  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.serving import Engine, EngineConfig  # noqa: E402
from repro_torch.state import export_state  # noqa: E402
from repro_torch.traces import TRACE_SPECS, make_trace  # noqa: E402

SEED = 0
#: The H100 SXM's published rates (NVIDIA data sheet): HBM3 bytes/s, and
#: int32 operations/s: 64 INT32 lanes per SM beside 128 FP32 lanes, so half
#: the 67 TFLOP/s float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
#: Integer operations per key of the in-kernel hash (two fmix32 = 16, the
#: second hash's xor/or = 2, row index add/mul/and x 4 = 12) and per cell
#: increment or gather (compare, add/min).
OPS_PER_KEY = 30
OPS_PER_CELL = 2
#: The main path's shapes (CPU-counted on msr2 at scale 0.1, 1% capacity,
#: av-sampled_frequency: fused median M=2 increments, N=20 estimates;
#: unfused estimate median N=11; staged update M=2 at aging resets), at the
#: full-size table width next_pow2(858) = 1024.
MAIN_WIDTH = 1024
MAIN_SHAPES = {"cms_update_estimate": (2, 20), "cms_estimate": (0, 11), "cms_update": (2, 0)}
FLASH = "flash_attention_fwd"
CMS_SOURCE = "src/repro_torch/kernels/cms/csrc/cms.cu"
#: each kernel of the path: (its source, the TPU kernel it replaces)
KERNELS = {
    "cms_update_estimate": (CMS_SOURCE, "src/repro/kernels/cms/cms.py:141"),
    "cms_update": (CMS_SOURCE, "src/repro/kernels/cms/cms.py:101"),
    "cms_estimate": (CMS_SOURCE, "src/repro/kernels/cms/cms.py:121"),
    FLASH: ("src/repro_torch/kernels/attention/csrc/flash_fwd.cu",
            "src/repro/kernels/attention/flash.py:77"),
}
#: float32 outside the tensor cores (the kernel's arithmetic; TF32 would
#: break the reference's float32 tolerance) and bf16 dense tensor-core rate
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
#: |kernel - plain| <= atol + rtol * |plain|. float32: the reference's kernel
#: tolerance (tests/test_kernels.py). bfloat16: kernel and plain both compute
#: in float32 and round once, so they differ by at most one bf16 step
#: (2**-7 relative at most); the reference's 3e-2 would be as large as a
#: typical output at T ~ 3k and hide a fault in the bf16 path.
FLASH_TOL = {torch.float32: (2e-5, 2e-4), torch.bfloat16: (1e-3, 2 ** -7)}
#: SmolLM-135M's prefill at the serving phase's longest prompt: q [B,S,Hq,D],
#: k/v [B,S,Hkv,D], causal
SMOLLM_PREFILL = (1, 3584, 9, 3, 64)
CPU_BUDGET_S = 330.0  # phases 3 + 4 before the CPU comparison is cut


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- phase 1 ----------------------------------------------------------------
def phase_device() -> str:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[torch.cuda.current_device()]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # one nvcc per library, started together
        for fut in [pool.submit(cms.load_library), pool.submit(flash.load_library)]:
            fut.result()
    log(f"phase 1: kernels built and loaded in {time.perf_counter() - t0:.3f} s")
    return card


# -- phase 2 ----------------------------------------------------------------
def _keys(rng, n, kind):
    if kind == "dup":  # one key, n times
        return np.full(n, rng.integers(-2**31, 2**31), dtype=np.int32)
    if kind == "few":
        return rng.integers(-2**31, 2**31, 3)[rng.integers(0, 3, n)].astype(np.int32)
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


def phase_kernels_vs_plain(dev) -> dict[str, int]:
    rng = np.random.default_rng(SEED)
    err = {fn.__name__: 0 for fn in (cms.cms_update, cms.cms_estimate, cms.cms_update_estimate)}
    cases = 0
    for width in (128, 1024, 65536, 1 << 22):
        base = torch.from_numpy(rng.integers(0, 256, (4, width), dtype=np.int32)).to(dev)
        for cap in (15, 255):
            table = base % (cap + 1)  # cells <= cap, the sketch's invariant
            for m in (1, 64, 512):
                for n in (1, 5, 33, 256):
                    kind = ("rand", "dup", "few")[cases % 3]
                    upd = torch.from_numpy(_keys(rng, m, kind)).to(dev)
                    est = torch.from_numpy(np.concatenate(
                        [upd.cpu().numpy(), _keys(rng, n, "rand")])[:n]).to(dev)
                    a, b = table.clone(), table.clone()
                    cms.cms_update(a, upd, cap=cap)
                    cms.cms_update(b, upd, cap=cap, use_kernel=False)
                    err["cms_update"] = max(err["cms_update"], int((a - b).abs().max()))
                    ea = cms.cms_estimate(a, est)
                    eb = cms.cms_estimate(a, est, use_kernel=False)
                    err["cms_estimate"] = max(err["cms_estimate"], int((ea - eb).abs().max()))
                    a, b = table.clone(), table.clone()
                    va = cms.cms_update_estimate(a, upd, est, cap=cap)
                    vb = cms.cms_update_estimate(b, upd, est, cap=cap, use_kernel=False)
                    err["cms_update_estimate"] = max(
                        err["cms_update_estimate"],
                        int((a - b).abs().max()), int((va - vb).abs().max()))
                    check(ea.dtype == torch.int32 and va.shape == (n,), "kernel output shape/type")
                    cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {cases} cases x 3 kernels against plain, max |kernel - plain| = {err}")
    check(all(v == 0 for v in err.values()), f"kernels disagree with their plain versions: {err}")
    return err


def _time(fn, reps: int) -> float:
    """ms per call: CUDA events around ``reps`` back-to-back calls."""
    for i in range(20):
        fn(i)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(reps):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _bound(name: str, m: int, n: int) -> tuple[float, str]:
    """Least time for the function on these inputs: the bytes it must move
    (keys read, touched cells read and written, estimates written) over
    HBM bandwidth, against its integer operations over the int32 rate."""
    nbytes = 4 * (m + n) + 4 * 4 * m * 2 + 4 * 4 * n + 4 * n
    ops = OPS_PER_KEY * (m + n) + OPS_PER_CELL * 4 * (m + n) + 3 * n
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timings(dev, reps: int = 2000) -> dict[str, dict]:
    rng = np.random.default_rng(SEED + 1)
    table0 = torch.from_numpy(rng.integers(0, 16, (4, MAIN_WIDTH), dtype=np.int32)).to(dev)
    rows = torch.arange(4, device=dev)[:, None]
    out = {}
    for name, (m, n) in MAIN_SHAPES.items():
        # a fresh key batch per call, as on the main path
        upd = torch.from_numpy(rng.integers(0, 2**31, (reps + 20, max(m, 1)), dtype=np.int32)).to(dev)
        est = torch.from_numpy(rng.integers(0, 2**31, (reps + 20, max(n, 1)), dtype=np.int32)).to(dev)
        uidx = [row_indexes(upd[i], MAIN_WIDTH) for i in range(reps + 20)]
        eidx = [row_indexes(est[i], MAIN_WIDTH) for i in range(reps + 20)]
        ones = torch.ones((4, max(m, 1)), dtype=torch.int32, device=dev)
        table = table0.clone()
        if name == "cms_update":
            kernel = lambda i, k: cms.cms_update(table, upd[i], cap=15, use_kernel=k)  # noqa: E731

            def library(i):
                table.scatter_add_(1, uidx[i], ones).clamp_(max=15)
        elif name == "cms_estimate":
            kernel = lambda i, k: cms.cms_estimate(table, est[i], use_kernel=k)  # noqa: E731

            def library(i):
                return table.gather(1, eidx[i]).amin(0)
        else:
            kernel = lambda i, k: cms.cms_update_estimate(  # noqa: E731
                table, upd[i], est[i], cap=15, use_kernel=k)

            def library(i):
                table.scatter_add_(1, uidx[i], ones).clamp_(max=15)
                return table.gather(1, eidx[i]).amin(0)
        # plain, kernel, kernel, plain: report the mean of each pair
        p1 = _time(lambda i: kernel(i, False), reps)
        k1 = _time(lambda i: kernel(i, None), reps)
        k2 = _time(lambda i: kernel(i, None), reps)
        p2 = _time(lambda i: kernel(i, False), reps)
        lib = _time(library, reps)
        bound_ms, bound_by = _bound(name, m, n)
        out[name] = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
                     "bound_ms": bound_ms, "bound_by": bound_by, "shape": [MAIN_WIDTH, m, n]}
        log(f"phase 2: {name} at W={MAIN_WIDTH} M={m} N={n}: kernel {out[name]['ms']:.6f} ms "
            f"({k1:.6f}, {k2:.6f}), plain {out[name]['plain_ms']:.6f} ms ({p1:.6f}, {p2:.6f}), "
            f"library {lib:.6f} ms, bound {bound_ms:.9f} ms ({bound_by})")
    return out


def phase_device_times(dev, reps: int = 500) -> dict[str, float | None]:
    """Device time per launch of each kernel at the main path's shapes,
    from the profiler's CUDA activity (None where it records none)."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(SEED + 2)
    table = torch.from_numpy(rng.integers(0, 16, (4, MAIN_WIDTH), dtype=np.int32)).to(dev)
    calls = {
        "cms_update": lambda u, e: cms.cms_update(table, u, cap=15),
        "cms_estimate": lambda u, e: cms.cms_estimate(table, e),
        "cms_update_estimate": lambda u, e: cms.cms_update_estimate(table, u, e, cap=15),
    }
    out: dict[str, float | None] = {}
    for name, fn in calls.items():
        m, n = MAIN_SHAPES[name]
        keys = [(torch.from_numpy(rng.integers(0, 2**31, m, dtype=np.int32)).to(dev),
                 torch.from_numpy(rng.integers(0, 2**31, n, dtype=np.int32)).to(dev))
                for _ in range(reps)]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for u, e in keys:
                fn(u, e)
            torch.cuda.synchronize()
        kernel = name + "_kernel"
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if kernel in ev.key:
                total += getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
                count += ev.count
        out[name] = total / count / 1e3 if count else None  # us -> ms
        log(f"phase 2: {name} device time per launch (profiler, {count} launches): "
            f"{'not measured' if out[name] is None else f'{out[name]:.6f} ms'}")
    return out


# -- phase 2: flash attention -------------------------------------------------
def _flash_cases():
    """Every value of each parameter, crossed with every size and dtype:
    D/Dv cycle over {64,128}^2, GQA groups over {1,3,8}, masks over
    window {None,256} x soft-cap {None,50}."""
    sizes = [(1, 1), (63, 63), (2049, 2049), (3588, 3588), (700, 2500)]
    dims = [(64, 64), (128, 128), (64, 128), (128, 64)]
    masks = [(None, None), (256, None), (None, 50.0), (256, 50.0)]
    i = 0
    for S, T in sizes:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for window, softcap in masks:
                    D, Dv = dims[(i // 4) % 4]
                    yield {"B": 2 if S < 100 else 1, "S": S, "T": T, "Hkv": 2,
                           "g": (1, 3, 8)[i % 3], "D": D, "Dv": Dv, "dtype": dtype,
                           "causal": causal, "window": window, "softcap": softcap}
                    i += 1


def _qkv(gen, dev, B, S, T, Hq, Hkv, D, Dv, dtype):
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, T, Hkv, Dv), generator=gen, device=dev).to(dtype)
    return q, k, v


def phase_flash_vs_plain(dev) -> dict[str, float]:
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    err = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    for c in _flash_cases():
        q, k, v = _qkv(gen, dev, c["B"], c["S"], c["T"], c["g"] * c["Hkv"], c["Hkv"], c["D"],
                       c["Dv"], c["dtype"])
        kw = {"causal": c["causal"], "window": c["window"], "softcap": c["softcap"]}
        scale = c["D"] ** -0.5
        got = flash.flash_attention_fwd(q, k, v, scale, **kw).float()
        want = flash.flash_attention_fwd(q, k, v, scale, use_kernel=False, **kw).float()
        check(got.shape == (c["B"], c["S"], c["g"] * c["Hkv"], c["Dv"]), f"flash shape: {c}")
        check(bool(torch.isfinite(got).all()), f"flash kernel output not finite: {c}")
        atol, rtol = FLASH_TOL[c["dtype"]]
        diff = (got - want).abs()
        bad = int((diff > atol + rtol * want.abs()).sum())
        name = str(c["dtype"]).split(".")[1]
        err[name] = max(err[name], float(diff.max()))
        check(bad == 0, f"flash kernel disagrees with its plain version in {bad} elements "
                        f"(max |diff| {float(diff.max()):.3e}): {c}")
        cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {cases} flash cases against plain, max |kernel - plain| = {err} "
        f"(tolerance atol + rtol*|plain|: float32 {FLASH_TOL[torch.float32]}, "
        f"bfloat16 {FLASH_TOL[torch.bfloat16]})")
    return err


def _flash_bound(B, S, T, Hq, Hkv, D, Dv, nbytes) -> tuple[float, str]:
    """Least time at the causal prefill shape (S == T): the score and
    output products over the live (query, key) pairs at the float32 rate,
    against q, k, v read once and o written once over HBM bandwidth."""
    pairs = S * (S + 1) // 2
    flops = 2 * B * Hq * pairs * (D + Dv)
    moved = nbytes * (B * S * Hq * D + B * T * Hkv * (D + Dv) + B * S * Hq * Dv)
    t_ops, t_bytes = flops / F32_FLOPS_PER_S * 1e3, moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_flash_timing(dev, reps: int = 20) -> dict:
    """The kernel at SmolLM-135M's prefill shape (float32, causal): CUDA
    events, the profiler's device time, its plain version and
    ``scaled_dot_product_attention`` (the port never calls it)."""
    from torch.profiler import ProfilerActivity, profile

    B, S, Hq, Hkv, D = SMOLLM_PREFILL
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    q, k, v = _qkv(gen, dev, B, S, S, Hq, Hkv, D, D, torch.float32)
    scale = D ** -0.5
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    def kernel(i):
        return flash.flash_attention_fwd(q, k, v, scale, causal=True)

    def plain(i):
        return flash_attention_ref(q, k, v, scale, True)

    def library(i):
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True)

    p1, k1, k2, p2 = _time(plain, reps), _time(kernel, reps), _time(kernel, reps), _time(plain, reps)
    lib = _time(library, reps)
    lib_err = float((library(0).transpose(1, 2) - plain(0)).abs().max())
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            kernel(i)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if "flash_fwd_kernel" in ev.key:
            total += getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    device_ms = total / count / 1e3 if count else None
    bound_ms, bound_by = _flash_bound(B, S, S, Hq, Hkv, D, D, 4)
    out = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
           "bound_ms": bound_ms, "bound_by": bound_by, "device_ms": device_ms,
           "shape": [B, S, Hq, Hkv, D]}
    log(f"phase 2: {FLASH} at q [{B},{S},{Hq},{D}], k/v [{B},{S},{Hkv},{D}], causal, float32: "
        f"kernel {out['ms']:.6f} ms ({k1:.6f}, {k2:.6f}), device "
        f"{'not measured' if device_ms is None else f'{device_ms:.6f} ms'} "
        f"({count} profiled launches), plain {out['plain_ms']:.6f} ms ({p1:.6f}, {p2:.6f}), "
        f"library (scaled_dot_product_attention) {lib:.6f} ms, max |library - plain| "
        f"{lib_err:.3e}, bound {bound_ms:.6f} ms ({bound_by}, {F32_FLOPS_PER_S:.3g} FLOP/s "
        f"float32, {HBM_BYTES_PER_S:.3g} B/s)")
    return out


# -- phase 3 ----------------------------------------------------------------
def _sizing(trace, frac=0.01):
    """Capacity and ``expected_entries`` by the benchmarks' rule."""
    cap = int(trace.total_object_bytes * frac)
    return cap, max(64, int(cap / max(1.0, trace.mean_object_size)))


def _run(spec, trace, cap, ee, **kw):
    policy = REGISTRY.build(spec, cap, expected_entries=ee, **kw)
    rec = HitMaskRecorder()
    SimulationEngine(instruments=[rec]).run(policy, trace)
    if policy.device.type == "cuda":
        torch.cuda.synchronize()
    return policy, rec.hits


def _same_runs(a, a_hits, b, b_hits, what):
    sa, sb = a.stats.as_dict(), b.stats.as_dict()
    sa.pop("wall_seconds"), sb.pop("wall_seconds")
    check(sa == sb, f"{what}: CacheStats differ: {sa} != {sb}")
    check(np.array_equal(a_hits, b_hits), f"{what}: hit bitmaps differ")
    ea, eb = export_state(a), export_state(b)
    check(ea.keys() == eb.keys(), f"{what}: state keys differ")
    for k in ea:
        same = (np.array_equal(ea[k], eb[k]) if isinstance(ea[k], np.ndarray) else ea[k] == eb[k])
        check(same, f"{what}: state {k!r} differs")


def phase_main_path_kernel_vs_plain() -> None:
    trace = make_trace("msr2", seed=SEED, scale=0.02)
    cap, ee = _sizing(trace)
    t0 = time.perf_counter()
    specs = [f"wtlfu-{a}-{e}?sketch_backend=cms" for a in ("iv", "qv", "av")
             for e in ("slru", "sampled_frequency", "random")]
    cms.reset_launch_counts()
    kernel_runs = [_run(s, trace, cap, ee) for s in specs]
    counts = cms.launch_counts()
    log(f"phase 3: msr2 scale 0.02 ({len(trace)} accesses, cap {cap}, expected_entries {ee}), "
        f"9 combos through the kernels: launches {counts}")
    check(all(v > 0 for v in counts.values()), f"a kernel was not launched: {counts}")
    for spec, (p, hits) in zip(specs, kernel_runs):
        q, q_hits = _run(spec, trace, cap, ee, sketch_kwargs={"use_kernel": False})
        _same_runs(p, hits, q, q_hits, spec)
        log(f"phase 3: {spec}: kernel == plain, hit ratio {p.stats.hit_ratio:.6f}, "
            f"resets {p.sketch.resets}")
    check(cms.launch_counts() == counts, "use_kernel=False runs launched kernels")
    log(f"phase 3: {time.perf_counter() - t0:.3f} s")


# -- phase 4 ----------------------------------------------------------------
def phase_full_size(card: str, t_phase3: float, timings: dict) -> dict[str, int]:
    t0 = time.perf_counter()
    trace = make_trace("msr2", seed=SEED, scale=1.0)
    cap, ee = _sizing(trace)
    log(f"phase 4: msr2 scale 1.0: {len(trace)} accesses over a universe of "
        f"{TRACE_SPECS['msr2'].n_objects} objects ({trace.num_objects} accessed, "
        f"{trace.total_object_bytes} B), cap {cap} B (1%), expected_entries {ee}; "
        f"trace made in {time.perf_counter() - t0:.3f} s")
    check(len(trace) == TRACE_SPECS["msr2"].n_accesses == 900_000, "msr2 is not full size")
    spec = "wtlfu-av-sampled_frequency?sketch_backend=cms"
    policy = REGISTRY.build(spec, cap, expected_entries=ee)
    check(policy.device.type == "cuda" and policy.sketch.table.is_cuda, "policy is not on the card")
    step = 100_000
    rec = HitMaskRecorder()
    engine = SimulationEngine(instruments=[rec], snapshot_every=step)
    cms.reset_launch_counts()
    t0 = time.perf_counter()
    result = engine.run(policy, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = cms.launch_counts()
    st = policy.stats
    decisions = policy.main.decision
    check(all(v > 0 for v in counts.values()), f"a kernel was not launched: {counts}")
    launches = sum(counts.values())
    measured = all(timings[k]["device_ms"] is not None for k in counts)
    log(f"phase 4: {spec} on {card}: wall {wall:.3f} s, {st.accesses / wall:.1f} accesses/s, "
        f"{decisions} decisions, {decisions / wall:.1f} decisions/s")
    log(f"phase 4: hit ratio {st.hit_ratio:.6f}, byte hit ratio {st.byte_hit_ratio:.6f}, "
        f"resets {policy.sketch.resets}, launches {counts} ({launches} in all)")
    if measured:
        in_kernels = sum(counts[k] * timings[k]["device_ms"] for k in counts) / 1e3
        log(f"phase 4: kernel time inside the run (launches x profiler device time per "
            f"launch): {in_kernels:.3f} s = {100 * in_kernels / wall:.3f}% of wall; "
            f"mean {1e3 * in_kernels / launches:.6f} ms per launch")
    else:
        log("phase 4: kernel time inside the run: not measured (no profiler device time)")
    check(st.accesses == len(trace) and 0 < st.hits < st.accesses, "implausible stats")

    # the same run through the plain versions on the CPU, cut to whole
    # 100k-access segments once the time budget of phases 3 + 4 is spent
    torch.set_num_threads(1)
    cpu = REGISTRY.build(spec, cap, expected_entries=ee, device="cpu")
    cpu_rec = HitMaskRecorder()
    cpu_engine = SimulationEngine(instruments=[cpu_rec])
    cpu_hits = []
    done = 0
    t0 = time.perf_counter()
    while done < len(trace):
        hi = min(done + step, len(trace))
        cpu_engine.run(cpu, AccessTrace(trace.name, trace.keys[done:hi], trace.sizes[done:hi]))
        cpu_hits.append(cpu_rec.hits)
        done = hi
        snap = result.snapshots[done // step - 1] if done % step == 0 else None
        if snap is not None:
            got = (cpu.stats.accesses, cpu.stats.hits, cpu.stats.bytes_requested,
                   cpu.stats.bytes_hit, cpu.used_bytes(), cpu.stats.evictions)
            want = (snap.accesses, snap.hits, snap.bytes_requested, snap.bytes_hit,
                    snap.used_bytes, snap.evictions)
            check(got == want, f"CPU plain run differs at access {done}: {got} != {want}")
        if time.perf_counter() - t_phase3 > CPU_BUDGET_S and done < len(trace):
            break
    cpu_wall = time.perf_counter() - t0
    cpu_hits = np.concatenate(cpu_hits)
    check(np.array_equal(cpu_hits, rec.hits[:done]), "CPU plain run: hit bitmap differs")
    if done == len(trace):
        _same_runs(policy, rec.hits, cpu, cpu_hits, "full msr2, card vs CPU")
        log(f"phase 4: CPU plain run == card run over all {done} accesses ({cpu_wall:.3f} s)")
    else:
        log(f"phase 4: CPU comparison cut to the first {done} of {len(trace)} accesses "
            f"(time budget {CPU_BUDGET_S:.0f} s for phases 3 + 4)")
        log(f"phase 4: CPU plain run == card run over the first {done} accesses "
            f"({cpu_wall:.3f} s, {done / cpu_wall:.1f} accesses/s)")
    return counts


# -- phase 5 ----------------------------------------------------------------
SERVE_REQUESTS = 32
SERVE_NEW_TOKENS = 8


def _serving_prompts(vocab: int, seed: int) -> list[list[int]]:
    """As the reference launcher builds its traffic: 6 templates of uniform
    random tokens (2,304-3,584 long), each request a Zipf(1.2) choice of
    template plus 4 random suffix tokens."""
    rng = np.random.default_rng(seed)
    templates = [[int(t) for t in rng.integers(0, vocab, int(n))]
                 for n in rng.integers(2304, 3585, 6)]
    pmf = np.arange(1, 7.0) ** -1.2
    pmf /= pmf.sum()
    return [templates[int(rng.choice(6, p=pmf))] + [int(x) for x in rng.integers(0, vocab, 4)]
            for _ in range(SERVE_REQUESTS)]


def _comparable(stats: dict) -> dict:
    """Engine stats without the admission hook's wall-clock latencies."""
    out = dict(stats)
    out["admission"] = {k: v for k, v in stats["admission"].items()
                        if k not in ("decision_p50_ms", "decision_p99_ms")}
    return out


def phase_serving(card: str, flash_device_ms: float | None) -> dict[str, int]:
    # float32 as the reference: no TF32 in the port's matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("smollm-135m")
    model = LM(cfg, dtype=torch.float32, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(SEED))
    prompts = _serving_prompts(cfg.vocab_size, SEED)
    ecfg = EngineConfig(max_seq=4096, block_size=16, cache_capacity_bytes=512 << 20,
                        cache_policy="wtlfu-av?sketch_backend=cms")
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 5: {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, head dim {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} float32 parameters on the card; "
        f"{len(prompts)} prompts of {min(map(len, prompts))}-{max(map(len, prompts))} tokens")
    with torch.inference_mode():  # cuBLAS handles and workspaces, outside the counted run
        model.prefill(params, {"tokens": torch.zeros((1, 2100), dtype=torch.long, device="cuda")})
    torch.cuda.synchronize()

    engine = Engine(model, params, ecfg)
    check(engine.prefix_cache.policy.sketch.table.is_cuda, "the prefix cache's sketch is not on the card")
    torch.cuda.reset_peak_memory_stats()
    cms.reset_launch_counts()
    flash.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**cms.launch_counts(), **flash.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    stats = engine.stats()

    misses = [(p, r) for p, r in zip(prompts, out) if r["cached_tokens"] == 0]
    ttft = sorted(r["ttft_s"] for r in out)
    decode_tokens = sum(len(r["tokens"]) - 1 for r in out)
    log(f"phase 5: served {len(out)} requests on {card} in {wall:.3f} s: "
        f"{len(out) / wall:.3f} requests/s; {len(misses)} prefills at "
        f"{sum(len(p) for p, _ in misses) / sum(r['ttft_s'] for _, r in misses):.1f} prompt "
        f"tokens/s; time to first token p50 {1e3 * ttft[len(ttft) // 2]:.3f} ms, max "
        f"{1e3 * ttft[-1]:.3f} ms; decode {1e3 * sum(r['decode_s'] for r in out) / decode_tokens:.3f} "
        f"ms/token; peak memory {peak} B")
    log(f"phase 5: request hit ratio {stats['request_hit_ratio']}, token hit ratio "
        f"{stats['token_hit_ratio']}, byte hit ratio {stats['byte_hit_ratio']}, prefill savings "
        f"{stats['prefill_savings_frac']} ({stats['prefill_tokens_saved']} tokens saved, "
        f"{stats['prefill_tokens_computed']} computed); launches {counts}")
    if flash_device_ms is not None:
        share = counts[FLASH] * flash_device_ms / 1e3 / wall
        log(f"phase 5: flash kernel share of the wall (launches x device time per launch at "
            f"the 3,584-token shape, an upper bound per launch): {100 * share:.3f}%")
    else:
        log("phase 5: flash kernel share of the wall: not measured (no profiler device time)")
    check(len(misses) > 0 and counts[FLASH] == cfg.num_layers * len(misses),
          f"flash launches {counts[FLASH]} != {cfg.num_layers} x {len(misses)} prefills")
    check(stats["prefill_tokens_saved"] > 0, "the prefix cache saved no prefill")
    check(sum(counts[k] for k in cms.launch_counts()) > 0, "no CMS kernel was launched")
    for r in out:
        check(len(r["tokens"]) == SERVE_NEW_TOKENS and bool(torch.isfinite(r["prompt_logits"]).all()),
              "a request has the wrong number of tokens or non-finite logits")

    # the same traffic on a fresh engine through the plain versions, on the card
    t0 = time.perf_counter()
    plain = Engine(model, params, dataclasses.replace(ecfg, use_kernel=False))
    out_p = plain.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    check({**cms.launch_counts(), **flash.launch_counts()} == counts,
          "the use_kernel=False run launched kernels")
    atol, rtol = FLASH_TOL[torch.float32]
    worst = 0.0
    for i, (a, b) in enumerate(zip(out, out_p)):
        diff = (a["prompt_logits"] - b["prompt_logits"]).abs()
        worst = max(worst, float(diff.max()))
        bad = int((diff > atol + rtol * b["prompt_logits"].abs()).sum())
        check(bad == 0, f"request {i}: last prompt token logits differ in {bad} entries "
                        f"(max {float(diff.max()):.3e})")
        if a["tokens"] != b["tokens"]:
            for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])):
                if x != y:
                    log(f"phase 5: request {i} token {j}: kernel run {x}, plain run {y}")
                    break
        check(a["tokens"] == b["tokens"], f"request {i}: generated tokens differ")
        check(a["cached_tokens"] == b["cached_tokens"], f"request {i}: cached tokens differ")
    check(_comparable(stats) == _comparable(plain.stats()), "engine stats differ")
    log(f"phase 5: plain run ({time.perf_counter() - t0:.3f} s) == kernel run: tokens, cached "
        f"tokens and stats equal; max |last prompt token logits kernel - plain| = {worst:.3e}")
    return counts


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree



def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_device()
    errors = phase_kernels_vs_plain(dev)
    flash_errors = phase_flash_vs_plain(dev)
    timings = phase_timings(dev)
    for name, ms in phase_device_times(dev).items():
        timings[name]["device_ms"] = ms
    timings[FLASH] = phase_flash_timing(dev)
    t_phase3 = time.perf_counter()
    phase_main_path_kernel_vs_plain()
    counts = phase_full_size(card, t_phase3, timings)
    counts[FLASH] = phase_serving(card, timings[FLASH]["device_ms"])[FLASH]
    errors[FLASH] = max(flash_errors.values())
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": counts[name], "max_abs_err": errors[name],
        "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"],
        "bound_ms": timings[name]["bound_ms"], "bound_by": timings[name]["bound_by"],
        "library_ms": timings[name]["library_ms"], "device_ms": timings[name]["device_ms"],
        "shape": timings[name]["shape"],
    } for name, (source, replaces) in KERNELS.items()]
    log(f"total {time.perf_counter() - t_start:.3f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
