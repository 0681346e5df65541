#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and hold its kernels
against their plain versions.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

It imports nothing of JAX and nothing of the JAX package ``repro``. It
builds the port's CUDA kernels from ``src/repro_torch/kernels/*/csrc``
with ``nvcc`` (one ``nvcc`` per library, started together, into each
library's ``_build/``) and runs six phases; any failure raises and the
script exits nonzero:

1. device: the card's name and power limit (``nvidia-smi``), the build;
2. kernels: each CMS kernel against its plain PyTorch version on the card,
   byte for byte, over widths, batch sizes, caps and key mixes, through its
   tensor wrapper and through the sketch's one-C-call path
   (:func:`phase_sketch_vs_plain`); the flash
   attention kernel against its plain version over head dims, GQA groups,
   masks, soft-cap, lengths and dtypes, within ``FLASH_TOL``; the wkv6
   kernel's output and final state against its plain version over lengths,
   heads, batch sizes, dtypes and an extreme-decay case, within ``WKV_TOL``;
   then each kernel timed with CUDA events at its path's shapes beside its
   plain version and one PyTorch library call of the same function, where
   one exists;
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
   plain versions must give the same tokens, cache hits and stats;
6. serving RWKV-6: rwkv6-7b at its published width and depth (random
   weights from ``SEED``) behind the same prefix cache serves 32 requests
   over 6 block-aligned templates of 2,304-3,584 tokens, each bare or with
   4 more tokens, so that a stored recurrent state is reused; every prefill
   runs the wkv6 kernel in each of the 32 layers. The cache's stats must
   equal a CPU rehearsal of the same traffic (:func:`rehearse_rwkv_serving`),
   and a fresh engine through the plain versions must give the same tokens,
   cache hits and stats. Then the kernel is held against its plain version
   on every layer's own wkv6 inputs of every prefill, and against an exact
   (float64) wkv6 on one prompt (:func:`rwkv_precision`).

Phase 2 also times each CMS kernel as the sketch calls it, a host-clock
round trip from numpy keys to numpy estimates through ``CMSSketch``, beside
its library call timed the same way, through pinned buffers and
stream-ordered copies as the sketch's staging moves its keys.

The line before the last is a JSON object of the kernels' numbers; the
last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --sketch [--src DIR]

runs only what measures the sketch's calls: phase 1, the CMS timings of
phase 2 and phase 4 without its CPU comparison, with host timers wrapped
around ``CMSSketch.estimate_batch`` and ``CMSSketch.flush``
(:class:`SketchTimer`, whose own cost it measures), and prints their
numbers as one JSON line. ``--src DIR`` drives the package under ``DIR/src`` (a
``git archive`` of another commit, such as the parent, unpacked in the
checkout) with this script, so two commits are measured the same way in
one chip call.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import itertools
import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch


def _package_root() -> pathlib.Path:
    """The checkout whose ``src/`` the script drives: its own, or the one
    after ``--src``."""
    args = sys.argv[1:] if __name__ == "__main__" else []
    if "--src" in args:
        return pathlib.Path(args[args.index("--src") + 1]).resolve()
    return pathlib.Path(__file__).resolve().parent


sys.path.insert(0, str(_package_root() / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import REGISTRY, AccessTrace, HitMaskRecorder, SimulationEngine  # noqa: E402
from repro_torch.core.cms_sketch import CMSSketch  # noqa: E402
from repro_torch.kernels.attention import flash  # noqa: E402
from repro_torch.kernels.attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.cms import cms  # noqa: E402
from repro_torch.kernels.cms.ref import row_indexes  # noqa: E402
from repro_torch.kernels.wkv import wkv6 as wkv  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import rwkv as rwkv_model  # noqa: E402
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
#: The main path's shapes, the medians that phase 4's ``SketchTimer`` counts
#: on full msr2 (1% capacity, av-sampled_frequency; the CPU plain run makes
#: the same calls): fused calls M=4 pending increments, N=20 estimates;
#: estimate-only calls N=13; the update launches of staged flushes M=3. At
#: the full-size table width next_pow2(858) = 1024.
MAIN_WIDTH = 1024
#: The main path's sketch, sized as phase 4 sizes it (``expected_entries``
#: 858, width 1,024). The round trips sample no aging reset, so every call
#: takes the path its shape picks.
MAIN_EXPECTED = 858
ROUND_TRIP_SAMPLE_FACTOR = 10 ** 6
MAIN_SHAPES = {"cms_update_estimate": (4, 20), "cms_estimate": (0, 13), "cms_update": (3, 0)}
FLASH = "flash_attention_fwd"
WKV = "wkv6_fwd"
CMS_SOURCE = "src/repro_torch/kernels/cms/csrc/cms.cu"
#: each kernel of the path: (its source, the TPU kernel it replaces)
KERNELS = {
    "cms_update_estimate": (CMS_SOURCE, "src/repro/kernels/cms/cms.py:141"),
    "cms_update": (CMS_SOURCE, "src/repro/kernels/cms/cms.py:101"),
    "cms_estimate": (CMS_SOURCE, "src/repro/kernels/cms/cms.py:121"),
    FLASH: ("src/repro_torch/kernels/attention/csrc/flash_fwd.cu",
            "src/repro/kernels/attention/flash.py:77"),
    WKV: ("src/repro_torch/kernels/wkv/csrc/wkv6.cu", "src/repro/kernels/wkv/wkv6.py:71"),
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
#: wkv6 |kernel - plain| <= atol + rtol * |plain|. float32: the reference's
#: wkv6 tolerance (tests/test_kernels.py::TestWkv6Kernel, against the scan),
#: atol 3e-4, and 5e-4 where w reaches down to 1e-7; the kernel and its plain
#: version differ only in the order of float32 sums and in ex2/log2 against
#: exp/log. bfloat16 output: both compute in float32 from the same bf16
#: inputs and round once, so they differ by one bf16 step at most. The final
#: state is float32 in both dtypes and held to the float32 atol.
WKV_TOL = {torch.float32: (3e-4, 0.0), torch.bfloat16: (1e-3, 2 ** -7)}
WKV_EXTREME_ATOL = 5e-4
#: rwkv6-7b's prefill at the serving phase's longest prompt: r/k/v/w [B,T,H,64]
RWKV_PREFILL = (1, 3584, 64)
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
    libraries = (cms.load_library, flash.load_library, wkv.load_library)
    with ThreadPoolExecutor(len(libraries)) as pool:  # one nvcc per library, started together
        for fut in [pool.submit(load) for load in libraries]:
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


def phase_sketch_vs_plain(dev, steps: int = 400) -> int:
    """The sketch's one-C-call path (pinned staging, the ``*_call`` entries)
    against the same sketch through the plain versions on the card, byte for
    byte: random interleavings of increments, batches above ``flush_block``
    and across aging resets, estimates of 0-60 keys, lazy prefix views and
    flushes (two in a row among them), at the main path's table and at a
    small one whose sample fills every few calls. Returns the max |kernel -
    plain| over estimates and tables."""
    rng = np.random.default_rng(SEED + 9)
    err, resets = 0, 0
    for ee, flush_block in ((MAIN_EXPECTED, 512), (16, 48)):
        staged = CMSSketch(ee, flush_block=flush_block, device=dev)
        plain = CMSSketch(ee, flush_block=flush_block, use_kernel=False, device=dev)
        pool = rng.integers(-2**40, 2**40, 4096)
        for _ in range(steps):
            op = int(rng.integers(0, 5))
            if op == 0:
                batch = pool[rng.integers(0, 4096, int(rng.choice([1, 4, 600, 1500])))]
                staged.increment_batch(batch)
                plain.increment_batch(batch)
            elif op == 1:
                staged.flush()
                staged.flush()
                plain.flush()
            else:
                keys = pool[rng.integers(0, 4096, int(rng.integers(0, 61)))].tolist()
                a = staged.estimate_batch(iter(keys) if op == 4 else keys)
                b = plain.estimate_batch(keys)
                err = max(err, int(np.abs(a.astype(np.int64) - b).max(initial=0)))
            err = max(err, int((staged.table - plain.table).abs().max()))
            check((staged._ops, staged.resets, staged._pending)
                  == (plain._ops, plain.resets, plain._pending), "sketch state differs")
        resets += staged.resets
    torch.cuda.synchronize()
    log(f"phase 2: the sketch's staged C path against the plain versions on the card, "
        f"{2 * steps} calls, {resets} aging resets: max |kernel - plain| = {err}")
    check(err == 0 and resets > 0, "the staged sketch disagrees with its plain version")
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


def _host_ms(fn, reps: int) -> float:
    """ms per call on the host clock around ``reps`` calls, each of which
    ends with its result on the host (or, for an update, its stream
    synchronised)."""
    for i in range(20):
        fn(i)
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    return (time.perf_counter() - t0) / reps * 1e3


def phase_round_trips(dev, reps: int = 2000) -> dict[str, dict]:
    """Each CMS kernel as the main path calls it: a host-clock round trip
    from numpy keys to numpy estimates through ``CMSSketch`` on the card
    (for ``cms_update``, ``increment_batch`` + ``flush`` until the stream
    is synchronised), at ``MAIN_SHAPES``. Beside it, the library call of
    ``phase_timings`` over the same transport as the sketch's staging: the
    keys' row indexes (hashed beforehand, a favour to the library) written
    into a pinned host tensor and copied with ``non_blocking=True`` into a
    device tensor allocated once, the call, the estimates copied the same
    way into a pinned host tensor, one stream synchronisation, and the
    estimates copied out of the pinned buffer as numpy. Kernel, library,
    library, kernel: each reported as the mean of its pair."""
    rng = np.random.default_rng(SEED + 8)
    stream = torch.cuda.current_stream(dev)
    out = {}
    for name, (m, n) in MAIN_SHAPES.items():
        sk = CMSSketch(MAIN_EXPECTED, sample_factor=ROUND_TRIP_SAMPLE_FACTOR, device=dev)
        check(sk.width == MAIN_WIDTH, f"sketch width {sk.width} != {MAIN_WIDTH}")
        table = sk.table.clone()
        upd = rng.integers(0, 2**40, (reps + 20, m))
        est = rng.integers(0, 2**40, (reps + 20, n))
        idx = [np.concatenate([row_indexes(torch.from_numpy(k.astype(np.int32)), MAIN_WIDTH).numpy()
                               for k in (upd[i], est[i])], axis=1) for i in range(reps + 20)]
        ones = torch.ones((4, m), dtype=torch.int32, device=dev)
        h_idx = torch.empty((4, m + n), dtype=torch.int64, pin_memory=True)
        h_out = torch.empty(n, dtype=torch.int32, pin_memory=True)
        d_idx = torch.empty((4, m + n), dtype=torch.int64, device=dev)
        h_idx_np, h_out_np = h_idx.numpy(), h_out.numpy()

        def send(i):
            h_idx_np[...] = idx[i]  # the previous call synchronised: no copy reads it
            d_idx.copy_(h_idx, non_blocking=True)

        def fetch(vals):
            h_out.copy_(vals, non_blocking=True)
            stream.synchronize()
            return h_out_np.copy()

        if name == "cms_update":
            def kernel(i):
                sk.increment_batch(upd[i])
                sk.flush()
                stream.synchronize()

            def library(i):
                send(i)
                table.scatter_add_(1, d_idx, ones).clamp_(max=15)
                stream.synchronize()
        elif name == "cms_estimate":
            def kernel(i):
                return sk.estimate_batch(est[i])

            def library(i):
                send(i)
                return fetch(table.gather(1, d_idx).amin(0))
        else:
            def kernel(i):
                sk.increment_batch(upd[i])
                return sk.estimate_batch(est[i])

            def library(i):
                send(i)
                table.scatter_add_(1, d_idx[:, :m], ones).clamp_(max=15)
                return fetch(table.gather(1, d_idx[:, m:]).amin(0))
        k1, l1, l2, k2 = (_host_ms(fn, reps) for fn in (kernel, library, library, kernel))
        out[name] = {"round_trip_ms": (k1 + k2) / 2, "library_round_trip_ms": (l1 + l2) / 2}
        log(f"phase 2: {name} round trip at W={MAIN_WIDTH} M={m} N={n}, numpy keys to numpy "
            f"estimates on the host clock, pinned copies: sketch {out[name]['round_trip_ms']:.6f} "
            f"ms ({k1:.6f}, {k2:.6f}), library {out[name]['library_round_trip_ms']:.6f} ms "
            f"({l1:.6f}, {l2:.6f})")
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


# -- phase 2: wkv6 ------------------------------------------------------------
def _wkv_cases():
    """T over {64, 100, 1,000, 3,584} (one chunk, a ragged chunk, many, the
    serving prompt) x H over {2, 64} x float32 and bfloat16 (bf16 cases
    alternate bf16 and float32 w, as the model gives it), B = 2 below 1,000
    tokens; w uniform in (0.2, 0.999); then two extreme-decay cases with w
    from 1e-7."""
    i = 0
    for T in (64, 100, 1000, 3584):
        for H in (2, 64):
            for dtype in (torch.float32, torch.bfloat16):
                w_dtype = torch.float32 if dtype == torch.float32 or i % 2 else torch.bfloat16
                yield {"B": 2 if T < 1000 else 1, "T": T, "H": H, "dtype": dtype,
                       "w_dtype": w_dtype, "w_low": 0.2}
                i += 1
    for dtype in (torch.float32, torch.bfloat16):
        yield {"B": 1, "T": 130, "H": 2, "dtype": dtype, "w_dtype": dtype, "w_low": 1e-7}


def _wkv_inputs(gen, dev, B, T, H, dtype, w_dtype, w_low):
    K = wkv.HEAD_SIZE
    r, k, v = ((torch.randn((B, T, H, K), generator=gen, device=dev) * 0.5).to(dtype)
               for _ in range(3))
    hi = 0.999 if w_low > 1e-3 else 1.0
    w = (torch.rand((B, T, H, K), generator=gen, device=dev) * (hi - w_low) + w_low).to(w_dtype)
    u = torch.randn((H, K), generator=gen, device=dev) * 0.1
    return r, k, v, w, u


def phase_wkv_vs_plain(dev) -> dict[str, float]:
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    err = {"float32": 0.0, "bfloat16": 0.0, "state": 0.0}
    cases = 0
    for c in _wkv_cases():
        r, k, v, w, u = _wkv_inputs(gen, dev, c["B"], c["T"], c["H"], c["dtype"], c["w_dtype"],
                                    c["w_low"])
        o, S = wkv.wkv6_fwd(r, k, v, w, u, return_state=True)
        o_p, S_p = wkv.wkv6_fwd(r, k, v, w, u, return_state=True, use_kernel=False)
        o, o_p = o.float(), o_p.float()
        check(o.shape == (c["B"], c["T"], c["H"], wkv.HEAD_SIZE) and S.shape == S_p.shape,
              f"wkv6 shapes: {c}")
        check(bool(torch.isfinite(o).all() and torch.isfinite(S).all()),
              f"wkv6 kernel output not finite: {c}")
        atol, rtol = WKV_TOL[c["dtype"]]
        if c["dtype"] == torch.float32 and c["w_low"] < 1e-3:
            atol = WKV_EXTREME_ATOL
        s_atol = WKV_EXTREME_ATOL if c["w_low"] < 1e-3 else WKV_TOL[torch.float32][0]
        diff, s_diff = (o - o_p).abs(), (S - S_p).abs()
        bad = int((diff > atol + rtol * o_p.abs()).sum())
        s_bad = int((s_diff > s_atol).sum())
        name = str(c["dtype"]).split(".")[1]
        err[name] = max(err[name], float(diff.max()))
        err["state"] = max(err["state"], float(s_diff.max()))
        check(bad == 0 and s_bad == 0,
              f"wkv6 kernel disagrees with its plain version in {bad} outputs (max "
              f"{float(diff.max()):.3e}) and {s_bad} state entries (max "
              f"{float(s_diff.max()):.3e}): {c}")
        cases += 1
    torch.cuda.synchronize()
    log(f"phase 2: {cases} wkv6 cases against plain (output and final state), max "
        f"|kernel - plain| = {err} (tolerance atol + rtol*|plain|: float32 "
        f"{WKV_TOL[torch.float32]}, {WKV_EXTREME_ATOL} with w from 1e-7, bfloat16 "
        f"{WKV_TOL[torch.bfloat16]}; state atol {WKV_TOL[torch.float32][0]})")
    return err


def _wkv_bound(B, T, H, K, nbytes) -> tuple[float, str]:
    """Least time for wkv6 on these inputs: r, k, v, w read once, o and the
    final state written once over HBM bandwidth, against the least work of
    the function, that of the step-by-step recurrence: per token and head,
    o_t = r_t S (2 K V FLOP) and S = diag(w_t) S + k_t^T v_t (2 K V), so
    4 B T H K V float32 FLOP over the float32 rate. It needs no
    exponential (w is given); the pairwise exponentials of a chunked form
    are a cost of that algorithm, not of the function."""
    flops = 4 * B * T * H * K * K
    moved = nbytes * B * T * H * (4 * K + K) + 4 * B * H * K * K  # and the float32 state
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_wkv_timing(dev, reps: int = 20) -> dict:
    """The kernel at rwkv6-7b's prefill shape (float32): CUDA events, the
    profiler's device time and its plain version. No single PyTorch call
    computes wkv6, so there is no library time."""
    from torch.profiler import ProfilerActivity, profile

    B, T, H = RWKV_PREFILL
    gen = torch.Generator(device=dev).manual_seed(SEED + 6)
    r, k, v, w, u = _wkv_inputs(gen, dev, B, T, H, torch.float32, torch.float32, 0.2)

    def kernel(i):
        return wkv.wkv6_fwd(r, k, v, w, u, return_state=True)

    def plain(i):
        return wkv.wkv6_fwd(r, k, v, w, u, return_state=True, use_kernel=False)

    p1, k1, k2, p2 = _time(plain, reps), _time(kernel, reps), _time(kernel, reps), _time(plain, reps)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(reps):
            kernel(i)
        torch.cuda.synchronize()
    total, count = 0.0, 0
    for ev in prof.key_averages():
        if "wkv6_kernel" in ev.key:
            total += getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
            count += ev.count
    device_ms = total / count / 1e3 if count else None
    bound_ms, bound_by = _wkv_bound(B, T, H, wkv.HEAD_SIZE, 4)
    out = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by, "device_ms": device_ms,
           "shape": [B, T, H, wkv.HEAD_SIZE]}
    log(f"phase 2: {WKV} at r/k/v/w [{B},{T},{H},{wkv.HEAD_SIZE}], float32, with the final "
        f"state: kernel {out['ms']:.6f} ms ({k1:.6f}, {k2:.6f}), device "
        f"{'not measured' if device_ms is None else f'{device_ms:.6f} ms'} "
        f"({count} profiled launches), plain {out['plain_ms']:.6f} ms ({p1:.6f}, {p2:.6f}), "
        f"library: none (no single PyTorch call computes wkv6), bound {bound_ms:.6f} ms "
        f"({bound_by}: {F32_FLOPS_PER_S:.3g} FLOP/s float32, {HBM_BYTES_PER_S:.3g} B/s)")
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
class SketchTimer:
    """Host timers around ``CMSSketch.estimate_batch`` and ``CMSSketch.flush``
    while the block runs (the class attributes are wrapped, so a policy
    built inside the block calls the wrappers). Per ``estimate_batch`` it
    records the estimated keys, the pending increments it found and the
    sketch's flushed count; a lazy prefix view is materialised before its
    timer starts (walking the victims is the control plane's work). A
    ``flush`` inside an ``estimate_batch`` is counted inside it. Which path
    each call took, and the update launches of a staged call, are worked
    out afterwards, by the package's ``plan_flush`` where it has one. The
    wrappers' own cost a call is measured by :meth:`cost_us`."""

    def __init__(self):
        self.n, self.m, self.ops = [], [], []
        self.estimate_s = self.flush_s = 0.0
        self.flushes = 0
        self.sample_size = self.flush_block = None
        self._inside = False

    def _wrap(self, estimate_batch, flush):
        timer = self

        def timed_estimate_batch(sk, keys):
            if not isinstance(keys, (list, tuple, np.ndarray)):
                keys = list(keys)
            timer.n.append(len(keys))
            timer.m.append(len(sk._pending))
            timer.ops.append(sk._ops)
            t0 = time.perf_counter()
            timer._inside = True
            try:
                return estimate_batch(sk, keys)
            finally:
                timer._inside = False
                timer.estimate_s += time.perf_counter() - t0

        def timed_flush(sk):
            if timer._inside:
                return flush(sk)
            t0 = time.perf_counter()
            try:
                return flush(sk)
            finally:
                timer.flushes += 1
                timer.flush_s += time.perf_counter() - t0
        return timed_estimate_batch, timed_flush

    @contextlib.contextmanager
    def installed(self):
        estimate_batch, flush = CMSSketch.estimate_batch, CMSSketch.flush
        CMSSketch.estimate_batch, CMSSketch.flush = self._wrap(estimate_batch, flush)
        try:
            yield self
        finally:
            CMSSketch.estimate_batch, CMSSketch.flush = estimate_batch, flush

    @staticmethod
    def cost_us(calls: int = 200_000) -> float:
        """The wrappers' host cost a call, in us: the timed wrapper around a
        call that does nothing, less that call alone, at phase 4's median
        shape (13 keys, 2 pending)."""
        sk = type("Sketch", (), {"_pending": [1, 2], "_ops": 0})()
        keys = list(range(13))

        def nothing(sk, keys):
            return None
        wrapped = SketchTimer()._wrap(nothing, nothing)[0]
        per_call = []
        for fn in (nothing, wrapped, nothing, wrapped):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn(sk, keys)
            per_call.append((time.perf_counter() - t0) / calls * 1e6)
        return (per_call[1] + per_call[3] - per_call[0] - per_call[2]) / 2

    def summary(self, wall: float, sketch) -> dict:
        n, m, ops = np.asarray(self.n), np.asarray(self.m), np.asarray(self.ops)
        size, block = sketch.sample_size, sketch.flush_block
        calls = len(n) + self.flushes
        sketch_s = self.estimate_s + self.flush_s
        # the sketch's rule: fused while the pending keys fit one flush
        # block with no aging reset due, staged for more, estimate for none
        path = np.where(m == 0, 0, np.where((m <= block) & (ops + m < size), 1, 2))
        try:
            from repro_torch.core.cms_sketch import plan_flush
            takes = [take for i in np.flatnonzero(path == 2)
                     for take, _ in plan_flush(int(m[i]), int(ops[i]), size, block)[0]]
        except ImportError:  # a package from before plan_flush
            takes = None

        def med(x):
            return int(np.median(x)) if len(x) else None
        return {
            "calls": calls, "estimate_batch_calls": len(n), "flush_calls": self.flushes,
            "keys_mean": float(n.mean()), "keys_max": int(n.max()),
            "keys_p50": med(n), "keys_p99": int(np.percentile(n, 99)),
            "pending_share": float((m > 0).mean()), "pending_mean": float(m[m > 0].mean()),
            "fused_calls": int((path == 1).sum()), "staged_calls": int((path == 2).sum()),
            "estimate_calls": int((path == 0).sum()),
            "fused_median_mn": [med(m[path == 1]), med(n[path == 1])],
            "estimate_median_n": med(n[path == 0]),
            "staged_median_mn": [med(m[path == 2]), med(n[path == 2])],
            "staged_update_launches": None if takes is None else len(takes),
            "update_median_m": None if takes is None else med(takes),
            "estimate_batch_s": self.estimate_s, "flush_s": self.flush_s, "sketch_s": sketch_s,
            "sketch_share": sketch_s / wall, "control_plane_s": wall - sketch_s,
            "sketch_us_per_call": 1e6 * sketch_s / calls,
        }


def phase_full_size(card: str, t_phase3: float, timings: dict,
                    timed: bool = False) -> tuple[dict[str, int], dict]:
    """Full ``msr2`` through the port on the card, then through the plain
    versions on the CPU, which must agree. ``timed`` (the ``--sketch``
    mode) wraps the sketch in a :class:`SketchTimer` instead and skips the
    CPU run, so the full run's wall carries no timer."""
    t0 = time.perf_counter()
    trace = make_trace("msr2", seed=SEED, scale=1.0)
    cap, ee = _sizing(trace)
    log(f"phase 4: msr2 scale 1.0: {len(trace)} accesses over a universe of "
        f"{TRACE_SPECS['msr2'].n_objects} objects ({trace.num_objects} accessed, "
        f"{trace.total_object_bytes} B), cap {cap} B (1%), expected_entries {ee}; "
        f"trace made in {time.perf_counter() - t0:.3f} s")
    check(len(trace) == TRACE_SPECS["msr2"].n_accesses == 900_000, "msr2 is not full size")
    check(ee == MAIN_EXPECTED, f"expected_entries {ee} != MAIN_EXPECTED {MAIN_EXPECTED}")
    spec = "wtlfu-av-sampled_frequency?sketch_backend=cms"
    step = 100_000
    rec = HitMaskRecorder()
    engine = SimulationEngine(instruments=[rec], snapshot_every=step)
    timer = SketchTimer()
    with timer.installed() if timed else contextlib.nullcontext():
        policy = REGISTRY.build(spec, cap, expected_entries=ee)
        check(policy.device.type == "cuda" and policy.sketch.table.is_cuda,
              "policy is not on the card")
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
    sketch = {}
    if timed:
        sk = sketch = timer.summary(wall, policy.sketch)
        sk["timer_us_per_call"] = SketchTimer.cost_us()
        sk["timer_s"] = sk["timer_us_per_call"] * sk["calls"] / 1e6
        log(f"phase 4: sketch calls {sk['calls']} ({sk['estimate_batch_calls']} estimate_batch, "
            f"{sk['flush_calls']} flush outside it): keys per call mean {sk['keys_mean']:.3f}, "
            f"p50 {sk['keys_p50']}, p99 {sk['keys_p99']}, max {sk['keys_max']}; "
            f"{100 * sk['pending_share']:.3f}% with pending increments (mean "
            f"{sk['pending_mean']:.3f}); paths: {sk['fused_calls']} fused (median M, N "
            f"{sk['fused_median_mn']}), {sk['estimate_calls']} estimate (median N "
            f"{sk['estimate_median_n']}), {sk['staged_calls']} staged (median M, N "
            f"{sk['staged_median_mn']}; {sk['staged_update_launches']} update launches, "
            f"median M {sk['update_median_m']})")
        log(f"phase 4: host time in the sketch: estimate_batch {sk['estimate_batch_s']:.3f} s, "
            f"flush {sk['flush_s']:.3f} s, together {sk['sketch_s']:.3f} s = "
            f"{100 * sk['sketch_share']:.3f}% of the wall, {sk['sketch_us_per_call']:.3f} us a "
            f"call; control plane (the rest) {sk['control_plane_s']:.3f} s; the timer's own "
            f"cost {sk['timer_us_per_call']:.3f} us a call (a wrapper around a call that does "
            f"nothing), about {sk['timer_s']:.3f} s of the wall")
    sketch.update({"wall_s": wall, "accesses_per_s": st.accesses / wall,
                   "decisions": decisions, "decisions_per_s": decisions / wall,
                   "hit_ratio": st.hit_ratio, "byte_hit_ratio": st.byte_hit_ratio,
                   "resets": policy.sketch.resets, "launches": counts,
                   "stats": {k: v for k, v in st.as_dict().items() if k != "wall_seconds"},
                   "hits_sha256": hashlib.sha256(np.asarray(rec.hits).tobytes()).hexdigest()})
    check(st.accesses == len(trace) and 0 < st.hits < st.accesses, "implausible stats")
    if timed:
        return counts, sketch

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
    return counts, sketch


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


# -- phase 6 ----------------------------------------------------------------
#: rwkv6-7b's parameters: the reference's ``LM.init`` tree (``jax.eval_shape``
#: of it); the config's ``param_count()`` estimate is 7,566,524,416
RWKV_PARAMS = 7_576_756_224
RWKV_ENGINE = {"max_seq": 4096, "block_size": 16, "cache_capacity_bytes": 384 << 20,
               "cache_policy": "wtlfu-av?sketch_backend=cms"}
#: The kernel's precision on the model's own inputs, checked twice after
#: the plain run. (1) Every layer of every miss's prefill: the kernel's
#: output and final state against the plain version's on that layer's wkv6
#: inputs, max |kernel - plain| <= the reference's float32 atol
#: (``WKV_TOL``), which it states for outputs of unit scale, times
#: max(1, max |plain|) of the layer (float32 rounding is relative). (2) On
#: request ``RWKV_PRECISION_REQUEST``'s prompt, every layer's wkv6 computed
#: exactly (a float64 scan): the kernel's relative RMS distance from it at
#: most ``RWKV_EXACT_RATIO`` times the plain version's (float32 sums in
#: another order may double the rounding; a fault far above rounding does
#: not pass).
RWKV_PRECISION_REQUEST = 13
RWKV_EXACT_RATIO = 2.0
#: The last prompt token's float32 logits, kernel run against plain run: a
#: check for faults far above rounding (the layer checks above hold the
#: rounding). This random 32-layer model carries float32-rounding-sized
#: changes of its first layers' wkv6 outputs to the logits many times
#: amplified: relative noise of 1e-7 on the plain outputs moved request 13's
#: logits by 4.6e-3 and the plain version itself lies 2.9e-3 from the exact
#: run (on an H100, by :func:`rwkv_precision`; PERF.md), so the
#: logits of two float32 computations in different orders may differ by a
#: few 1e-3 to 1e-2; a wrong term or decay moves them by the scale of the
#: logits (about 5).
RWKV_LOGITS_TOL = 2e-2


def _rwkv_prompts(vocab: int, seed: int) -> list[list[int]]:
    """Block-aligned templates, so that a recurrent state is reusable: 6
    templates of uniform random tokens, 16 x U{144..224} long (2,304-3,584);
    each request a Zipf(1.2) choice of template, bare when ``i % 4 == 0``
    and otherwise followed by 4 random tokens."""
    rng = np.random.default_rng(seed)
    templates = [[int(t) for t in rng.integers(0, vocab, 16 * int(n))]
                 for n in rng.integers(144, 225, 6)]
    pmf = np.arange(1, 7.0) ** -1.2
    pmf /= pmf.sum()
    out = []
    for i in range(SERVE_REQUESTS):
        t = templates[int(rng.choice(6, p=pmf))]
        out.append(t if i % 4 == 0 else t + [int(x) for x in rng.integers(0, vocab, 4)])
    return out


class _NoModel:
    """Stands in for the model in :func:`rehearse_rwkv_serving`: the engine
    asks it for logits (zeros) and caches (none), so the engine's lookups
    and offers run on the real prefix cache at the real config's bytes per
    token with nothing computed."""

    def __init__(self, cfg):
        self.cfg, self.device, self.dtype = cfg, torch.device("cpu"), torch.float32

    def prefill(self, params, batch, max_seq=None, *, use_kernel=True):
        return torch.zeros((1, self.cfg.padded_vocab)), []

    def decode_step(self, params, caches, tokens, pos):
        return torch.zeros((1, self.cfg.padded_vocab)), caches


def rehearse_rwkv_serving() -> dict:
    """Phase 6's traffic through the engine and prefix cache alone, on the
    CPU (admission sees only block hashes and sizes): the cache stats that
    the card's run must give. ``python3 -c "import chip_smoke as c;
    print(c.rehearse_rwkv_serving())"``."""
    cfg = get_config("rwkv6-7b")
    ecfg = EngineConfig(**RWKV_ENGINE, device="cpu")
    engine = Engine(_NoModel(cfg), None, ecfg)
    engine.serve(_rwkv_prompts(cfg.vocab_size, SEED), max_new_tokens=SERVE_NEW_TOKENS)
    return engine.stats()


def phase_rwkv_serving(dev, card: str, wkv_device_ms: float | None) -> dict[str, int]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = rehearse_rwkv_serving()
    log(f"phase 6: CPU rehearsal of the traffic through the prefix cache alone "
        f"({time.perf_counter() - t0:.3f} s): request hit ratio {want['request_hit_ratio']}, "
        f"token hit ratio {want['token_hit_ratio']}, byte hit ratio {want['byte_hit_ratio']}, "
        f"prefill savings {want['prefill_savings_frac']}")
    cfg = get_config("rwkv6-7b")
    model = LM(cfg, dtype=torch.float32, device=dev)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    prompts = _rwkv_prompts(cfg.vocab_size, SEED)
    ecfg = EngineConfig(**RWKV_ENGINE)
    log(f"phase 6: {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv_head_dim} heads x {cfg.rwkv_head_dim}, channel-mix d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; {n_params} float32 parameters drawn on the card "
        f"in {time.perf_counter() - t0:.3f} s ({torch.cuda.memory_allocated()} B); "
        f"{len(prompts)} prompts of {min(map(len, prompts))}-{max(map(len, prompts))} tokens")
    check(n_params == RWKV_PARAMS, f"{n_params} parameters, not {RWKV_PARAMS}")
    with torch.inference_mode():  # cuBLAS handles and workspaces, outside the counted run
        model.prefill(params, {"tokens": torch.zeros((1, 256), dtype=torch.long, device=dev)})
    torch.cuda.synchronize()

    engine = Engine(model, params, ecfg)
    check(engine.prefix_cache.policy.sketch.table.is_cuda, "the prefix cache's sketch is not on the card")
    torch.cuda.reset_peak_memory_stats()
    cms.reset_launch_counts()
    flash.reset_launch_counts()
    wkv.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {**cms.launch_counts(), **flash.launch_counts(), **wkv.launch_counts()}
    peak = torch.cuda.max_memory_allocated()
    stats = engine.stats()

    misses = [(p, r) for p, r in zip(prompts, out) if r["cached_tokens"] == 0]
    ttft = sorted(r["ttft_s"] for r in out)
    decode_tokens = sum(len(r["tokens"]) - 1 for r in out)
    log(f"phase 6: served {len(out)} requests on {card} in {wall:.3f} s: "
        f"{len(out) / wall:.3f} requests/s; {len(misses)} prefills at "
        f"{sum(len(p) for p, _ in misses) / sum(r['ttft_s'] for _, r in misses):.1f} prompt "
        f"tokens/s; time to first token p50 {1e3 * ttft[len(ttft) // 2]:.3f} ms, max "
        f"{1e3 * ttft[-1]:.3f} ms; decode {1e3 * sum(r['decode_s'] for r in out) / decode_tokens:.3f} "
        f"ms/token; peak memory {peak} B")
    log(f"phase 6: request hit ratio {stats['request_hit_ratio']}, token hit ratio "
        f"{stats['token_hit_ratio']}, byte hit ratio {stats['byte_hit_ratio']}, prefill savings "
        f"{stats['prefill_savings_frac']} ({stats['prefill_tokens_saved']} tokens saved, "
        f"{stats['prefill_tokens_computed']} computed); launches {counts}")
    if wkv_device_ms is not None:
        share = counts[WKV] * wkv_device_ms / 1e3 / wall
        log(f"phase 6: wkv6 kernel share of the wall (launches x device time per launch at "
            f"the 3,584-token shape, an upper bound per launch): {100 * share:.3f}%")
    else:
        log("phase 6: wkv6 kernel share of the wall: not measured (no profiler device time)")
    check(_comparable(stats) == _comparable(want), "cache stats differ from the CPU rehearsal")
    check(len(misses) > 0 and counts[WKV] == cfg.num_layers * len(misses),
          f"wkv6 launches {counts[WKV]} != {cfg.num_layers} x {len(misses)} prefills")
    check(counts[FLASH] == 0, "an attention-free model launched the flash kernel")
    check(stats["prefill_tokens_saved"] > 0, "the prefix cache saved no prefill")
    check(counts["cms_update_estimate"] > 0, "no fused CMS kernel was launched")
    for r in out:
        check(len(r["tokens"]) == SERVE_NEW_TOKENS and bool(torch.isfinite(r["prompt_logits"]).all()),
              "a request has the wrong number of tokens or non-finite logits")

    # the same traffic on a fresh engine through the plain versions, on the card
    t0 = time.perf_counter()
    plain = Engine(model, params, dataclasses.replace(ecfg, use_kernel=False))
    out_p = plain.serve(prompts, max_new_tokens=SERVE_NEW_TOKENS)
    torch.cuda.synchronize()
    check({**cms.launch_counts(), **flash.launch_counts(), **wkv.launch_counts()} == counts,
          "the use_kernel=False run launched kernels")
    t_plain = time.perf_counter() - t0
    worst = 0.0
    for i, (a, b) in enumerate(zip(out, out_p)):
        diff = float((a["prompt_logits"] - b["prompt_logits"]).abs().max())
        worst = max(worst, diff)
        check(diff <= RWKV_LOGITS_TOL, f"request {i}: last prompt token logits differ by "
                                       f"{diff:.3e}, more than {RWKV_LOGITS_TOL}")
        if a["tokens"] != b["tokens"]:
            for j, (x, y) in enumerate(zip(a["tokens"], b["tokens"])):
                if x != y:
                    log(f"phase 6: request {i} token {j}: kernel run {x}, plain run {y}")
                    break
        check(a["tokens"] == b["tokens"], f"request {i}: generated tokens differ")
        check(a["cached_tokens"] == b["cached_tokens"], f"request {i}: cached tokens differ")
    check(_comparable(stats) == _comparable(plain.stats()), "engine stats differ")
    scale = max(float(r["prompt_logits"].abs().max()) for r in out_p)
    log(f"phase 6: plain run ({t_plain:.3f} s) == kernel run: tokens, cached tokens and stats "
        f"equal; max |last prompt token logits kernel - plain| = {worst:.3e} (tolerance "
        f"{RWKV_LOGITS_TOL}; max |plain logit| {scale:.3f})")

    # the kernel on every layer's own wkv6 inputs (these launches come after
    # the counted run)
    t0 = time.perf_counter()
    layer_err = max(max(wkv_layers_vs_plain(model, params, p, dev)) for p, _ in misses)
    log(f"phase 6: wkv6 in every layer of the {len(misses)} prefills, kernel against plain on "
        f"the layer's inputs ({time.perf_counter() - t0:.3f} s): max |kernel - plain| / "
        f"max(1, max |plain|) = {layer_err:.3e} (tolerance {WKV_TOL[torch.float32][0]})")
    check(layer_err <= WKV_TOL[torch.float32][0], "a layer's wkv6 kernel output or state "
                                                 "disagrees with its plain version")
    t0 = time.perf_counter()
    prec = rwkv_precision(model, params, prompts[RWKV_PRECISION_REQUEST], dev)
    err = prec["layer_rel_rms_err"]
    ratio = max(a / b for a, b in zip(err["kernel"], err["plain32"]))
    log(f"phase 6: precision on request {RWKV_PRECISION_REQUEST} ({prec['tokens']} tokens, "
        f"{time.perf_counter() - t0:.3f} s): {json.dumps(prec)}")
    log(f"phase 6: wkv6 relative RMS distance from the exact (float64) value, over the "
        f"{cfg.num_layers} layers: kernel {min(err['kernel']):.3e}-{max(err['kernel']):.3e}, "
        f"plain chunk 32 {min(err['plain32']):.3e}-{max(err['plain32']):.3e}, chunk 64 "
        f"{min(err['plain64']):.3e}-{max(err['plain64']):.3e}; kernel / chunk 32 at most "
        f"{ratio:.3f} (limit {RWKV_EXACT_RATIO})")
    check(ratio <= RWKV_EXACT_RATIO, "the wkv6 kernel is less accurate than its plain version")
    return counts


@contextlib.contextmanager
def _wkv_layers(fn):
    """Routes the rwkv model's wkv6 calls through ``fn(layer, r, k, v, w, u)``
    (which returns o and the final state) while the block runs; ``layer``
    counts the calls from 0."""
    layers = itertools.count()
    model_wkv6 = rwkv_model.wkv6

    def tap(r, k, v, w, u, *, chunk, return_state, use_kernel):
        o, S = fn(next(layers), r, k, v, w, u)
        return (o, S) if return_state else o

    rwkv_model.wkv6 = tap
    try:
        yield
    finally:
        rwkv_model.wkv6 = model_wkv6


def _prefill_logits(model, params, prompt, dev, fn) -> torch.Tensor:
    """The last prompt token's logits of a prefill whose wkv6 calls go
    through ``fn`` (see :func:`_wkv_layers`)."""
    with torch.inference_mode(), _wkv_layers(fn):
        tokens = torch.tensor([prompt], dtype=torch.long, device=dev)
        return model.prefill(params, {"tokens": tokens}, use_kernel=False)[0][0]


def _wkv_plain(layer, r, k, v, w, u, chunk=rwkv_model.CHUNK):
    return wkv.wkv6_fwd(r, k, v, w, u, chunk=chunk, return_state=True, use_kernel=False)


def _wkv_kernel(layer, r, k, v, w, u):
    return wkv.wkv6_fwd(r, k, v, w, u, return_state=True)


def _wkv6_exact(r, k, v, w, u):
    """wkv6 by the step-by-step recurrence in float64: the exact value that
    float32 versions are measured against. Returns float64 o and state."""
    B, T, H, K = r.shape
    r, k, v, w = (x.double() for x in (r, k, v, w))
    uu = u.double()[None, :, :, None]
    S = r.new_zeros((B, H, K, v.shape[-1]))
    o = r.new_empty((B, T, H, v.shape[-1]))
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        o[:, t] = torch.einsum("bhk,bhkv->bhv", r[:, t], S + uu * kv)
        S = w[:, t, :, :, None] * S + kv
    return o, S


def wkv_layers_vs_plain(model, params, prompt, dev) -> list[float]:
    """Prefills ``prompt`` through the plain versions and runs the kernel on
    every layer's own wkv6 inputs: per layer, max |kernel - plain| of the
    output and the final state over max(1, max |plain|) of each (the
    model's plain version: chunk ``rwkv_model.CHUNK``)."""
    errs = []

    def fn(layer, r, k, v, w, u):
        o, S = _wkv_plain(layer, r, k, v, w, u)
        o_k, S_k = _wkv_kernel(layer, r, k, v, w, u)
        errs.append(max(float((o_k - o).abs().max()) / max(1.0, float(o.abs().max())),
                        float((S_k - S).abs().max()) / max(1.0, float(S.abs().max()))))
        return o, S

    _prefill_logits(model, params, prompt, dev, fn)
    return errs


def rwkv_precision(model, params, prompt, dev) -> dict:
    """Where the kernel run's logits part from the plain run's, on one
    prompt. Each layer's wkv6 is computed exactly (float64 scan) and, on the
    same inputs, by the kernel and by the plain version at chunks 32 and
    64: their relative distances from the exact value, per layer. Then the
    last prompt token's logits of whole prefills whose wkv6 is, in every
    layer, the exact one, the kernel, the plain one at chunk 32 (the
    model's) or 64, the kernel in layer 0 only, or the plain one with every
    output multiplied by 1 + eps N(0, 1) for eps 1e-7 and 1e-6."""
    layer_err = {"kernel": [], "plain32": [], "plain64": []}
    fns = {"kernel": _wkv_kernel, "plain32": _wkv_plain,
           "plain64": functools.partial(_wkv_plain, chunk=64)}

    def exact(layer, r, k, v, w, u):
        o, S = _wkv6_exact(r, k, v, w, u)
        rms = float(o.square().mean().sqrt())
        for name, fn in fns.items():
            o_x = fn(layer, r, k, v, w, u)[0].double()
            layer_err[name].append(float((o_x - o).square().mean().sqrt()) / rms)
        return o.float(), S.float()

    def noisy(eps):
        gen = torch.Generator(device=dev).manual_seed(SEED + 7)

        def fn(layer, r, k, v, w, u):
            o, S = _wkv_plain(layer, r, k, v, w, u)
            return o * (1 + eps * torch.randn(o.shape, generator=gen, device=o.device)), S
        return fn

    def kernel_in_layer0(layer, r, k, v, w, u):
        return (_wkv_kernel if layer == 0 else _wkv_plain)(layer, r, k, v, w, u)

    logits = {"exact": _prefill_logits(model, params, prompt, dev, exact)}
    for name, fn in {**fns, "kernel_layer0": kernel_in_layer0, "noise1e-7": noisy(1e-7),
                     "noise1e-6": noisy(1e-6)}.items():
        logits[name] = _prefill_logits(model, params, prompt, dev, fn)
    base = logits["plain32"]
    return {"tokens": len(prompt),
            "layer_rel_rms_err": layer_err,
            "logits_vs_plain32": {n: float((x - base).abs().max()) for n, x in logits.items()
                                  if n != "plain32"},
            "logits_vs_exact": {n: float((x - logits["exact"]).abs().max())
                                for n, x in logits.items() if n != "exact"}}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree



def _cms_timings(dev) -> dict[str, dict]:
    """Phase 2's CMS timings: CUDA events, profiler device time, round trips."""
    timings = phase_timings(dev)
    for name, ms in phase_device_times(dev).items():
        timings[name]["device_ms"] = ms
    for name, rt in phase_round_trips(dev).items():
        timings[name].update(rt)
    return timings


def main_sketch() -> int:
    """``--sketch``: phase 1, the CMS timings and phase 4 without its CPU
    comparison; their numbers as one JSON line."""
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_device()
    timings = _cms_timings(dev)
    _, sketch = phase_full_size(card, time.perf_counter(), timings, timed=True)
    log(f"total {time.perf_counter() - t_start:.3f} s on {card}")
    print(json.dumps({"card": card, "src": str(_package_root()), "timings": timings,
                      "phase4": sketch}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    if "--sketch" in sys.argv[1:]:
        return main_sketch()
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = phase_device()
    errors = phase_kernels_vs_plain(dev)
    errors["cms_staged"] = phase_sketch_vs_plain(dev)
    flash_errors = phase_flash_vs_plain(dev)
    timings = _cms_timings(dev)
    timings[FLASH] = phase_flash_timing(dev)
    wkv_errors = phase_wkv_vs_plain(dev)
    timings[WKV] = phase_wkv_timing(dev)
    t_phase3 = time.perf_counter()
    phase_main_path_kernel_vs_plain()
    counts, sketch = phase_full_size(card, t_phase3, timings)
    counts[FLASH] = phase_serving(card, timings[FLASH]["device_ms"])[FLASH]
    counts[WKV] = phase_rwkv_serving(dev, card, timings[WKV]["device_ms"])[WKV]
    for name in ("cms_update", "cms_estimate", "cms_update_estimate"):
        errors[name] = max(errors[name], errors["cms_staged"])
    errors[FLASH] = max(flash_errors.values())
    errors[WKV] = max(wkv_errors.values())
    kernels = [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": counts[name], "max_abs_err": errors[name],
        "ms": timings[name]["ms"], "plain_ms": timings[name]["plain_ms"],
        "bound_ms": timings[name]["bound_ms"], "bound_by": timings[name]["bound_by"],
        "library_ms": timings[name]["library_ms"], "device_ms": timings[name]["device_ms"],
        "round_trip_ms": timings[name].get("round_trip_ms"),
        "library_round_trip_ms": timings[name].get("library_round_trip_ms"),
        "shape": timings[name]["shape"],
    } for name, (source, replaces) in KERNELS.items()]
    log(f"total {time.perf_counter() - t_start:.3f} s on {card}")
    log(json.dumps({"phase4": sketch}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
