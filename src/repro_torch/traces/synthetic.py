"""Seeded synthetic traces calibrated to the paper's four trace classes.

A copy of the reference package's ``repro/traces/synthetic.py``: the same
specs, RNG call order and constants (``_ID_MULT``, ``_ID_SPACE``), so the
same seed makes byte-identical traces in both packages.

The paper's traces (Table 1) are not redistributable; we synthesize traces
whose *shape* matches each class (DESIGN.md §8):

* **MSR1/MSR2** (enterprise storage): object sizes concentrated in 3-4 tight
  clusters (Fig. 8: "easy to divide into a small number of size buckets"),
  sizes <1KB..0.5MB, strong popularity skew.
* **MSR3 / SYSTOR1-3** (storage/VDI): sizes spread (lognormal) over
  512B..0.5MB, moderate skew, strong recency.
* **CDN1-3**: sizes spanning the whole range up to 0.5GB (lognormal body +
  Pareto tail), Zipf popularity, mild recency.
* **TENCENT1** (photo store): lognormal 4KB..1MB, many one-hit wonders.

Popularity: Zipf(α) over N objects + a recency process (with probability
``p_recency`` an access repeats a recent access at geometric backward
distance), giving both LFU- and LRU-exploitable structure. Object sizes are
sampled once per object and are stable across the trace.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from repro_torch.core.cache_api import AccessTrace

__all__ = [
    "TraceSpec",
    "TRACE_SPECS",
    "ShiftSpec",
    "SHIFT_SPECS",
    "shift_boundaries",
    "make_trace",
    "paper_traces",
]

KB = 1024
MB = 1024 * KB
GB = 1024 * MB


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    name: str
    n_accesses: int
    n_objects: int
    zipf_alpha: float
    p_recency: float
    recency_scale: int
    size_kind: str  # clustered | lognormal | heavytail
    size_params: tuple
    one_hit_frac: float = 0.0  # extra tail of single-access objects


# Scaled-down analogues of paper Table 1 (accesses ~1/40, objects ~1/60).
TRACE_SPECS: dict[str, TraceSpec] = {
    # clustered sizes; 29M/18M in the paper
    "msr1": TraceSpec("msr1", 700_000, 280_000, 0.85, 0.35, 2_000, "clustered",
                      ((4 * KB, 0.45), (64 * KB, 0.35), (256 * KB, 0.15), (512, 0.05))),
    # 37M/6M: fewer objects, higher reuse
    "msr2": TraceSpec("msr2", 900_000, 140_000, 0.95, 0.40, 1_500, "clustered",
                      ((8 * KB, 0.5), (32 * KB, 0.3), (128 * KB, 0.2))),
    # 2.2M/0.27M: small trace, spread sizes
    "msr3": TraceSpec("msr3", 300_000, 36_000, 0.9, 0.30, 1_000, "lognormal",
                      (14.0, 1.8, 512, 512 * KB)),
    "systor1": TraceSpec("systor1", 1_000_000, 640_000, 0.75, 0.45, 4_000, "lognormal",
                         (13.5, 2.0, 512, 512 * KB)),
    "systor2": TraceSpec("systor2", 1_000_000, 600_000, 0.78, 0.45, 4_000, "lognormal",
                         (13.8, 1.9, 512, 512 * KB)),
    "systor3": TraceSpec("systor3", 1_000_000, 660_000, 0.74, 0.42, 4_000, "lognormal",
                         (13.4, 2.1, 512, 512 * KB)),
    # CDN: sizes span to 0.5GB
    "cdn1": TraceSpec("cdn1", 1_200_000, 45_000, 0.95, 0.20, 8_000, "heavytail",
                      (15.0, 2.2, 1 * KB, 512 * MB, 1.3, 0.05), one_hit_frac=0.1),
    "cdn2": TraceSpec("cdn2", 1_500_000, 60_000, 1.0, 0.18, 8_000, "heavytail",
                      (14.5, 2.4, 1 * KB, 512 * MB, 1.25, 0.06), one_hit_frac=0.12),
    "cdn3": TraceSpec("cdn3", 1_400_000, 70_000, 0.92, 0.22, 8_000, "heavytail",
                      (14.8, 2.3, 1 * KB, 768 * MB, 1.35, 0.05), one_hit_frac=0.1),
    # photo store: many one-hit wonders
    "tencent1": TraceSpec("tencent1", 1_200_000, 480_000, 0.8, 0.25, 6_000, "lognormal",
                          (11.5, 1.4, 4 * KB, 1 * MB), one_hit_frac=0.35),
}


def _sample_sizes(spec: TraceSpec, n: int, rng: np.random.Generator) -> np.ndarray:
    kind, p = spec.size_kind, spec.size_params
    if kind == "clustered":
        centers = np.array([c for c, _ in p], dtype=np.float64)
        weights = np.array([w for _, w in p], dtype=np.float64)
        weights /= weights.sum()
        idx = rng.choice(len(centers), size=n, p=weights)
        jitter = rng.lognormal(0.0, 0.08, size=n)  # tight clusters (Fig. 8)
        sizes = centers[idx] * jitter
        return np.maximum(64, sizes).astype(np.int64)
    if kind == "lognormal":
        mu, sigma, lo, hi = p
        sizes = rng.lognormal(mu, sigma, size=n)
        return np.clip(sizes, lo, hi).astype(np.int64)
    if kind == "heavytail":
        mu, sigma, lo, hi, pareto_a, tail_frac = p
        body = rng.lognormal(mu, sigma, size=n)
        tail = lo * 1024 * (1.0 + rng.pareto(pareto_a, size=n))
        take_tail = rng.random(n) < tail_frac
        sizes = np.where(take_tail, tail, body)
        return np.clip(sizes, lo, hi).astype(np.int64)
    raise ValueError(f"unknown size kind {kind}")


def _zipf_pmf(n: int, alpha: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    pmf = ranks ** (-alpha)
    return pmf / pmf.sum()


def _index_stream(spec: TraceSpec, rng: np.random.Generator, n_acc: int,
                  n_obj: int, n_popular: int) -> np.ndarray:
    """Zipf + one-hit-wonder + recency access stream in local *object index*
    space (``[0, n_obj)``); callers map indices onto object ids. The RNG
    call order matches the original inline generator, so traces built
    through this helper are byte-identical to pre-refactor ones."""
    pmf = _zipf_pmf(n_popular, spec.zipf_alpha)
    base = rng.choice(n_popular, size=n_acc, p=pmf)

    # One-hit wonders: sprinkle unique objects over the stream.
    n_ohw = n_obj - n_popular
    if n_ohw > 0:
        pos = rng.choice(n_acc, size=min(n_ohw, n_acc // 4), replace=False)
        base[pos] = n_popular + np.arange(len(pos))

    # Recency process: some accesses repeat a recent access.
    rec_mask = rng.random(n_acc) < spec.p_recency
    back = rng.geometric(1.0 / spec.recency_scale, size=n_acc)
    src = np.arange(n_acc) - back
    apply = rec_mask & (src >= 0)
    idxs = np.nonzero(apply)[0]
    src_idx = src[idxs]
    for i, s in zip(idxs.tolist(), src_idx.tolist()):  # sequential: refs may chain
        base[i] = base[s]
    return base


@dataclasses.dataclass(frozen=True)
class ShiftSpec:
    """A workload-shift trace: phases with different popularity orderings
    and size distributions, concatenated (paper Figs. 11-12 stress
    robustness over time; this stresses it across an abrupt shift).

    ``overlap_frac`` of each later phase's popular ranks carry over objects
    from the previous phase (with their original sizes — object sizes stay
    stable trace-wide); the rest of the universe is fresh, so the hot set
    genuinely moves at every boundary.
    """

    name: str
    phases: tuple[TraceSpec, ...]
    overlap_frac: float = 0.15


SHIFT_SPECS: dict[str, ShiftSpec] = {
    # two phases: clustered-small-object MSR-like -> large-object lognormal
    "shift1": ShiftSpec("shift1", (
        TraceSpec("shift1:p0", 400_000, 120_000, 0.95, 0.35, 1_500, "clustered",
                  ((8 * KB, 0.55), (64 * KB, 0.45))),
        TraceSpec("shift1:p1", 400_000, 120_000, 0.95, 0.35, 1_500, "lognormal",
                  (13.8, 1.0, 64 * KB, 4 * MB)),
    )),
    # three phases with higher carry-over: skew flip + size regime changes
    "shift2": ShiftSpec("shift2", (
        TraceSpec("shift2:p0", 300_000, 90_000, 1.05, 0.30, 2_000, "clustered",
                  ((4 * KB, 0.6), (32 * KB, 0.4))),
        TraceSpec("shift2:p1", 300_000, 90_000, 0.75, 0.45, 2_000, "heavytail",
                  (14.0, 2.0, 1 * KB, 256 * MB, 1.3, 0.05)),
        TraceSpec("shift2:p2", 300_000, 90_000, 0.95, 0.35, 2_000, "clustered",
                  ((16 * KB, 0.5), (128 * KB, 0.5))),
    ), overlap_frac=0.25),
}

_ID_MULT = np.int64(2654435761)  # odd: x -> x*c mod 2^40 is a bijection
_ID_SPACE = np.int64(1 << 40)


def shift_boundaries(spec: "ShiftSpec | str", *, scale: float = 1.0) -> list[int]:
    """Access indices where each later phase of a shift trace begins (same
    per-phase scaling rule as :func:`make_trace`)."""
    if isinstance(spec, str):
        spec = SHIFT_SPECS[spec]
    bounds, acc = [], 0
    for phase in spec.phases[:-1]:
        acc += max(1000, int(phase.n_accesses * scale))
        bounds.append(acc)
    return bounds


def _make_shift_trace(spec: ShiftSpec, seed: int, scale: float) -> AccessTrace:
    all_keys: list[np.ndarray] = []
    all_sizes: list[np.ndarray] = []
    size_of: dict[int, int] = {}  # id -> stable size, across phases
    prev_ids: np.ndarray | None = None
    id_offset = 0
    for p, phase in enumerate(spec.phases):
        rng = np.random.default_rng(
            [seed, zlib.crc32(spec.name.encode()) & 0x7FFFFFFF, p])
        n_acc = max(1000, int(phase.n_accesses * scale))
        n_obj = max(100, int(phase.n_objects * scale))
        n_popular = max(10, int(n_obj * (1.0 - phase.one_hit_frac)))
        # Fresh universe for this phase, pre-mapped to final id space
        # (disjoint offsets + odd-multiplier bijection keep phases disjoint).
        ids = (rng.permutation(n_obj).astype(np.int64) + id_offset) * _ID_MULT % _ID_SPACE
        id_offset += n_obj
        sizes_per_obj = _sample_sizes(phase, n_obj, rng)
        if prev_ids is not None and spec.overlap_frac > 0:
            # Carry over previous-phase objects into a slice of the popular
            # ranks; they keep their established sizes.
            n_carry = min(int(n_popular * spec.overlap_frac), len(prev_ids))
            carried = rng.choice(prev_ids, size=n_carry, replace=False)
            slots = rng.choice(n_popular, size=n_carry, replace=False)
            ids[slots] = carried
            sizes_per_obj[slots] = [size_of[int(c)] for c in carried]
        for i, s in zip(ids.tolist(), sizes_per_obj.tolist()):
            size_of.setdefault(i, s)
        base = _index_stream(phase, rng, n_acc, n_obj, n_popular)
        all_keys.append(ids[base])
        all_sizes.append(sizes_per_obj[base])
        prev_ids = ids
    return AccessTrace(
        spec.name,
        np.concatenate(all_keys).astype(np.int64),
        np.concatenate(all_sizes).astype(np.int64),
    )


def make_trace(
    spec: "TraceSpec | ShiftSpec | str", *, seed: int = 0, scale: float = 1.0
) -> AccessTrace:
    """Generate a trace; ``scale`` shrinks both accesses and object count.

    Accepts paper-class names (:data:`TRACE_SPECS`), workload-shift names
    (:data:`SHIFT_SPECS`) or explicit spec objects.
    """
    if isinstance(spec, str):
        spec = SHIFT_SPECS.get(spec) or TRACE_SPECS[spec]
    if isinstance(spec, ShiftSpec):
        return _make_shift_trace(spec, seed, scale)
    # crc32, NOT hash(): str hashing is randomized per process, which would
    # make "the same trace" differ between runs (and made tests flaky).
    rng = np.random.default_rng([seed, zlib.crc32(spec.name.encode()) & 0x7FFFFFFF])
    n_acc = max(1000, int(spec.n_accesses * scale))
    n_obj = max(100, int(spec.n_objects * scale))
    n_popular = max(10, int(n_obj * (1.0 - spec.one_hit_frac)))
    # Shuffle object ids so key order is uncorrelated with popularity rank.
    ids = rng.permutation(n_obj).astype(np.int64)
    keys = ids[_index_stream(spec, rng, n_acc, n_obj, n_popular)]
    sizes_per_obj = _sample_sizes(spec, n_obj, rng)
    sizes = sizes_per_obj[keys]
    # Re-map keys into a compact but non-contiguous id space (realistic ids).
    keys = keys * _ID_MULT % _ID_SPACE
    return AccessTrace(spec.name, keys.astype(np.int64), sizes.astype(np.int64))


def paper_traces(
    names: tuple[str, ...] = ("msr2", "systor2", "tencent1", "cdn1"),
    *,
    seed: int = 0,
    scale: float = 1.0,
) -> dict[str, AccessTrace]:
    """The four representative traces the paper plots (Figs. 9/10)."""
    return {n: make_trace(n, seed=seed, scale=scale) for n in names}
