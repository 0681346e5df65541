"""Spec-driven, chunked trace simulation: the paper's evaluation instrument.

Replaces the old free-function ``simulate`` loop with a
:class:`SimulationEngine` that

* streams the trace in **chunks** — an :class:`AccessTrace` is never
  materialized into Python lists up front, so driving a multi-million-access
  trace stays O(chunk) memory;
* supports **warmup** (accesses that exercise the policy but are excluded
  from the reported stats);
* records periodic :class:`StatsSnapshot` rows (hit-ratio-over-time curves
  for the robustness plots);
* drives a policy's ``access_batch(keys, sizes)`` fast path **by default**
  whenever one exists (e.g. :class:`~repro_torch.core.tinylfu.SizeAwareWTinyLFU`,
  whose batched admission data plane scores each decision with one fused
  CMS kernel launch) — the scalar loop remains for per-access
  instrumentation and as the reference semantics;
* runs pluggable :class:`Instrument` hooks — the old ``check_invariants``
  flag is now the :class:`CapacityInvariant` instrument, and
  :class:`HitMaskRecorder` captures the per-access hit/miss decision stream
  on either drive path (the equivalence tests' trace-wide assertion).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Iterable, Iterator, Sequence

import numpy as np

from .cache_api import AccessTrace, CachePolicy, CacheStats

__all__ = [
    "Instrument",
    "CapacityInvariant",
    "HitMaskRecorder",
    "StatsSnapshot",
    "SimulationResult",
    "SimulationEngine",
]


class Instrument:
    """Observer hooks called by the engine while it drives a policy.

    Subclasses override any subset. Overriding :meth:`on_access` forces the
    engine onto the scalar path for that run (per-access visibility is
    incompatible with the batched fast path).
    """

    def on_run_start(self, policy: CachePolicy) -> None:
        pass

    def on_access(self, policy: CachePolicy, key: int, size: int, hit: bool) -> None:
        pass

    def on_chunk(self, policy: CachePolicy, keys, sizes, hits) -> None:
        """After each driven chunk; ``hits`` is a bool array parallel to keys."""

    def on_snapshot(self, policy: CachePolicy, snapshot: "StatsSnapshot") -> None:
        pass

    def on_run_end(self, policy: CachePolicy, stats: CacheStats) -> None:
        pass

    @property
    def per_access(self) -> bool:
        return type(self).on_access is not Instrument.on_access


class CapacityInvariant(Instrument):
    """Assert after every access that the policy never exceeds capacity
    (the old ``simulate(check_invariants=True)``; used by property tests)."""

    def on_access(self, policy: CachePolicy, key: int, size: int, hit: bool) -> None:
        used = policy.used_bytes()
        if used > policy.capacity:
            raise AssertionError(
                f"capacity invariant violated: used={used} > cap={policy.capacity} "
                f"after access ({key}, {size})"
            )


class HitMaskRecorder(Instrument):
    """Record the full hit/miss decision stream of a run.

    Hooks :meth:`on_chunk` (not :meth:`on_access`), so it observes both the
    scalar and the batched drive paths without forcing either — which is
    what makes it usable as the trace-wide "byte-identical decisions"
    assertion between the two admission data planes.
    """

    def __init__(self):
        self._chunks: list[np.ndarray] = []

    def on_run_start(self, policy: CachePolicy) -> None:
        self._chunks = []

    def on_chunk(self, policy: CachePolicy, keys, sizes, hits) -> None:
        self._chunks.append(np.asarray(hits, dtype=bool).copy())

    @property
    def hits(self) -> np.ndarray:
        """Bool array parallel to the driven trace (warmup included)."""
        if not self._chunks:
            return np.zeros(0, dtype=bool)
        return np.concatenate(self._chunks)


@dataclasses.dataclass(frozen=True)
class StatsSnapshot:
    """Cumulative stats sampled every ``snapshot_every`` accesses."""

    accesses: int
    hits: int
    bytes_requested: int
    bytes_hit: int
    used_bytes: int
    evictions: int
    interval_hit_ratio: float  # hit ratio since the previous snapshot

    @property
    def hit_ratio(self) -> float:
        return self.hits / self.accesses if self.accesses else 0.0

    @property
    def byte_hit_ratio(self) -> float:
        return self.bytes_hit / self.bytes_requested if self.bytes_requested else 0.0


@dataclasses.dataclass
class SimulationResult:
    """Outcome of one :meth:`SimulationEngine.run`."""

    stats: CacheStats  # the policy's post-warmup stats object
    snapshots: list[StatsSnapshot]
    warmup_stats: CacheStats | None = None
    wall_seconds: float = 0.0
    used_batch: bool = False
    #: The policy's resolved admission data plane ("scalar" / "batched"),
    #: or None for policies without one —
    #: benchmark rows key their per-plane throughput comparisons on this.
    data_plane: str | None = None


def _iter_chunks(
    trace: "AccessTrace | Iterable[tuple[int, int]]",
    chunk_size: int,
    limit: int | None,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Stream ``(keys, sizes)`` array chunks without materializing the trace."""
    if isinstance(trace, AccessTrace):
        if limit is not None and limit < len(trace):
            trace = trace.slice(limit)  # numpy views, no copy
        yield from trace.iter_chunks(chunk_size)
        return
    pairs: Iterator[tuple[int, int]] = iter(trace)
    if limit is not None:
        pairs = itertools.islice(pairs, limit)
    while True:
        block = list(itertools.islice(pairs, chunk_size))
        if not block:
            return
        arr = np.asarray(block, dtype=np.int64).reshape(len(block), 2)
        yield arr[:, 0], arr[:, 1]


class SimulationEngine:
    """Drives cache policies over access traces in chunked batches.

    Parameters
    ----------
    chunk_size: accesses per driven chunk (memory high-watermark).
    warmup: leading accesses excluded from reported stats (the policy still
        sees them; its stats object is swapped fresh afterwards).
    snapshot_every: record a :class:`StatsSnapshot` every N post-warmup
        accesses (chunks are split so snapshots land exactly on N).
    instruments: :class:`Instrument` observers; any per-access instrument
        (e.g. :class:`CapacityInvariant`) forces the scalar path.
    use_batch: ``"auto"`` uses ``policy.access_batch`` when present,
        ``True`` requires it, ``False`` forces the scalar loop.
    """

    def __init__(
        self,
        *,
        chunk_size: int = 8192,
        warmup: int = 0,
        snapshot_every: int | None = None,
        instruments: Sequence[Instrument] = (),
        use_batch: "bool | str" = "auto",
    ):
        if chunk_size <= 0:
            raise ValueError("chunk_size must be positive")
        if snapshot_every is not None and snapshot_every <= 0:
            raise ValueError("snapshot_every must be positive")
        if use_batch not in (True, False, "auto"):
            raise ValueError("use_batch must be True, False or 'auto'")
        self.chunk_size = chunk_size
        self.warmup = warmup
        self.snapshot_every = snapshot_every
        self.instruments = tuple(instruments)
        self.use_batch = use_batch

    # -- helpers -----------------------------------------------------------
    def _resolve_batch(self, policy: CachePolicy) -> bool:
        batch_fn = getattr(policy, "access_batch", None)
        scalar_only = any(inst.per_access for inst in self.instruments)
        if self.use_batch is True:
            if batch_fn is None:
                raise ValueError(
                    f"{type(policy).__name__} has no access_batch fast path"
                )
            if scalar_only:
                raise ValueError(
                    "per-access instruments are incompatible with use_batch=True"
                )
            return True
        return self.use_batch == "auto" and batch_fn is not None and not scalar_only

    def _drive_chunk(self, policy: CachePolicy, keys, sizes, batched: bool):
        if batched:
            hits = policy.access_batch(keys, sizes)
        else:
            hits = np.empty(len(keys), dtype=bool)
            access = policy.access
            insts = self.instruments
            for i, (key, size) in enumerate(zip(keys.tolist(), sizes.tolist())):
                hit = access(key, size)
                hits[i] = hit
                for inst in insts:
                    inst.on_access(policy, key, size, hit)
        for inst in self.instruments:
            inst.on_chunk(policy, keys, sizes, hits)
        return hits

    def _snapshot(self, policy: CachePolicy, prev: StatsSnapshot | None) -> StatsSnapshot:
        st = policy.stats
        p_acc = prev.accesses if prev else 0
        p_hits = prev.hits if prev else 0
        interval = st.accesses - p_acc
        snap = StatsSnapshot(
            accesses=st.accesses,
            hits=st.hits,
            bytes_requested=st.bytes_requested,
            bytes_hit=st.bytes_hit,
            used_bytes=policy.used_bytes(),
            evictions=st.evictions,
            interval_hit_ratio=(st.hits - p_hits) / interval if interval else 0.0,
        )
        for inst in self.instruments:
            inst.on_snapshot(policy, snap)
        return snap

    # -- main entry point --------------------------------------------------
    def run(
        self,
        policy: CachePolicy,
        trace: "AccessTrace | Iterable[tuple[int, int]]",
        *,
        limit: int | None = None,
    ) -> SimulationResult:
        """Drive ``policy`` over ``trace`` (``limit`` caps total accesses,
        warmup included). Returns the result; the policy's ``stats`` object
        accumulates post-warmup traffic and ``wall_seconds``."""
        batched = self._resolve_batch(policy)
        for inst in self.instruments:
            inst.on_run_start(policy)

        snapshots: list[StatsSnapshot] = []
        warmup_stats: CacheStats | None = None
        to_warm = self.warmup
        since_snap = 0
        t0 = t_measured = time.perf_counter()
        for keys, sizes in _iter_chunks(trace, self.chunk_size, limit):
            lo = 0
            n = len(keys)
            # Sub-chunk splitting invariant (the reference package's
            # TestEngine::test_snapshot_alignment_sweep covers every
            # (warmup, chunk_size, snapshot_every) shape): warmup ending
            # mid-chunk caps the sub-chunk at the warmup boundary, and only
            # post-warmup sub-chunks are capped at the next snapshot point
            # — so the first post-warmup snapshot lands exactly
            # `snapshot_every` accesses after warmup. Both caps split
            # *around* a driven sub-chunk, never inside one.
            # since_snap < snapshot_every holds at every iteration top
            # (driven <= snapshot_every - since_snap, reset on snapshot),
            # so the hi cap below can never go non-positive.
            while lo < n:
                hi = n
                if to_warm > 0:
                    hi = min(hi, lo + to_warm)
                if self.snapshot_every is not None and to_warm == 0:
                    hi = min(hi, lo + self.snapshot_every - since_snap)
                self._drive_chunk(policy, keys[lo:hi], sizes[lo:hi], batched)
                driven = hi - lo
                if to_warm > 0:
                    to_warm -= driven
                    if to_warm == 0:
                        # stats swap: policies re-read self.stats per access
                        warmup_stats = policy.stats
                        policy.stats = CacheStats()
                        t_measured = time.perf_counter()
                        warmup_stats.wall_seconds += t_measured - t0
                else:
                    since_snap += driven
                    if self.snapshot_every is not None and since_snap >= self.snapshot_every:
                        snapshots.append(self._snapshot(policy, snapshots[-1] if snapshots else None))
                        since_snap = 0
                lo = hi
        t_end = time.perf_counter()
        wall = t_end - t0
        if warmup_stats is None and to_warm > 0:
            # trace shorter than warmup: everything was warmup
            warmup_stats = policy.stats
            policy.stats = CacheStats()
            warmup_stats.wall_seconds += wall
            t_measured = t_end
        # warmup driving time is charged to warmup_stats, not the reported
        # stats — us/access overhead metrics must only see measured traffic
        policy.stats.wall_seconds += t_end - t_measured
        for inst in self.instruments:
            inst.on_run_end(policy, policy.stats)
        return SimulationResult(
            stats=policy.stats,
            snapshots=snapshots,
            warmup_stats=warmup_stats,
            wall_seconds=wall,
            used_batch=batched,
            data_plane=getattr(policy, "data_plane", None),
        )
