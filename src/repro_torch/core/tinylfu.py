"""Size-aware W-TinyLFU (the paper's contribution, Section 4, Algorithms 1-4).

Architecture (Fig. 1/3): a Window LRU cache (default 1% of total bytes) in
front of a Main cache with a pluggable eviction policy; the TinyLFU frequency
sketch arbitrates admission from Window into Main. Extending to variable-sized
objects (Alg. 1):

* an object larger than the whole cache is rejected outright;
* an object larger than the Window bypasses it and is offered to Main directly;
* inserting into the Window can push out *multiple* Window victims, each of
  which becomes a Main-cache candidate.

This class is a thin **composition** of the three planes:

* the Window LRU + Alg. 1 miss cascade (here);
* a pluggable Main :class:`~.eviction.EvictionPolicy` exposing both
  the scalar ``iter_victims`` walk and the array ``peek_victims`` view;
* an :class:`~.admission.AdmissionPolicy` (IV / QV / AV) whose
  batched data plane scores candidate + victim set with **one**
  ``sketch.estimate_batch`` call per admission decision (with
  ``sketch_backend="cms"``, the pending-increment flush and that scoring
  fuse into a single Hopper kernel launch).

``access_batch`` is the primary drive path (the default under
:class:`~.engine.SimulationEngine`); ``access`` remains for scalar
driving and per-access instrumentation. ``data_plane="scalar"`` pins the
admission policies to their reference per-victim walks — byte-identical
decisions to the batched plane, asserted trace-wide in tests.

The same spec string builds the same policy here and in the reference
package (``repro/core/tinylfu.py``), through each package's own registry;
this one adds ``device``. The reference's device planes
(``data_plane="device" | "device_batched" | "device_full"``) are not
ported yet and raise.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .admission import ADMISSIONS, AdmissionPolicy, make_admission
from .cache_api import CacheStats
from .cms_sketch import CMSSketch, resolve_device
from .eviction import EvictionPolicy, make_eviction
from .registry import register_policy
from .sketch import FrequencySketch

__all__ = ["SizeAwareWTinyLFU", "ADMISSIONS", "EVICTIONS", "DATA_PLANES"]

EVICTIONS = (
    "slru",
    "lru",
    "sampled_frequency",
    "sampled_size",
    "sampled_frequency_size",
    "sampled_needed_size",
    "random",
)

SKETCH_BACKENDS = ("auto", "host", "cms")
DATA_PLANES = ("auto", "batched", "scalar")
#: The reference's device planes, queued in ROADMAP (queue 1, items 3-6).
_UNPORTED_PLANES = ("device", "device_batched", "device_full")


def _wtlfu_alias(name: str) -> dict | None:
    """Map ``wtlfu-<admission>[-<eviction>]`` spec names onto constructor
    params (the registry's family resolver)."""
    if not name.startswith("wtlfu-"):
        return None
    parts = name.split("-", 2)
    if parts[1] not in ADMISSIONS:
        return None
    implied = {"admission": parts[1]}
    if len(parts) > 2:
        implied["eviction"] = parts[2]
    return implied


def _wtlfu_variants() -> tuple[str, ...]:
    """Full admission x eviction product for benchmark sweeps."""
    out = [f"wtlfu-{a}" for a in ADMISSIONS]
    out.extend(f"wtlfu-{a}-{e}" for a in ADMISSIONS for e in EVICTIONS)
    return tuple(out)


@register_policy(
    "wtlfu",
    alias_fn=_wtlfu_alias,
    variants=tuple(f"wtlfu-{a}" for a in ADMISSIONS),
    expand_fn=_wtlfu_variants,
)
class SizeAwareWTinyLFU:
    """W-TinyLFU extended to variable object sizes.

    Parameters
    ----------
    capacity: total cache bytes.
    admission: ``"iv" | "qv" | "av"``.
    eviction: Main-cache eviction policy name (see :data:`EVICTIONS`).
    window_frac: Window share of ``capacity`` (paper uses 1%).
    expected_entries: sketch sizing hint (≈ capacity / mean object size).
    early_pruning: AV's early-pruning optimization (Alg. 4 lines 6-7).
    seed: victim-sampling RNG seed for the sampled/random evictions
        (counter-based, see :mod:`.crng`); spec-string
        ``?seed=`` (decimal or ``0x...`` hex) plumbs it through the
        registry and round-trips via ``PolicySpec.parse``/``to_string``.
    sketch_backend: ``"host"`` (pure-Python sketch) or ``"cms"`` (batched
        count-min-sketch kernels; increments are buffered and flushed
        lazily before estimates, which is exactly equivalent to scalar
        driving — see :mod:`.cms_sketch`). The default ``"auto"`` resolves
        to ``"host"``, as in the reference.
    data_plane: ``"batched"`` scores each admission decision with one
        ``estimate_batch`` call over the lazily-gathered victim prefix;
        ``"scalar"`` pins the reference per-victim walk. The default
        ``"auto"`` picks per sketch backend (``sketch.batched_native``):
        batched for the CMS kernels — one fused launch per decision beats
        per-victim kernel calls — and the scalar walk for the host sketch.
        Decisions are byte-identical on every plane (asserted trace-wide in
        tests).
    device: where the CMS table lives and its kernels run: ``"cuda"``
        unless the caller asks for ``"cpu"`` (spec ``?device=cpu``). A CUDA
        device on a machine without CUDA raises, whatever the backend.
    """

    def __init__(
        self,
        capacity: int,
        *,
        admission: str = "av",
        eviction: str = "slru",
        window_frac: float = 0.01,
        expected_entries: int | None = None,
        early_pruning: bool = True,
        adaptive_window: bool = False,
        seed: int = 0x5EED,
        sketch_backend: str = "auto",
        sketch_kwargs: dict | None = None,
        data_plane: str = "auto",
        device: str = "cuda",
    ):
        if admission not in ADMISSIONS:
            raise ValueError(f"admission must be one of {ADMISSIONS}")
        if sketch_backend not in SKETCH_BACKENDS:
            raise ValueError(f"sketch_backend must be one of {SKETCH_BACKENDS}")
        if data_plane in _UNPORTED_PLANES:
            raise ValueError(
                f'data_plane="{data_plane}" is not yet ported, see ROADMAP '
                "(queue 1, items 3-6)")
        if data_plane not in DATA_PLANES:
            raise ValueError(f"data_plane must be one of {DATA_PLANES}")
        self.device = resolve_device(device)
        if sketch_backend == "auto":
            sketch_backend = "host"
        self.capacity = int(capacity)
        self.window_cap = max(1, int(capacity * window_frac))
        self.main_cap = self.capacity - self.window_cap
        self.admission = admission
        self.early_pruning = early_pruning
        # Adaptive region sizing (the paper's ref [19] / Caffeine's climber):
        # hill-climb the Window share on the hit-ratio gradient.
        self.adaptive_window = adaptive_window
        self._adapt_step = max(1, int(capacity * 0.0625))
        self._adapt_every = max(1000, 2 * (expected_entries or max(64, capacity // 4096)))
        self._adapt_prev_hits = 0
        self._adapt_prev_ratio = -1.0
        self._adapt_accesses = 0
        self._adapt_dir = 1
        if expected_entries is None:
            expected_entries = max(64, self.capacity // 4096)
        if sketch_backend == "cms":
            self.sketch = CMSSketch(expected_entries, device=self.device,
                                    **(sketch_kwargs or {}))
        else:
            self.sketch = FrequencySketch(expected_entries, **(sketch_kwargs or {}))
        self.sketch_backend = sketch_backend

        # Window: plain LRU over (key -> size).
        self.window: OrderedDict[int, int] = OrderedDict()
        self.window_bytes = 0
        # Main: pluggable eviction policy (owns its size map). Batched-native
        # sketches also hand the sampled policies their one-call pool scorer
        # (the vectorized sample-gather feeds a single estimate_batch /
        # fused update+estimate kernel launch per walk block).
        self.main: EvictionPolicy = make_eviction(
            eviction,
            capacity=self.main_cap,
            freq_fn=self.sketch.estimate,
            seed=seed,
            freq_batch_fn=(
                self.sketch.estimate_batch
                if getattr(self.sketch, "batched_native", False)
                else None
            ),
        )
        # Admission: IV/QV/AV arbitration over (sketch, main).
        kw = {"early_pruning": early_pruning} if admission == "av" else {}
        self.admission_policy: AdmissionPolicy = make_admission(admission, self.sketch, **kw)
        if data_plane == "auto":
            data_plane = "batched" if getattr(self.sketch, "batched_native", False) else "scalar"
        self.data_plane = data_plane  # resolved, never "auto"
        if data_plane == "batched":
            self._admit = self.admission_policy.admit
        else:
            self._admit = self.admission_policy.admit_scalar
        self.stats = CacheStats()

    # -- introspection -----------------------------------------------------
    def __contains__(self, key: int) -> bool:
        return key in self.window or key in self.main

    def used_bytes(self) -> int:
        return self.window_bytes + self.main.used

    # -- serving-layer reclaim -----------------------------------------------
    def discard(self, key: int) -> bool:
        """Forcibly remove ``key`` from the cache (serving-layer reclaim:
        the block pool needs the bytes back regardless of policy opinion).
        Returns True if the key was resident. Counts as an eviction."""
        if key in self.window:
            self.window_bytes -= self.window.pop(key)
            self.stats.evictions += 1
            return True
        if key in self.main:
            self.main.evict(key)
            self.stats.evictions += 1
            return True
        return False

    def reclaim_victims(self, needed: int = 0):
        """Yield resident keys in the order this policy would give them up
        (serving-layer shortage reclaim asks the eviction policy instead of
        discarding in insertion order). Main victims come first — the
        eviction discipline's own candidate order, ``needed`` bytes worth
        of context for the size-aware rules — then the window LRU→MRU.
        Never evicts; pair each taken key with :meth:`discard`."""
        self.main.begin_decision()  # sampling mains: fresh replayable draws
        seen = set()
        for key in self.main.iter_victims(needed):
            if key not in seen:
                seen.add(key)
                yield key
        for key in list(self.window):
            if key not in seen:
                seen.add(key)
                yield key

    # -- hot path ------------------------------------------------------------
    def access(self, key: int, size: int) -> bool:
        st = self.stats
        st.accesses += 1
        st.bytes_requested += size
        self.sketch.increment(key)  # every occurrence, cached or not (§3)
        if key in self.window:
            self.window.move_to_end(key)
            st.hits += 1
            st.bytes_hit += size
            return True
        if key in self.main:
            self.main.on_access(key)
            st.hits += 1
            st.bytes_hit += size
            return True
        self._on_miss(key, size)
        if self.adaptive_window:
            self._maybe_adapt()
        return False

    def access_batch(self, keys, sizes) -> np.ndarray:
        """Primary drive path: a parallel key/size array pair per chunk.

        Observationally identical to calling :meth:`access` per element
        (asserted by tests): the loop body is the same state machine with
        hot attributes hoisted out, and with the ``cms`` sketch backend the
        per-access increments are buffered and flushed through one batched
        kernel launch fused with the next admission decision's victim
        scoring.
        """
        n = len(keys)
        hits = np.empty(n, dtype=bool)
        keys = keys.tolist() if hasattr(keys, "tolist") else list(keys)
        sizes = sizes.tolist() if hasattr(sizes, "tolist") else list(sizes)
        st = self.stats
        window = self.window
        main = self.main
        increment = self.sketch.increment
        adaptive = self.adaptive_window
        for i in range(n):
            key = keys[i]
            size = sizes[i]
            st.accesses += 1
            st.bytes_requested += size
            increment(key)
            if key in window:
                window.move_to_end(key)
                st.hits += 1
                st.bytes_hit += size
                hits[i] = True
            elif key in main:
                main.on_access(key)
                st.hits += 1
                st.bytes_hit += size
                hits[i] = True
            else:
                hits[i] = False
                self._on_miss(key, size)
                if adaptive:
                    self._maybe_adapt()
        return hits

    # -- adaptive window (paper ref [19]; Caffeine's climber) ---------------
    def _maybe_adapt(self) -> None:
        self._adapt_accesses += 1
        if self._adapt_accesses < self._adapt_every:
            return
        ratio = (self.stats.hits - self._adapt_prev_hits) / self._adapt_accesses
        if self._adapt_prev_ratio >= 0 and ratio < self._adapt_prev_ratio:
            self._adapt_dir = -self._adapt_dir  # got worse: reverse
        new_window = self.window_cap + self._adapt_dir * self._adapt_step
        # Floor at 1 byte, not capacity//100 alone: below 100 bytes that
        # floor is 0, and a couple of downward steps would silently disable
        # the Window (violating the constructor's max(1, ...) invariant).
        new_window = max(1, self.capacity // 100, min(self.capacity // 2, new_window))
        self.window_cap = new_window
        self.main_cap = self.capacity - new_window
        # drain whichever region now overflows
        while self.window_bytes > self.window_cap and self.window:
            vk, vs = self.window.popitem(last=False)
            self.window_bytes -= vs
            self._evict_or_admit(vk, vs)
        self.main.begin_decision()  # drain walk gets its own RNG stream
        # Pass the actual overflow so size-targeting rules (needed_size)
        # pick victims that clear it in few evictions, not smallest-first.
        it = self.main.iter_victims(max(0, self.main.used - self.main_cap))
        while self.main.used > self.main_cap and len(self.main):
            v = next(it, None)
            if v is None:
                break
            self.main.evict(v)
            self.stats.evictions += 1
        self._adapt_prev_ratio = ratio
        self._adapt_prev_hits = self.stats.hits
        self._adapt_accesses = 0

    # -- Algorithm 1: miss handling ---------------------------------------
    def _on_miss(self, key: int, size: int) -> None:
        if size > self.capacity:  # line 2: can never fit
            self.stats.rejections += 1
            return
        candidates: list[tuple[int, int]] = []
        if size > self.window_cap:
            # line 6: too large for the Window -> direct Main candidate
            candidates.append((key, size))
        else:
            self.window[key] = size
            self.window_bytes += size
            while self.window_bytes > self.window_cap:  # lines 9-11
                vk, vs = self.window.popitem(last=False)
                self.window_bytes -= vs
                candidates.append((vk, vs))
        for ck, cs in candidates:  # line 13
            self._evict_or_admit(ck, cs)

    # -- admission dispatch -------------------------------------------------
    def _evict_or_admit(self, key: int, size: int) -> None:
        if size > self.main_cap:
            self.stats.rejections += 1
            return
        free = self.main_cap - self.main.used
        if free >= size:
            # No victims needed: admit unconditionally (§5.2: "AV always
            # admits an item if there is enough free space without evictions").
            self.main.insert(key, size)
            self.stats.admissions += 1
            return
        # Single per-decision RNG-stream advance, shared by both data planes
        # (see .admission): victim walks replay, never consume.
        self.main.begin_decision()
        self._admit(key, size, size - free, self.main, self.stats)
