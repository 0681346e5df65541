"""Admission control plane + batched data plane (paper Algorithms 2-4).

This module is the control-plane/data-plane split of size-aware W-TinyLFU
admission. Each discipline (IV / QV / AV) is an :class:`AdmissionPolicy`
whose

* **control plane** decides *which* victims matter (a walk over the Main
  cache's eviction order, the paper's Algorithms 2-4 verbatim), and whose
* **data plane** scores candidate + victims with **one batched sketch
  call**: the victim prefix is streamed through a :class:`_LazyPrefix`
  view over the eviction policy's ``_peek_iter`` walk (the lazy twin of
  the :meth:`EvictionPolicy.peek_victims` array API — arbitrary-precision
  keys survive and no ndarray round-trip lands on the hot path) and
  ``sketch.estimate_batch`` is the single scoring entry point (with the
  CMS backend, the pending-increment flush and the scoring fuse into one
  kernel launch).

Two planes are implemented for every discipline — ``admit`` (batched) and
``admit_scalar`` (the reference per-victim walk; also what
``SizeAwareWTinyLFU(data_plane="auto")`` resolves to on the host sketch,
where direct calls beat batching abstraction at typical victim counts) —
and are **byte-identical**: same admissions, same evictions in the same
order, same ``CacheStats`` counters, asserted trace-wide in the tests
against each other and against the reference package. The device planes
of the reference (``bind_device_plane``, ``bind_device_batch_plane``) are
not ported yet (ROADMAP queue 1, items 3 and 6). The equivalence
arguments, per discipline:

* **IV** compares the candidate against the *first* victim only, so the
  batched plane scores ``[candidate, first]`` in one call. Estimates are
  read-only and all increments are flushed before the first estimate of a
  decision, so splitting vs. fusing the two lookups cannot differ.
* **QV** walks victims in order, evicting every victim the candidate beats
  and stopping at the first it loses to. Because the walk stops at the
  first loss, it never examines beyond the minimal prefix whose sizes cover
  ``needed`` — exactly what ``peek_victims`` returns — so the batched plane
  pre-scores that prefix and replays the walk over the cached frequencies.
* **AV** gathers victims until their sizes cover ``needed`` (candidate
  loses to the aggregate frequency). Without early pruning the gathered set
  depends only on sizes; with pruning the stop point depends only on the
  running frequency sum, which the replay recomputes from the same batched
  scores.

The replay shortcut requires the victim order to be *peek-stable*
(deterministic replay; see :attr:`EvictionPolicy.peek_stable`). Every
built-in eviction policy qualifies: LRU/SLRU walk deterministic snapshots,
and the sampling policies draw victim samples from a counter-based RNG
stream (:mod:`.crng`) that is a pure function of the decision
index — gathering more victims than the scalar walk would have examined
replays draws instead of consuming them, so over-pulling cannot leak into
later decisions. The scalar-walk fallbacks below (QV and pruned AV on
``peek_stable=False`` mains) remain only for third-party stateful-RNG
policies.

Decision-counter contract: the caller advances ``main.begin_decision()``
exactly once per admission decision, before invoking either plane —
:meth:`SizeAwareWTinyLFU._evict_or_admit` is that single call site. The
bump lives *outside* ``admit``/``admit_scalar`` so the batched plane's
fallback delegation to the scalar plane cannot double-advance the stream.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

__all__ = [
    "AdmissionPolicy",
    "IVAdmission",
    "QVAdmission",
    "AVAdmission",
    "ADMISSIONS",
    "make_admission",
]

if TYPE_CHECKING:  # pragma: no cover
    from .cache_api import CacheStats
    from .eviction import EvictionPolicy

ADMISSIONS = ("iv", "qv", "av")


class _LazyPrefix:
    """``[candidate] + victim-covering-prefix`` key view for ``estimate_batch``.

    The single object handed to the data plane's one scoring call per
    decision. Victims are pulled from the eviction policy's live
    ``_peek_iter`` walk on demand, stopping once their cumulative size
    covers ``needed``:

    * a host (lazy) ``estimate_batch`` indexes it per consumed entry, so
      the gather does exactly the work the replay consumes — early pruning
      keeps its Fig. 7 savings;
    * a device ``estimate_batch`` iterates it once, materializing the full
      covering prefix for a single kernel call.

    Callers must finish pulling before mutating the eviction policy (the
    replays below evict/promote only after their walk ends).
    """

    __slots__ = ("victims", "_cand", "_it", "_sizes", "_needed", "_covered", "_done")

    def __init__(self, cand: int, main: "EvictionPolicy", needed: int):
        self.victims: list[int] = []
        self._cand = cand
        self._it = main._peek_iter(needed)
        self._sizes = main.sizes
        self._needed = needed
        self._covered = 0
        self._done = needed <= 0

    def victim_at(self, j: int) -> "int | None":
        """The j-th victim of the covering prefix, or None past its end."""
        victims = self.victims
        while len(victims) <= j:
            if self._done:
                return None
            v = next(self._it, None)
            if v is None:
                self._done = True
                return None
            victims.append(v)
            self._covered += self._sizes[v]
            if self._covered >= self._needed:
                self._done = True
        return victims[j]

    def __getitem__(self, i: int) -> int:
        if i == 0:
            return self._cand
        v = self.victim_at(i - 1)
        if v is None:
            raise IndexError(i)
        return v

    def __iter__(self):
        yield self._cand
        j = 0
        while True:
            v = self.victim_at(j)
            if v is None:
                return
            yield v
            j += 1


class AdmissionPolicy:
    """Candidate-vs-victims arbitration over a Main eviction policy.

    ``admit``/``admit_scalar`` are called only when the Main cache lacks
    ``needed > 0`` free bytes for a candidate that fits it (``size <=
    main_cap``), which guarantees the victim walk can always cover
    ``needed``. Both mutate ``main`` (evict/insert/promote) and ``stats``
    (victims_examined / evictions / admissions / rejections) and return
    True iff the candidate was admitted. Callers advance
    ``main.begin_decision()`` once per decision first (see the module
    docstring); neither plane advances it itself.
    """

    name: str

    def __init__(self, sketch):
        self.sketch = sketch
        # The data plane's single scoring entry point.
        self.estimate_batch = sketch.estimate_batch

    def admit(self, key: int, size: int, needed: int,
              main: "EvictionPolicy", stats: "CacheStats") -> bool:
        """Batched data plane: one ``estimate_batch`` call per decision."""
        raise NotImplementedError

    def admit_scalar(self, key: int, size: int, needed: int,
                     main: "EvictionPolicy", stats: "CacheStats") -> bool:
        """Scalar reference control loop (per-victim ``estimate`` calls)."""
        raise NotImplementedError

    # -- device data planes (not ported yet) --------------------------------
    def bind_device_plane(self, main: "EvictionPolicy"):
        """The reference's per-decision device plane (``data_plane="device"``)."""
        raise NotImplementedError(
            "the per-decision device plane is not ported yet: ROADMAP queue 1, item 3")

    def bind_device_batch_plane(self, main: "EvictionPolicy", *, chunk: int = 64,
                                victim_cap: int = 16):
        """The reference's decision-batched device plane (``data_plane="device_batched"``)."""
        raise NotImplementedError(
            "the decision-batched device plane is not ported yet: ROADMAP queue 1, item 6")


class IVAdmission(AdmissionPolicy):
    """Implicit Victims (Alg. 2 — Caffeine): compare against the *first*
    victim only; on a win, blindly evict as many victims as needed."""

    name = "iv"

    def admit(self, key, size, needed, main, stats):
        if main.peek_stable:
            prefix = _LazyPrefix(key, main, needed)
            first = prefix.victim_at(0)
            stats.victims_examined += 1
            # IV only ever compares candidate vs the FIRST victim, so the
            # one batched call scores exactly those two; the rest of the
            # covering prefix is pulled (never scored) only on a win.
            freqs = self.estimate_batch([key, first])
            if int(freqs[0]) >= int(freqs[1]):
                j = 1
                while prefix.victim_at(j) is not None:  # pull, then evict
                    j += 1
                for v in prefix.victims:
                    main.evict(v)
                    stats.evictions += 1
                main.insert(key, size)
                stats.admissions += 1
                return True
            main.promote(first)
            stats.rejections += 1
            return False
        # Mirror the scalar walk's RNG pattern: one draw for the first
        # victim now, a fresh evicting walk only on a win.
        first = main.victim(needed)
        stats.victims_examined += 1
        freqs = self.estimate_batch([key, first])
        if int(freqs[0]) >= int(freqs[1]):
            freed = 0
            it = main.iter_victims(needed)
            while freed < needed:
                v = next(it)
                freed += main.sizes[v]
                main.evict(v)
                stats.evictions += 1
            main.insert(key, size)
            stats.admissions += 1
            return True
        main.promote(first)
        stats.rejections += 1
        return False

    def admit_scalar(self, key, size, needed, main, stats):
        estimate = self.sketch.estimate
        first = main.victim(needed)
        stats.victims_examined += 1
        if estimate(key) >= estimate(first):
            freed = 0
            it = main.iter_victims(needed)
            while freed < needed:
                v = next(it)
                freed += main.sizes[v]
                main.evict(v)
                stats.evictions += 1
            main.insert(key, size)
            stats.admissions += 1
            return True
        main.promote(first)
        stats.rejections += 1
        return False


class QVAdmission(AdmissionPolicy):
    """Queue of Victims (Alg. 3 — Ristretto): walk victims, evicting every
    victim the candidate beats (evictions stick even if the candidate is
    ultimately rejected); admit iff enough space was freed."""

    name = "qv"

    def admit(self, key, size, needed, main, stats):
        if not main.peek_stable:
            return self.admit_scalar(key, size, needed, main, stats)
        prefix = _LazyPrefix(key, main, needed)
        freqs = self.estimate_batch(prefix)
        cand_f = int(freqs[0])
        sizes = main.sizes
        # Replay Alg. 3 over the scored prefix: the scalar walk stops at
        # the first loss, so it never outruns the covering prefix.
        freed = 0
        n_evict = 0
        loser = None
        j = 0
        while freed < needed:
            v = prefix.victim_at(j)
            if v is None:
                break
            stats.victims_examined += 1
            if cand_f >= int(freqs[1 + j]):
                freed += sizes[v]
                n_evict += 1
            else:
                loser = v
                break
            j += 1
        for v in prefix.victims[:n_evict]:
            main.evict(v)
            stats.evictions += 1
        if loser is not None:
            main.promote(loser)
        if freed >= needed:
            main.insert(key, size)
            stats.admissions += 1
            return True
        stats.rejections += 1
        return False

    def admit_scalar(self, key, size, needed, main, stats):
        estimate = self.sketch.estimate
        cand_f = estimate(key)
        freed = 0
        it = main.iter_victims(needed)
        while freed < needed:
            v = next(it, None)
            if v is None:
                break
            stats.victims_examined += 1
            if cand_f >= estimate(v):
                freed += main.sizes[v]
                main.evict(v)  # sticks even if candidate is rejected
                stats.evictions += 1
            else:
                main.promote(v)
                break
        if freed >= needed:
            main.insert(key, size)
            stats.admissions += 1
            return True
        stats.rejections += 1
        return False


class AVAdmission(AdmissionPolicy):
    """Aggregated Victims (Alg. 4 — this paper): gather victims until their
    total size suffices; admit iff ``freq(candidate) >= sum freq(victims)``;
    with *early pruning*, stop gathering as soon as the victim frequency sum
    already exceeds the candidate's (Fig. 7)."""

    name = "av"

    def __init__(self, sketch, *, early_pruning: bool = True):
        super().__init__(sketch)
        self.early_pruning = early_pruning

    def admit(self, key, size, needed, main, stats):
        if self.early_pruning and not main.peek_stable:
            # The prune point shortens the gather, so pre-gathering the full
            # prefix would draw extra samples from a live-RNG victim stream.
            # (Without pruning the gather is size-driven and consumes the
            # whole covering prefix, so the lazy walk below draws exactly
            # the scalar walk's RNG stream and stays batched.)
            return self.admit_scalar(key, size, needed, main, stats)
        prefix = _LazyPrefix(key, main, needed)
        freqs = self.estimate_batch(prefix)
        cand_f = int(freqs[0])
        sizes = main.sizes
        # Replay Alg. 4 over the scored prefix.
        vbytes = 0
        vfreq = 0
        j = 0
        pruned = False
        while vbytes < needed:
            v = prefix.victim_at(j)
            if v is None:  # whole cache cannot cover `needed`
                pruned = True
                break
            vbytes += sizes[v]
            vfreq += int(freqs[1 + j])
            j += 1
            stats.victims_examined += 1
            if self.early_pruning and cand_f < vfreq:  # lines 6-7
                pruned = True
                break
        gathered = prefix.victims[:j]
        if not pruned and cand_f >= vfreq:
            for v in gathered:  # lines 9-11
                main.evict(v)
                stats.evictions += 1
            main.insert(key, size)
            stats.admissions += 1
            return True
        for v in gathered:  # lines 13-14
            main.promote(v)
        stats.rejections += 1
        return False

    def admit_scalar(self, key, size, needed, main, stats):
        estimate = self.sketch.estimate
        cand_f = estimate(key)
        victims: list[int] = []
        vbytes = 0
        vfreq = 0
        it = main.iter_victims(needed)
        pruned = False
        while vbytes < needed:
            v = next(it, None)
            if v is None:  # cannot free enough (shouldn't happen: size<=main_cap)
                pruned = True
                break
            victims.append(v)
            vbytes += main.sizes[v]
            vfreq += estimate(v)
            stats.victims_examined += 1
            if self.early_pruning and cand_f < vfreq:  # lines 6-7
                pruned = True
                break
        if not pruned and cand_f >= vfreq:
            for v in victims:  # lines 9-11
                main.evict(v)
                stats.evictions += 1
            main.insert(key, size)
            stats.admissions += 1
            return True
        for v in victims:  # lines 13-14
            main.promote(v)
        stats.rejections += 1
        return False


_ADMISSION_CLASSES: dict[str, type[AdmissionPolicy]] = {
    "iv": IVAdmission,
    "qv": QVAdmission,
    "av": AVAdmission,
}


def make_admission(name: str, sketch, **kw) -> AdmissionPolicy:
    """Factory over the paper's three admission disciplines.

    ``kw`` is discipline-specific (AV takes ``early_pruning=``).
    """
    cls = _ADMISSION_CLASSES.get(name.lower())
    if cls is None:
        raise ValueError(f"admission must be one of {ADMISSIONS}")
    return cls(sketch, **kw)
