"""Main-cache eviction policies for size-aware W-TinyLFU (paper Section 5).

The paper evaluates six Main-cache eviction disciplines underneath the three
admission schemes: SLRU (Caffeine's choice), four sampled policies mimicking
Ristretto's SampledLFU (sample five, pick by: lowest frequency / largest size /
lowest frequency-per-byte / closest-to-needed-size), and Random.

The admission schemes (IV/QV/AV) need to *peek* at successive would-be victims
without evicting them (AV gathers a victim set first; QV walks one at a time),
so the interface exposes two victim views:

* :meth:`iter_victims` — the scalar control plane: a generator of distinct
  candidate victims in eviction order;
* :meth:`peek_victims` — the array data plane: the minimal victim prefix
  covering ``needed`` bytes as parallel ``(keys, sizes)`` arrays, ready for
  one batched sketch scoring call. Equivalent to gathering
  :meth:`iter_victims` until the sizes cover ``needed`` (asserted by
  property tests); LRU/SLRU override it to walk their order dicts directly,
  touching O(prefix) entries where ``iter_victims`` snapshots O(n).

Every built-in policy advertises ``peek_stable = True``: its victim order is
a pure function of the policy state plus (for the sampling policies) a
counter-based RNG stream (:mod:`.crng`), so peeking consumes no
state and evicting already-yielded victims cannot reorder unseen ones. The
sampling policies draw victim samples as ``draw(seed, decision, i)`` — the
**decision counter** advances only through :meth:`begin_decision` (called
once per admission decision by
:class:`~.tinylfu.SizeAwareWTinyLFU`), never by walking — which is
what lets the batched admission data plane pre-gather a victim prefix
without perturbing the stream the scalar walk replays.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Iterator, Sequence

import numpy as np

from . import crng

__all__ = [
    "EvictionPolicy",
    "LRUEviction",
    "SLRUEviction",
    "SampledEviction",
    "RandomEviction",
    "make_eviction",
]


class EvictionPolicy:
    """Bookkeeping for cached entries; selects victims. Sizes in bytes."""

    #: True when the victim order is a deterministic replay: peeking draws
    #: no RNG state and evicting already-yielded victims cannot change which
    #: victims follow. Enables the single-batch admission data plane.
    peek_stable: bool = False

    def __init__(self):
        self.sizes: dict[int, int] = {}
        self.used = 0

    def __contains__(self, key: int) -> bool:
        return key in self.sizes

    def __len__(self) -> int:
        return len(self.sizes)

    # -- mutations -------------------------------------------------------
    def insert(self, key: int, size: int) -> None:
        raise NotImplementedError

    def evict(self, key: int) -> None:
        raise NotImplementedError

    def on_access(self, key: int) -> None:
        """Hit: promote per the policy's recency rules."""
        raise NotImplementedError

    def promote(self, key: int) -> None:
        """Rejected-candidate bookkeeping: treat ``key`` as if accessed once
        (paper Alg. 4 line 14) so the next candidate sees different victims.
        Sampled/Random policies have no order to promote in (paper: "some
        eviction policies may not require this step")."""
        self.on_access(key)

    # -- victim selection --------------------------------------------------
    def begin_decision(self) -> None:
        """Advance the victim stream to a fresh decision.

        Called once per admission decision (both data planes, same call
        site), *before* any victim walk of that decision. Deterministic
        policies need no per-decision state, so the default is a no-op; the
        sampling policies advance their counter-based RNG stream here —
        walking/peeking itself never does.
        """

    def iter_victims(self, needed: int = 0) -> Iterator[int]:
        """Yield distinct victim candidates in eviction order, without evicting.

        ``needed`` is the space the caller is trying to free — only the
        Sampled-Needed-Size rule uses it.
        """
        raise NotImplementedError

    def victim(self, needed: int = 0) -> int | None:
        return next(self.iter_victims(needed), None)

    def peek_victims(self, needed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Array view of the minimal victim prefix covering ``needed`` bytes.

        Returns parallel int64 ``(keys, sizes)`` arrays: the victims
        :meth:`iter_victims` would yield, truncated at the first point where
        their cumulative size reaches ``needed`` (every victim if the whole
        cache cannot cover it; empty for ``needed <= 0``). Never evicts,
        reorders, or consumes RNG state — the sampling policies replay the
        current decision's counter-based draw stream, so peeking and then
        walking see identical victims. Keys must be int64-representable;
        the admission plane streams the same walk lazily through
        ``_peek_iter`` instead (see :mod:`.admission`).
        """
        keys: list[int] = []
        vsizes: list[int] = []
        if needed > 0:
            total = 0
            sizes = self.sizes
            for v in self._peek_iter(needed):
                keys.append(v)
                s = sizes[v]
                vsizes.append(s)
                total += s
                if total >= needed:
                    break
        return (np.asarray(keys, dtype=np.int64), np.asarray(vsizes, dtype=np.int64))

    def _peek_iter(self, needed: int) -> Iterator[int]:
        """Streaming victim-order walk for the lazy data-plane gather.

        Same victims in the same order as :meth:`iter_victims`; peek-stable
        policies override it with a *live* (copy-free) traversal so pulling
        k victims costs O(k) instead of an O(n) snapshot. Callers must stop
        advancing it before mutating the policy (the admission replays pull
        everything they need before evicting/promoting).
        """
        return self.iter_victims(needed)


class LRUEviction(EvictionPolicy):
    """Plain LRU: victims from the least-recently-used end."""

    peek_stable = True

    def __init__(self):
        super().__init__()
        self.order: OrderedDict[int, None] = OrderedDict()

    def insert(self, key: int, size: int) -> None:
        self.sizes[key] = size
        self.used += size
        self.order[key] = None

    def evict(self, key: int) -> None:
        self.used -= self.sizes.pop(key)
        del self.order[key]

    def on_access(self, key: int) -> None:
        self.order.move_to_end(key)

    def iter_victims(self, needed: int = 0) -> Iterator[int]:
        return iter(list(self.order))

    def _peek_iter(self, needed: int) -> Iterator[int]:
        # Walk the order dict live: O(pulled), where iter_victims copies the
        # whole order (O(n)) before yielding the first victim.
        return iter(self.order)


class SLRUEviction(EvictionPolicy):
    """Segmented LRU: probationary + protected segments (Caffeine's Main).

    New entries land in the probationary segment. A hit in probation moves the
    entry to protected; when protected exceeds its share (80% of the bytes the
    policy currently holds' capacity), its LRU entries demote back to
    probation MRU. Victims drain from probation LRU first, then protected LRU.
    """

    peek_stable = True

    def __init__(self, capacity: int, protected_frac: float = 0.8):
        super().__init__()
        self.protected_cap = int(capacity * protected_frac)
        self.probation: OrderedDict[int, None] = OrderedDict()
        self.protected: OrderedDict[int, None] = OrderedDict()
        self.protected_bytes = 0

    def insert(self, key: int, size: int) -> None:
        self.sizes[key] = size
        self.used += size
        self.probation[key] = None

    def evict(self, key: int) -> None:
        size = self.sizes.pop(key)
        self.used -= size
        if key in self.probation:
            del self.probation[key]
        else:
            del self.protected[key]
            self.protected_bytes -= size

    def _demote_overflow(self) -> None:
        while self.protected_bytes > self.protected_cap and len(self.protected) > 1:
            old, _ = self.protected.popitem(last=False)
            self.protected_bytes -= self.sizes[old]
            self.probation[old] = None

    def on_access(self, key: int) -> None:
        if key in self.protected:
            self.protected.move_to_end(key)
            return
        del self.probation[key]
        self.protected[key] = None
        self.protected_bytes += self.sizes[key]
        self._demote_overflow()

    def promote(self, key: int) -> None:
        # Rejected-candidate promotion only refreshes recency within the
        # entry's current segment; it must not force probation→protected
        # upgrades (those are reserved for real hits).
        if key in self.protected:
            self.protected.move_to_end(key)
        else:
            self.probation.move_to_end(key)

    def iter_victims(self, needed: int = 0) -> Iterator[int]:
        yield from list(self.probation)
        yield from list(self.protected)

    def _peek_iter(self, needed: int) -> Iterator[int]:
        yield from self.probation
        yield from self.protected


class SampledEviction(EvictionPolicy):
    """Ristretto-style sampling: sample 5 entries, pick per ``rule``.

    Rules (paper Section 5): ``frequency`` (lowest sketch frequency),
    ``size`` (largest size), ``frequency_size`` (lowest frequency/size),
    ``needed_size`` (size closest to the space needed); ``random`` is the
    internal 1-sample rule behind :class:`RandomEviction`.
    Maintains a swap-remove list for O(1) uniform sampling.

    Sampling is **counter-based** (:mod:`.crng`): the ``i``-th
    draw of a walk is ``draw(seed, decision, i) % len(keys)``, a pure
    function of the policy seed and the decision counter. One walk =
    one decision's draw stream, consumed ``SAMPLE`` draws per step from
    index 0; replaying a walk (peek, then the admission replay) reproduces
    it exactly, and draws beyond the point a shorter walk stops at cannot
    leak into later decisions. ``iter_victims`` snapshots the key list at
    call time so interleaved evictions of already-yielded victims (QV's
    scalar walk) cannot perturb the remaining stream; ``_peek_iter`` walks
    the live list under the no-mutation-while-pulling contract — both see
    the same keys in the same slots, hence the same victims.

    When ``freq_batch_fn`` is given (the CMS backend's ``estimate_batch``),
    the walk prefetches draws for a whole block of steps in one vectorized
    ``rng → indices → keys`` gather and scores the block's sample pool with
    ONE batched sketch call; otherwise each step scores its ≤5-key pool
    through scalar ``freq_fn`` calls (the paper's lightweight host path).
    Frequencies are estimate-only (no sketch writes land mid-decision), so
    block granularity cannot change which victims are selected.
    """

    SAMPLE = 5
    peek_stable = True
    RULES = ("frequency", "size", "frequency_size", "needed_size", "random")
    #: Rules whose scoring reads the frequency sketch.
    _FREQ_RULES = frozenset(("frequency", "frequency_size"))

    def __init__(
        self,
        rule: str,
        freq_fn: Callable[[int], int],
        seed: int = 0x5EED,
        freq_batch_fn: "Callable[[list[int]], Sequence[int]] | None" = None,
    ):
        super().__init__()
        if rule not in self.RULES:
            raise ValueError(f"unknown sampling rule: {rule}")
        self.rule = rule
        self.freq_fn = freq_fn
        self.freq_batch_fn = freq_batch_fn
        self.keys: list[int] = []
        self.pos: dict[int, int] = {}
        self.seed = int(seed)
        #: Counter-based RNG stream index; bumped by :meth:`begin_decision`.
        self.decision = 0
        #: Walks that exhausted a sample pool (every draw already taken) and
        #: fell back to the deterministic linear scan — regression-test
        #: observability for the rejection/fallback path.
        self.fallback_scans = 0

    def insert(self, key: int, size: int) -> None:
        self.sizes[key] = size
        self.used += size
        self.pos[key] = len(self.keys)
        self.keys.append(key)

    def evict(self, key: int) -> None:
        self.used -= self.sizes.pop(key)
        i = self.pos.pop(key)
        last = self.keys.pop()
        if last != key:
            self.keys[i] = last
            self.pos[last] = i

    def on_access(self, key: int) -> None:  # sampling policies keep no order
        pass

    def promote(self, key: int) -> None:
        pass

    def begin_decision(self) -> None:
        self.decision += 1

    def _score(self, key: int, needed: int, freq: "int | None" = None) -> float:
        size = self.sizes[key]
        rule = self.rule
        if rule == "frequency":
            return self.freq_fn(key) if freq is None else freq
        if rule == "size":
            return -size  # largest size evicted first
        if rule == "frequency_size":
            return (self.freq_fn(key) if freq is None else freq) / size
        if rule == "needed_size":
            # minimize |size - needed| (best memory utilization)
            return abs(size - needed)
        return 0.0  # random: every sampled key ties; min() keeps the first

    def _walk(self, keys: "list[int]", needed: int) -> Iterator[int]:
        """Yield distinct victims over a fixed ``keys`` view, drawing the
        current decision's counter-based stream from index 0."""
        n = len(keys)
        if n == 0:
            return
        taken: set[int] = set()
        sample = self.SAMPLE
        seed, decision = self.seed, self.decision
        prefetch = self.freq_batch_fn is not None and self.rule in self._FREQ_RULES
        freqs: dict[int, int] = {}
        base = crng.stream_key(seed, decision)
        if prefetch:
            # Vectorized gather granularity: enough steps to cover `needed`
            # at the current mean object size (perf only — the draw stream
            # is index-addressed, so block size cannot change the victims).
            mean = max(1, self.used // n)
            block = min(64, max(4, -(-needed // mean) if needed > 0 else 8))
        block_pools: list[list[int]] = []  # current block's per-step pools
        block_base = 0
        step = 0
        while len(taken) < n:
            if prefetch:
                if step - block_base >= len(block_pools):
                    block_base = step
                    start = step * sample
                    idx = crng.draws(seed, decision, start, block * sample) % np.uint64(n)
                    flat = [keys[i] for i in idx.tolist()]
                    block_pools = [
                        flat[j * sample : (j + 1) * sample] for j in range(block)
                    ]
                    missing = [k for k in dict.fromkeys(flat) if k not in freqs]
                    if missing:
                        freqs.update(zip(missing, map(int, self.freq_batch_fn(missing))))
                raw = block_pools[step - block_base]
            else:
                # Scalar per-step draws: same stream (draws == draw, asserted
                # in tests), no numpy dispatch on the host hot path.
                start = step * sample
                raw = [keys[crng.stream_draw(base, start + j) % n] for j in range(sample)]
            pool = [k for k in raw if k not in taken]
            step += 1
            if not pool:
                # every draw hit an already-taken key: deterministic linear
                # scan over the (fixed) key view, consuming no extra draws
                self.fallback_scans += 1
                pool = [k for k in keys if k not in taken]
                if prefetch:
                    missing = [k for k in pool if k not in freqs]
                    if missing:
                        freqs.update(zip(missing, map(int, self.freq_batch_fn(missing))))
            best = min(pool, key=lambda k: self._score(k, needed, freqs.get(k)))
            taken.add(best)
            yield best

    def iter_victims(self, needed: int = 0) -> Iterator[int]:
        # Snapshot the key list NOW: the scalar admission walks (QV, IV's
        # evicting pass) interleave evictions of already-yielded victims
        # with the walk, which must not perturb the remaining stream.
        return self._walk(list(self.keys), needed)

    def _peek_iter(self, needed: int) -> Iterator[int]:
        # Live view — callers must finish pulling before mutating, so the
        # slots match the snapshot iter_victims would have taken.
        return self._walk(self.keys, needed)


class RandomEviction(SampledEviction):
    """Uniform random victims (paper's 'Random' baseline): a 1-sample walk
    whose score is constant, so each step takes the drawn key (or the first
    not-yet-taken key in slot order when the draw collides with one already
    taken — the same deterministic fallback as the 5-sample policies)."""

    SAMPLE = 1

    def __init__(self, seed: int = 0x5EED):
        super().__init__("random", lambda _k: 0, seed)


def make_eviction(
    name: str,
    *,
    capacity: int,
    freq_fn: Callable[[int], int],
    seed: int = 0x5EED,
    freq_batch_fn: "Callable[[list[int]], Sequence[int]] | None" = None,
) -> EvictionPolicy:
    """Factory covering the paper's six Main-cache eviction policies.

    ``freq_batch_fn`` (optional, batched-native sketches only) lets the
    sampled policies score a whole sample block with one sketch call.
    """
    name = name.lower()
    if name == "lru":
        return LRUEviction()
    if name == "slru":
        return SLRUEviction(capacity)
    if name == "random":
        return RandomEviction(seed)
    if name in ("sampled_frequency", "sampled_size", "sampled_frequency_size", "sampled_needed_size"):
        return SampledEviction(name.removeprefix("sampled_"), freq_fn, seed, freq_batch_fn)
    raise ValueError(f"unknown eviction policy: {name}")
