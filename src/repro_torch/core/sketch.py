"""TinyLFU frequency sketch: count-min sketch + doorkeeper + periodic reset.

Paper Section 3: "The TinyLFU admission filter is implemented through a sketch
such as a minimal increment counting Bloom filter, or a count min sketch. All
sketch counters are halved for aging purposes every S accesses [...] counters
are also capped [...] The sketch counters corresponding to x are updated for
every occurrence of x, even if it is not in the cache."

This is the host control-plane implementation. It is deliberately written with
pure-integer arithmetic on flat lists: the paper's headline claim is *CPU
overhead* (Fig. 13), so the hot path must be cheap. The device data-plane
variant (batched count-min-sketch kernels) lives in ``repro_torch/kernels/cms``
behind :class:`repro_torch.core.cms_sketch.CMSSketch`.
"""

from __future__ import annotations

__all__ = ["FrequencySketch", "mix64"]


class _LazyEstimates:
    """Sequence view over a key batch's estimates, evaluated on demand.

    The admission data plane issues ONE ``estimate_batch`` call per decision
    and its replay loops consume a *prefix* of the result (AV's early
    pruning and QV's first-loss stop cut the walk short). A device sketch
    evaluates the whole batch eagerly anyway — one kernel call is the whole
    point — but the host sketch has no vector unit to exploit, so its batch
    is gathered lazily: only the entries the replay actually reads are
    computed, making the batched plane cost exactly what the scalar walk
    costs. Estimates are read-only, so deferring them past the call site
    cannot change their values (no increments land mid-decision).
    """

    __slots__ = ("_keys", "_vals", "_estimate")

    def __init__(self, keys, estimate):
        self._keys = keys
        self._vals: list[int] = []
        self._estimate = estimate

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, i: int) -> int:
        vals = self._vals
        if i < 0:
            i += len(self._keys)
        while len(vals) <= i:
            vals.append(self._estimate(int(self._keys[len(vals)])))
        return vals[i]

    def __iter__(self):
        for i in range(len(self._keys)):
            yield self[i]

_MASK64 = (1 << 64) - 1
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
_GOLDEN = 0x9E3779B97F4A7C15


def mix64(x: int) -> int:
    """Stafford mix13 finalizer (64-bit splitmix)."""
    x &= _MASK64
    x ^= x >> 30
    x = (x * _MIX1) & _MASK64
    x ^= x >> 27
    x = (x * _MIX2) & _MASK64
    x ^= x >> 31
    return x


class FrequencySketch:
    """4-row count-min sketch with conservative increment, doorkeeper, reset.

    Parameters
    ----------
    expected_entries:
        Rough number of distinct objects the backing cache can hold; each row
        allocates the next power of two ≥ that, and the reset sample size
        ``S`` defaults to ``10 * expected_entries`` (Caffeine's choice; the
        paper requires S ≳ 10·C).
    cap:
        Counter saturation value (paper: O(log S/C) bits; Caffeine uses 4-bit
        counters capped at 15).
    conservative:
        Minimal-increment update (only counters equal to the row minimum are
        bumped) — the "minimal increment counting Bloom filter" of the paper.
    doorkeeper:
        A bloom filter absorbing first occurrences so one-hit wonders never
        reach the main counters.

    Rows are indexed by Kirsch–Mitzenmacher double hashing:
    ``idx_i = (h1 + i*h2) mod width`` with two splitmix64-derived hashes.
    """

    ROWS = 4
    #: No vector unit behind estimate_batch: batching buys nothing here, so
    #: the admission plane's "auto" mode keeps the scalar walk (the paper's
    #: lightweight hot path). The CMS backend flips this to True.
    batched_native = False

    def __init__(
        self,
        expected_entries: int,
        *,
        cap: int = 15,
        sample_factor: int = 10,
        conservative: bool = True,
        doorkeeper: bool = True,
    ):
        expected_entries = max(16, int(expected_entries))
        width = 1
        while width < expected_entries:
            width <<= 1
        self.width = width
        self.mask = width - 1
        self.cap = int(cap)
        # Flat table: row i occupies [i*width, (i+1)*width).
        self.table = [0] * (self.ROWS * width)
        self.sample_size = sample_factor * expected_entries
        self.conservative = conservative
        self._ops = 0
        self.resets = 0
        self.use_doorkeeper = doorkeeper
        self._dk_mask = 2 * width - 1
        self._door = bytearray(2 * width) if doorkeeper else None

    # -- public API ------------------------------------------------------
    def increment(self, key: int) -> None:
        """Record one occurrence of ``key`` (called on *every* access)."""
        self._ops += 1
        if self.use_doorkeeper:
            h = mix64(key ^ 0xA5A5A5A5)
            door = self._door
            b0 = h & self._dk_mask
            b1 = (h >> 21) & self._dk_mask
            if not (door[b0] and door[b1]):
                door[b0] = 1
                door[b1] = 1
                if self._ops >= self.sample_size:
                    self._reset()
                return
        h1 = mix64(key)
        h2 = mix64(key ^ _GOLDEN) | 1
        mask = self.mask
        width = self.width
        table = self.table
        i0 = h1 & mask
        i1 = width + ((h1 + h2) & mask)
        i2 = 2 * width + ((h1 + 2 * h2) & mask)
        i3 = 3 * width + ((h1 + 3 * h2) & mask)
        c0 = table[i0]
        c1 = table[i1]
        c2 = table[i2]
        c3 = table[i3]
        if self.conservative:
            lo = min(c0, c1, c2, c3)
            if lo < self.cap:
                nv = lo + 1
                if c0 == lo:
                    table[i0] = nv
                if c1 == lo:
                    table[i1] = nv
                if c2 == lo:
                    table[i2] = nv
                if c3 == lo:
                    table[i3] = nv
        else:
            cap = self.cap
            if c0 < cap:
                table[i0] = c0 + 1
            if c1 < cap:
                table[i1] = c1 + 1
            if c2 < cap:
                table[i2] = c2 + 1
            if c3 < cap:
                table[i3] = c3 + 1
        if self._ops >= self.sample_size:
            self._reset()

    def estimate(self, key: int) -> int:
        """Approximate access frequency of ``key`` within the current sample."""
        h1 = mix64(key)
        h2 = mix64(key ^ _GOLDEN) | 1
        mask = self.mask
        width = self.width
        table = self.table
        est = min(
            table[h1 & mask],
            table[width + ((h1 + h2) & mask)],
            table[2 * width + ((h1 + 2 * h2) & mask)],
            table[3 * width + ((h1 + 3 * h2) & mask)],
        )
        if self.use_doorkeeper:
            h = mix64(key ^ 0xA5A5A5A5)
            if self._door[h & self._dk_mask] and self._door[(h >> 21) & self._dk_mask]:
                est += 1
        return est

    def estimate_batch(self, keys) -> _LazyEstimates:
        """Estimates for a whole key batch — the single scoring entry point
        of the admission data plane. The host sketch has no device batching
        to exploit, so the result is a :class:`_LazyEstimates` prefix view
        (only consumed entries are computed); the CMS backend's
        ``estimate_batch`` is eager — one fused kernel call."""
        return _LazyEstimates(keys, self.estimate)

    def _reset(self) -> None:
        """Aging: halve every counter and clear the doorkeeper (paper §3)."""
        self.table = [c >> 1 for c in self.table]
        if self.use_doorkeeper:
            self._door = bytearray(len(self._door))
        self._ops //= 2
        self.resets += 1
