"""Counter-based (splittable) RNG for replayable victim sampling.

The sampled eviction policies (Ristretto's SampledLFU family, Random) draw
their victim candidates at random. With a *stateful* generator, peeking at
victims consumes RNG state, so the batched admission data plane could not
pre-gather a victim prefix without perturbing the stream the scalar walk
would have seen — which is why the sampling policies used to force the
per-victim scalar walk (``peek_stable = False``).

This module replaces the stateful stream with a splitmix64-style
counter-based construction: every draw is a pure function

    ``draw(seed, decision, i) = mix64(stream_key(seed, decision) ^ i * GAMMA)``

of the policy seed, a **decision counter** (advanced once per admission
decision by :meth:`EvictionPolicy.begin_decision`, never by peeking) and the
draw index *within* that decision. Consequences:

* peeking is replayable — walking the same decision's victim stream twice
  yields the same victims, so ``peek_victims`` and the lazy ``_peek_iter``
  gather are side-effect free;
* over-pulling is free — gathering more victims than the scalar walk would
  have examined (AV early pruning, QV first-loss stop) cannot shift any
  later decision's draws, because those use a different decision index;
* the draws vectorize — :func:`draws` produces a whole block of draw values
  in one numpy pass, feeding the sampled policies' one-gather-one-
  ``estimate_batch`` data plane.

The scalar :func:`draw` and the vectorized :func:`draws` are bit-identical
(asserted in tests). The constants are those of the reference package's
``crng`` (``repro/core/crng.py``), so both packages draw the same victims.
"""

from __future__ import annotations

import numpy as np

from .sketch import mix64

__all__ = [
    "GOLDEN",
    "GAMMA",
    "MIX_M1",
    "MIX_M2",
    "stream_key",
    "stream_draw",
    "draw",
    "draws",
    "mix64_vec",
]

_MASK64 = (1 << 64) - 1
#: Weyl constants: GOLDEN spaces decision streams, GAMMA spaces draws
#: within a stream (both odd, both well-studied splitmix64 increments).
GOLDEN = 0x9E3779B97F4A7C15
GAMMA = 0xD2B74407B1CE6E93
#: Stafford mix13 multipliers (the constants :func:`.sketch.mix64` uses).
MIX_M1 = 0xBF58476D1CE4E5B9
MIX_M2 = 0x94D049BB133111EB

_M1 = np.uint64(MIX_M1)
_M2 = np.uint64(MIX_M2)


def stream_key(seed: int, decision: int) -> int:
    """The 64-bit stream key of one decision's draw sequence."""
    return mix64((seed * GOLDEN + decision * GAMMA) & _MASK64)


def stream_draw(base: int, i: int) -> int:
    """The ``i``-th draw of a stream whose :func:`stream_key` is ``base`` —
    the scalar hot-path form (one mix per draw; callers hoist the key)."""
    return mix64(base ^ ((i * GAMMA) & _MASK64))


def draw(seed: int, decision: int, i: int) -> int:
    """The ``i``-th 64-bit draw of decision ``decision`` (scalar twin of
    :func:`draws`; pure — no state anywhere)."""
    return stream_draw(stream_key(seed, decision), i)


def mix64_vec(x: np.ndarray) -> np.ndarray:
    """Stafford mix13 finalizer over a uint64 array (vector twin of
    :func:`.sketch.mix64`)."""
    with np.errstate(over="ignore"):
        x = x.astype(np.uint64, copy=True)
        x ^= x >> np.uint64(30)
        x *= _M1
        x ^= x >> np.uint64(27)
        x *= _M2
        x ^= x >> np.uint64(31)
    return x


def draws(seed: int, decision: int, start: int, count: int) -> np.ndarray:
    """Draws ``start .. start+count-1`` of one decision as a uint64 array.

    ``draws(s, d, a, n)[i] == draw(s, d, a + i)`` bit-for-bit, so a walk may
    consume its draw stream in any block granularity without changing the
    victims it selects.
    """
    base = np.uint64(stream_key(seed, decision))
    with np.errstate(over="ignore"):
        idx = np.arange(start, start + count, dtype=np.uint64) * np.uint64(GAMMA)
        return mix64_vec(base ^ idx)
