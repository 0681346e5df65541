"""Carry a W-TinyLFU policy's state across, as plain numpy arrays and ints.

A cache holds no weights: its state is what a run has built up. For a
:class:`~repro_torch.core.tinylfu.SizeAwareWTinyLFU` that is

* the sketch: its table, flushed-increment count ``_ops``, ``resets`` and,
  for the CMS backend, the pending (not yet flushed) increments; for the
  host sketch also the doorkeeper bits;
* the window LRU (keys and sizes, LRU first), ``window_bytes`` and the
  region caps the adaptive climber moves, with the climber's own state;
* Main's entries in the eviction policy's canonical order (recency order
  for LRU, probation then protected for SLRU, slot order for the sampling
  policies) and, for the sampling policies, the ``decision`` counter;
* the :class:`~repro_torch.core.cache_api.CacheStats` counters.

:func:`export_state` writes that dict and :func:`load_reference_state` fills
a policy from it. The dict holds only numpy arrays, ints and one float, so
a run of the reference package can be carried over into the port by
building the same dict from its attributes; this module touches no object
of the reference.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch.core.cache_api import CacheStats
from repro_torch.core.cms_sketch import CMSSketch
from repro_torch.core.eviction import LRUEviction, SampledEviction, SLRUEviction
from repro_torch.core.tinylfu import SizeAwareWTinyLFU

__all__ = ["STATS_FIELDS", "export_state", "load_reference_state"]

#: The integer counters of CacheStats, in the order ``state["stats"]`` holds them.
STATS_FIELDS = ("accesses", "hits", "bytes_requested", "bytes_hit", "victims_examined",
                "admissions", "rejections", "evictions")

State = dict[str, "np.ndarray | int | float"]


def _i64(values) -> np.ndarray:
    return np.asarray(list(values), dtype=np.int64)


def _main_rows(main) -> tuple[list[int], list[int]]:
    """(keys, segments) of Main in its canonical order."""
    if isinstance(main, SLRUEviction):
        return (list(main.probation) + list(main.protected),
                [0] * len(main.probation) + [1] * len(main.protected))
    if isinstance(main, LRUEviction):
        keys = list(main.order)
    elif isinstance(main, SampledEviction):
        keys = list(main.keys)
    else:
        raise TypeError(f"no state layout for {type(main).__name__}")
    return keys, [0] * len(keys)


def export_state(policy: SizeAwareWTinyLFU) -> State:
    """The policy's state as numpy arrays and ints (see the module docstring)."""
    sk = policy.sketch
    main = policy.main
    keys, segments = _main_rows(main)
    state: State = {
        "stats": _i64(getattr(policy.stats, f) for f in STATS_FIELDS),
        "window_keys": _i64(policy.window),
        "window_sizes": _i64(policy.window.values()),
        "window_bytes": policy.window_bytes,
        "window_cap": policy.window_cap,
        "main_cap": policy.main_cap,
        "adapt_prev_hits": policy._adapt_prev_hits,
        "adapt_prev_ratio": policy._adapt_prev_ratio,
        "adapt_accesses": policy._adapt_accesses,
        "adapt_dir": policy._adapt_dir,
        "main_keys": _i64(keys),
        "main_sizes": _i64(main.sizes[k] for k in keys),
        "main_segments": np.asarray(segments, dtype=np.int8),
        "main_decision": getattr(main, "decision", 0),
        "sketch_ops": sk._ops,
        "sketch_resets": sk.resets,
    }
    if isinstance(sk, CMSSketch):
        state["sketch_table"] = sk.table.cpu().numpy().copy()
        state["sketch_pending"] = _i64(sk._pending)
    else:
        state["sketch_table"] = _i64(sk.table)
        if sk.use_doorkeeper:
            state["sketch_door"] = np.frombuffer(bytes(sk._door), dtype=np.uint8).copy()
    return state


def _load_main(main, keys: list[int], sizes: list[int], segments: list[int]) -> None:
    main.sizes = dict(zip(keys, sizes))
    main.used = sum(sizes)
    if isinstance(main, SLRUEviction):
        main.probation = OrderedDict((k, None) for k, g in zip(keys, segments) if not g)
        main.protected = OrderedDict((k, None) for k, g in zip(keys, segments) if g)
        main.protected_bytes = sum(s for s, g in zip(sizes, segments) if g)
    elif isinstance(main, LRUEviction):
        main.order = OrderedDict((k, None) for k in keys)
    elif isinstance(main, SampledEviction):
        main.keys = list(keys)
        main.pos = {k: i for i, k in enumerate(keys)}
    else:
        raise TypeError(f"no state layout for {type(main).__name__}")


def load_reference_state(policy: SizeAwareWTinyLFU, state: State) -> None:
    """Fill ``policy`` in place from a state dict, as :func:`export_state`
    writes it (or as a test builds it from a reference policy). The policy
    must have been built with the same spec and capacity as the one the
    state came from."""
    sk = policy.sketch
    table = np.asarray(state["sketch_table"])
    if isinstance(sk, CMSSketch):
        if table.shape != tuple(sk.table.shape):
            raise ValueError(f"sketch table {table.shape} != {tuple(sk.table.shape)}")
        sk.table.copy_(torch.from_numpy(table.astype(np.int32)))
        sk._pending = np.asarray(state["sketch_pending"], dtype=np.int64).tolist()
    else:
        if table.shape != (len(sk.table),):
            raise ValueError(f"sketch table {table.shape} != ({len(sk.table)},)")
        sk.table = table.astype(np.int64).tolist()
        if sk.use_doorkeeper:
            sk._door = bytearray(np.asarray(state["sketch_door"], dtype=np.uint8).tobytes())
    sk._ops = int(state["sketch_ops"])
    sk.resets = int(state["sketch_resets"])

    policy.window = OrderedDict(zip(np.asarray(state["window_keys"]).tolist(),
                                    np.asarray(state["window_sizes"]).tolist()))
    policy.window_bytes = int(state["window_bytes"])
    policy.window_cap = int(state["window_cap"])
    policy.main_cap = int(state["main_cap"])
    policy._adapt_prev_hits = int(state["adapt_prev_hits"])
    policy._adapt_prev_ratio = float(state["adapt_prev_ratio"])
    policy._adapt_accesses = int(state["adapt_accesses"])
    policy._adapt_dir = int(state["adapt_dir"])

    _load_main(policy.main, np.asarray(state["main_keys"]).tolist(),
               np.asarray(state["main_sizes"]).tolist(),
               np.asarray(state["main_segments"]).tolist())
    if isinstance(policy.main, SampledEviction):
        policy.main.decision = int(state["main_decision"])

    policy.stats = CacheStats(**dict(zip(STATS_FIELDS, np.asarray(state["stats"]).tolist())))
