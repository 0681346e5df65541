"""Shared helpers of the port's differential tests (``tests/test_torch_*.py``).

Inputs are made with numpy from a seed and handed to both packages; JAX
runs on the CPU. Integer paths (sketch tables, admission verdicts, cache
contents and stats, block hashes, generated tokens) are compared exactly,
with tolerance 0. Float paths (attention, the model's logits and KV
caches) are compared within the tolerance that each test states.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from repro.kernels.cms import ops as jax_cms_ops

# -- a fast path for the reference's CMS sketch in whole-trace runs ----------
#
# The reference CMSSketch on the CPU calls its plain-jnp oracles eagerly,
# about 12 ms per admission decision (op-by-op dispatch), which would make
# the 21-combo trace comparisons take minutes. ``fast_jax_cms`` swaps the
# three callables of one reference sketch instance for a jitted call of the
# reference's own ``flush_scores`` (its scatter-add + gather form of the
# same function, asserted equal to the oracles in tests/test_kernels.py),
# with key batches padded to power-of-two buckets so that few shapes
# compile; padded update lanes are masked off by ``n_pend`` and padded
# estimates are dropped. The sketch's control plane (buffering, flush
# splitting at reset boundaries and ``flush_block``, the fused-path test,
# aging) is the reference's own code, untouched. test_torch_sketch.py
# holds the port against the unpatched reference sketch.


@functools.partial(jax.jit, static_argnames=("cap",))
def _flush_scores(table, upd, n_pend, est, cap):
    return jax_cms_ops.flush_scores(table, upd, n_pend, est, cap=cap,
                                    use_pallas=False, interpret=True)


def _bucket(keys) -> tuple[np.ndarray, int]:
    keys = np.asarray(keys, dtype=np.int32)
    size = 8
    while size < len(keys):
        size <<= 1
    out = np.zeros(size, dtype=np.int32)
    out[: len(keys)] = keys
    return out, len(keys)


def fast_jax_cms(sketch) -> None:
    """Route one reference ``CMSSketch`` through :func:`_flush_scores`."""
    assert not sketch.use_pallas
    none, _ = _bucket([])

    def update(table, keys, cap):
        upd, m = _bucket(keys)
        return _flush_scores(table, upd, m, none, cap)[0]

    def estimate(table, keys):
        est, n = _bucket(keys)
        return np.asarray(_flush_scores(table, none, 0, est, sketch.cap)[1])[:n]

    def update_estimate(table, upd_keys, est_keys, cap):
        upd, m = _bucket(upd_keys)
        est, n = _bucket(est_keys)
        table, vals = _flush_scores(table, upd, m, est, cap)
        return table, np.asarray(vals)[:n]

    sketch._update_ref = update
    sketch._estimate_ref = estimate
    sketch._update_estimate_ref = update_estimate


# -- whole-policy state, read from either package -----------------------------
STATS_FIELDS = ("accesses", "hits", "bytes_requested", "bytes_hit", "victims_examined",
                "admissions", "rejections", "evictions")


def _main_rows(main):
    kind = type(main).__name__
    if kind == "SLRUEviction":
        return (list(main.probation) + list(main.protected),
                [0] * len(main.probation) + [1] * len(main.protected))
    keys = list(main.order) if kind == "LRUEviction" else list(main.keys)
    return keys, [0] * len(keys)


def policy_state(policy) -> dict:
    """The state dict of ``repro_torch.state`` read from the attributes of a
    W-TinyLFU policy of either package (the two share attribute names)."""
    sk = policy.sketch
    keys, segments = _main_rows(policy.main)
    table = sk.table
    table = table.cpu().numpy() if isinstance(table, torch.Tensor) else np.asarray(table)
    state = {
        "stats": np.asarray([getattr(policy.stats, f) for f in STATS_FIELDS], dtype=np.int64),
        "window_keys": np.asarray(list(policy.window), dtype=np.int64),
        "window_sizes": np.asarray(list(policy.window.values()), dtype=np.int64),
        "window_bytes": policy.window_bytes,
        "window_cap": policy.window_cap,
        "main_cap": policy.main_cap,
        "adapt_prev_hits": policy._adapt_prev_hits,
        "adapt_prev_ratio": policy._adapt_prev_ratio,
        "adapt_accesses": policy._adapt_accesses,
        "adapt_dir": policy._adapt_dir,
        "main_keys": np.asarray(keys, dtype=np.int64),
        "main_sizes": np.asarray([policy.main.sizes[k] for k in keys], dtype=np.int64),
        "main_segments": np.asarray(segments, dtype=np.int8),
        "main_decision": getattr(policy.main, "decision", 0),
        "sketch_ops": sk._ops,
        "sketch_resets": sk.resets,
        "sketch_table": table.astype(np.int32 if table.ndim == 2 else np.int64),
    }
    if hasattr(sk, "_pending"):
        state["sketch_pending"] = np.asarray(sk._pending, dtype=np.int64)
    elif sk.use_doorkeeper:
        state["sketch_door"] = np.frombuffer(bytes(sk._door), dtype=np.uint8).copy()
    return state


def assert_same_state(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.fixture(scope="module")
def torch_one_thread():
    """One intra-op thread: the port's tensors here are a few KB, and more
    threads only burn the other test workers' cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)

