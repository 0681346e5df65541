"""The port's ``CMSSketch`` on the CPU against the reference's, step by step,
and its flush plan (``plan_flush``) against scalar driving.

Random interleavings of ``increment`` / ``increment_batch`` /
``estimate`` / ``estimate_batch`` go to both sketches (the reference's
unpatched, on its jnp oracles). After every step the tables, ``_ops``,
``resets`` and the pending increments must be equal, and so must every
estimate. The streams cover pending batches above ``flush_block`` (staged,
split flushes), aging resets that fall inside a flush, and int64 keys at
and above 2**31, which both packages truncate to int32 before hashing.
"""

import numpy as np
import pytest
import torch
from _torch_port import torch_one_thread  # noqa: F401  (fixture)

from repro.core.cms_sketch import CMSSketch as JaxCMSSketch
from repro_torch.core.cms_sketch import CMSSketch, plan_flush
from repro_torch.kernels.cms import ops as port_ops

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _key_pool(rng, n):
    small = rng.integers(0, 50, n // 2)
    wide = rng.integers(1 << 31, 1 << 40, n - n // 2)  # trace ids reach 2**40
    pool = np.concatenate([small, wide, [(1 << 31) - 1, 1 << 31, (1 << 32) + 7, -5]])
    return pool.astype(np.int64)


def _assert_same(jax_sk, port_sk):
    np.testing.assert_array_equal(port_sk.table.numpy(), np.asarray(jax_sk.table))
    assert port_sk._ops == jax_sk._ops
    assert port_sk.resets == jax_sk.resets
    assert port_sk._pending == jax_sk._pending


@pytest.mark.parametrize("seed,expected_entries,flush_block",
                         [(0, 16, 512), (1, 40, 48), (2, 300, 512), (3, 16, 100)])
def test_random_interleavings(seed, expected_entries, flush_block):
    rng = np.random.default_rng([seed, expected_entries, flush_block])
    pool = _key_pool(rng, 64)
    jax_sk = JaxCMSSketch(expected_entries, flush_block=flush_block, use_pallas=False)
    port_sk = CMSSketch(expected_entries, flush_block=flush_block, device="cpu")
    assert (port_sk.width, port_sk.sample_size) == (jax_sk.width, jax_sk.sample_size)
    fused = staged = 0
    for _ in range(30):
        op = rng.integers(0, 4)
        if op == 0:
            key = int(rng.choice(pool))
            jax_sk.increment(key)
            port_sk.increment(key)
        elif op == 1:
            # short runs take the fused path; long ones (above flush_block,
            # or across an aging reset) take the staged flush
            n = int(rng.choice([3, 30, flush_block + 1, 2 * flush_block + 37]))
            batch = rng.choice(pool, n)
            jax_sk.increment_batch(batch)
            port_sk.increment_batch(batch)
        else:
            n_pend = len(port_sk._pending)
            if 0 < n_pend <= flush_block and port_sk._ops + n_pend < port_sk.sample_size:
                fused += 1
            elif n_pend:
                staged += 1
            if op == 2:
                key = int(rng.choice(pool))
                assert port_sk.estimate(key) == jax_sk.estimate(key)
            else:
                keys = rng.choice(pool, int(rng.choice([1, 7, 33])))
                got = port_sk.estimate_batch(keys)
                assert got.dtype == np.int32
                np.testing.assert_array_equal(got, np.asarray(jax_sk.estimate_batch(keys)))
        _assert_same(jax_sk, port_sk)
    assert fused and staged  # both branches of estimate_batch were taken


def test_reset_inside_a_flush_lands_at_the_same_access():
    """A pending batch that crosses two reset boundaries halves the table
    twice, each time at the same access index as the reference."""
    jax_sk = JaxCMSSketch(16, use_pallas=False)
    port_sk = CMSSketch(16, device="cpu")
    keys = np.arange(2 * jax_sk.sample_size + 5, dtype=np.int64) % 7 + (1 << 33)
    for sk in (jax_sk, port_sk):
        sk.increment_batch(keys)
        sk.estimate_batch([int(1 << 33)])
    assert port_sk.resets == jax_sk.resets >= 2
    _assert_same(jax_sk, port_sk)


def test_lazy_prefix_view_is_materialised():
    """``estimate_batch`` takes any iterable (the admission plane's lazy
    victim prefix) and scores it in one call."""
    port_sk = CMSSketch(64, device="cpu")
    port_sk.increment_batch([1, 2, 2])
    assert port_sk.estimate_batch(iter([2, 1, 9])).tolist() == [2, 1, 0]


def test_device_rules():
    with pytest.raises(ValueError, match="use_kernel=True"):
        CMSSketch(64, device="cpu", use_kernel=True)
    with pytest.raises(ValueError, match="flush_block"):
        CMSSketch(64, device="cpu", flush_block=513)
    sk = CMSSketch(64, device="cpu")
    assert sk.table.device == torch.device("cpu") and sk.table.dtype == torch.int32


def _scalar_resets(pending, ops, sample_size):
    """Scalar driving: one increment at a time, the reset right after the
    increment that fills the sample. Returns the 1-based indexes (within
    the flush) of the increments that reset, and ``ops`` after."""
    resets = []
    for i in range(1, pending + 1):
        ops += 1
        if ops >= sample_size:
            ops //= 2
            resets.append(i)
    return resets, ops


def _check_plan(steps, pending, ops, sample_size, flush_block):
    """``steps`` cover the pending keys in order, no step above
    ``flush_block``, a step cut short only by a reset, and every reset at
    the increment where scalar driving resets."""
    want_resets, want_ops = _scalar_resets(pending, ops, sample_size)
    done, resets = 0, []
    for i, (take, reset) in enumerate(steps):
        assert 0 < take <= flush_block
        done += take
        if reset:
            resets.append(done)
        elif i < len(steps) - 1:
            assert take == flush_block  # only a reset or the block cuts a step
    assert done == pending and resets == want_resets
    return want_ops


@pytest.mark.parametrize("seed", range(6))
def test_plan_flush_matches_scalar_driving(seed):
    """Random interleavings of flush sizes, carrying the sample count from
    flush to flush, against one increment at a time."""
    rng = np.random.default_rng(seed)
    sample_size = int(rng.choice([7, 160, 2000]))
    flush_block = int(rng.choice([1, 3, 48, 512]))
    ops = 0
    for _ in range(200):
        pending = int(rng.choice([0, 1, 2, flush_block - 1, flush_block, flush_block + 1,
                                  rng.integers(0, 3 * sample_size)]))
        pending = max(pending, 0)
        steps, new_ops = plan_flush(pending, ops, sample_size, flush_block)
        assert new_ops == _check_plan(steps, pending, ops, sample_size, flush_block)
        ops = new_ops
        assert 0 <= ops < sample_size


@pytest.mark.parametrize("pending,ops,want", [
    (0, 5, []),  # nothing pending: no step
    (512, 0, [(512, False)]),  # exactly one block: the fused path
    (513, 0, [(512, False), (1, False)]),  # one over the block
    (900, 0, [(512, False), (388, False)]),  # two blocks, the second short
    (995, 5, [(512, False), (483, True)]),  # the sample fills in the second block
    (100, 900, [(100, True)]),  # fills the sample exactly: a reset, not fused
    (99, 900, [(99, False)]),  # one short of the sample: fused
    (1200, 900, [(100, True), (500, True), (500, True), (100, False)]),  # resets inside
    (1, 999, [(1, True)]),
])
def test_plan_flush_edges(pending, ops, want):
    """flush_block 512, sample 1,000: block edges and resets inside a flush."""
    steps, new_ops = plan_flush(pending, ops, 1000, 512)
    assert steps == want
    assert new_ops == _check_plan(steps, pending, ops, 1000, 512)


def test_host_path_follows_the_plan(monkeypatch):
    """The CPU sketch's flush makes the plan's updates and resets, in its
    order, and books its count and resets."""
    calls = []
    monkeypatch.setattr(port_ops, "update",
                        lambda table, keys, **kw: calls.append(("update", keys.numel())))
    monkeypatch.setattr(port_ops, "reset", lambda table: calls.append(("reset",)))
    sk = CMSSketch(16, flush_block=48, device="cpu")
    sk._ops = sk.sample_size - 30
    sk.increment_batch(np.arange(2 * sk.sample_size + 7))
    steps, ops = plan_flush(len(sk._pending), sk._ops, sk.sample_size, 48)
    sk.flush()
    want = []
    for take, reset in steps:
        want.append(("update", take))
        if reset:
            want.append(("reset",))
    assert calls == want and sk._ops == ops and sk._pending == []
    assert sk.resets == sum(r for _, r in steps) >= 2
