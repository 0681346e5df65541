"""The port's ``CMSSketch`` on the CPU against the reference's, step by step.

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
from repro_torch.core.cms_sketch import CMSSketch

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
