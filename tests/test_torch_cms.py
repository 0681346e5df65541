"""The port's count-min-sketch ops against the reference's, byte for byte.

The port's plain versions (what its kernel wrappers run for CPU tensors)
against ``repro.kernels.cms.ops`` on both the Pallas kernels in interpret
mode (``use_pallas=True``) and the jnp oracles (``use_pallas=False``). Keys
span the whole int32 range, negatives included. The Hopper kernels
themselves run only on the card: ``test_torch_cuda.py`` (marked ``cuda``)
and ``chip_smoke.py`` hold them against these plain versions there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_port import torch_one_thread  # noqa: F401  (fixture)

from repro.kernels.cms import ops as jax_ops
from repro.kernels.cms import ref as jax_ref
from repro_torch.kernels.cms import cms as port_cms
from repro_torch.kernels.cms import ops as port_ops
from repro_torch.kernels.cms import ref as port_ref

WIDTHS = (128, 512, 2048)
COUNTS = (1, 64, 300)
I32 = np.iinfo(np.int32)

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _keys(rng, n, *, distinct=None):
    """``n`` int32 keys over the full range, or drawn from ``distinct`` values."""
    if distinct is not None:
        pool = rng.integers(I32.min, I32.max, distinct, endpoint=True, dtype=np.int64)
        return pool[rng.integers(0, distinct, n)].astype(np.int32)
    keys = rng.integers(I32.min, I32.max, n, endpoint=True, dtype=np.int64).astype(np.int32)
    keys[: min(n, 4)] = np.asarray([I32.min, -1, 0, I32.max], dtype=np.int32)[: min(n, 4)]
    return keys


def _table(rng, width, cap):
    # cells <= cap: the sketch's invariant (the kernels' precondition)
    return rng.integers(0, cap + 1, (port_ref.ROWS, width)).astype(np.int32)


def _port_update(table, keys, cap):
    return port_ops.update(torch.from_numpy(table.copy()), torch.from_numpy(keys), cap=cap).numpy()


@pytest.mark.parametrize("width", WIDTHS + (1 << 22,))
def test_row_indexes_bit_identical(width):
    keys = _keys(np.random.default_rng(width), 4096)
    want = np.asarray(jax_ref.row_indexes(jnp.asarray(keys), width))
    got = port_ref.row_indexes(torch.from_numpy(keys), width).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))
    np.testing.assert_array_equal(
        port_ref.mix32(torch.from_numpy(keys).to(torch.int64)).numpy(),
        np.asarray(jax_ref.mix32(jnp.asarray(keys))).astype(np.int64))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "ref"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", COUNTS)
def test_update(width, n, use_pallas):
    rng = np.random.default_rng([width, n])
    table, keys = _table(rng, width, 12), _keys(rng, n)
    want = np.asarray(jax_ops.update(jnp.asarray(table), jnp.asarray(keys), cap=15,
                                     use_pallas=use_pallas))
    np.testing.assert_array_equal(_port_update(table, keys, 15), want)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "ref"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", COUNTS)
def test_estimate(width, n, use_pallas):
    rng = np.random.default_rng([width, n, 1])
    table, keys = _table(rng, width, 15), _keys(rng, n)
    want = np.asarray(jax_ops.estimate(jnp.asarray(table), jnp.asarray(keys),
                                       use_pallas=use_pallas))
    got = port_ops.estimate(torch.from_numpy(table), torch.from_numpy(keys)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["pallas", "ref"])
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("m,n", [(1, 1), (1, 300), (64, 64), (300, 1), (300, 300)])
def test_update_estimate(width, m, n, use_pallas):
    rng = np.random.default_rng([width, m, n])
    table, upd, est = _table(rng, width, 12), _keys(rng, m), _keys(rng, n)
    want_t, want_v = jax_ops.update_estimate(jnp.asarray(table), jnp.asarray(upd),
                                             jnp.asarray(est), cap=15, use_pallas=use_pallas)
    got_t = torch.from_numpy(table.copy())
    same_t, got_v = port_ops.update_estimate(got_t, torch.from_numpy(upd), torch.from_numpy(est),
                                             cap=15)
    assert same_t is got_t  # updated in place
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("cap", [15, 255])
@pytest.mark.parametrize("distinct", [1, 3, 40])
def test_saturation_duplicate_heavy(cap, distinct):
    """Duplicate-heavy batches sum per cell and clamp at ``cap``, from an
    empty table and from one near ``cap``."""
    rng = np.random.default_rng([cap, distinct])
    keys = _keys(rng, 300, distinct=distinct)
    for table in (np.zeros((4, 512), np.int32),
                  rng.integers(cap - 3, cap + 1, (4, 512)).astype(np.int32)):
        for use_pallas in (True, False):
            want = np.asarray(jax_ops.update(jnp.asarray(table), jnp.asarray(keys), cap=cap,
                                             use_pallas=use_pallas))
            np.testing.assert_array_equal(_port_update(table, keys, cap), want)
        est_t, est_v = jax_ops.update_estimate(jnp.asarray(table), jnp.asarray(keys),
                                               jnp.asarray(keys[:7]), cap=cap, use_pallas=False)
        t = torch.from_numpy(table.copy())
        _, v = port_ops.update_estimate(t, torch.from_numpy(keys), torch.from_numpy(keys[:7]),
                                        cap=cap)
        np.testing.assert_array_equal(t.numpy(), np.asarray(est_t))
        np.testing.assert_array_equal(v.numpy(), np.asarray(est_v))
    top = np.unique(keys, return_counts=True)[1].max()
    assert min(cap, top) <= _port_update(np.zeros((4, 512), np.int32), keys, cap).max() <= cap


@pytest.mark.parametrize("width", WIDTHS)
def test_reset_halves_in_place(width):
    table = _table(np.random.default_rng(width), width, 255)
    want = np.asarray(jax_ops.reset(jnp.asarray(table)))
    t = torch.from_numpy(table.copy())
    assert port_ops.reset(t) is t
    np.testing.assert_array_equal(t.numpy(), want)


def test_make_table():
    t = port_ops.make_table(256, "cpu")
    assert t.shape == (4, 256) and t.dtype == torch.int32 and not t.any()
    np.testing.assert_array_equal(t.numpy(), np.asarray(jax_ops.make_table(256)))
    with pytest.raises(ValueError):
        port_ops.make_table(300, "cpu")


def test_empty_batches():
    table = torch.zeros((4, 128), dtype=torch.int32)
    none = torch.zeros(0, dtype=torch.int32)
    port_ops.update(table, none)
    assert not table.any()
    assert port_ops.estimate(table, none).shape == (0,)
    _, vals = port_ops.update_estimate(table, none, torch.tensor([5], dtype=torch.int32))
    assert vals.tolist() == [0]


def test_wrappers_check_their_inputs():
    table = torch.zeros((4, 128), dtype=torch.int32)
    keys = torch.zeros(3, dtype=torch.int32)
    bad = [
        (torch.zeros((4, 100), dtype=torch.int32), keys),  # width not a power of two
        (torch.zeros((3, 128), dtype=torch.int32), keys),  # rows != 4
        (torch.zeros((4, 128), dtype=torch.int64), keys),  # table dtype
        (torch.zeros((128, 4), dtype=torch.int32).t(), keys),  # not contiguous
        (table, keys.to(torch.int64)),  # key dtype
        (table, torch.zeros((2, 2), dtype=torch.int32)),  # key rank
    ]
    for t, k in bad:
        with pytest.raises(ValueError):
            port_cms.cms_update(t, k)
        with pytest.raises(ValueError):
            port_cms.cms_estimate(t, k)
    too_many = torch.zeros(port_cms.FUSED_MAX_UPDATES + 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most"):
        port_cms.cms_update_estimate(table, too_many, keys)


def test_cpu_wrappers_launch_nothing():
    port_cms.reset_launch_counts()
    table = torch.zeros((4, 128), dtype=torch.int32)
    keys = torch.arange(10, dtype=torch.int32)
    port_cms.cms_update(table, keys)
    port_cms.cms_estimate(table, keys)
    port_cms.cms_update_estimate(table, keys, keys)
    assert port_cms.launch_counts() == {
        "cms_update": 0, "cms_estimate": 0, "cms_update_estimate": 0}

