"""The slice as a whole: the same spec through both registries, byte for byte.

``SimulationEngine.run`` drives the reference policy and the port's (with
``device=cpu``) over the same trace. ``CacheStats``, the per-access hit
bitmap, the final window and Main contents in order, the sketch table,
``_ops``, ``resets`` and the pending increments must all be equal. The
reference's CMS sketch runs through ``_torch_port.fast_jax_cms`` (see
there why, and why that leaves the reference's semantics untouched).
"""

import numpy as np
import pytest
from _torch_port import (  # noqa: F401  (fixture)
    assert_same_state,
    fast_jax_cms,
    policy_state,
    torch_one_thread,
)

import repro.core as jax_core
import repro.traces as jax_traces
import repro_torch.core as port_core
import repro_torch.traces as port_traces
from repro_torch.core.tinylfu import EVICTIONS

ADMISSIONS = ("iv", "qv", "av")

pytestmark = pytest.mark.usefixtures("torch_one_thread")


def _trace(name, scale):
    return jax_traces.make_trace(name, scale=scale)


def _sizing(trace, frac=0.01):
    """Capacity and ``expected_entries`` by the benchmarks' rule."""
    cap = int(trace.total_object_bytes * frac)
    return cap, max(64, int(cap / max(1.0, trace.mean_object_size)))


def run_both(spec, trace, *, frac=0.01, **engine_kw):
    """Drive ``spec`` through both packages; assert the runs are identical.
    Returns the port's policy."""
    cap, ee = _sizing(trace, frac)
    ref = jax_core.REGISTRY.build(spec, cap, expected_entries=ee)
    if ref.sketch_backend == "cms":
        fast_jax_cms(ref.sketch)
    sep = "&" if "?" in spec else "?"
    port = port_core.REGISTRY.build(f"{spec}{sep}device=cpu", cap, expected_entries=ee)
    ref_hits, port_hits = jax_core.HitMaskRecorder(), port_core.HitMaskRecorder()
    ref_res = jax_core.SimulationEngine(instruments=[ref_hits], **engine_kw).run(ref, trace)
    port_trace = port_core.AccessTrace(trace.name, trace.keys, trace.sizes)
    port_res = port_core.SimulationEngine(instruments=[port_hits], **engine_kw).run(port, port_trace)
    assert port_res.data_plane == ref_res.data_plane
    assert port_res.used_batch == ref_res.used_batch
    np.testing.assert_array_equal(port_hits.hits, ref_hits.hits)
    for a, b in ((port_res.stats, ref_res.stats), (port_res.warmup_stats, ref_res.warmup_stats)):
        if b is not None:
            da, db = a.as_dict(), b.as_dict()
            da.pop("wall_seconds"), db.pop("wall_seconds")
            assert da == db
    assert [vars(s) for s in port_res.snapshots] == [vars(s) for s in ref_res.snapshots]
    assert_same_state(policy_state(port), policy_state(ref))
    return port


@pytest.fixture(scope="module")
def msr2():
    return _trace("msr2", 0.003)


@pytest.mark.parametrize("eviction", EVICTIONS)
@pytest.mark.parametrize("admission", ADMISSIONS)
def test_every_combo_on_cms(msr2, admission, eviction):
    port = run_both(f"wtlfu-{admission}-{eviction}?sketch_backend=cms", msr2)
    assert port.data_plane == "batched" and port.sketch.resets > 0
    assert port.stats.admissions and port.stats.rejections


@pytest.mark.parametrize("eviction", ["slru", "sampled_frequency"])
@pytest.mark.parametrize("admission", ADMISSIONS)
@pytest.mark.parametrize("name", ["cdn1", "tencent1"])
def test_other_trace_classes(name, admission, eviction):
    run_both(f"wtlfu-{admission}-{eviction}?sketch_backend=cms", _trace(name, 0.001))


def test_adaptive_window(msr2):
    port = run_both("wtlfu-av-sampled_frequency?sketch_backend=cms&adaptive_window=1", msr2)
    assert port.window_cap != max(1, int(port.capacity * 0.01))  # the climber moved


@pytest.mark.parametrize("spec", ["wtlfu-iv-slru", "wtlfu-qv-sampled_frequency",
                                  "wtlfu-av-random?early_pruning=0"])
def test_scalar_plane_on_cms(msr2, spec):
    sep = "&" if "?" in spec else "?"
    port = run_both(f"{spec}{sep}sketch_backend=cms&data_plane=scalar", msr2)
    assert port.data_plane == "scalar"


@pytest.mark.parametrize("spec", ["wtlfu-av", "wtlfu-qv-lru", "wtlfu-iv-sampled_size",
                                  "wtlfu-av-sampled_frequency?data_plane=batched"])
def test_host_sketch_backend(msr2, spec):
    port = run_both(spec, msr2)
    assert port.sketch_backend == "host"


def test_warmup_snapshots_and_scalar_drive(msr2):
    run_both("wtlfu-qv-sampled_frequency_size?sketch_backend=cms", msr2,
             chunk_size=333, warmup=500, snapshot_every=700)
    run_both("wtlfu-av-slru?sketch_backend=cms", msr2, use_batch=False)


@pytest.mark.parametrize("name", sorted(jax_traces.TRACE_SPECS) + sorted(jax_traces.SHIFT_SPECS))
def test_make_trace_byte_identical(name):
    ref = jax_traces.make_trace(name, seed=3, scale=0.002)
    port = port_traces.make_trace(name, seed=3, scale=0.002)
    assert port.name == ref.name
    for a, b in ((port.keys, ref.keys), (port.sizes, ref.sizes)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    if name in jax_traces.SHIFT_SPECS:
        assert (port_traces.shift_boundaries(name, scale=0.002)
                == jax_traces.shift_boundaries(name, scale=0.002))


README_SPECS = [
    "wtlfu-av-slru?window_frac=0.05&early_pruning=0",
    "wtlfu-av-random?seed=7",
    "wtlfu-av-random?seed=0x5EED",
    "wtlfu-qv-sampled_frequency?data_plane=device",
    "wtlfu-av-slru?data_plane=device&window_frac=0.05",
    "wtlfu-qv-sampled_frequency?data_plane=device_batched&chunk=64",
    "wtlfu-iv-random?data_plane=device_batched&chunk=16&seed=0xA11CE",
    "wtlfu-av-slru?data_plane=device_full&chunk=64",
    "wtlfu-av?early_pruning=0",
    "wtlfu-av-sampled_frequency?sketch_backend=cms",
    "wtlfu-av-slru?sketch_backend=cms&device=cpu",
]


@pytest.mark.parametrize("text", README_SPECS)
def test_policy_spec_round_trip(text):
    ref, port = jax_core.PolicySpec.parse(text), port_core.PolicySpec.parse(text)
    assert (port.name, port.params) == (ref.name, ref.params)
    assert port.to_string() == ref.to_string()
    assert port_core.PolicySpec.parse(port.to_string()) == port


def test_registry_lists_the_same_wtlfu_variants():
    ref = [n for n in jax_core.available_policies(expand=True) if n.startswith("wtlfu")]
    assert list(port_core.available_policies(expand=True)) == ref
    assert port_core.REGISTRY is not jax_core.REGISTRY


@pytest.mark.parametrize("plane", ["device", "device_batched", "device_full"])
def test_device_planes_not_yet_ported(plane):
    with pytest.raises(ValueError, match="not yet ported"):
        port_core.REGISTRY.build(f"wtlfu-av?data_plane={plane}&device=cpu", 10_000)
