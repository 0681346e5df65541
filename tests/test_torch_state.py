"""State carried across: a reference run continues in the port, byte for byte.

The reference policy drives the first half of a trace. Its state is read
into the dict of ``repro_torch.state`` (``_torch_port.policy_state``, from
the reference objects' attributes) and loaded into a fresh port policy with
``load_reference_state``. Then both policies drive the second half: the hit
bitmaps, ``CacheStats`` and final states must be identical.
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
from repro_torch.state import export_state, load_reference_state

pytestmark = pytest.mark.usefixtures("torch_one_thread")


@pytest.fixture(scope="module")
def trace():
    return jax_traces.make_trace("msr2", seed=1, scale=0.003)


def _halves(trace):
    h = len(trace) // 2
    return trace.slice(h), jax_core.AccessTrace(trace.name, trace.keys[h:], trace.sizes[h:])


@pytest.mark.parametrize("spec", [
    "wtlfu-av-slru?sketch_backend=cms",
    "wtlfu-qv-sampled_frequency?sketch_backend=cms",
    "wtlfu-iv-lru?sketch_backend=cms&data_plane=scalar",
    "wtlfu-av-random?sketch_backend=cms&adaptive_window=1",
    "wtlfu-qv-sampled_size",  # host sketch: table, doorkeeper, _ops
])
def test_reference_state_continues_in_port(trace, spec):
    cap = int(trace.total_object_bytes * 0.01)
    first, second = _halves(trace)
    ref = jax_core.REGISTRY.build(spec, cap, expected_entries=64)
    if ref.sketch_backend == "cms":
        fast_jax_cms(ref.sketch)
    jax_core.SimulationEngine().run(ref, first)
    extra = 0
    if ref.sketch_backend == "cms":
        # a hit buffers an increment with no decision to flush it, so
        # pending increments are part of the state carried across
        sizes = ref.window if ref.window else ref.main.sizes
        key = next(iter(sizes))
        assert ref.access(key, sizes[key])
        extra = 1
    state = policy_state(ref)
    if ref.sketch_backend == "cms":
        assert len(state["sketch_pending"])

    sep = "&" if "?" in spec else "?"
    port = port_core.REGISTRY.build(f"{spec}{sep}device=cpu", cap, expected_entries=64)
    load_reference_state(port, state)
    assert_same_state(export_state(port), state)

    ref_hits, port_hits = jax_core.HitMaskRecorder(), port_core.HitMaskRecorder()
    jax_core.SimulationEngine(instruments=[ref_hits]).run(ref, second)
    port_core.SimulationEngine(instruments=[port_hits]).run(
        port, port_core.AccessTrace(second.name, second.keys, second.sizes))
    np.testing.assert_array_equal(port_hits.hits, ref_hits.hits)
    assert port.stats.accesses == len(trace) + extra
    assert_same_state(export_state(port), policy_state(ref))


def test_state_round_trips_within_the_port(trace):
    """export -> load into a fresh policy -> both continue identically."""
    spec = "wtlfu-av-sampled_frequency?sketch_backend=cms&device=cpu"
    cap = int(trace.total_object_bytes * 0.01)
    first, second = _halves(trace)
    second = port_core.AccessTrace(second.name, second.keys, second.sizes)
    a = port_core.REGISTRY.build(spec, cap, expected_entries=64)
    port_core.SimulationEngine().run(a, port_core.AccessTrace(first.name, first.keys, first.sizes))
    b = port_core.REGISTRY.build(spec, cap, expected_entries=64)
    load_reference_state(b, export_state(a))
    for p in (a, b):
        port_core.SimulationEngine().run(p, second)
    assert_same_state(export_state(a), export_state(b))


def test_mismatched_table_is_refused(trace):
    small = port_core.REGISTRY.build("wtlfu-av?sketch_backend=cms&device=cpu", 10**6,
                                     expected_entries=64)
    big = port_core.REGISTRY.build("wtlfu-av?sketch_backend=cms&device=cpu", 10**6,
                                   expected_entries=4096)
    with pytest.raises(ValueError, match="sketch table"):
        load_reference_state(small, export_state(big))
