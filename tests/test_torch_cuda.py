"""The port's Hopper kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false (the kernels have no CPU or
interpret mode). The file imports neither JAX nor the reference package,
so it runs on a machine with a card and PyTorch alone:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core import REGISTRY, HitMaskRecorder, SimulationEngine
from repro_torch.kernels.cms import cms
from repro_torch.state import export_state
from repro_torch.traces import make_trace

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _keys(rng, n, distinct=None):
    if distinct:
        return rng.integers(-2**31, 2**31, distinct)[rng.integers(0, distinct, n)].astype(np.int32)
    return rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("width", (128, 1024, 1 << 16))
def test_kernels_match_plain(cuda_device, width):
    """Each kernel equals its plain version on the card, byte for byte."""
    rng = np.random.default_rng(width)
    for cap in (15, 255):
        table = torch.from_numpy(rng.integers(0, cap + 1, (4, width), dtype=np.int32)).to(cuda_device)
        upd = torch.from_numpy(_keys(rng, 512, distinct=40)).to(cuda_device)
        est = torch.from_numpy(_keys(rng, 33)).to(cuda_device)
        a, b = table.clone(), table.clone()
        cms.cms_update(a, upd, cap=cap)
        cms.cms_update(b, upd, cap=cap, use_kernel=False)
        assert torch.equal(a, b)
        assert torch.equal(cms.cms_estimate(a, est), cms.cms_estimate(a, est, use_kernel=False))
        va = cms.cms_update_estimate(a, upd, est, cap=cap)
        vb = cms.cms_update_estimate(b, upd, est, cap=cap, use_kernel=False)
        assert torch.equal(a, b) and torch.equal(va, vb)
    torch.cuda.synchronize()


@pytest.mark.parametrize("spec", ["wtlfu-av-sampled_frequency?sketch_backend=cms",
                                  "wtlfu-qv-slru?sketch_backend=cms"])
def test_main_path_kernels_equal_plain_and_cpu(cuda_device, spec):
    """The policy on the card through the kernels == through their plain
    versions on the card == on the CPU; every kernel was launched."""
    trace = make_trace("msr2", scale=0.003)
    cap = int(trace.total_object_bytes * 0.01)
    runs = []
    cms.reset_launch_counts()
    for kw in ({}, {"sketch_kwargs": {"use_kernel": False}}, {"device": "cpu"}):
        policy = REGISTRY.build(spec, cap, expected_entries=64, **kw)
        rec = HitMaskRecorder()
        SimulationEngine(instruments=[rec]).run(policy, trace)
        runs.append((policy.stats.hits, policy.stats.admissions, rec.hits, export_state(policy)))
        if not kw:
            counts = cms.launch_counts()
    assert all(v > 0 for v in counts.values()), counts
    assert cms.launch_counts() == counts  # the plain runs launched nothing
    for hits, admissions, bitmap, state in runs[1:]:
        assert (hits, admissions) == runs[0][:2]
        np.testing.assert_array_equal(bitmap, runs[0][2])
        for k, v in state.items():
            assert np.array_equal(v, runs[0][3][k]) if isinstance(v, np.ndarray) else v == runs[0][3][k]
