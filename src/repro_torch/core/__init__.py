"""The paper's primary contribution: size-aware cache admission policies,
on PyTorch.

Public surface (the counterparts of ``repro.core`` in the reference):

* :class:`SizeAwareWTinyLFU` — W-TinyLFU with IV / QV / AV size-aware
  admission (the paper, Section 4) over the seven Main-cache evictions.
  With ``sketch_backend="cms"`` every admission decision scores its victim
  set with one fused count-min-sketch kernel launch on the card.
* :data:`REGISTRY` / :class:`PolicySpec` — spec-driven construction:
  ``REGISTRY.build("wtlfu-av-slru?sketch_backend=cms", cap)`` builds the
  same policy the reference's registry builds from that string.
* :class:`SimulationEngine` — the trace-driven evaluation instrument
  (chunked streaming, warmup, snapshots, instruments).
"""

from __future__ import annotations

from .admission import (
    AdmissionPolicy,
    AVAdmission,
    IVAdmission,
    QVAdmission,
    make_admission,
)
from .cache_api import AccessTrace, CachePolicy, CacheStats
from .cms_sketch import CMSSketch
from .engine import (
    CapacityInvariant,
    HitMaskRecorder,
    Instrument,
    SimulationEngine,
    SimulationResult,
    StatsSnapshot,
)
from .eviction import make_eviction
from .registry import (
    REGISTRY,
    ParamSchema,
    PolicyRegistry,
    PolicySpec,
    available_policies,
    register_policy,
)
from .sketch import FrequencySketch
from .tinylfu import ADMISSIONS, EVICTIONS, SizeAwareWTinyLFU

__all__ = [
    "AccessTrace",
    "CachePolicy",
    "CacheStats",
    "CMSSketch",
    "FrequencySketch",
    "SizeAwareWTinyLFU",
    "REGISTRY",
    "PolicyRegistry",
    "PolicySpec",
    "ParamSchema",
    "register_policy",
    "available_policies",
    "SimulationEngine",
    "SimulationResult",
    "StatsSnapshot",
    "Instrument",
    "CapacityInvariant",
    "HitMaskRecorder",
    "AdmissionPolicy",
    "IVAdmission",
    "QVAdmission",
    "AVAdmission",
    "make_admission",
    "make_eviction",
    "ADMISSIONS",
    "EVICTIONS",
]
