"""Trace substrate: seeded synthetic generators calibrated to the paper's
trace classes (Table 1 / Fig. 8) and workload-shift stress traces."""

from .synthetic import (
    SHIFT_SPECS,
    TRACE_SPECS,
    ShiftSpec,
    TraceSpec,
    make_trace,
    paper_traces,
    shift_boundaries,
)

__all__ = [
    "make_trace",
    "paper_traces",
    "TRACE_SPECS",
    "TraceSpec",
    "SHIFT_SPECS",
    "ShiftSpec",
    "shift_boundaries",
]
