"""Admission hooks between the serving view and the admission policy.

The port's counterpart of the reference's ``repro/serving/admission.py``,
synchronous hook only. :class:`SyncAdmission` is the reference's blocking
hook: every lookup-touch and offer is a ``policy.access`` call and its
verdict is immediate. The reference's asynchronous pipeline
(``AsyncAdmissionPipeline``, ``admission="async"``) needs the
decision-batched device plane, which is not ported: asking for it raises
(ROADMAP queue 1, item 6).
"""

from __future__ import annotations

import time

import numpy as np

__all__ = ["AdmissionHook", "SyncAdmission", "make_admission_hook"]


class AdmissionHook:
    """Protocol between the serving view and the admission policy.

    ``touch``/``offer`` feed the policy's access stream; ``sync`` resolves
    everything and returns the offer verdicts accumulated since the last
    resolve as ``[(key, admitted)]`` in offer order. ``key in hook``
    queries post-resolve policy residency.
    """

    is_async = False

    def touch(self, key: int, size: int) -> None:
        raise NotImplementedError

    def offer(self, key: int, size: int) -> None:
        raise NotImplementedError

    def sync(self) -> list[tuple[int, bool]]:
        raise NotImplementedError

    @property
    def has_pending_offers(self) -> bool:
        return False

    def __contains__(self, key: int) -> bool:
        raise NotImplementedError

    # -- instrumentation (shared shape) -----------------------------------
    def latency_percentiles(self) -> dict:
        """p50/p99 admission-decision latency in milliseconds."""
        lat = self.decision_latencies
        if not lat:
            return {"decision_p50_ms": 0.0, "decision_p99_ms": 0.0}
        arr = np.asarray(lat, dtype=np.float64) * 1e3
        return {
            "decision_p50_ms": round(float(np.percentile(arr, 50)), 6),
            "decision_p99_ms": round(float(np.percentile(arr, 99)), 6),
        }


class SyncAdmission(AdmissionHook):
    """Blocking reference hook: one ``policy.access`` per event, verdict
    returned in line. Decision latency == the access call itself."""

    is_async = False

    def __init__(self, policy, clock=time.perf_counter):
        self.policy = policy
        self._clock = clock
        self.decision_latencies: list[float] = []
        self.events = 0

    def touch(self, key: int, size: int) -> None:
        self.events += 1
        self.policy.access(key, size)

    def offer(self, key: int, size: int) -> bool:
        self.events += 1
        t0 = self._clock()
        self.policy.access(key, size)
        admitted = key in self.policy
        self.decision_latencies.append(self._clock() - t0)
        return admitted

    def sync(self) -> list[tuple[int, bool]]:
        return []

    def __contains__(self, key: int) -> bool:
        return key in self.policy

    def metrics(self) -> dict:
        out = {"mode": "sync", "events": self.events,
               "max_queue_depth": 0, "mean_queue_depth": 0.0}
        out.update(self.latency_percentiles())
        return out


def make_admission_hook(policy, mode: str = "sync") -> AdmissionHook:
    """Build an admission hook over ``policy``. ``mode``: "sync" ("async"
    is not ported yet and raises)."""
    if mode == "sync":
        return SyncAdmission(policy)
    if mode == "async":
        raise NotImplementedError(
            'admission="async" needs the decision-batched device plane, which is not '
            "ported yet (ROADMAP queue 1, item 6)")
    raise ValueError(f"unknown admission mode: {mode!r} (want sync|async)")
