"""Batched device-CMS frequency sketch backend for W-TinyLFU.

The counterpart of the reference's ``repro/core/cms_sketch.py``, over the
Hopper count-min-sketch kernels of :mod:`repro_torch.kernels.cms` (their
plain PyTorch versions for a CPU table). The sketch is *non-conservative*
(no minimal-increment, no doorkeeper), which buys an exactness property the
batching relies on:

    saturating non-conservative increments commute — applying a batch of
    keys in one kernel call yields the same table as applying them one at
    a time, in any order.

So :class:`CMSSketch` buffers ``increment`` calls and flushes them lazily,
*just before the next estimate*: every estimate observes exactly the
increments that precede it in access order, and scalar and batched driving
of a policy make byte-identical admission decisions.

Aging follows the TinyLFU reset rule (paper §3): after every
``sample_factor * expected_entries`` increments all counters are halved;
flushes are split at reset boundaries so the halving lands at the same
access index as it would scalar-by-scalar (:func:`plan_flush`).

On a CUDA table with the kernels, every ``estimate_batch`` and ``flush`` is
one C call through the sketch's pinned staging buffers
(:class:`repro_torch.kernels.cms.cms.Staging`): the same launches, in the
same order, as the tensor wrappers would make, with no tensor made per
call. A CPU table, or ``use_kernel=False``, runs the plain versions through
the tensor ops.

Keys are int64 (trace ids reach 2**40) and are truncated to int32 before
hashing, exactly as the reference does, so both packages hash the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.cms import ops
from repro_torch.kernels.cms.cms import FUSED_MAX_UPDATES, Staging
from repro_torch.kernels.cms.ref import ROWS

__all__ = ["CMSSketch", "plan_flush", "resolve_device"]


def resolve_device(device: "torch.device | str") -> torch.device:
    """The device a policy or sketch runs on. A CUDA device on a machine
    without CUDA raises: nothing falls back to the CPU unless asked."""
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def plan_flush(pending: int, ops: int, sample_size: int,
               flush_block: int) -> tuple[list[tuple[int, bool]], int]:
    """How a flush of ``pending`` buffered increments is cut, from ``ops``
    flushed increments in the current sample: the steps ``[(take, reset),
    ...]``, each one kernel update of the next ``take`` keys followed, where
    ``reset``, by the aging reset; and ``ops`` after the flush. A step ends
    at ``flush_block`` keys or where the sample fills, so each halving lands
    at the same access as it would scalar by scalar. One step with no reset
    is what the fused update + estimate takes."""
    steps = []
    while pending > 0:
        take = min(pending, sample_size - ops, flush_block)
        pending -= take
        ops += take
        reset = ops >= sample_size
        if reset:
            ops //= 2
        steps.append((take, reset))
    return steps, ops


class CMSSketch:
    """Drop-in ``increment``/``estimate`` sketch backed by the batched CMS
    kernels, plus ``estimate_batch`` for one-call victim-set scoring.

    Parameters
    ----------
    expected_entries: sizing hint; row width is the next power of two
        (min 128, as in the reference).
    cap: counter saturation value.
    sample_factor: reset period = ``sample_factor * expected_entries``.
    use_kernel: the counterpart of the reference's ``use_pallas``. ``None``
        launches the Hopper kernels on a CUDA device and runs their plain
        versions on the CPU; ``False`` runs the plain versions on either.
    flush_block: max keys per kernel update call (the reference bounds its
        ``[ROWS, N, width]`` one-hot with it; here it also bounds the fused
        kernel's one CTA). Sub-batching does not change results.
    device: where the table lives; ``"cuda"`` unless the caller asks for
        the CPU.
    """

    #: One kernel call scores a whole batch: the admission plane's "auto"
    #: mode picks the batched data plane for this backend.
    batched_native = True

    def __init__(
        self,
        expected_entries: int,
        *,
        cap: int = 15,
        sample_factor: int = 10,
        use_kernel: bool | None = None,
        flush_block: int = 512,
        device: "torch.device | str" = "cuda",
    ):
        self.device = resolve_device(device)
        if use_kernel and self.device.type != "cuda":
            raise ValueError("use_kernel=True needs a CUDA device")
        if not 0 < flush_block <= FUSED_MAX_UPDATES:
            raise ValueError(f"flush_block must be in [1, {FUSED_MAX_UPDATES}]")
        self.use_kernel = use_kernel
        expected_entries = max(16, int(expected_entries))
        width = 128
        while width < expected_entries:
            width <<= 1
        self.width = width
        self.rows = ROWS
        self.cap = int(cap)
        self.flush_block = int(flush_block)
        self.sample_size = sample_factor * expected_entries
        self.table = ops.make_table(width, self.device)
        self.resets = 0
        self._ops = 0  # flushed increments within the current sample
        self._pending: list[int] = []
        self._staging = (Staging(self.table)
                         if self.table.is_cuda and use_kernel is not False else None)

    def _keys(self, keys) -> torch.Tensor:
        """int64 keys -> int32 (truncating, as the reference) on the device."""
        arr = np.asarray(keys, dtype=np.int64).astype(np.int32)
        return torch.from_numpy(arr).to(self.device)

    def _take_pending(self) -> tuple[list[int], list[tuple[int, bool]]]:
        """Empties the buffer; returns its keys and their flush plan, whose
        count and resets are booked now."""
        pending, self._pending = self._pending, []
        steps, self._ops = plan_flush(len(pending), self._ops, self.sample_size, self.flush_block)
        self.resets += sum(reset for _, reset in steps)
        return pending, steps

    def _flush_tensors(self, pending: list[int], steps) -> None:
        pos = 0
        for take, reset in steps:
            ops.update(self.table, self._keys(pending[pos : pos + take]), cap=self.cap,
                       use_kernel=self.use_kernel)
            pos += take
            if reset:
                ops.reset(self.table)

    # -- batched data plane ------------------------------------------------
    def flush(self) -> None:
        """Apply buffered increments in batched kernel calls, splitting at
        aging-reset boundaries so reset timing matches scalar driving."""
        if not self._pending:
            return
        pending, steps = self._take_pending()
        if self._staging is not None:
            self._staging.flush(self.table, self.cap, pending, steps)
        else:
            self._flush_tensors(pending, steps)

    # -- FrequencySketch-compatible control plane --------------------------
    def increment(self, key: int) -> None:
        """Record one occurrence (buffered; flushed before the next estimate)."""
        self._pending.append(key)

    def increment_batch(self, keys) -> None:
        """Record a whole chunk of occurrences (buffered)."""
        self._pending.extend(np.asarray(keys, dtype=np.int64).tolist())

    def estimate(self, key: int) -> int:
        return int(self.estimate_batch(np.asarray([key], dtype=np.int64))[0])

    def estimate_batch(self, keys) -> np.ndarray:
        """Frequency estimates for ``keys`` — the data plane's single scoring
        entry point. When increments are pending and fit one sub-batch with no
        aging reset due, the flush and the scoring run as ONE fused kernel
        launch (update + estimate-on-updated-table); otherwise the staged
        flush runs first and a plain estimate follows."""
        if not isinstance(keys, (list, tuple, np.ndarray)):
            # e.g. the admission plane's lazy victim-prefix view: a device
            # sketch scores the whole prefix eagerly in its one kernel call
            keys = list(keys)
        pending, steps = self._take_pending()
        fused = len(steps) == 1 and not steps[0][1]
        if self._staging is not None:
            if fused:
                return self._staging.update_estimate(self.table, self.cap, pending, keys)
            return self._staging.estimate(self.table, self.cap, pending, keys, steps)
        if fused:
            # one host->device copy carries both key sets
            n = len(pending)
            both = self._keys(np.concatenate([np.asarray(pending, dtype=np.int64),
                                              np.asarray(keys, dtype=np.int64)]))
            _, vals = ops.update_estimate(self.table, both[:n], both[n:], cap=self.cap,
                                          use_kernel=self.use_kernel)
            return vals.cpu().numpy()
        self._flush_tensors(pending, steps)
        return ops.estimate(self.table, self._keys(keys), use_kernel=self.use_kernel).cpu().numpy()
