"""Continuous-batching scheduler: waiting queue -> running slots, with a
prefill token budget per step and preemption when the block pool runs dry.

The scheduler is pure bookkeeping (testable without tensors); the engine
drives it with real model calls. When constructed with a BlockPool it also
owns each request's *live* KV block allocation: blocks are acquired when a
request is picked for prefill and released exactly once on completion or
preemption (idempotent release — the preempt → resubmit → finish cycle can
never double-free or leak). The port's copy of the reference's
``repro/serving/scheduler.py``."""

from __future__ import annotations

import dataclasses
import math
from collections import deque

__all__ = ["Request", "Scheduler", "SchedulerConfig"]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list
    max_new_tokens: int
    # runtime state
    generated: list = dataclasses.field(default_factory=list)
    cached_tokens: int = 0
    state: str = "waiting"  # waiting | prefill | decode | done
    preemptions: int = 0
    block_ids: list = dataclasses.field(default_factory=list)  # live KV blocks

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_running: int = 8
    prefill_token_budget: int = 8192  # per scheduling step


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, pool=None, block_size: int = 16):
        self.cfg = cfg
        self.pool = pool  # optional BlockPool for live-KV accounting
        self.block_size = block_size
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self.finished: list[Request] = []
        self.alloc_failures = 0  # schedule() stalls on pool pressure

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -- live-KV block accounting -----------------------------------------
    def _blocks_needed(self, req: Request) -> int:
        return math.ceil((len(req.prompt) + req.max_new_tokens) / self.block_size)

    def _acquire_blocks(self, req: Request) -> bool:
        """Allocate the request's live KV blocks (idempotent: a request
        already holding blocks keeps them). Returns False on pool
        pressure — the caller leaves the request waiting."""
        if self.pool is None or req.block_ids:
            return True
        got = self.pool.alloc(self._blocks_needed(req))
        if got is None:
            return False
        req.block_ids = got
        return True

    def _release_blocks(self, req: Request) -> None:
        """Release the request's live blocks exactly once. Idempotent:
        ``block_ids`` is cleared before unref returns, so preempting an
        already-released request (or finishing a preempted one) is safe."""
        if self.pool is None or not req.block_ids:
            return
        ids, req.block_ids = req.block_ids, []
        self.pool.unref(ids)
        self.pool.check_invariants()

    def schedule(self) -> tuple[list[Request], list[Request]]:
        """One scheduling decision: returns (to_prefill, to_decode)."""
        budget = self.cfg.prefill_token_budget
        to_prefill = []
        while (
            self.waiting
            and len(self.running) + len(to_prefill) < self.cfg.max_running
            and budget >= len(self.waiting[0].prompt) - self.waiting[0].cached_tokens
        ):
            if not self._acquire_blocks(self.waiting[0]):
                self.alloc_failures += 1
                break  # pool pressure: leave it queued, try next step
            req = self.waiting.popleft()
            budget -= len(req.prompt) - req.cached_tokens
            req.state = "prefill"
            to_prefill.append(req)
        to_decode = [r for r in self.running if r.state == "decode"]
        return to_prefill, to_decode

    def on_prefilled(self, req: Request) -> None:
        req.state = "decode"
        self.running.append(req)

    def on_token(self, req: Request, token) -> None:
        req.generated.append(token)
        if req.done:
            req.state = "done"
            self.running.remove(req)
            self.finished.append(req)
            self._release_blocks(req)

    def preempt(self, req: Request) -> None:
        """Evict a running request back to the queue (block-pool pressure);
        its KV is dropped and will be recomputed (recompute-style preemption)."""
        req.state = "waiting"
        req.preemptions += 1
        req.generated.clear()
        req.cached_tokens = 0
        self.running.remove(req)
        self.waiting.appendleft(req)
        self._release_blocks(req)
