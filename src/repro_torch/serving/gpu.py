"""Accelerator model for the serving engine: processor-sharing lanes with
an MPS-style asymmetric static partition (paper §4.4, Fig 6).

TPU adaptation (DESIGN.md §3): the coarse 80/20 CUDA-MPS split becomes a
token-budget split of one chip's serving capacity; the fine-grained
guardrail (agent queue served exhaustively, judge only when the agent has
spare slots) is the same policy, expressed in the engine's dispatcher.

Each lane is a processor-sharing server: n active jobs each progress at
min(v1, capacity/n) token-equivalents per second — capturing both the
single-stream decode speed ceiling and the aggregate batched throughput of
continuous batching.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Callable, Optional


@dataclasses.dataclass
class Job:
    jid: int
    tokens: float          # remaining token-equivalents
    callback: Callable     # fn(now) fired at completion
    enqueued: float = 0.0
    started: float = 0.0


class PSLane:
    """Processor-sharing lane with single-stream cap and slot limit."""

    def __init__(self, capacity: float, v1: float, slots: int = 64):
        self.capacity = capacity
        self.v1 = v1
        self.slots = slots
        self.active: dict[int, Job] = {}
        # FIFO admission queue: deque so the promote-side popleft is O(1)
        self.queue: collections.deque[Job] = collections.deque()
        self.t_last = 0.0
        self.version = 0
        self._ids = itertools.count()
        self.busy_tokens = 0.0  # processed token-equivalents (utilisation)

    def _running(self) -> list:
        return [j for j in self.active.values() if j.tokens > 1e-9]

    def _rate(self) -> float:
        n = len(self._running())
        if n == 0:
            return 0.0
        return min(self.v1, self.capacity / n)

    def advance(self, now: float) -> None:
        """Piecewise-exact processor sharing: within [t_last, now] the rate
        redistributes at every internal job completion, so work accounting
        is exact even when completions aren't reaped promptly."""
        while now > self.t_last:
            running = self._running()
            if not running:
                break
            r = min(self.v1, self.capacity / len(running))
            rem_min = min(j.tokens for j in running)
            t_next = self.t_last + rem_min / r
            t_step = min(now, t_next)
            dt = t_step - self.t_last
            for j in running:
                j.tokens -= r * dt
            self.busy_tokens += r * dt * len(running)
            self.t_last = t_step
        self.t_last = max(self.t_last, now)

    def submit(self, now: float, tokens: float, callback) -> int:
        self.advance(now)
        jid = next(self._ids)
        job = Job(jid, tokens, callback, enqueued=now)
        if len(self.active) < self.slots:
            job.started = now
            self.active[jid] = job
        else:
            self.queue.append(job)
        self.version += 1
        return jid

    def _promote(self, now: float) -> None:
        while self.queue and len(self.active) < self.slots:
            job = self.queue.popleft()
            job.started = now
            self.active[job.jid] = job

    def next_completion(self) -> Optional[float]:
        if not self.active:
            return None
        if any(j.tokens <= 1e-9 for j in self.active.values()):
            return self.t_last  # finished-but-unreaped: fire immediately
        r = self._rate()
        rem = min(j.tokens for j in self.active.values())
        return self.t_last + max(rem, 0.0) / r

    def complete_due(self, now: float) -> list[Job]:
        """Advance to `now`, pop every finished job, promote queue."""
        self.advance(now)
        done = [j for j in self.active.values() if j.tokens <= 1e-9]
        for j in done:
            del self.active[j.jid]
        if done:
            self._promote(now)
            self.version += 1
        return done

    @property
    def n_active(self) -> int:
        return len(self.active)

    @property
    def n_waiting(self) -> int:
        return len(self.queue)


@dataclasses.dataclass
class GPUConfig:
    capacity: float = 3000.0   # aggregate token-eq/s (continuous batching)
    v1: float = 800.0          # single-stream token-eq/s
    agent_share: float = 0.8   # MPS-style static partition
    judge_share: float = 0.2
    agent_slots: int = 48
    judge_slots: int = 16
    colocated: bool = True     # False = judge on its own dedicated chip


class GPU:
    def __init__(self, cfg: GPUConfig):
        self.cfg = cfg
        if cfg.colocated:
            self.agent = PSLane(
                cfg.capacity * cfg.agent_share, cfg.v1, cfg.agent_slots
            )
            self.judge = PSLane(
                cfg.capacity * cfg.judge_share, cfg.v1, cfg.judge_slots
            )
            self.n_chips = 1
        else:
            self.agent = PSLane(cfg.capacity, cfg.v1, cfg.agent_slots)
            self.judge = PSLane(cfg.capacity, cfg.v1, cfg.judge_slots)
            self.n_chips = 2

    def rebalance(self, now: float) -> bool:
        """Work-conserving co-location (the TPU time-multiplexing model,
        DESIGN.md §3): the agent reclaims the judge's share whenever the
        judge lane is idle; the static 80/20 split is the floor the judge
        is guaranteed when busy. Returns True if capacities changed."""
        if not self.cfg.colocated:
            return False
        want = self.cfg.capacity * (
            self.cfg.agent_share if self.judge.n_active else 1.0
        )
        if abs(want - self.agent.capacity) < 1e-9:
            return False
        self.agent.advance(now)
        self.agent.capacity = want
        self.agent.version += 1
        return True

    def occupancy(self) -> dict:
        """Instantaneous lane-occupancy gauges (DESIGN.md §16): active
        jobs, admission-queue depth, and active-slot utilisation per
        lane. Pure reads — safe from the telemetry sampler."""
        return {
            "agent_active": self.agent.n_active,
            "agent_waiting": self.agent.n_waiting,
            "agent_util": self.agent.n_active / self.agent.slots,
            "judge_active": self.judge.n_active,
            "judge_waiting": self.judge.n_waiting,
            "judge_util": self.judge.n_active / self.judge.slots,
        }

    def judge_admission_ok(self) -> bool:
        """Fine-grained guardrail: defer judge work while the agent lane is
        saturated (queue backed up behind full slots)."""
        if not self.cfg.colocated:
            return True
        return self.agent.n_waiting == 0


def judge_batch_tokens(base: float, m: int, marginal: float) -> float:
    """Token cost of a judge micro-batch of m requests (paper §4.4).

    Judge jobs are prefill-only classifications over near-identical
    prompts; co-batching them into one accelerator launch shares the
    instruction/prompt prefill, so request 2..m each pay only a
    ``marginal`` fraction of the base cost. m=1 degenerates to the
    unbatched cost."""
    if m <= 0:
        return 0.0
    return base * (1.0 + marginal * (m - 1))
