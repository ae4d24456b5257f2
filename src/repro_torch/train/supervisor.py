"""Fault tolerance, the port of the reference's ``train/supervisor.py``:
restart from the last checkpoint, fault injection and straggler
detection, exercised in one process.

* ``Supervisor`` wraps a step function: on an (injected or real) failure
  it restores the latest checkpoint and replays, so the trainer's crash
  semantics are restart-idempotent.
* ``StragglerMonitor`` tracks step durations; a step above
  ``deadline_factor`` x the rolling median is flagged and counted.

Unlike the reference's, :meth:`Supervisor.run` joins the checkpoint
writers it started before it restores (then, with ``barrier``, waits for
every rank of a mesh program) and before it returns or raises:
a restart resumes from the last checkpoint saved, whatever the writers'
timing, and no writer is still in a directory its caller may remove. It
also drops the failed state before it restores the next.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.train import checkpoint as ckpt


class FaultInjector:
    """Deterministic fault schedule for tests: fail at given steps."""

    def __init__(self, fail_at: set[int] | None = None):
        self.fail_at = set(fail_at or ())
        self.fired: set[int] = set()

    def maybe_fail(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class StragglerMonitor:
    def __init__(self, window: int = 32, deadline_factor: float = 3.0):
        self.durations: deque[float] = deque(maxlen=window)
        self.deadline_factor = deadline_factor
        self.stragglers = 0

    def observe(self, dt: float) -> bool:
        flagged = False
        if len(self.durations) >= 8:
            med = float(np.median(self.durations))
            if dt > self.deadline_factor * med:
                self.stragglers += 1
                flagged = True
        self.durations.append(dt)
        return flagged


@dataclasses.dataclass
class RunResult:
    steps_done: int
    restarts: int
    stragglers: int
    losses: list


class Supervisor:
    """Checkpoints every ``save_every`` steps and after the last (none
    with ``save_every=0``: a restart then replays from step 0)."""

    def __init__(self, ckpt_dir: str, *, save_every: int = 10,
                 max_restarts: int = 10,
                 injector: Optional[FaultInjector] = None,
                 barrier: Optional[Callable[[], None]] = None):
        self.ckpt_dir = ckpt_dir
        self.save_every = save_every
        self.max_restarts = max_restarts
        self.injector = injector or FaultInjector()
        self.restarts = 0
        # ranks of one program over a mesh: after its own writers, each
        # waits for every rank's before a restore reads the checkpoints
        self.barrier = barrier

    def run(self, *, init_state: Callable[[], object], step_fn: Callable,
            n_steps: int) -> RunResult:
        """Run ``n_steps`` of ``step_fn(state, step) -> (state, metrics)``
        with checkpoints and restarts; ``state`` is a tree of tensors. At
        each start the latest checkpoint, if any, is copied into
        ``init_state()``'s tensors in place (``checkpoint.restore``): an
        ``init_state`` that hands back the same tensors every time (a
        trainer whose step is a CUDA graph over them) keeps them."""
        monitor = StragglerMonitor()
        losses = []
        writers = []
        try:
            while True:
                last = ckpt.latest_step(self.ckpt_dir)
                if last is not None:
                    state, extra = ckpt.restore(self.ckpt_dir, last,
                                                init_state())
                    start = int(extra.get("next_step", last))
                else:
                    state = init_state()
                    start = 0
                try:
                    for step in range(start, n_steps):
                        self.injector.maybe_fail(step)
                        t0 = time.monotonic()
                        state, metrics = step_fn(state, step)
                        monitor.observe(time.monotonic() - t0)
                        if metrics and "loss" in metrics:
                            losses.append(float(metrics["loss"]))
                        if self.save_every and (
                                (step + 1) % self.save_every == 0
                                or step == n_steps - 1):
                            th = ckpt.save(self.ckpt_dir, step + 1, state,
                                           extra={"next_step": step + 1},
                                           async_write=True)
                            if th is not None:   # this rank writes
                                writers.append(th)
                    return RunResult(steps_done=n_steps,
                                     restarts=self.restarts,
                                     stragglers=monitor.stragglers,
                                     losses=losses)
                except RuntimeError:
                    self.restarts += 1
                    if self.restarts > self.max_restarts:
                        raise
                    # the failed state goes before its replacement is made
                    # (a step that ran out of device memory would run out
                    # again at restore beside it)
                    state = None
                    # restore the latest checkpoint and replay; the writes
                    # in flight land first, so the restart point does not
                    # depend on the writers' timing
                    for th in writers:
                        th.join()
                    if self.barrier is not None:
                        self.barrier()
        finally:
            for th in writers:
                th.join()
