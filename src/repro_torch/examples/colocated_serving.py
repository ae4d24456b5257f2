"""Real co-located serving, the port of the reference's
``examples/colocated_serving.py``: a reduced agent LM decodes batched
requests through the continuous-batching runtime while the (real, tiny)
semantic judge cross-encoder executes between decode ticks under the
paper's priority rule (Cortex §4.4). On the card the batcher replays one
CUDA graph of its decode step (kernel 7, ``decode_attention``) and the
judge one of its score (kernel 6, ``flash_attention_fwd``).

Run:  PYTHONPATH=src python -m repro_torch.examples.colocated_serving [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, shrink
from repro_torch.core.judge import ModelJudge
from repro_torch.device import resolve_device
from repro_torch.examples import printer
from repro_torch.serving.generator import ContinuousBatcher, GenRequest

PAIRS = ([f"query {i}" for i in range(4)], [f"cached {i}" for i in range(4)])


def agent_config():
    return shrink(get_config("search-r1-7b"), d_model=128, vocab=512,
                  n_repeat=2)


def colocated(device="cuda", n_requests: int = 10, params=None,
              judge=None) -> tuple[list[str], list[GenRequest],
                                   ContinuousBatcher]:
    """Serve ``n_requests`` seeded requests on the shrunk agent
    (``params``: its parameters, seeded by the batcher when None) with
    ``judge`` (a ``ModelJudge``, made on ``device`` when None) scoring
    between ticks: ``(lines, requests, batcher)``, the lines printed.
    Raises unless every request was served and a judge batch ran."""
    lines, say = printer()

    judge = judge or ModelJudge(device=device)
    judge_scores = []

    def judge_batch():
        judge_scores.append(judge.score_pairs(*PAIRS).mean())

    cb = ContinuousBatcher(agent_config(), params, slots=4, max_len=96,
                           judge=judge_batch, device=device)
    rng = np.random.default_rng(0)
    reqs = [
        GenRequest(i, rng.integers(1, 512, size=int(rng.integers(4, 12))),
                   max_new=8)
        for i in range(n_requests)
    ]
    for r in reqs:
        cb.submit(r)

    t0 = time.perf_counter()
    ticks = cb.run()
    dt = time.perf_counter() - t0
    done = sum(r.done for r in reqs)
    say(f"served {done}/{len(reqs)} requests in {ticks} ticks "
        f"({cb.decode_steps} batched decode steps) in {dt:.2f}s")
    say(f"judge batches interleaved (priority rule): {cb.judge_batches_run}")
    say(f"sample generation (req 0): {reqs[0].out_tokens}")
    if done != len(reqs) or cb.judge_batches_run == 0:
        raise RuntimeError(f"served {done}/{len(reqs)}, "
                           f"{cb.judge_batches_run} judge batches")
    say("CO-LOCATED SERVING OK")
    return lines, reqs, cb


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return colocated(resolve_device(args.device))


if __name__ == "__main__":
    main()
