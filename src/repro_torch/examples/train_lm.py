"""Train a reduced granite-family LM for a few hundred steps on synthetic
bigram data, with mid-run fault injection + checkpoint/restart, the port
of the reference's ``examples/train_lm.py``: the training substrate end
to end (optimizer, remat, supervisor, data) through
``repro_torch.launch.train.main``, which replays one CUDA graph of the
step on the card (kernel 6, ``flash_attention_fwd``, with its lse for the
backward).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.launch.train import main as train_main


def train_lm(device="cuda", steps: int = 200, save_every: int = 50,
             fail_at: int = 120):
    """The reference's run (``steps``, checkpoints every ``save_every``,
    one failure injected at ``fail_at``) on ``device``, in a temporary
    checkpoint directory: the Supervisor's ``RunResult``. Raises unless it
    restarted once and the loss fell."""
    ckpt = tempfile.mkdtemp(prefix="repro_torch_train_")
    try:
        res = train_main([
            "--arch", "granite-3-8b", "--smoke",
            "--steps", str(steps), "--batch", "16", "--seq", "64",
            "--d-model", "128", "--vocab", "256", "--n-repeat", "2",
            "--lr", "3e-3", "--ckpt-dir", ckpt,
            "--save-every", str(save_every), "--fail-at", str(fail_at),
            "--device", str(device),
        ])
        if res.restarts != 1:
            raise RuntimeError(f"fault injection should have fired once, "
                               f"restarts={res.restarts}")
        if not res.losses[-1] < res.losses[0]:
            raise RuntimeError(f"loss should decrease: {res.losses[0]} -> "
                               f"{res.losses[-1]}")
        print("train example OK (restarted once, loss decreased)")
        return res
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return train_lm(args.device)


if __name__ == "__main__":
    main()
