"""The trainer, the port of the reference's ``launch/train.py``: any
registered architecture (shrunk with ``--smoke``, or at its published
widths), synthetic bigram data, AdamW, remat, microbatching,
checkpoint/restart through the Supervisor, optional fault injection.

CPU example (a few minutes):
  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \\
      --smoke --device cpu --steps 20

On one GPU (the default device) a published config trains at its widths;
``--n-repeat`` cuts its depth to the superblock repeats that fit the card
(with ``--smoke`` it is the shrunk config's depth, 2 by default, as in the
reference). ``--mesh single|multi`` (the reference's production meshes)
raises: training over several GPUs waits for the multi-GPU work (ROADMAP
'Open items', item 6); ``launch/dryrun.py`` runs the sharded step on a
fake process group.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import get_config, shrink
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import LM
from repro_torch.nn.param import init_params
from repro_torch.train.data import BigramStream
from repro_torch.train.optim import AdamWConfig, init_state
from repro_torch.train.supervisor import FaultInjector, Supervisor

MULTI_GPU = "ROADMAP 'Open items', item 6: work over several GPUs"


def build(args):
    """``(cfg, lm, opt_cfg, step)`` for parsed ``args``: the step updates
    its parameters and optimizer state in place, as the reference's
    trainer donates them to its jitted step."""
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: training over a device mesh needs several "
            f"GPUs ({MULTI_GPU}); the dry run (launch/dryrun.py) runs the "
            f"sharded step on a fake process group")
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = shrink(cfg, d_model=args.d_model, vocab=args.vocab,
                     n_repeat=2 if args.n_repeat is None else args.n_repeat)
    elif args.n_repeat is not None:
        cfg = dataclasses.replace(cfg, n_repeat=args.n_repeat)
    lm = LM(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, remat=args.remat,
                           microbatches=args.microbatches, donate=True)
    return cfg, lm, opt_cfg, step


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink to a CPU-feasible same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--n-repeat", type=int, default=None,
                    help="superblock repeats (--smoke: default 2; else "
                         "the published depth)")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--save-every", type=int, default=25,
                    help="checkpoint period in steps (0: no checkpoints)")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[],
                    help="inject node failures at these steps")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, data=None):
    """Train as the arguments say and return the Supervisor's
    ``RunResult``. ``data(step)`` gives a step's ``{"tokens", "labels"}``
    (numpy arrays); by default the bigram stream's batch."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg, lm, opt_cfg, step_fn_ = build(args)
    stream = BigramStream(cfg.vocab_size, seed=args.seed)
    if data is None:
        data = lambda step: stream.batch(step, args.batch, args.seq)
    print(f"arch={cfg.name} layers={cfg.n_layers} vocab={cfg.vocab_size}")

    def init_state_fn():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(lm.param_specs(), gen, dev)
        return {"params": params, "opt": init_state(opt_cfg, params)}

    t_step = [time.monotonic()]

    def step_fn(state, step):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data(step).items()}
        params, opt, metrics = step_fn_(state["params"], state["opt"], batch)
        loss = float(metrics["loss"])
        dt = time.monotonic() - t_step[0]
        t_step[0] = time.monotonic()
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} {dt:.2f}s")
        return {"params": params, "opt": opt}, {"loss": loss}

    sup = Supervisor(args.ckpt_dir, save_every=args.save_every,
                     injector=FaultInjector(set(args.fail_at)))
    res = sup.run(init_state=init_state_fn, step_fn=step_fn,
                  n_steps=args.steps)
    print(f"done: {res.steps_done} steps, {res.restarts} restarts, "
          f"{res.stragglers} stragglers, final loss {res.losses[-1]:.4f} "
          f"(unigram entropy {stream.unigram_entropy:.2f}, "
          f"bigram entropy {stream.bigram_entropy:.2f})")
    return res


if __name__ == "__main__":
    main()
