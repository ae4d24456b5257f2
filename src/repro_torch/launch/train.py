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
reference). The step runs as the reference's jitted one, with a mesh or
without: ``launch/steps.TrainStepGraph`` owns the parameters, the AdamW
state and a static (batch, seq) buffer of tokens and labels, and on CUDA
replays one CUDA graph of the donated step a training step (captured once
per run, at the first start; a restart seeds the same tensors again or
restores the checkpoint into them, and replays the same graph); each
batch goes up from a pinned staging buffer, and the metrics are read
after the replay. On the CPU the same owner runs the step eagerly; the
eager step stays ``make_train_step``.

``--mesh single|multi`` trains on the reference's production mesh,
re-expressed for H100 nodes (``launch/mesh.py``: (32, 8), or (2, 32, 8)
with ``multi``) as a DTensor program over the launched process group, one
rank a GPU, each rank replaying its own graph of the step, NCCL
collectives included. Every parameter and AdamW moment is a DTensor over
a local shard allocated once: the seeded init draws each
leaf whole as without a mesh and copies in this rank's shard, placed by
``param_pspec``; each rank stages and copies up only its own slice of a
batch, placed by its input pspecs (no collective in either); checkpoints
are in the reference's layout (one ``.npy`` per whole leaf, written by
rank 0). The process group comes from the caller, or from ``torchrun``'s
environment; its size must be the mesh's.
``build``/``main`` also take a ``mesh=`` (any ``DeviceMesh`` with the
reference's axis names), which is how the tests reach a small mesh.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, shrink
from repro_torch.configs.common import input_layout
from repro_torch.device import resolve_device
from repro_torch.launch.steps import TrainStepGraph, make_train_step
from repro_torch.models.lm import LM
from repro_torch.nn.config import ShapeCell
from repro_torch.nn.param import init_leaf, map_specs
from repro_torch.nn.sharding import (dtensor_of, local_part, local_shape,
                                     param_pspec)
from repro_torch.train import tree as tr
from repro_torch.train.data import BigramStream
from repro_torch.train.optim import AdamWConfig, init_state
from repro_torch.train.supervisor import FaultInjector, Supervisor


def production_mesh(kind: str, device_type: str):
    """The reference's ``--mesh single|multi`` over the launched process
    group (from ``torchrun``'s environment if none is up: on CUDA each
    rank first takes card ``LOCAL_RANK``); raises with the sizes when the
    group's is not the mesh's, as ``jax.make_mesh`` does."""
    import math

    from repro_torch.launch.mesh import MULTI, SINGLE, make_production_mesh

    shape = (MULTI if kind == "multi" else SINGLE)[0]
    if device_type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError(f"--mesh {kind}: no process group; launch "
                               f"{math.prod(shape)} ranks (e.g. torchrun)")
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"--mesh {kind}: mesh {shape} needs "
                         f"{math.prod(shape)} ranks, the process group has "
                         f"{dist.get_world_size()}")
    return make_production_mesh(multi_pod=kind == "multi",
                                device_type=device_type)


def build(args, mesh=None):
    """``(cfg, lm, opt_cfg, step, mesh)`` for parsed ``args``: the step
    updates its parameters and optimizer state in place, as the
    reference's trainer donates them to its jitted step (``main`` runs it
    through ``TrainStepGraph``, with a mesh or without). ``mesh`` (a
    ``DeviceMesh``) or ``--mesh single|multi`` runs it over a mesh (None
    without one)."""
    if mesh is None and args.mesh != "none":
        mesh = production_mesh(args.mesh, resolve_device(args.device).type)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = shrink(cfg, d_model=args.d_model, vocab=args.vocab,
                     n_repeat=2 if args.n_repeat is None else args.n_repeat)
    elif args.n_repeat is not None:
        cfg = dataclasses.replace(cfg, n_repeat=args.n_repeat)
    lm = LM(cfg)
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)
    step = make_train_step(cfg, opt_cfg, remat=args.remat,
                           microbatches=args.microbatches, donate=True,
                           mesh=mesh)
    return cfg, lm, opt_cfg, step, mesh


def owned_state(specs, opt_cfg: AdamWConfig, dev, mesh=None):
    """The trainer's state, allocated once: ``(state, leaves)``, ``state``
    ``{"params", "opt"}`` with each parameter of the spec tree ``specs``
    an empty tensor on ``dev`` (on a mesh a DTensor over this rank's shard
    alone, placed by ``param_pspec``) and AdamW's zeros beside;
    ``leaves`` the ``(spec, local tensor, pspec)`` triples in the specs'
    order."""
    leaves = []

    def alloc(s):
        ps = param_pspec(mesh, s)
        local = torch.empty(local_shape(mesh, s.shape, ps), dtype=s.dtype,
                            device=dev)
        leaves.append((s, local, ps))
        return dtensor_of(mesh, local, s.shape, ps)

    params = map_specs(alloc, specs)
    return {"params": params, "opt": init_state(opt_cfg, params)}, leaves


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


def main(argv=None, data=None, mesh=None):
    """Train as the arguments say and return the Supervisor's
    ``RunResult``. ``data(step)`` gives a step's ``{"tokens", "labels"}``
    (numpy arrays); by default the bigram stream's batch. ``mesh`` (a
    ``DeviceMesh`` over the process group) trains over it, as ``--mesh``
    does over the production mesh."""
    args = parse_args(argv)
    cfg, lm, opt_cfg, step_fn_, mesh = build(args, mesh)
    dev = resolve_device(args.device)
    if dev.type == "cuda":      # --mesh has taken the rank's card by now
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = BigramStream(cfg.vocab_size, seed=args.seed)
    if data is None:
        data = lambda step: stream.batch(step, args.batch, args.seq)
    print(f"arch={cfg.name} layers={cfg.n_layers} vocab={cfg.vocab_size}")

    owner = []      # the TrainStepGraph, made once a run

    def init_state_fn():
        if owner:       # a restart: the same tensors, seeded again
            owner[0].reset()
            return owner[0].state
        state, leaves = owned_state(lm.param_specs(), opt_cfg, dev, mesh)

        def seed():
            # the draws of init_leaf in the specs' order, into place; on a
            # mesh each leaf is drawn whole, as without one, and this
            # rank's shard copied in: no rank holds more than one whole
            # leaf, and no collective
            g = torch.Generator(device=dev).manual_seed(args.seed)
            for s, local, ps in leaves:
                local.copy_(local_part(init_leaf(s, g, dev), mesh, ps))
            for x in tr.leaves(state["opt"]):
                x.zero_()

        cell = ShapeCell("train", args.seq, args.batch, "train")
        layout = {k: v for k, v in input_layout(cfg, cell, mesh).items()
                  if k in ("tokens", "labels")}
        owner.append(TrainStepGraph(step_fn_, state, layout, seed, mesh))
        return state

    t_step = [time.monotonic()]

    def step_fn(state, step):
        metrics = owner[0](data(step))
        loss = float(metrics["loss"])
        dt = time.monotonic() - t_step[0]
        t_step[0] = time.monotonic()
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} {dt:.2f}s")
        return state, {"loss": loss}

    sup = Supervisor(args.ckpt_dir, save_every=args.save_every,
                     injector=FaultInjector(set(args.fail_at)),
                     barrier=None if mesh is None else dist.barrier)
    res = sup.run(init_state=init_state_fn, step_fn=step_fn,
                  n_steps=args.steps)
    print(f"done: {res.steps_done} steps, {res.restarts} restarts, "
          f"{res.stragglers} stragglers, final loss {res.losses[-1]:.4f} "
          f"(unigram entropy {stream.unigram_entropy:.2f}, "
          f"bigram entropy {stream.bigram_entropy:.2f})")
    return res


if __name__ == "__main__":
    main()
