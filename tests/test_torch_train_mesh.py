"""``launch.train.main`` over a device mesh: four ``gloo`` CPU ranks, a
(2, 2) (data, model) mesh, shrunk granite-3-8b (``--smoke``, 6 steps),
against the one-device trainer on the same numbers.

One spawn of four ranks serves the whole file. Every rank trains a clean
run and one with ``--fail-at 4`` (a checkpoint every 3 steps, so the
restart restores step 3 and replays steps 3-5). Held:

* the losses within 1e-5 relative of the one-device trainer's, on every
  rank. The shrunk config runs in fp32 here (``shrink`` patched in each
  process): in its bf16 the mesh's sums in another order move the loss
  by about 5e-5 relative, bf16 rounding and not the sharding;
* the restart replays the clean run's losses exactly, on every rank;
* the checkpoint's manifest (rank 0 writes it, one ``.npy`` per whole
  leaf) lists the one-device trainer's shapes and dtypes, leaf for leaf,
  and its arrays restore into the mesh's placements;
* ``--mesh single`` over four ranks raises with the sizes;
* ``--mesh single`` from a launcher's environment (``WORLD_SIZE``,
  ``RANK``, ``LOCAL_RANK``, no process group yet), the single mesh patched
  to (2, 2), trains as the ``mesh=`` runs do, loss for loss.

The trainer runs its mesh step through ``launch/steps.TrainStepGraph``
(on the card one CUDA graph a rank; eager here), and each rank also:

* runs the eager mesh path the owner replaced (the init placed and each
  batch copied up and placed by ``distribute_tensor``'s scatter from
  rank 0, the pure step's results taken back): the owner's losses, clean
  and restarted, are bitwise its losses;
* records the run's one owner across the ``--fail-at 4`` restart: the
  restore wrote into its DTensors' local shards, every ``data_ptr`` kept;
* steps an owner from the reference's initial parameters carried into
  its DTensors in place: the first 3 losses within 1e-5 relative of the
  reference's jitted, donated step on the same batches (fp32, AdamW
  without weight decay as tests/test_torch_train_graph.py; the reference
  runs in the parent process);
* places every parameter with ``distribute`` and restores the checkpoint
  with no collective, to the same local shards as the forms with a
  scatter from rank 0 give.

The batches come from a seeded numpy function (``data=``), the same in
every process: the bigram stream's seed is Python's salted ``hash``, which
differs between processes.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import socket
import tempfile

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

WORLD = 4
MESH = (2, 2)
STEPS, BATCH, SEQ, VOCAB = 6, 4, 16, 512
ARGS = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu", "--steps",
        str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
        "--save-every", "3"]
TOL = 1e-5
OPT = dict(lr=1e-3, warmup_steps=0, eps=1e-3, weight_decay=0.0)
REF_STEPS = 3


class Collectives(TorchDispatchMode):
    """Counts the collectives dispatched while entered (``c10d`` ops of
    ``torch.distributed``'s own API, ``_c10d_functional`` ops)."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace in ("c10d", "_c10d_functional"):
            self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _data(step: int) -> dict:
    t = np.random.default_rng(100 + step).integers(
        0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
    return {"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()}


def _fp32(train_mod) -> None:
    real = train_mod.shrink
    train_mod.shrink = lambda *a, **k: dataclasses.replace(
        real(*a, **k), param_dtype="float32", compute_dtype="float32")


def _manifest(d: str, step: int) -> dict:
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _local_ptrs(state) -> list:
    from repro_torch.train import tree as tr

    return [(x.to_local() if hasattr(x, "to_local") else x).data_ptr()
            for x in tr.leaves(state)]


def _old_main(argv, data, mesh):
    """``launch.train.main``'s mesh path before its step became the
    owner's: the seeded init drawn whole and placed by
    ``distribute_tensor`` with its scatter from rank 0, every batch copied
    up whole and placed the same way, the donated step's results taken
    back, the Supervisor's restarts through ``checkpoint.restore``."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.common import input_layout
    from repro_torch.launch import train as train_mod
    from repro_torch.nn.config import ShapeCell
    from repro_torch.nn.param import init_leaf, map_specs
    from repro_torch.nn.sharding import param_pspec, placements
    from repro_torch.train.optim import init_state
    from repro_torch.train.supervisor import FaultInjector, Supervisor

    args = train_mod.parse_args(argv)
    cfg, lm, opt_cfg, step, mesh = train_mod.build(args, mesh)

    def old_distribute(x, pspec):
        return distribute_tensor(x, mesh, placements(mesh, pspec))

    def init():
        gen = torch.Generator().manual_seed(args.seed)
        params = map_specs(lambda s: old_distribute(
            init_leaf(s, gen, "cpu"), param_pspec(mesh, s)),
            lm.param_specs())
        return {"params": params, "opt": init_state(opt_cfg, params)}

    cell = ShapeCell("train", args.seq, args.batch, "train")
    pspecs = {k: v[2] for k, v in input_layout(cfg, cell, mesh).items()}

    def step_fn(state, i):
        batch = {k: old_distribute(torch.from_numpy(v), pspecs[k])
                 for k, v in data(i).items()}
        state["params"], state["opt"], m = step(state["params"],
                                                state["opt"], batch)
        return state, {"loss": float(m["loss"])}

    sup = Supervisor(args.ckpt_dir, save_every=args.save_every,
                     injector=FaultInjector(set(args.fail_at)),
                     barrier=dist.barrier)
    return sup.run(init_state=init, step_fn=step_fn, n_steps=args.steps)


def _carried_losses(train_mod, mesh, ref_params) -> list:
    """REF_STEPS steps of an owner over ``mesh`` whose parameters are the
    reference's (numpy, carried over), copied into its DTensors' local
    shards in place."""
    from repro_torch.configs.common import input_layout
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.launch.steps import TrainStepGraph, make_train_step
    from repro_torch.nn.config import ShapeCell
    from repro_torch.nn.sharding import local_part, pspec_of
    from repro_torch.train import tree as tr
    from repro_torch.train.optim import AdamWConfig

    args = train_mod.parse_args(ARGS)
    cfg, lm, _, _, _ = train_mod.build(args, mesh)
    opt = AdamWConfig(**OPT)
    pp = lm_params_from_numpy(ref_params, cfg, "cpu")
    state, _ = train_mod.owned_state(lm.param_specs(), opt, "cpu", mesh)

    def reset():
        for x, p in zip(tr.leaves(state["params"]), tr.leaves(pp),
                        strict=True):
            x.to_local().copy_(local_part(p, mesh, pspec_of(x)))
        for x in tr.leaves(state["opt"]):
            x.zero_()

    step = make_train_step(cfg, opt, remat="none", donate=True, mesh=mesh)
    layout = {k: v for k, v in input_layout(cfg, ShapeCell(
        "train", SEQ, BATCH, "train"), mesh).items()
        if k in ("tokens", "labels")}
    owner = TrainStepGraph(step, state, layout, reset, mesh)
    return [float(owner(_data(i))["loss"]) for i in range(REF_STEPS)]


def _shards_as_before(train_mod, mesh, d: str) -> dict:
    """``distribute`` of every parameter and ``checkpoint.restore`` of the
    clean run's last checkpoint: the collectives each issues, and whether
    every local shard is the one the forms with a scatter from rank 0
    give."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.nn.param import init_params
    from repro_torch.nn.sharding import distribute, param_pspec, placements
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import tree as tr
    from repro_torch.train.optim import init_state

    args = train_mod.parse_args(ARGS)
    cfg, lm, opt_cfg, _, _ = train_mod.build(args, mesh)
    specs = lm.param_specs()
    wholes = init_params(specs, torch.Generator().manual_seed(5), "cpu")
    out = {"distribute_ops": 0, "old_distribute_ops": 0,
           "distribute_same": True}
    for s, x in zip(tr.leaves(specs), tr.leaves(wholes), strict=True):
        pl = placements(mesh, param_pspec(mesh, s))
        with Collectives() as new:
            a = distribute(mesh, x, param_pspec(mesh, s))
        with Collectives() as old:
            b = distribute_tensor(x, mesh, pl)
        out["distribute_ops"] += len(new.ops)
        out["old_distribute_ops"] += len(old.ops)
        out["distribute_same"] &= torch.equal(a.to_local(), b.to_local())
    state, _ = train_mod.owned_state(specs, opt_cfg, "cpu", mesh)
    with Collectives() as new:
        got, _ = ckpt.restore(f"{d}/mesh_clean", STEPS, state)
    out["restore_ops"] = len(new.ops)
    out["restore_same"] = True
    step_dir = os.path.join(f"{d}/mesh_clean", f"step_{STEPS:08d}")
    for i, ref in enumerate(tr.leaves(got)):
        whole = torch.from_numpy(np.load(os.path.join(
            step_dir, f"arr_{i:05d}.npy")))
        if hasattr(ref, "to_local"):
            old = distribute_tensor(whole, mesh, ref.placements).to_local()
            out["restore_same"] &= torch.equal(ref.to_local(), old)
        else:
            out["restore_same"] &= torch.equal(ref, whole)
    return out


def _worker(rank: int, port: int, port_env: int, d: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch import train as train_mod
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import tree as tr

    torch.set_num_threads(1)
    _fp32(train_mod)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    out = {}
    clean = train_mod.main(ARGS + ["--ckpt-dir", f"{d}/mesh_clean"],
                           data=_data, mesh=mesh)
    # the run's owners, with their local shards' data_ptrs when made
    made, real = [], train_mod.TrainStepGraph

    class Kept(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append((self, _local_ptrs(self.state)))

    train_mod.TrainStepGraph = Kept
    try:
        faulty = train_mod.main(ARGS + ["--ckpt-dir", f"{d}/mesh_faulty",
                                        "--fail-at", "4"], data=_data,
                                mesh=mesh)
    finally:
        train_mod.TrainStepGraph = real
    out["clean"], out["faulty"] = clean.losses, faulty.losses
    out["restarts"] = faulty.restarts
    out["owners"] = len(made)
    out["ptrs_kept"] = all(_local_ptrs(o.state) == p for o, p in made)
    out["old_clean"] = _old_main(ARGS + ["--ckpt-dir", f"{d}/old_clean"],
                                 _data, mesh).losses
    out["old_faulty"] = _old_main(ARGS + ["--ckpt-dir", f"{d}/old_faulty",
                                          "--fail-at", "4"], _data,
                                  mesh).losses
    with open(f"{d}/ref_params.pkl", "rb") as f:
        out["carried"] = _carried_losses(train_mod, mesh, pickle.load(f))
    out["shards"] = _shards_as_before(train_mod, mesh, d)
    # the last checkpoint restores into the mesh's placements
    args = train_mod.parse_args(ARGS)
    cfg, lm, opt_cfg, _, _ = train_mod.build(args, mesh)
    from repro_torch.nn.param import init_params
    from repro_torch.nn.sharding import distribute_tree

    specs = lm.param_specs()
    like = distribute_tree(mesh, specs, init_params(
        specs, torch.Generator().manual_seed(1), "cpu"))
    got, extra = ckpt.restore(f"{d}/mesh_clean", STEPS,
                              {"params": like, "opt": {
                                  "m": like, "step": torch.zeros(
                                      (), dtype=torch.int32), "v": like}})
    leaves = tr.leaves(got["params"])
    out["restored"] = {
        "next_step": extra["next_step"],
        "placed": all(tuple(a.placements) == tuple(b.placements)
                      for a, b in zip(leaves, tr.leaves(like))),
        "params": [a.full_tensor() for a in leaves]}
    try:
        train_mod.production_mesh("single", "cpu")
    except ValueError as e:
        out["refused"] = str(e)
    dist.barrier()
    dist.destroy_process_group()
    # --mesh single as a launcher starts it: the group from the environment
    from repro_torch.launch import mesh as mesh_mod

    mesh_mod.SINGLE = (MESH, ("data", "model"))
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port_env),
                      WORLD_SIZE=str(WORLD), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    env = train_mod.main(ARGS + ["--ckpt-dir", f"{d}/mesh_env", "--mesh",
                                 "single"], data=_data)
    out["env"] = env.losses
    out["env_world"] = dist.get_world_size()
    with open(f"{d}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    import torch.multiprocessing as mp

    from repro_torch.launch import train as train_mod

    with tempfile.TemporaryDirectory() as d:
        ref_params, ref_losses = _reference()
        with open(f"{d}/ref_params.pkl", "wb") as f:
            pickle.dump(ref_params, f)
        mp.spawn(_worker, args=(_free_port(), _free_port(), d),
                 nprocs=WORLD, join=True)
        ranks = []
        for r in range(WORLD):
            with open(f"{d}/rank{r}.pkl", "rb") as f:
                ranks.append(pickle.load(f))
        real = train_mod.shrink
        try:
            _fp32(train_mod)
            one = train_mod.main(ARGS + ["--ckpt-dir", f"{d}/one"],
                                 data=_data)
        finally:
            train_mod.shrink = real
        from repro_torch.train import checkpoint as ckpt

        manifests = {k: _manifest(f"{d}/{k}", STEPS)
                     for k in ("one", "mesh_clean")}
        mesh_arrays = ckpt.restore(f"{d}/mesh_clean", STEPS, _like())[0]
    return {"ranks": ranks, "one": one.losses, "manifests": manifests,
            "mesh_ckpt": mesh_arrays, "ref": ref_losses}


def _reference():
    """The reference's initial parameters of the trainer's shrunk granite
    (fp32; numpy, for the ranks) and REF_STEPS losses of its jitted,
    donated step on ``_data``'s batches. JAX is imported here only, so
    the spawned ranks never load it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as ref_get_config
    from repro.configs import shrink as ref_shrink
    from repro.launch.steps import make_train_step as ref_make_train_step
    from repro.models.lm import LM as RefLM
    from repro.nn.param import init_tree
    from repro.train.optim import AdamWConfig as RefAdamWConfig
    from repro.train.optim import init_state as ref_init_state

    cfg = dataclasses.replace(
        ref_shrink(ref_get_config("granite-3-8b"), d_model=128, vocab=VOCAB,
                   n_repeat=2),
        param_dtype="float32", compute_dtype="float32")
    params = init_tree(jax.random.PRNGKey(0), RefLM(cfg).param_specs())
    host = jax.tree.map(np.asarray, params)
    opt = RefAdamWConfig(**OPT)
    step = jax.jit(ref_make_train_step(cfg, None, opt, remat="none"),
                   donate_argnums=(0, 1))
    p, s, losses = params, ref_init_state(opt, params), []
    for i in range(REF_STEPS):
        p, s, m = step(p, s, {k: jnp.asarray(v)
                              for k, v in _data(i).items()})
        losses.append(float(m["loss"]))
    return host, losses


def _like():
    """A restore target of the one-device trainer's shapes and dtypes
    (plain tensors), in its tree."""
    from repro_torch.launch import train as train_mod

    args = train_mod.parse_args(ARGS)
    real = train_mod.shrink
    try:
        _fp32(train_mod)
        cfg, lm, opt_cfg, _, _ = train_mod.build(args)
    finally:
        train_mod.shrink = real
    from repro_torch.nn.param import init_params
    from repro_torch.train.optim import init_state

    params = init_params(lm.param_specs(), torch.Generator().manual_seed(1),
                         "cpu")
    return {"params": params, "opt": init_state(opt_cfg, params)}


def test_mesh_losses_match_the_one_device_trainer(runs):
    for i, r in enumerate(runs["ranks"]):
        got, want = np.asarray(r["clean"]), np.asarray(runs["one"])
        assert got.shape == (STEPS,)
        rel = np.abs(got - want) / np.abs(want)
        assert rel.max() <= TOL, f"rank {i}: {rel.max()} relative"


def test_mesh_restart_replays_exactly_on_every_rank(runs):
    for r in runs["ranks"]:
        assert r["restarts"] == 1
        # steps 0-3, then 3-5 again from the checkpoint at step 3
        assert r["faulty"] == r["clean"][:4] + r["clean"][3:]
    assert all(r["clean"] == runs["ranks"][0]["clean"] for r in runs["ranks"])


def test_mesh_checkpoint_has_the_one_device_layout(runs):
    """Rank 0 wrote one whole leaf a file: the manifest's shapes, dtypes,
    leaf count and step are the one-device trainer's, the files restore
    into the one-device tree, and into the mesh's placements on every
    rank with the same values."""
    one, mesh = runs["manifests"]["one"], runs["manifests"]["mesh_clean"]
    for key in ("n_leaves", "shapes", "dtypes", "extra", "step"):
        assert mesh[key] == one[key], key
    from repro_torch.train import tree as tr

    assert int(runs["mesh_ckpt"]["opt"]["step"]) == STEPS
    params = tr.leaves(runs["mesh_ckpt"]["params"])
    for r in runs["ranks"]:
        res = r["restored"]
        assert res["next_step"] == STEPS and res["placed"]
        for a, b in zip(res["params"], params, strict=True):
            assert torch.equal(a, b)


def test_mesh_owner_is_bitwise_the_eager_path_it_replaced(runs):
    """The owner's losses, clean and across the restart, are the eager
    mesh path's before it, bit for bit, on every rank."""
    for r in runs["ranks"]:
        assert r["clean"] == r["old_clean"]
        assert r["faulty"] == r["old_faulty"]


def test_mesh_restart_restores_into_the_owners_dtensors(runs):
    for r in runs["ranks"]:
        assert r["restarts"] == 1
        assert r["owners"] == 1 and r["ptrs_kept"]


def test_mesh_owner_matches_the_reference_jitted_step(runs):
    """The reference's parameters carried into the (2, 2) owner's
    DTensors: REF_STEPS losses within 1e-5 relative of the reference's
    jitted, donated step, on every rank (sums in another order)."""
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["carried"], runs["ref"], rtol=1e-5)


def test_distribute_and_restore_keep_the_shards_with_no_collective(runs):
    for r in runs["ranks"]:
        sh = r["shards"]
        assert sh["distribute_ops"] == 0 and sh["restore_ops"] == 0
        assert sh["old_distribute_ops"] > 0
        assert sh["distribute_same"] and sh["restore_same"]


def test_mesh_of_the_wrong_size_is_refused(runs):
    for r in runs["ranks"]:
        assert r["refused"] == ("--mesh single: mesh (32, 8) needs 256 "
                                "ranks, the process group has 4")


def test_mesh_from_the_launcher_environment(runs):
    for r in runs["ranks"]:
        assert r["env_world"] == WORLD
        assert r["env"] == r["clean"]


def test_mesh_on_cuda_takes_the_local_rank_card(monkeypatch):
    """Under a launcher each rank takes card LOCAL_RANK before the NCCL
    group is made, so no two ranks of a host share card 0."""
    import torch.distributed as dist

    from repro_torch.launch import train as train_mod

    calls = []

    def init(backend, **kw):
        calls.append(("group", backend))
        raise RuntimeError("no group here")

    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda i: calls.append(("card", i)))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", init)
    monkeypatch.setenv("WORLD_SIZE", "256")
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(RuntimeError, match="no group here"):
        train_mod.production_mesh("single", "cuda")
    assert calls == [("card", 3), ("group", "nccl")]


def test_mesh_without_a_process_group_is_refused(monkeypatch):
    import torch.distributed as dist

    from repro_torch.launch import train as train_mod

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no process group; launch 512"):
        train_mod.main(["--smoke", "--device", "cpu", "--mesh", "multi"])
