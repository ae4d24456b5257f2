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

WORLD = 4
MESH = (2, 2)
STEPS, BATCH, SEQ, VOCAB = 6, 4, 16, 512
ARGS = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu", "--steps",
        str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ),
        "--save-every", "3"]
TOL = 1e-5


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
    faulty = train_mod.main(ARGS + ["--ckpt-dir", f"{d}/mesh_faulty",
                                    "--fail-at", "4"], data=_data, mesh=mesh)
    out["clean"], out["faulty"] = clean.losses, faulty.losses
    out["restarts"] = faulty.restarts
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
            "mesh_ckpt": mesh_arrays}


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
