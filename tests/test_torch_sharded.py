"""The sharded program on four ``gloo`` CPU ranks, a (2, 2) (data, model)
mesh, against the one-device port on the same numbers.

One spawn of four ranks serves the whole file (about 30 s of tier-1):
each rank runs six shrunk configs as DTensor programs (granite; gemma3's
sliding window; deepseek-v3's MLA, MoE under expert parallelism and MTP;
jamba's Mamba (on each rank's channels) and MoE; xlstm's mLSTM and sLSTM;
seamless's encoder and cross-attention) and every collective on every
rank; rank 0 also runs the one-device calls and writes both. The loss,
every gradient leaf, the prefill logits and four decode steps must agree
within 1e-5 of each tensor's scale (its largest magnitude). Four configs
run in fp32; jamba and xlstm in float64 (parameters, caches and every
accumulation the model makes in fp32): at these random weights xlstm's
gradients move by about 1e-3 of their scale when the weights are rounded
by one fp32 ulp, whatever the order of the sums, and jamba's smallest
leaves come within a tenth of the limit, so in fp32 a reordering of sums
alone could pass or fail them.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import socket
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, shrink

NAMES = ["granite-3-8b", "gemma3-12b", "deepseek-v3-671b",
         "jamba-1.5-large-398b", "xlstm-350m", "seamless-m4t-large-v2"]
WORLD = 4
MESH = (2, 2)
B, S, ENC, VOCAB = 4, 8, 5, 128
DECODE_STEPS = 4
TOL = 1e-5
FLOAT64 = ("jamba-1.5-large-398b", "xlstm-350m")


def _cfg(name: str):
    dt = "float64" if name in FLOAT64 else "float32"
    return dataclasses.replace(
        shrink(get_config(name), d_model=64, vocab=VOCAB, n_repeat=1,
               seq_chunk=4), param_dtype=dt, compute_dtype=dt)


def _widen(tree, cfg):
    """A float64 config's floating leaves in float64 (its specs keep some
    leaves fp32, as the reference's do)."""
    from repro_torch.train import tree as tr

    if cfg.param_dtype != "float64":
        return tree
    return tr.tree_map(lambda a: a.double() if a.is_floating_point() else a,
                       tree)


def _inputs(cfg):
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, VOCAB, (B, S))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.enc_dec:
        batch["enc_emb"] = torch.from_numpy(
            rng.standard_normal((B, ENC, 64)).astype(np.float32))
    return batch


def _params(lm, seed: int = 0):
    """Random parameters, the 1-d leaves moved off their constant init so
    that every leaf matters."""
    from repro_torch.nn.param import init_params
    from repro_torch.train import tree as tr

    g = torch.Generator().manual_seed(seed)
    params = init_params(lm.param_specs(), g, "cpu")
    params = tr.tree_map(lambda a: a + 0.05 * torch.randn(
        a.shape, generator=g) if a.ndim == 1 else a, params)
    return _widen(params, lm.cfg)


def _run(lm, params, batch, wrap=lambda t, specs: t, full=lambda t: t):
    """(loss, gradient leaves, prefill logits, decode logits per step) of
    ``lm`` at ``params``, inputs passed through ``wrap``, results through
    ``full``."""
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.nn.param import init_params
    from repro_torch.train import tree as tr

    cfg = lm.cfg
    bw = {k: wrap(v, None) for k, v in batch.items()}
    with lm.ctx.scope():
        loss, grads = value_and_grad(lm, params, bw)
    out = {"loss": full(loss).reshape(1),
           "grads": [full(g) for g in tr.leaves(grads)]}
    extra = {k: v for k, v in bw.items() if k == "enc_emb"}
    logits, _ = lm.prefill(params, bw["tokens"], **extra)
    out["prefill"] = full(logits)
    specs = lm.cache_specs(B, S, enc_len=ENC if cfg.enc_dec else 0)
    caches = wrap(_widen(init_params(specs, None, "cpu"), cfg), specs)
    steps = []
    for t in range(DECODE_STEPS):
        tok = batch["tokens"][:, t:t + 1].contiguous()
        lg, caches = lm.decode(params, wrap(tok, None), caches, t)
        steps.append(full(lg))
    out["decode"] = steps
    return out


def _worker(rank: int, port: int, path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.models import lm as lm_mod
    from repro_torch.models.lm import LM
    from repro_torch.nn import moe as moe_mod
    from repro_torch.nn.sharding import (ShardCtx, distribute,
                                         distribute_tree, resolve_pspec)

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
    ctx = ShardCtx(mesh)
    calls: dict[str, int] = {}

    def counted(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        setattr(mod, name, wrapper)

    for mod, name in ((lm_mod, "_sharded_embed"), (lm_mod, "_sharded_xent"),
                      (moe_mod, "_moe_mesh")):
        counted(mod, name)

    def wrap(t, specs):
        if specs is not None:
            return distribute_tree(mesh, specs, t)
        axes = ("dp",) + (None,) * (t.ndim - 1)
        return distribute(mesh, t, resolve_pspec(mesh, axes, t.shape))

    results = {}
    for name in NAMES:
        cfg = _cfg(name)
        batch = _inputs(cfg)
        calls.clear()
        lmd = LM(cfg, ctx)
        got = _run(lmd, wrap(_params(lmd), lmd.param_specs()), batch, wrap,
                   lambda t: t.full_tensor())
        got["calls"] = dict(calls)
        got["ep"] = any(sp.moe is not None and
                        sp.moe.n_experts % ctx.tp_size() == 0
                        for sp in cfg.layer_iter())
        if rank == 0:
            lm = LM(cfg)
            results[name] = {"mesh": got, "one": _run(lm, _params(lm), batch)}
    if rank == 0:
        with open(path, "wb") as f:
            pickle.dump(results, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs():
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "runs.pkl")
        mp.spawn(_worker, args=(_free_port(), path), nprocs=WORLD,
                 join=True)
        with open(path, "rb") as f:
            return pickle.load(f)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    scale = float(a.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def _pairs(res, what):
    """``(one-device, mesh)`` for each tensor of ``what``."""
    def listed(x):
        return [x] if what in ("loss", "prefill") else list(x)

    return list(zip(listed(res["one"][what]), listed(res["mesh"][what])))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("what", ["loss", "grads", "prefill", "decode"])
@pytest.mark.parametrize("name", NAMES)
def test_sharded_equals_one_device(runs, name, what):
    pairs = _pairs(runs[name], what)
    assert pairs
    want = torch.float64 if name in FLOAT64 else torch.float32
    for one, mesh in pairs:
        assert mesh.shape == one.shape and mesh.dtype == one.dtype == want
        assert torch.isfinite(mesh).all()
        err = _rel(one, mesh)
        assert err <= TOL, (f"{name} {what}: {err} of the one-device "
                            f"result's scale, limit {TOL}")


@pytest.mark.timeout(300)
def test_manual_regions_ran_on_the_mesh(runs):
    """The vocab-sharded embedding and cross-entropy ran for every config
    (vocab 128 over a model axis of 2), and deepseek-v3's and jamba's MoE
    layers took the expert-parallel region (4 experts over 2 ranks)."""
    for name in NAMES:
        calls = runs[name]["mesh"]["calls"]
        assert calls.get("_sharded_embed", 0) > 0, name
        assert calls.get("_sharded_xent", 0) > 0, name
    for name in ("deepseek-v3-671b", "jamba-1.5-large-398b"):
        assert runs[name]["mesh"]["ep"], name
        assert runs[name]["mesh"]["calls"].get("_moe_mesh", 0) > 0, name


if __name__ == "__main__":
    # each config's and quantity's largest error and its limit, as the
    # tests above judge them:  PYTHONPATH=src python tests/test_torch_sharded.py
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "runs.pkl")
        mp.spawn(_worker, args=(_free_port(), path), nprocs=WORLD)
        with open(path, "rb") as f:
            res = pickle.load(f)
    for name in NAMES:
        for what in ("loss", "grads", "prefill", "decode"):
            errs = [_rel(o, m) for o, m in _pairs(res[name], what)]
            print(f"{name} {what}: max {max(errs):.3g} of scale over "
                  f"{len(errs)}; {sum(e > TOL for e in errs)} above {TOL}")
