"""``nn/pipeline.py::pipeline_apply`` (GPipe over a mesh axis) on four
``gloo`` CPU ranks, against the reference's ``pipeline_apply`` and against
the stages run in sequence.

One spawn of four ranks serves the whole file. Each rank runs:

* the reference test's own case (tests/test_pipeline.py: S=4, M=6, mb=2,
  d=8, stage ``x + p`` with p_s = s + 1, output ``x + 10``) and a
  ``tanh(x * p)`` stage, on a (4,) mesh, and the ``tanh`` stage at S=2
  over the "pod" axis of a (2, 2) mesh (two pipelines side by side);
  the loss ``sum(out ** 2)``, the output and every stage's gradient are
  held to the reference's values, which a subprocess computes with
  ``jax.grad`` on 8 forced XLA host devices. The gradient must be the
  reference's, not S times it (each rank computes the same loss from the
  replicated output);
* a stage of shrunk granite-3-8b layers (4 layers over 4 stages, fp32):
  the output and the gradient of every stage's parameters against the
  one-device port running the layers in sequence;
* S=1 over the "pod" axis of a (1, 4) mesh: no P2P call, the output and
  the gradient bitwise the microbatches run through the stage in order;
* a non-finite microbatch: S=2 over the "pod" axis of a (2, 2) mesh (two
  pipelines of 2 ranks each), M=4, the stage ``x * p``, ``xs`` ones with
  ``xs[0, 0, 0] = inf``: the output and the gradient of a loss over
  microbatches 1-3 against the reference's. Its ``jax.grad`` is itself
  NaN in p's first column (the stage's own ``0 * inf`` on microbatch 0),
  so the pattern of non-finite entries must match and the finite ones
  agree.

Tolerance: 1e-5 of each tensor's scale (its largest magnitude): sums in
another order (the reference's XLA against torch's), and for granite the
stages' gradients accumulated over the microbatches one at a time.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

WORLD = 4
M, MB, D = 6, 2, 8
TOL = 1e-5
# name: (mesh shape, mesh axes, stage function)
TOY = {"add": ((4,), ("pod",), "add"),
       "tanh": ((4,), ("pod",), "tanh"),
       "tanh_s2": ((2, 2), ("pod", "data"), "tanh")}
GRANITE_LAYERS, GRANITE_M, GRANITE_SEQ = 4, 3, 8
INF_M, INF_SHAPE = 4, (2, 3)     # the non-finite case: S=2, M=4, (2, 3)


def _inf_x() -> np.ndarray:
    xs = np.ones((INF_M, *INF_SHAPE), np.float32)
    xs[0, 0, 0] = np.inf
    return xs


def _inf_params() -> np.ndarray:
    return 1.0 + 0.25 * np.arange(6, dtype=np.float32).reshape(2, 3)


def _toy_params(n_stages: int, fn: str) -> np.ndarray:
    if fn == "add":
        return np.arange(1.0, n_stages + 1)[:, None] * np.ones((n_stages, D))
    g = np.random.default_rng(5)
    return 1.0 + 0.3 * g.standard_normal((n_stages, D))


def _toy_x() -> np.ndarray:
    return np.random.default_rng(0).standard_normal((M, MB, D)).astype(
        np.float32)


def _stage(fn: str):
    if fn == "add":
        return lambda p, x: x + p[None, :]
    return lambda p, x: torch.tanh(x * p[None, :])


def _granite():
    from repro_torch.configs import get_config, shrink
    from repro_torch.models.lm import LM
    from repro_torch.nn.param import init_params

    cfg = dataclasses.replace(
        shrink(get_config("granite-3-8b"), d_model=64, vocab=128,
               n_repeat=GRANITE_LAYERS),
        param_dtype="float32", compute_dtype="float32")
    lm = LM(cfg)
    params = init_params(lm.param_specs(), torch.Generator().manual_seed(0),
                         "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (GRANITE_M, 1, GRANITE_SEQ, cfg.d_model)).astype(np.float32))
    return cfg, lm, params["layers"], x


def _granite_stage(cfg, lm):
    from repro_torch.models.lm import apply_layer

    pos = torch.arange(GRANITE_SEQ, dtype=torch.int32)[None, :]
    return lambda p, x: apply_layer(lm.layers[0], p, x, pos,
                                    norm_eps=cfg.norm_eps)[0]


def _grads(loss, leaves):
    return [g.detach().clone() for g in torch.autograd.grad(loss, leaves)]


def _worker(rank: int, port: int, path: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.nn import pipeline
    from repro_torch.train import tree as tr

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    sent = []
    real_batch = dist.batch_isend_irecv

    def counted(ops):
        sent.append(len(ops))
        return real_batch(ops)

    pipeline.dist.batch_isend_irecv = counted
    out = {}
    x = torch.from_numpy(_toy_x())
    for name, (shape, axes, fn) in TOY.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
        sid = mesh.get_local_rank("pod")
        p = torch.from_numpy(_toy_params(shape[0], fn)[sid]).float()
        p.requires_grad_(True)
        before = len(sent)
        y = pipeline.pipeline_apply(mesh, "pod", _stage(fn), p, x)
        loss = (y ** 2).sum()
        out[name] = {"sid": sid, "out": y.detach(), "loss": float(loss),
                     "grad": _grads(loss, [p])[0],
                     "p2p": len(sent) - before}

    cfg, lm, layers, gx = _granite()
    stage = _granite_stage(cfg, lm)
    mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("pod",))
    p = tr.tree_map(lambda a: a.requires_grad_(True), layers[rank])
    before = len(sent)
    y = pipeline.pipeline_apply(mesh, "pod", stage, p, gx)
    loss = (y ** 2).sum()
    out["granite"] = {"out": y.detach(), "grad": _grads(loss, tr.leaves(p)),
                      "p2p": len(sent) - before}

    try:
        pipeline.pipeline_apply(mesh, "pod", stage, p,
                                gx.clone().requires_grad_())
    except ValueError as e:
        out["refused"] = str(e)

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    sid = mesh.get_local_rank("pod")
    p = torch.from_numpy(_inf_params()[sid]).requires_grad_()
    y = pipeline.pipeline_apply(mesh, "pod", lambda p, x: x * p[None, :], p,
                                torch.from_numpy(_inf_x()))
    out["inf"] = {"sid": sid, "out": y.detach(),
                  "grad": _grads((y[1:] ** 2).sum(), [p])[0]}

    mesh = init_device_mesh("cpu", (1, WORLD), mesh_dim_names=("pod", "data"))
    p = torch.from_numpy(_toy_params(1, "tanh")[0]).float().requires_grad_()
    before = len(sent)
    y = pipeline.pipeline_apply(mesh, "pod", _stage("tanh"), p, x)
    g = _grads((y ** 2).sum(), [p])[0]
    seq = torch.stack([_stage("tanh")(p, x[t]) for t in range(M)])
    out["s1"] = {"p2p": len(sent) - before, "out": y.detach(), "grad": g,
                 "want_out": seq.detach(),
                 "want_grad": _grads((seq ** 2).sum(), [p])[0]}
    with open(f"{path}.{rank}", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


REF_SCRIPT = r"""
import os, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.nn.pipeline import pipeline_apply
import test_torch_pipeline as t

try:
    from jax.sharding import AxisType
    mk = lambda shape, names: jax.make_mesh(
        shape, names, axis_types=(AxisType.Auto,) * len(shape))
except ImportError:
    mk = jax.make_mesh
res = {}
x = jnp.asarray(t._toy_x())
for name, (shape, _, fn) in t.TOY.items():
    s = shape[0]
    mesh = mk((s, 8 // s), ("pod", "data"))
    params = jnp.asarray(t._toy_params(s, fn), jnp.float32)
    stage = (lambda p, x: x + p[None, :]) if fn == "add" else \
        (lambda p, x: jnp.tanh(x * p[None, :]))
    f = lambda p: pipeline_apply(mesh, "pod", stage, p, x)
    out = jax.jit(f)(params)
    loss, g = jax.value_and_grad(lambda p: jnp.sum(f(p) ** 2))(params)
    res[name] = {"out": np.asarray(out).tolist(), "loss": float(loss),
                 "grad": np.asarray(g).tolist()}
mesh = mk((2, 4), ("pod", "data"))
stage = lambda p, x: x * p[None, :]
f = lambda p: pipeline_apply(mesh, "pod", stage, p, jnp.asarray(t._inf_x()))
params = jnp.asarray(t._inf_params())
g = jax.jit(jax.grad(lambda p: jnp.sum(f(p)[1:] ** 2)))(params)
res["inf"] = {"out": np.asarray(jax.jit(f)(params)).tolist(),
              "grad": np.asarray(g).tolist()}
print("REF_JSON " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def runs():
    import torch.multiprocessing as mp

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [os.path.join(here, "..", "src"), here]))
    ref = subprocess.Popen([sys.executable, "-c", REF_SCRIPT], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "runs")
        mp.spawn(_worker, args=(_free_port(), path), nprocs=WORLD,
                 join=True)
        ranks = []
        for r in range(WORLD):
            with open(f"{path}.{r}", "rb") as f:
                ranks.append(pickle.load(f))
    stdout, stderr = ref.communicate(timeout=280)
    line = [x for x in stdout.splitlines() if x.startswith("REF_JSON ")]
    assert line, stderr[-2000:]
    return ranks, json.loads(line[0][len("REF_JSON "):])


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.abs().max()) or 1.0
    return float((got - want).abs().max()) / scale


@pytest.mark.parametrize("name", sorted(TOY))
def test_pipeline_matches_reference(runs, name):
    """Output on every rank and each stage's gradient, against the
    reference's outputs and ``jax.grad`` (ratio 1, not S)."""
    ranks, ref = runs
    want_out = torch.tensor(ref[name]["out"], dtype=torch.float32)
    want_grad = torch.tensor(ref[name]["grad"], dtype=torch.float32)
    if name == "add":
        assert _rel(want_out, torch.from_numpy(_toy_x()) + 10.0) <= 1e-6
    for r in ranks:
        got = r[name]
        assert _rel(got["out"], want_out) <= TOL
        assert got["loss"] == pytest.approx(ref[name]["loss"], rel=TOL)
        g = got["grad"]
        assert _rel(g, want_grad[got["sid"]]) <= TOL, \
            (f"stage {got['sid']}: gradient / reference's = "
             f"{float(g.norm() / want_grad[got['sid']].norm()):.4f}")


def test_pipeline_of_granite_layers_matches_the_sequence(runs):
    """4 shrunk granite layers, one a stage: the output on every rank and
    each stage's parameter gradients against the layers run in sequence
    on one device."""
    from repro_torch.train import tree as tr

    ranks, _ = runs
    cfg, lm, layers, x = _granite()
    stage = _granite_stage(cfg, lm)
    leaves = [tr.tree_map(lambda a: a.requires_grad_(True), p)
              for p in layers]
    ys = []
    for t in range(GRANITE_M):
        h = x[t]
        for p in leaves:
            h = stage(p, h)
        ys.append(h)
    y = torch.stack(ys)
    want = _grads((y ** 2).sum(), [a for p in leaves for a in tr.leaves(p)])
    n = len(tr.leaves(leaves[0]))
    for rank, r in enumerate(ranks):
        assert _rel(r["granite"]["out"], y.detach()) <= TOL
        got = r["granite"]["grad"]
        assert len(got) == n
        for a, b in zip(got, want[rank * n:(rank + 1) * n], strict=True):
            assert _rel(a, b) <= TOL


def _same_pattern(got: torch.Tensor, want: torch.Tensor) -> None:
    """Non-finite in the same places, the finite entries within TOL."""
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    assert _rel(got[fin], want[fin]) <= TOL


def test_an_inf_stays_in_its_microbatch(runs):
    """One inf in microbatch 0: microbatch 0 is non-finite and 1-3 are
    finite and the reference's, on every rank; each stage's gradient of a
    loss over microbatches 1-3 has the reference's pattern and values
    (a product with 0 in the schedule turned 1-3 into NaN)."""
    ranks, ref = runs
    want_out = torch.tensor(ref["inf"]["out"], dtype=torch.float32)
    want_grad = torch.tensor(ref["inf"]["grad"], dtype=torch.float32)
    assert not bool(torch.isfinite(want_out[0]).all())
    assert bool(torch.isfinite(want_out[1:]).all())
    for r in ranks:
        got = r["inf"]
        _same_pattern(got["out"], want_out)
        _same_pattern(got["grad"], want_grad[got["sid"]])


def test_one_stage_is_the_sequence_with_no_p2p(runs):
    ranks, _ = runs
    for r in ranks:
        s1 = r["s1"]
        assert s1["p2p"] == 0
        assert torch.equal(s1["out"], s1["want_out"])
        assert torch.equal(s1["grad"], s1["want_grad"])


def test_ring_ran_every_tick_both_ways(runs):
    """S + M - 1 ticks, a shift after each but the last, on every rank,
    forward and backward: 2 (S + M - 2) P2P batches."""
    ranks, _ = runs
    for i, r in enumerate(ranks):
        assert r["add"]["sid"] == i
        for name, (shape, _, _) in TOY.items():
            assert r[name]["p2p"] == 2 * (shape[0] + M - 2)
        assert r["granite"]["p2p"] == 2 * (WORLD + GRANITE_M - 2)


def test_an_input_that_requires_grad_is_refused_over_stages(runs):
    ranks, _ = runs
    for r in ranks:
        assert "input's gradient over several stages" in r["refused"]
