"""The xLSTM cores' work per rank over a mesh, against the reference's
compiled program: each block (mLSTM, sLSTM) at xlstm-350m's published
width (d_model 1024, 4 heads, proj 2, chunk 128, bf16 parameters), one
layer, prefill at B 8 x S 256 (two chunks) and one decode step from a
cache of B 8, on the (data, model) meshes (2, 2), (1, 4) and (1, 8).

A rank's share is its FLOPs over the same block's on a one-device mesh.
The port's are counted by ``launch/costs.CostMode`` on ``meta`` shards
over the fake process group of ``launch/mesh.make_production_mesh``; the
reference's are ``cost_analysis()["flops"]`` of its jitted block compiled
over 8 forced XLA host devices, in a subprocess that runs while the
port's are counted. The port's share must be at most 1.15 x the
reference's in every cell. The reference divides each block by the
number of devices; the port does so by ``nn/xlstm.split_rule``: whole
heads a rank where the model axis divides the 4 heads ((2, 2), (1, 4)),
else rows of each rank's batch shard ((1, 8)). About 25 s in one
process.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.costs import CostMode
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn import xlstm as xl
from repro_torch.nn.config import XLSTMConfig
from repro_torch.nn.param import struct_tree
from repro_torch.nn.sharding import (ShardCtx, meta_dtensor, param_pspec,
                                     resolve_pspec)

D, B, S = 1024, 8, 256
MESHES = [(2, 2), (1, 4), (1, 8)]
RULE = {(2, 2): "heads", (1, 4): "heads", (1, 8): "rows"}
BLOCKS = ("mlstm", "slstm")
MODES = ("prefill", "decode")
SHARE_LIMIT = 1.15      # the port's share over the reference's, at most

_REFERENCE = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding
from repro.nn import xlstm as xl
from repro.nn.config import XLSTMConfig
from repro.nn.sharding import ShardCtx, param_pspec, resolve_pspec

D, B, S = {d}, {b}, {s}
out = {{}}
for kind in ("mlstm", "slstm"):
    cfg = XLSTMConfig(kind=kind, n_heads=4, proj_factor=2.0, chunk=128)
    specs = getattr(xl, kind + "_specs")(cfg, D, jnp.bfloat16)
    cspecs = getattr(xl, kind + "_cache_specs")(cfg, D, B)
    apply = getattr(xl, kind + "_apply")
    for shape in {meshes!r}:
        n = shape[0] * shape[1]
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape),
                    ("data", "model"))
        ctx = ShardCtx(mesh)

        def struct(specs):
            return {{k: jax.ShapeDtypeStruct(
                sp.shape, sp.dtype,
                sharding=NamedSharding(mesh, param_pspec(mesh, sp)))
                for k, sp in specs.items()}}

        for mode, s in (("prefill", S), ("decode", 1)):
            x = jax.ShapeDtypeStruct((B, s, D), jnp.bfloat16, sharding=(
                NamedSharding(mesh, resolve_pspec(
                    mesh, ("dp", None, None), (B, s, D)))))
            args = (struct(specs), x) + (
                (struct(cspecs),) if mode == "decode" else ())
            fn = jax.jit(lambda p, x, *c: apply(ctx, p, cfg, x, *c))
            ca = fn.lower(*args).compile().cost_analysis()
            ca = ca[0] if isinstance(ca, list) else ca
            out[f"{{kind}} {{mode}} {{shape[0]}}x{{shape[1]}}"] = ca["flops"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """The fake default process group the production meshes make (rank 0
    of 512) is left behind for no later file on the worker."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _key(block: str, mode: str, shape) -> str:
    return f"{block} {mode} {shape[0]}x{shape[1]}"


def _count_block(block: str, shape, mode: str, b: int = B):
    """``(FLOPs of rank 0, the split rules taken)`` of one call of
    ``block`` on the ``shape`` mesh: a prefill of S tokens or one decode
    step, at batch ``b``."""
    cfg = XLSTMConfig(kind=block, n_heads=4, proj_factor=2.0, chunk=128)
    mesh = make_production_mesh(shape=shape)
    ctx = ShardCtx(mesh)

    def placed(tree):
        return struct_tree(tree, mesh, lambda sp: param_pspec(mesh, sp))

    params = placed(getattr(xl, f"{block}_specs")(cfg, D, torch.bfloat16))
    s = S if mode == "prefill" else 1
    x = meta_dtensor(mesh, (b, s, D), torch.bfloat16,
                     resolve_pspec(mesh, ("dp", None, None), (b, s, D)))
    cache = placed(getattr(xl, f"{block}_cache_specs")(cfg, D, b)) \
        if mode == "decode" else None
    xl.SPLITS.clear()
    counter = CostMode()
    with counter, ctx.scope():
        getattr(xl, f"{block}_apply")(ctx.fsdp_gather(params), cfg, x, cache,
                                      ctx=ctx)
    return counter.flops, dict(xl.SPLITS)


def _port_flops() -> tuple[dict, dict]:
    """``({cell: FLOPs of rank 0}, {cell: the split rules it took})``
    over (1, 1) and MESHES."""
    flops, rules = {}, {}
    for block in BLOCKS:
        for shape in [(1, 1)] + MESHES:
            for mode in MODES:
                key = _key(block, mode, shape)
                flops[key], rules[key] = _count_block(block, shape, mode)
    return flops, rules


@pytest.fixture(scope="module")
def counts():
    """The port's counts and the reference's, the reference compiled in a
    subprocess while the port's are counted."""
    code = _REFERENCE.format(d=D, b=B, s=S, meshes=[(1, 1)] + MESHES)
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src] + [p for p in os.environ.get("PYTHONPATH", "")
                            .split(os.pathsep) if p]))
    ref = subprocess.Popen([sys.executable, "-c", code], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        port, rules = _port_flops()
        out, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, err[-2000:]
    return {"port": port, "rules": rules,
            "reference": json.loads(out.strip().splitlines()[-1])}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("block", BLOCKS)
def test_rank_share_within_the_references(counts, block, mode, shape):
    """A rank's share of the block's FLOPs is at most SHARE_LIMIT x the
    reference's, and the call took the rule that the shapes give."""
    key, one = _key(block, mode, shape), _key(block, mode, (1, 1))
    port = counts["port"][key] / counts["port"][one]
    ref = counts["reference"][key] / counts["reference"][one]
    assert port <= SHARE_LIMIT * ref, \
        f"{key}: the port's rank does {port:.4f} of the block, the " \
        f"reference's {ref:.4f}"
    assert counts["rules"][key] == {(block, RULE[shape]): 1}, \
        counts["rules"][key]


@pytest.mark.timeout(300)
def test_one_device_takes_no_rule(counts):
    """On (1, 1) neither core splits (nothing to split over a model axis
    of 1), and no cell's count is zero."""
    for block in BLOCKS:
        for mode in MODES:
            key = _key(block, mode, (1, 1))
            assert counts["rules"][key] == {}, counts["rules"][key]
            assert counts["port"][key] > 0 and counts["reference"][key] > 0


@pytest.mark.parametrize("mode,batch", [("prefill", 1), ("decode", 4)])
@pytest.mark.parametrize("block", BLOCKS)
def test_whole_batch_shard_where_neither_heads_nor_rows_divide(block, mode,
                                                               batch):
    """On (1, 8) at B 1 (a prefill of S tokens) and B 4 (one decode step)
    the model axis divides neither the 4 heads nor the rows: every model
    rank runs its whole batch shard, the rule the dry run's prefill_32k,
    decode_32k and long_500k cells take on (32, 8). The reference's
    compiled share at these shapes is recorded in ROADMAP (queue 1, item
    5); no bound is held here."""
    flops, rules = _count_block(block, (1, 8), mode, batch)
    assert rules == {(block, "replicated"): 1}, rules
    assert flops > 0
