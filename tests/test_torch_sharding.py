"""The port's sharding plan against the reference's: ``resolve_pspec`` over
a fixed grid, ``param_pspec`` for every leaf of the ten assigned configs'
parameter, optimizer-state and cache trees on the reference's meshes and
the H100 ones, the per-device bytes, and the DTensor placements of a pspec
against ``NamedSharding``'s shards. Pure logic over stub meshes (a few
seconds of tier-1)."""
from __future__ import annotations

import itertools
import math

import jax
import jax.numpy as jnp
import pytest

from repro.configs import get_config as ref_get_config
from repro.models.lm import LM as RefLM
from repro.nn import sharding as ref_sh
from repro.nn.param import ParamSpec as RefSpec
from repro.train.optim import AdamWConfig as RefAdamW
from repro.train.optim import state_specs as ref_state_specs
from repro_torch.configs import ASSIGNED, get_config
from repro_torch.models.lm import LM
from repro_torch.nn import sharding as sh
from repro_torch.nn.param import ParamSpec
from repro_torch.train.optim import AdamWConfig, state_specs


class StubMesh:
    """The reference's stub (``tests/test_nn.py``): axis sizes only."""

    def __init__(self, shape: tuple[int, ...]):
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        self.shape = dict(zip(names, shape))
        self.axis_names = names
        self.mesh_dim_names = names


CONFIGS = {"default": (ref_sh.ShardingConfig, sh.ShardingConfig),
           "fsdp_only": (ref_sh.ShardingConfig.fsdp_only,
                         sh.ShardingConfig.fsdp_only),
           "fsdp_hybrid": (ref_sh.ShardingConfig.fsdp_hybrid,
                           sh.ShardingConfig.fsdp_hybrid)}
DIMS = (1, 2, 3, 8, 12, 28, 56, 64, 96, 128, 1600, 4096, 4100, 49155,
        49280, 65536)
SIZES = (1, 2, 4, 8, 16, 32)
LOGICAL = (("fsdp", "model"), ("model", "fsdp"), ("dp", None),
           ("expert", "fsdp", None), ("dp", "kv_seq", None, None),
           ("dp", "seq", None), (None, "dp", None), ("model",),
           ("data", "model"), (("pod", "data"), None))
MESHES = ((16, 16), (2, 16, 16), (32, 8), (2, 32, 8))


def _ref_tuple(ps) -> tuple:
    return tuple(ps)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("plan", sorted(CONFIGS))
def test_resolve_pspec_matches_reference_on_a_grid(plan, ndim):
    """The reference's own test of this is a hypothesis test (a skip
    here); this grid is fixed, every (dim, data, model[, pod]) of it."""
    ref_cfg, cfg = CONFIGS[plan][0](), CONFIGS[plan][1]()
    n = 0
    for sizes in itertools.product(SIZES, repeat=ndim):
        mesh = StubMesh(sizes)
        for axes in LOGICAL:
            for dims in itertools.product(DIMS[::3] if ndim == 3 else DIMS,
                                          repeat=1):
                shape = tuple(dims[0] * (i + 1) for i in range(len(axes)))
                want = _ref_tuple(ref_sh.resolve_pspec(mesh, axes, shape,
                                                       ref_cfg))
                assert sh.resolve_pspec(mesh, axes, shape, cfg) == want, \
                    (sizes, axes, shape)
                n += 1
    assert n > 1000


def _unstack(ref_tree, n_blocks: int, repeat: int):
    """A reference superblock tree (each position stacked over ``repeat``
    when above 1) as the port's list of layers, each leaf ``(spec,
    stacked)``."""
    def leaf(spec):
        return (spec, repeat > 1)

    def walk(t):
        if isinstance(t, RefSpec):
            return leaf(t)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return [walk(v) for v in t]

    return [walk(ref_tree[f"l{i % n_blocks}"])
            for i in range(repeat * n_blocks)]


def _ref_layout(ref_tree, cfg):
    """A reference LM tree in the port's layout (``_unstack``); leaves
    ``(spec, stacked)``."""
    def walk(t):
        if isinstance(t, RefSpec):
            return (t, False)
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return [walk(v) for v in t]

    out = {k: walk(v) for k, v in ref_tree.items()
           if k not in ("prefix", "blocks", "enc_blocks")}
    out["layers"] = [walk(l) for l in ref_tree.get("prefix", [])] + \
        _unstack(ref_tree["blocks"], len(cfg.blocks), cfg.n_repeat)
    if "enc_blocks" in ref_tree:
        out["enc_layers"] = _unstack(ref_tree["enc_blocks"],
                                     len(cfg.enc_blocks), cfg.enc_repeat)
    return out


def _pairs(port, ref, path=""):
    if isinstance(port, ParamSpec):
        yield path, port, ref
        return
    if isinstance(port, dict):
        assert set(port) == set(ref), (path, sorted(port), sorted(ref))
        for k in port:
            yield from _pairs(port[k], ref[k], f"{path}/{k}")
        return
    assert len(port) == len(ref), path
    for i, (a, b) in enumerate(zip(port, ref)):
        yield from _pairs(a, b, f"{path}/{i}")


def _local_bytes(mesh, shape, dtype_bytes, pspec) -> int:
    return math.prod(sh.local_shape(mesh, shape, pspec)) * dtype_bytes


def _trees(name: str):
    """(port, reference-in-port-layout) spec trees: parameters, AdamW
    state (bf16, as the big train plans keep it) and decode caches at
    batch 128 and at batch 1 (the sequence-sharded layout)."""
    cfg, ref_cfg = get_config(name), ref_get_config(name)
    lm, ref = LM(cfg), RefLM(ref_cfg)
    enc = 64 if cfg.enc_dec else 0
    out = []
    p, rp = lm.param_specs(), ref.param_specs()
    out.append((p, _ref_layout(rp, ref_cfg), rp))
    st = state_specs(AdamWConfig(state_dtype="bfloat16"), p)
    rst = ref_state_specs(RefAdamW(state_dtype="bfloat16"), rp)
    out.append((st["m"], _ref_layout(rst["m"], ref_cfg), rst["m"]))
    out.append(({"step": st["step"]}, {"step": (rst["step"], False)},
                {"step": rst["step"]}))
    for b in (128, 1):
        c = lm.cache_specs(b, 4096, enc_len=enc)
        rc = ref.cache_specs(b, 4096, enc_len=enc)
        out.append((c, _ref_layout(rc, ref_cfg), rc))
    return out


@pytest.mark.parametrize("mesh_shape", MESHES,
                         ids=["x".join(map(str, m)) for m in MESHES])
@pytest.mark.parametrize("name", ASSIGNED)
def test_param_pspecs_and_bytes_match_reference(name, mesh_shape):
    """Every leaf's pspec is the reference's (a stacked leaf's without its
    leading layer dim), and the per-device bytes of each tree sum to the
    reference's."""
    mesh = StubMesh(mesh_shape)
    for port, ref, raw in _trees(name):
        got = 0
        for path, spec, (rspec, stacked) in _pairs(port, ref):
            rps = _ref_tuple(ref_sh.param_pspec(mesh, rspec))
            if stacked:
                assert rps[:1] in ((), (None,)), (path, rps)
                rps = rps[1:]
            assert sh.param_pspec(mesh, spec) == rps, (path, spec.axes)
            shape = rspec.shape[1:] if stacked else rspec.shape
            assert spec.shape == shape, path
            got += _local_bytes(mesh, spec.shape, spec.dtype.itemsize,
                                sh.param_pspec(mesh, spec))
        want = sum(
            _local_bytes(mesh, r.shape, jnp.dtype(r.dtype).itemsize,
                         _ref_tuple(ref_sh.param_pspec(mesh, r)))
            for r in jax.tree.leaves(raw, is_leaf=lambda x:
                                     isinstance(x, RefSpec)))
        assert got == want, (name, got, want)


PSPECS = [(("pod", "data"), "model"), (None, ("pod", "data")),
          ("model", ("data",)), (("data", "model"),), ("pod", "data")]
_NAMED = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
devs = np.array(jax.devices()).reshape(2, 16, 16)
mesh = Mesh(devs, ("pod", "data", "model"))
out = []
for ps in json.loads({pspecs!r}):
    ps = [tuple(e) if isinstance(e, list) else e for e in ps]
    m = NamedSharding(mesh, P(*ps)).devices_indices_map((512, 64))
    out.append([[list(c), [[s.start or 0, s.stop if s.stop is not None
                            else n] for s, n in zip(m[devs[c]], (512, 64))]]
                for c in np.ndindex(2, 16, 16)])
print(json.dumps(out))
"""


@pytest.mark.timeout(120)
def test_placements_shard_as_named_sharding():
    """DTensor's shard of every device of a (2, 16, 16) mesh (local shape
    and offset, from :func:`placements`) is the block ``NamedSharding``
    gives that device (512 host devices, in a subprocess): a dim split
    over (pod, data) is split pod-major in both."""
    import json
    import os
    import subprocess
    import sys

    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)

    code = _NAMED.format(pspecs=json.dumps(PSPECS))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=110)
    assert run.returncode == 0, run.stderr[-2000:]
    named = json.loads(run.stdout.strip().splitlines()[-1])
    mesh_shape = (2, 16, 16)
    stub = _SizedStub(mesh_shape)
    for pspec, blocks in zip(PSPECS, named):
        pl = sh.placements(stub, pspec)
        for coord, box in blocks:
            local, off = _compute_local_shape_and_global_offset(
                (512, 64), mesh_shape, coord, pl)
            want_local = tuple(hi - lo for lo, hi in box)
            want_off = tuple(lo for lo, _ in box)
            assert (tuple(local), tuple(off)) == (want_local, want_off), \
                (pspec, coord)


class _SizedStub:
    """A mesh's names and per-dim sizes, as ``placements`` reads them."""

    def __init__(self, shape):
        self.mesh_dim_names = ("pod", "data", "model")
        self.shape = tuple(shape)
