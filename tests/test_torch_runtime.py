"""``nn/runtime.scan``, a loop of same-shaped trips counted once and
multiplied (the role of the reference's ``nn/runtime.py``), and the dry
run it makes finish.

* Under ``launch/costs.CostMode`` the helper runs two trips and counts
  ``n``: its FLOPs, bytes accessed, collectives and peak equal those of a
  plain loop over every trip of the same step (``_plain_scan``, what the
  cores ran before), for the sLSTM and mLSTM blocks at xlstm-350m's
  width (d_model 1024, 4 heads, proj 2, chunk 128, bf16 parameters) at
  S 512 with no mesh and on the fake (32, 8) production mesh, for a
  Mamba block at jamba's width, for a step with a collective in every
  trip, and where autograd records the trips (the helper then runs them
  all).
* Eagerly its outputs are bitwise those of the cores' old loops (copied
  here as they were).
* ``dryrun.run_cell`` of xlstm-350m's ``prefill_32k`` cut to S 512 counts
  383,420,497,920 FLOPs a device, and the bytes and memory of a count of
  every trip.

About 25 s in one process.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.costs import CostMode
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn import runtime
from repro_torch.nn import ssm
from repro_torch.nn import xlstm as xl
from repro_torch.nn.basic import f32, f32_dtype
from repro_torch.nn.config import MambaConfig, ShapeCell, XLSTMConfig
from repro_torch.nn.param import struct_tree
from repro_torch.nn.sharding import (NO_MESH, ShardCtx, meta_dtensor,
                                     param_pspec, resolve_pspec)

D, S = 1024, 512                # xlstm-350m's width; the cut cell's length
CELL_B = 32                     # prefill_32k's batch: 1 row a data rank
XL_CFG = {k: XLSTMConfig(kind=k, n_heads=4, proj_factor=2.0, chunk=128)
          for k in ("slstm", "mlstm")}
MAMBA_CFG = MambaConfig(d_state=16, d_conv=4, expand=2, chunk=256)
MAMBA_D = 8192                  # jamba-1.5-large's d_model
MAMBA_S = 2048                  # 8 of its chunks

# the cut cell's per-device counts, by a count of every trip
CELL_FLOPS = 383_420_497_920
CELL_BYTES = 17_958_253_692
CELL_HBM = 282_646_088


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """The fake default process group the production meshes make is left
    behind for no later file on the worker."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _plain_scan(step, carry, n, dim=1, stack=True):
    """Every trip, as the cores' loops ran before the helper."""
    ys = []
    for t in range(n):
        carry, y = step(t, carry)
        ys.append(y)
    return carry, (torch.stack if stack else torch.cat)(ys, dim)


def _tripping(scan, trips: list):
    """``scan`` appending each trip it runs to ``trips``."""
    def counting(step, carry, n, dim=1, stack=True):
        def seen(t, c):
            trips.append(t)
            return step(t, c)
        return scan(seen, carry, n, dim, stack)
    return counting


def _counted(run, scan, monkeypatch) -> dict:
    """``run()``'s counts under a CostMode with ``runtime.scan`` as
    ``scan``."""
    monkeypatch.setattr(runtime, "scan", scan)
    counter = CostMode()
    with counter:
        run()
    assert runtime.COUNTERS == []
    return {"flops": counter.flops, "bytes": counter.bytes,
            "peak": counter.peak, "collectives": counter.collectives}


def _block(kind: str, mesh_shape):
    """A call of the block ``kind`` on ``meta`` inputs: over the fake
    production mesh of ``mesh_shape`` at the cell's batch, or with no mesh
    at one data rank's row."""
    cfg, d = (MAMBA_CFG, MAMBA_D) if kind == "mamba" else (XL_CFG[kind], D)
    mod = ssm if kind == "mamba" else xl
    specs = getattr(mod, f"{kind}_specs")(cfg, d, torch.bfloat16)
    apply = getattr(mod, f"{kind}_apply")
    if mesh_shape is None:
        params = {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
                  for k, s in specs.items()}
        s = MAMBA_S if kind == "mamba" else S
        x = torch.empty((1, s, d), dtype=torch.bfloat16, device="meta")
        return lambda: apply(params, cfg, x, ctx=NO_MESH)
    mesh = make_production_mesh(shape=mesh_shape)
    ctx = ShardCtx(mesh)
    params = struct_tree(specs, mesh, lambda sp: param_pspec(mesh, sp))
    x = meta_dtensor(mesh, (CELL_B, S, d), torch.bfloat16,
                     resolve_pspec(mesh, ("dp", None, None), (CELL_B, S, d)))

    def run():
        with ctx.scope():
            apply(ctx.fsdp_gather(params), cfg, x, ctx=ctx)
    return run


@pytest.mark.parametrize("kind,mesh_shape", [
    ("slstm", None), ("slstm", (32, 8)), ("mlstm", None), ("mlstm", (32, 8)),
    ("mamba", None)])
def test_counts_equal_a_plain_loop(kind, mesh_shape, monkeypatch):
    """Two trips counted as n give every count of n trips."""
    run = _block(kind, mesh_shape)
    fast, full = [], []
    got = _counted(run, _tripping(runtime.scan, fast), monkeypatch)
    want = _counted(run, _tripping(_plain_scan, full), monkeypatch)
    assert got == want
    assert fast == [0, 1] and len(full) == (512 if kind == "slstm" else 4
                                            if kind == "mlstm" else 8)
    assert got["flops"] > 0 and got["bytes"] > 0 and got["peak"] > 0


def test_collectives_of_every_trip_are_counted(monkeypatch):
    """A step whose trip all-reduces a row-parallel product: the
    collectives (op, bytes, group) of n trips, and the rest."""
    from torch.distributed.tensor import Replicate

    mesh = make_production_mesh(shape=(4, 2))
    w1 = meta_dtensor(mesh, (64, 128), torch.float32, (None, "model"))
    w2 = meta_dtensor(mesh, (128, 64), torch.float32, ("model", None))
    h0 = meta_dtensor(mesh, (8, 64), torch.float32, (None, None))

    def step(t, h):
        y = ((h @ w1) @ w2).redistribute(mesh, [Replicate(), Replicate()])
        return y, y

    got = _counted(lambda: runtime.scan(step, h0, 7), runtime.scan,
                   monkeypatch)
    want = _counted(lambda: _plain_scan(step, h0, 7), _plain_scan,
                    monkeypatch)
    assert got == want
    assert len(got["collectives"]) == 7


@pytest.mark.parametrize("kind", ["slstm", "mlstm"])
def test_recorded_trips_all_run(kind, monkeypatch):
    """Where autograd records the trips, the helper runs every one, so
    that a backward sees them: a forward and backward count the same as
    the plain loop's, and the step ran n times."""
    cfg = XL_CFG[kind]
    specs = getattr(xl, f"{kind}_specs")(cfg, 64, torch.float32)
    trips = []

    def run():
        params = {k: torch.empty(s.shape, device="meta", requires_grad=True)
                  for k, s in specs.items()}
        x = torch.empty((2, 16, 64), device="meta", requires_grad=True)
        cfg_small = XLSTMConfig(kind=kind, n_heads=4, proj_factor=2.0,
                                chunk=4)
        y, _ = getattr(xl, f"{kind}_apply")(params, cfg_small, x)
        y.sum().backward()

    got = _counted(run, _tripping(runtime.scan, trips), monkeypatch)
    assert len(trips) == (16 if kind == "slstm" else 4)
    assert got == _counted(run, _plain_scan, monkeypatch)


# ------------------------------------------------- the old loops, eagerly


def _old_mlstm_chunked(cfg, q, k, v, i_pre, logf):
    b, s, h, dh = q.shape
    cs = min(cfg.chunk, s)
    wide = dict(dtype=f32_dtype(q.dtype), device=q.device)
    c_prev = torch.zeros((b, h, dh, dh), **wide)
    n_prev = torch.zeros((b, h, dh), **wide)
    m_prev = torch.zeros((b, h), **wide)
    tri = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=q.device))
    ys = []
    for lo in range(0, s, cs):
        sl = slice(lo, lo + cs)
        qf, kf, vf = f32(q[:, sl]), f32(k[:, sl]), f32(v[:, sl])
        ib, fb = i_pre[:, sl], logf[:, sl]
        fcum = torch.cumsum(fb, dim=1)
        ftot = fcum[:, -1]
        lam = fcum + m_prev[:, None, :]
        dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + ib[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, -math.inf)
        m_t = torch.maximum(lam, torch.amax(dmat, dim=2))
        w_carry = torch.exp(lam - m_t)
        num_carry = torch.einsum("bthd,bhdv->bthv", qf, c_prev) \
            * w_carry[..., None]
        den_carry = torch.einsum("bthd,bhd->bth", qf, n_prev) * w_carry
        wmat = torch.exp(dmat - m_t[:, :, None, :])
        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * wmat
        num = num_carry + torch.einsum("btsh,bshv->bthv", scores, vf)
        den = den_carry + torch.sum(scores, dim=2)
        ys.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_t))[..., None])
        w_log = ib + (ftot[:, None] - fcum)
        m_new = torch.maximum(ftot + m_prev, torch.amax(w_log, dim=1))
        wi = torch.exp(w_log - m_new[:, None])
        decay = torch.exp(ftot + m_prev - m_new)
        c_prev = decay[:, :, None, None] * c_prev + torch.einsum(
            "bthd,bth,bthv->bhdv", kf, wi, vf)
        n_prev = decay[..., None] * n_prev + torch.einsum(
            "bthd,bth->bhd", kf, wi)
        m_prev = m_new
    return torch.cat(ys, dim=1)


def _old_slstm_core(dtype, x, w_gates, b_gates, r, gn_scale):
    b, s, _ = x.shape
    nh, dh = r.shape[0], r.shape[1]
    wx = f32(x) @ f32(w_gates) + b_gates
    wx = wx.reshape(b, s, nh, 4 * dh)
    wide = dict(dtype=f32_dtype(x.dtype), device=x.device)
    hs, c, m = (torch.zeros((b, nh, dh), **wide) for _ in range(3))
    n = torch.ones((b, nh, dh), **wide)
    ys = []
    for t in range(s):
        g = wx[:, t] + torch.einsum("bhd,hdg->bhg", hs, r)
        i_pre, f_pre, z_pre, o_pre = torch.chunk(g, 4, dim=-1)
        m_t = torch.maximum(f_pre + m, i_pre)
        i_g = torch.exp(i_pre - m_t)
        f_g = torch.exp(f_pre + m - m_t)
        c = f_g * c + i_g * torch.tanh(z_pre)
        n = f_g * n + i_g
        hs = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        m = m_t
        ys.append(hs)
    y = torch.stack(ys, dim=1)
    y = xl._headwise_norm(y, gn_scale).to(dtype).reshape(b, s, nh * dh)
    return y, hs, c, n, m


def _rand(rng, *shape, scale=1.0, dtype=torch.float32):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,chunk", [(12, 4), (16, 16), (40, 8)])
def test_eager_mlstm_bitwise_the_old_loop(s, chunk, dtype):
    rng = np.random.default_rng(s + chunk)
    b, h, dh = 2, 4, 8
    cfg = XLSTMConfig(kind="mlstm", n_heads=h, proj_factor=2.0, chunk=chunk)
    q, k, v = (_rand(rng, b, s, h, dh, dtype=dtype) for _ in range(3))
    i_pre = _rand(rng, b, s, h)
    logf = F.logsigmoid(_rand(rng, b, s, h) + 2.0)
    got = xl._mlstm_chunked(cfg, q, k, v, i_pre, logf)
    assert torch.equal(got, _old_mlstm_chunked(cfg, q, k, v, i_pre, logf))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [1, 2, 3, 37])
def test_eager_slstm_bitwise_the_old_loop(s, dtype):
    rng = np.random.default_rng(s)
    b, h, dh = 2, 4, 8
    d = h * dh
    args = (_rand(rng, b, s, d, dtype=dtype),
            _rand(rng, d, 4 * d, scale=0.2, dtype=dtype),
            _rand(rng, 4 * d, scale=0.1), _rand(rng, h, dh, 4 * dh,
                                                scale=0.2),
            1.0 + _rand(rng, d, scale=0.1))
    got = xl._slstm_core(dtype, *args)
    want = _old_slstm_core(dtype, *args)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


# ---------------------------------------------------------- the dry run


def test_cut_prefill_cell_counts_every_trip():
    """xlstm-350m's prefill_32k at S 512 on the (32, 8) mesh: the FLOPs of
    the loops that ran every trip, and the bytes and memory of a count of
    every trip."""
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell("xlstm-350m", "prefill_32k", False, verbose=False,
                          cell=ShapeCell("prefill_32k", S, CELL_B,
                                         "prefill"))
    assert rec["status"] == "OK"
    assert rec["flops_per_device"] == CELL_FLOPS
    assert rec["bytes_per_device"] == CELL_BYTES
    assert rec["hbm_per_device"] == CELL_HBM
