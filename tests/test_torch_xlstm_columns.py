"""The xLSTM cores split by each head's columns (``nn/xlstm.split_rule``'s
``columns`` rule) in the dry run, at xlstm-350m's width on the fake
(32, 8) production mesh, where the model axis of 8 is the 4 heads times
2 and divides neither the heads nor a rank's rows.

* One block's collectives over the group of a head's 2 model ranks
  (``nn/sharding.head_group``), counted by ``launch/costs.CostMode``
  with ``nn/runtime.scan`` (two trips counted as n, three where autograd
  records them): at most what the reference's compiled loop bodies do a
  trip, one sum a chunk (mLSTM) and one gather a step (sLSTM), outside
  the loops the group norm's two sums and one gather of a whole head's
  operand; the backward the adjoint of each (but the gather of sLSTM's
  zero start). Every count equals a plain loop's over every trip.
* ``dryrun.run_cell`` of the prefill_32k, decode_32k and long_500k cells
  cut to a few hundred tokens: every layer takes ``columns``, the head
  group's collectives count under the model axis (the group is named by
  the mesh axis its ranks differ on), and the prefill's record equals a
  count with a plain loop over every trip.

About 60 s in one process.
"""
from __future__ import annotations

import collections

import pytest
import torch
import torch.distributed as dist

from repro_torch.launch.costs import CostMode
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.nn import runtime
from repro_torch.nn import xlstm as xl
from repro_torch.nn.config import ShapeCell, XLSTMConfig
from repro_torch.nn.param import struct_tree
from repro_torch.nn.sharding import (ShardCtx, head_group, meta_dtensor,
                                     param_pspec, resolve_pspec)

D, H, S = 1024, 4, 256          # xlstm-350m's width; the cut cells' length
CELL_B = 32                     # prefill_32k's batch: 1 row a data rank
CHUNK = 128
CUT = {"prefill_32k": ShapeCell("prefill_32k", S, CELL_B, "prefill"),
       "decode_32k": ShapeCell("decode_32k", S, 128, "decode"),
       "long_500k": ShapeCell("long_500k", S, 1, "decode")}
LAYERS = {("mlstm", "columns"): 21, ("slstm", "columns"): 3}


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """The fake default process group the production meshes make is left
    behind for no later file on the worker."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _plain_scan(step, carry, n, dim=1, stack=True):
    """Every trip, as a loop without ``runtime.scan`` runs it."""
    ys = []
    for t in range(n):
        carry, y = step(t, carry)
        ys.append(y)
    return carry, (torch.stack if stack else torch.cat)(ys, dim)


def _block_run(kind: str, recorded: bool):
    """A call of the block ``kind`` at the cut cell's batch and length on
    ``meta`` shards over the fake (32, 8) mesh (a forward and backward
    where ``recorded``), and the mesh."""
    cfg = XLSTMConfig(kind=kind, n_heads=H, proj_factor=2.0, chunk=CHUNK)
    mesh = make_production_mesh(shape=(32, 8))
    ctx = ShardCtx(mesh)
    specs = getattr(xl, f"{kind}_specs")(cfg, D, torch.float32)
    apply = getattr(xl, f"{kind}_apply")

    def run():
        params = struct_tree(specs, mesh, lambda sp: param_pspec(mesh, sp))
        x = meta_dtensor(mesh, (CELL_B, S, D), torch.float32,
                         resolve_pspec(mesh, ("dp", None, None),
                                       (CELL_B, S, D)))
        if recorded:
            params = {k: v.requires_grad_() for k, v in params.items()}
            x.requires_grad_()
        with ctx.scope():
            y = apply(ctx.fsdp_gather(params), cfg, x, ctx=ctx)[0]
            if recorded:
                y.sum().backward()
    return run, mesh


def _count(run, scan, monkeypatch) -> CostMode:
    monkeypatch.setattr(runtime, "scan", scan)
    counter = CostMode()
    with counter:
        run()
    return counter


# a block's collectives over its head group, (op, forward or backward):
# a trip's, and the rest's (outside the loop)
TRIP = {"mlstm": collections.Counter({"all_reduce": 1}),
        "slstm": collections.Counter({"all_gather_into_tensor": 1})}
OUTSIDE = {"mlstm": collections.Counter({"all_reduce": 2,
                                         "all_gather_into_tensor": 1}),
           "slstm": collections.Counter({"all_reduce": 2,
                                         "all_gather_into_tensor": 1})}
ADJOINT = {"all_reduce": "all_reduce",
           "all_gather_into_tensor": "reduce_scatter_tensor"}


@pytest.mark.parametrize("recorded", [False, True],
                         ids=["forward", "backward"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_head_group_collectives_a_trip(kind, recorded, monkeypatch):
    """The head group's collectives: one sum a chunk (mLSTM) or one
    gather a step (sLSTM) and, outside the loop, the group norm's two sums
    and one gather; with a backward, each again as its adjoint (a sum's
    gradient a sum, a gather's a reduce-scatter). Every count, of the
    head group's and of all, equals a plain loop's over every trip."""
    run, mesh = _block_run(kind, recorded)
    xl.SPLITS.clear()
    got = _count(run, runtime.scan, monkeypatch)
    assert dict(xl.SPLITS) == {(kind, "columns"): 1}
    want = _count(run, _plain_scan, monkeypatch)
    assert (got.flops, got.bytes, got.peak, got.collectives) == \
        (want.flops, want.bytes, want.peak, want.collectives)
    group = head_group(mesh, H).group_name
    ops = collections.Counter(op for op, _, g in got.collectives
                              if g == group)
    trips = S // CHUNK if kind == "mlstm" else S
    expect = collections.Counter()
    for op, n in TRIP[kind].items():
        expect[op] += n * trips
    expect.update(OUTSIDE[kind])
    if recorded:
        for op, n in list(expect.items()):
            expect[ADJOINT[op]] += n
        if kind == "slstm":
            # step 0 gathers h's zero start, which takes no gradient
            expect["reduce_scatter_tensor"] -= 1
    assert ops == expect, (ops, expect)


def test_head_group_is_named_by_the_model_axis():
    """The dry run names a group by the mesh axes its ranks differ on:
    the head group's 2 ranks differ on the model axis alone."""
    from repro_torch.launch import dryrun

    mesh = make_production_mesh(shape=(32, 8))
    group = head_group(mesh, H)
    assert head_group(mesh, H) is group
    assert dist.get_process_group_ranks(group) == [0, 1]
    assert dryrun._group_axes(mesh, [group.group_name]) == \
        {group.group_name: ("model", 2)}


@pytest.mark.parametrize("shape", sorted(CUT))
def test_cut_cells_split_by_columns(shape, monkeypatch):
    """xlstm-350m's prefill_32k, decode_32k and long_500k on (32, 8), cut
    to S tokens: every layer's core takes ``columns``, every collective
    counts under the model axis, and a prefill's record equals a count
    with a plain loop over every trip (a decode step's loops have one
    trip)."""
    from repro_torch.launch import dryrun

    def record(scan):
        monkeypatch.setattr(runtime, "scan", scan)
        xl.SPLITS.clear()
        rec = dryrun.run_cell("xlstm-350m", shape, False, verbose=False,
                              cell=CUT[shape])
        return rec, dict(xl.SPLITS)

    rec, splits = record(runtime.scan)
    assert rec["status"] == "OK"
    assert splits == LAYERS
    assert set(rec["wire_by_axis"]) == {"model"}
    assert rec["wire_by_axis"]["model"] == rec["wire_bytes_per_device"] > 0
    if CUT[shape].kind != "prefill":
        return
    plain, _ = record(_plain_scan)
    keys = ("flops_per_device", "bytes_per_device", "hbm_per_device",
            "wire_bytes_per_device", "coll_by_op", "coll_counts")
    assert {k: rec[k] for k in keys} == {k: plain[k] for k in keys}
