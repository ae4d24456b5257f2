"""The mesh trainer's step as the card captures it, one CUDA graph a rank
(``launch/steps.TrainStepGraph`` over a mesh, the reference's
``jax.jit(step, donate_argnums=(0, 1))`` over its mesh), rehearsed on
the CPU where there is no card and no capture:

* the donated DTensor step of shrunk granite-3-8b and deepseek-v2 (MoE,
  MLA) at 1 and 2 microbatches, and of shrunk xlstm-350m (its cores over
  whole heads a rank) at 1, through the owner's own static batch
  (DTensors over per-rank local buffers), on ``meta`` shards over a fake
  process group of a (2, 2) mesh, under ``CaptureRehearsal``
  (tests/test_torch_train_graph.py); and the rehearsal failing when the
  batch path of the trainer before the owner (a whole batch copied up
  and placed by ``distribute_tensor``'s scatter from rank 0) or a host
  zero is planted into the step;
* ``nn/sharding.distribute`` issues no collective (the form with a
  source rank does), and its shards, ``local_part``'s cuts and
  ``dtensor_of``'s DTensors are the blocks ``NamedSharding`` would give
  rank 0;
* the owner on a mesh takes only this rank's slice of a batch, and
  refuses a batch off its layout.

tests/test_torch_train_mesh.py holds the same owner on four gloo ranks:
bitwise the eager mesh path it replaced, within 1e-5 of the reference's
jitted step on carried parameters, and its restart in place.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.distributed.tensor as dtensor_mod
from test_torch_train_graph import PLANTS, CaptureRehearsal
from test_torch_train_mesh import Collectives

from repro_torch.configs import get_config, shrink
from repro_torch.configs.common import input_layout
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import TrainStepGraph, make_train_step
from repro_torch.models.lm import LM
from repro_torch.nn.config import ShapeCell
from repro_torch.nn.param import struct_tree
from repro_torch.nn.sharding import (distribute, dtensor_of, local_part,
                                     local_shape, param_pspec, placements,
                                     pspec_of, resolve_pspec)
from repro_torch.train import optim

VOCAB, D = 128, 64
CELL = ShapeCell("train", 16, 4, "train")   # two rows a data rank
MESH = (2, 2)


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """Every test here runs on the fake default process group the
    production mesh makes (rank 0 of 512); none is left behind for the
    next file on the worker."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.manual_seed(0)


def _mesh():
    return make_production_mesh(shape=MESH)


def _old_distribute(mesh, x, pspec):
    """``distribute`` as it was: ``distribute_tensor``'s default scatters
    (or broadcasts) rank 0's tensor."""
    return dtensor_mod.distribute_tensor(x, mesh, placements(mesh, pspec))


def _batch_copied_up(step, mesh, layout):
    """The trainer's batch path before the owner, inside the step: a
    whole host batch copied up, then placed by the old distribute."""
    def planted(params, opt, batch):
        placed = {k: _old_distribute(mesh, torch.zeros(shape, dtype=dt)
                                     .to("meta"), ps)
                  for k, (shape, dt, ps) in layout.items()}
        return step(params, opt, placed)
    return planted


def _batch_scattered(step, mesh, layout):
    """The same with the whole batch already on the device: placed by
    the old distribute's scatter from rank 0 every step."""
    whole = {k: torch.zeros(shape, dtype=dt, device="meta")
             for k, (shape, dt, _) in layout.items()}

    def planted(params, opt, batch):
        return step(params, opt, {k: _old_distribute(mesh, whole[k], ps)
                                  for k, (_, _, ps) in layout.items()})
    return planted


def rehearse_mesh(name: str, micro: int, remat: str, plant=None) -> dict:
    """One donated training step of the shrunk ``name`` over the (2, 2)
    mesh as a rank's capture would run it: the owner's step over DTensor
    parameters and AdamW state with ``meta`` shards and the owner's static
    batch of every input the config takes, under
    :class:`CaptureRehearsal`. ``plant(step, mesh, layout)`` wraps the
    step first."""
    mesh = _mesh()
    cfg = shrink(get_config(name), d_model=D, vocab=VOCAB, n_repeat=1)
    lm = LM(cfg)
    opt_cfg = optim.AdamWConfig()
    params = struct_tree(lm.param_specs(), mesh,
                         lambda s: param_pspec(mesh, s))
    state = {"params": params, "opt": optim.init_state(opt_cfg, params)}
    layout = input_layout(cfg, CELL, mesh)
    step = make_train_step(cfg, opt_cfg, remat=remat, microbatches=micro,
                           donate=True, mesh=mesh)
    if plant is not None:
        step = plant(step, mesh, layout)
    owner = TrainStepGraph(step, state, layout, lambda: None, mesh)
    assert owner.graph is None
    mode = CaptureRehearsal()
    with mode, mode.watching_constructors():
        metrics = owner._step()
    return metrics


@pytest.mark.parametrize("micro,remat", [(1, "none"), (2, "dots")])
@pytest.mark.parametrize("name", ["granite-3-8b", "deepseek-v2-236b"])
def test_mesh_capture_rehearsal_passes(name, micro, remat):
    metrics = rehearse_mesh(name, micro, remat)
    for k in ("loss", "lr", "grad_norm"):
        t = metrics[k]
        local = t.to_local() if isinstance(t, dtensor_mod.DTensor) else t
        assert local.device.type == "meta" and local.ndim == 0, k


def test_mesh_capture_rehearsal_passes_xlstm():
    """Shrunk xlstm-350m's step over the mesh, its two heads split whole
    over the model axis in both cores (``nn/xlstm.split_rule``): the
    regions read nothing of the device on the host and copy nothing up."""
    from repro_torch.nn import xlstm as xl

    xl.SPLITS.clear()
    metrics = rehearse_mesh("xlstm-350m", 1, "none")
    assert metrics["loss"].to_local().device.type == "meta"
    assert set(xl.SPLITS) == {("mlstm", "heads"), ("slstm", "heads")}, \
        xl.SPLITS


@pytest.mark.parametrize("plant", ["batch_copied_up", "batch_scattered",
                                   "steps_loss_start"])
def test_mesh_capture_rehearsal_fails_on_a_plant(monkeypatch, plant):
    wrap = {"batch_copied_up": _batch_copied_up,
            "batch_scattered": _batch_scattered}.get(plant)
    if wrap is None:
        module, attr, old = PLANTS[plant]
        monkeypatch.setattr(module, attr, old(getattr(module, attr)))
    with pytest.raises(AssertionError,
                       match="copied up|scatter from rank 0"):
        rehearse_mesh("granite-3-8b", 2, "none", wrap)


# ------------------------------------------------ distribute, local shards


def _block(x, mesh, pspec):
    """Rank 0's block of ``x`` under ``pspec``, as ``NamedSharding``
    places it: the first block of every split dim."""
    shape = local_shape(mesh, tuple(x.shape), pspec)
    return x[tuple(slice(0, n) for n in shape)]


PSPECS = [(("data",), (4, 6)), ((None, "model"), (4, 6)),
          ((("data", "model"),), (8, 3)), ((), (4, 6)),
          (("data", "model"), (2, 2, 5))]


@pytest.mark.parametrize("pspec,shape", PSPECS)
def test_distribute_is_local_and_issues_no_collective(pspec, shape):
    mesh = _mesh()
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32
                     ).reshape(shape)
    want = _block(x, mesh, pspec)
    with Collectives() as new:
        d = distribute(mesh, x, pspec)
    assert new.ops == []
    assert torch.equal(d.to_local(), want) and tuple(d.shape) == shape
    assert torch.equal(local_part(x, mesh, pspec), want)
    assert np.array_equal(local_part(x.numpy(), mesh, pspec), want.numpy())
    assert pspec_of(d) == pspec
    # the form it replaced scattered or broadcast rank 0's tensor
    with Collectives() as old:
        _old_distribute(mesh, x, pspec)
    assert old.ops and {f.namespace for f in old.ops} == {"c10d"}


def test_no_mesh_places_nothing():
    """Without a mesh the placement helpers are identities, so the owner
    and the trainer's state run one path with a mesh or without."""
    x = torch.arange(24.0).reshape(4, 6)
    assert resolve_pspec(None, ("dp", None), (4, 6)) == ()
    assert local_shape(None, (4, 6), ()) == (4, 6)
    assert local_part(x, None, ()) is x
    assert dtensor_of(None, x, (4, 6), ()) is x


def test_dtensor_of_wraps_the_callers_buffer():
    mesh = _mesh()
    local = torch.zeros(local_shape(mesh, (4, 6), ("data",)))
    d = dtensor_of(mesh, local, (4, 6), ("data",))
    assert tuple(d.shape) == (4, 6) and d.to_local().data_ptr() == \
        local.data_ptr()
    local.fill_(3.0)
    assert torch.equal(d.to_local(), torch.full((2, 6), 3.0))


def test_mesh_owner_stages_this_ranks_slice():
    """The owner's static batch on the (2, 2) mesh: DTensors of the global
    shapes over local buffers of the rank's two rows; a call stages only
    those rows, and a batch off its layout is refused."""
    mesh = _mesh()
    cfg = shrink(get_config("granite-3-8b"), d_model=D, vocab=VOCAB,
                 n_repeat=1)
    layout = input_layout(cfg, CELL, mesh)
    seen = []

    def step(params, opt, batch):
        seen.append({k: v.to_local().clone() for k, v in batch.items()})
        return params, opt, {}

    state = {"params": {"w": dtensor_of(mesh, torch.zeros(2, 3), (4, 3),
                                        ("data",))}, "opt": {}}
    owner = TrainStepGraph(step, state, layout, lambda: None, mesh)
    assert {k: tuple(v.shape) for k, v in owner.batch.items()} == \
        {"tokens": (4, 16), "labels": (4, 16)}
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, VOCAB, (4, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    owner(batch)
    for k, v in batch.items():
        assert torch.equal(seen[-1][k], torch.from_numpy(v[:2]))
    with pytest.raises(ValueError, match="keys"):
        owner({"tokens": batch["tokens"]})
    with pytest.raises(ValueError, match="static batch"):
        owner({**batch, "tokens": batch["tokens"][:2]})
    assert len(seen) == 1
