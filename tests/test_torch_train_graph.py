"""The graph-ready trainer and embedder of the port: the reference's
``jax.jit(step, donate_argnums=(0, 1))`` (``launch/train.py``) and its
jitted embedder encode run on the card as CUDA graphs
(``launch/steps.TrainStepGraph``, ``core/embedder.ModelEmbedder``). There
is no card here, so:

* a rehearsal of the capture: the training step of five shrunk configs
  runs on ``meta`` tensors under a dispatch mode that fails on what a
  capture refuses or would freeze (a read of the device on the host, a
  copy from the host into the step's device, a host tensor of one or more
  dims beside the step's tensors), and fails again when one of the host
  copies the step made before is planted back;
* the owner's eager form, which the CPU runs, against ``make_train_step``
  (bitwise) and the reference's jitted step (rtol 1e-5, fp32: sums in
  another order) on carried parameters, at 1 and 2 microbatches;
* a restart restores into the owner's own tensors (same ``data_ptr``),
  with the losses of an uninterrupted run and of the reference's
  Supervisor over its jitted step;
* ``checkpoint.restore`` in place refuses a shape or dtype that is not
  the checkpoint's; AdamW with its constants made on the device is
  bitwise the form that copied them up; the embedder's static buffer per
  batch size gives the eager rows bitwise.

The AdamW settings (``eps=1e-3``, no weight decay) are
tests/test_torch_train_step.py's, for the reasons given there.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.tensor as dtensor_mod
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models.lm import LM as RefLM
from repro.nn.param import init_tree
from repro.train import checkpoint as ref_ckpt
from repro.train.optim import AdamWConfig as RefAdamWConfig
from repro.train.optim import init_state as ref_init_state
from repro.train.supervisor import FaultInjector as RefInjector
from repro.train.supervisor import Supervisor as RefSupervisor
from repro_torch.configs import get_config, shrink
from repro_torch.configs.common import input_layout
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.embedder import ModelEmbedder, byte_tokens
from repro_torch.kernels import graphs
from repro_torch.launch import steps as steps_mod
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import TrainStepGraph, make_train_step
from repro_torch.models.lm import LM
from repro_torch.nn import attention
from repro_torch.nn.config import ShapeCell
from repro_torch.nn.param import init_params, map_specs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optim
from repro_torch.train import tree as tr
from repro_torch.train.supervisor import FaultInjector, Supervisor

torch.set_num_threads(1)
VOCAB, D, B, S = 128, 64, 4, 8
aten = torch.ops.aten

# ------------------------------------------------------------ rehearsal


class CaptureRehearsal(TorchDispatchMode):
    """Fails, with the caller's stack, on what a CUDA graph's capture of a
    step on ``device`` refuses or would freeze at its first value: a read
    of the device on the host (``_local_scalar_dense``, ``nonzero``), a
    copy from a host tensor into ``device`` (``_to_copy``, ``copy_``, and
    ``torch.tensor`` / ``torch.as_tensor`` of host data onto it, which no
    dispatch mode sees on ``meta``), and an op that takes a host tensor of
    one or more dims beside tensors on ``device`` (a 0-d host tensor is a
    scalar operand, read at the launch).

    A step over a mesh (DTensors with ``meta`` shards over a fake process
    group) is rehearsed as each rank runs it: an op on DTensors is handed
    back to DTensor, whose local ops come through this mode again, and
    the fake tensors of DTensor's own sharding propagation pass. On a mesh
    it also fails on a collective of ``torch.distributed``'s own API
    (``c10d`` ops, such as the scatter of ``distribute_tensor`` from a
    source rank, which is also watched since no dispatch mode sees it on
    ``meta``): the step's collectives are ``_c10d_functional`` ops, each
    joined to the stream by its ``wait_tensor``."""

    SYNC = (aten._local_scalar_dense.default, aten.nonzero.default)

    def __init__(self, device: str = "meta"):
        super().__init__()
        self.device = device

    def _on(self, dev) -> bool:
        return dev is not None and torch.device(dev).type == self.device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ts = [t for t in tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in ts):
            return NotImplemented
        if any(isinstance(t, FakeTensor) for t in ts):
            return func(*args, **kwargs)
        if func.namespace == "c10d":
            raise AssertionError(f"{func}: a collective outside the "
                                 f"functional ops")
        host = [t for t in ts if t.device.type == "cpu"]
        if func in self.SYNC:
            raise AssertionError(f"{func}: the host reads the device")
        if func is aten._to_copy.default and host and \
                self._on(kwargs.get("device")):
            raise AssertionError(f"{func}: a host tensor copied up")
        if func is aten.copy_.default and self._on(args[0].device) and \
                args[1].device.type == "cpu":
            raise AssertionError(f"{func}: a host tensor copied up")
        if any(self._on(t.device) for t in ts) and \
                any(t.ndim for t in host):
            raise AssertionError(
                f"{func}: a host tensor of shape "
                f"{[tuple(t.shape) for t in host if t.ndim]} beside the "
                f"step's")
        return func(*args, **kwargs)

    @contextlib.contextmanager
    def watching_constructors(self):
        """``torch.tensor`` and ``torch.as_tensor`` of host data onto the
        step's device fail too, and so does ``distribute_tensor`` from a
        source rank (a scatter or broadcast of that rank's data)."""
        real = {n: getattr(torch, n) for n in ("tensor", "as_tensor")}
        real_distribute = dtensor_mod.distribute_tensor

        def watched(name):
            def make(data, *a, **kw):
                if self._on(kw.get("device")) and \
                        not isinstance(data, torch.Tensor):
                    raise AssertionError(f"torch.{name} of host data onto "
                                         f"{kw['device']}")
                return real[name](data, *a, **kw)
            return make

        def distribute(*a, src_data_rank=0, **kw):
            if src_data_rank is not None:
                raise AssertionError(f"distribute_tensor: a scatter from "
                                     f"rank {src_data_rank}")
            return real_distribute(*a, src_data_rank=None, **kw)

        try:
            for n in real:
                setattr(torch, n, watched(n))
            dtensor_mod.distribute_tensor = distribute
            yield self
        finally:
            for n, f in real.items():
                setattr(torch, n, f)
            dtensor_mod.distribute_tensor = real_distribute


REHEARSED = ["granite-3-8b", "qwen2-vl-7b", "deepseek-v2-236b",
             "jamba-1.5-large-398b", "xlstm-350m"]


def rehearse(name: str, micro: int, remat: str) -> None:
    """One donated training step of the shrunk ``name`` on ``meta``
    parameters, AdamW state and batch (every input the config takes),
    under :class:`CaptureRehearsal`."""
    cfg = shrink(get_config(name), d_model=D, vocab=VOCAB, n_repeat=1)
    lm = LM(cfg)
    opt_cfg = optim.AdamWConfig()
    meta = torch.device("meta")
    params = map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                             device=meta), lm.param_specs())
    state = optim.init_state(opt_cfg, params)
    batch = {k: torch.zeros(shape, dtype=dt, device=meta) for k, (shape, dt, _)
             in input_layout(cfg, ShapeCell("train", 16, 2, "train")).items()}
    step = make_train_step(cfg, opt_cfg, remat=remat, microbatches=micro,
                           donate=True)
    mode = CaptureRehearsal()
    with mode, mode.watching_constructors():
        _, _, metrics = step(params, state, batch)
    assert all(t.device == meta for t in metrics.values())


@pytest.mark.parametrize("micro,remat", [(1, "none"), (2, "dots")])
@pytest.mark.parametrize("name", REHEARSED)
def test_capture_rehearsal_passes(name, micro, remat):
    rehearse(name, micro, remat)


def _old_loss_start(real):
    """value_and_grad whose loss comes back beside a zero made on the
    host and copied up, as the microbatch sum began before."""
    def vg(*a, **kw):
        loss, grads = real(*a, **kw)
        return torch.zeros((), dtype=torch.float32).to(loss.device) + loss, \
            grads
    return vg


def _old_band(real):
    """apply_rope that copies a host index vector up each call, as the
    M-RoPE band was built before."""
    def rope(cfg, x, positions, rot_dim=None):
        torch.zeros(3, dtype=torch.long).to(x.device)
        return real(cfg, x, positions, rot_dim)
    return rope


PLANTS = {
    # the bias corrections' base, as optim.py made it before
    "optim_const": (optim, "_const", lambda real: lambda x, device:
                    torch.as_tensor(x, dtype=torch.float32, device=device)),
    "steps_loss_start": (steps_mod, "value_and_grad", _old_loss_start),
    "mrope_band": (attention, "apply_rope", _old_band),
}


@pytest.mark.parametrize("plant,name", [("optim_const", "granite-3-8b"),
                                        ("steps_loss_start", "granite-3-8b"),
                                        ("mrope_band", "qwen2-vl-7b")])
def test_capture_rehearsal_fails_on_a_planted_host_copy(monkeypatch, plant,
                                                        name):
    module, attr, old = PLANTS[plant]
    monkeypatch.setattr(module, attr, old(getattr(module, attr)))
    with pytest.raises(AssertionError, match="copied up|host data"):
        rehearse(name, 2, "none")


# ------------------------------------------------------ the owner's form


def _models(n_repeat: int = 2, seed: int = 0):
    """Shrunk granite in fp32 in both packages, on the reference's
    parameters carried over."""
    size = dict(d_model=D, vocab=VOCAB, n_repeat=n_repeat)
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(
        ref_shrink(ref_get_config("granite-3-8b"), **size), **fp32)
    cfg = dataclasses.replace(shrink(get_config("granite-3-8b"), **size),
                              **fp32)
    ref = RefLM(ref_cfg)
    params = init_tree(jax.random.PRNGKey(seed), ref.param_specs())
    return ref, params, LM(cfg), lm_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def _batches(n: int) -> list:
    out = []
    for i in range(n):
        t = np.random.default_rng(50 + i).integers(
            0, VOCAB, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1].copy(), "labels": t[:, 1:].copy()})
    return out


OPT = dict(lr=1e-3, warmup_steps=0, eps=1e-3, weight_decay=0.0)
LAYOUT = {k: ((B, S), torch.int32) for k in ("tokens", "labels")}


def _owner(lm, pp, micro: int) -> TrainStepGraph:
    """A TrainStepGraph over copies of ``pp``, reset to them."""
    opt = optim.AdamWConfig(**OPT)
    params = tr.tree_map(torch.clone, pp)
    state = {"params": params, "opt": optim.init_state(opt, params)}

    def reset():
        for x, p in zip(tr.leaves(params), tr.leaves(pp)):
            x.copy_(p)
        for x in tr.leaves(state["opt"]):
            x.zero_()

    step = make_train_step(lm.cfg, opt, remat="none", microbatches=micro,
                           donate=True)
    return TrainStepGraph(step, state, LAYOUT, reset)


@pytest.mark.parametrize("micro", [1, 2])
def test_owner_matches_make_train_step_and_the_reference(micro):
    """Three steps through the owner: bitwise today's pure
    make_train_step on the same parameters, its losses within rtol 1e-5
    of the reference's jitted, donated step."""
    ref, params, lm, pp = _models()
    batches = _batches(3)
    owner = _owner(lm, pp, micro)
    ptrs = [x.data_ptr() for x in tr.leaves(owner.state)]
    got = [float(owner(b)["loss"]) for b in batches]
    assert [x.data_ptr() for x in tr.leaves(owner.state)] == ptrs
    opt = optim.AdamWConfig(**OPT)
    step = make_train_step(lm.cfg, opt, remat="none", microbatches=micro)
    p, s, eager = pp, optim.init_state(opt, pp), []
    for b in batches:
        p, s, m = step(p, s, {k: torch.from_numpy(v) for k, v in b.items()})
        eager.append(float(m["loss"]))
    assert got == eager
    for a, w in zip(tr.leaves(owner.state["params"]), tr.leaves(p)):
        assert torch.equal(a, w)
    assert int(owner.state["opt"]["step"]) == 3
    jstep = jax.jit(ref_make_train_step(
        ref.cfg, None, RefAdamWConfig(**OPT), remat="none",
        microbatches=micro), donate_argnums=(0, 1))
    rp, rs, want = params, ref_init_state(RefAdamWConfig(**OPT), params), []
    for b in batches:
        rp, rs, m = jstep(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("micro", [1, 2])
def test_train_main_smoke_steps_are_make_train_steps(micro):
    """``launch.train.main --smoke --device cpu`` (the owner, eager) gives
    the losses of a make_train_step loop from the same seeded init on the
    same bigram batches, bitwise."""
    argv = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
            "--steps", "3", "--batch", "2", "--seq", "16", "--save-every",
            "0", "--microbatches", str(micro), "--d-model", str(D),
            "--vocab", str(VOCAB)]
    res = train_mod.main(argv)
    args = train_mod.parse_args(argv)
    cfg, lm, opt_cfg, _, _ = train_mod.build(args)
    params = init_params(lm.param_specs(),
                         torch.Generator().manual_seed(args.seed), "cpu")
    step = make_train_step(cfg, opt_cfg, remat="none", microbatches=micro)
    state = optim.init_state(opt_cfg, params)
    stream = train_mod.BigramStream(cfg.vocab_size, seed=args.seed)
    losses = []
    for i in range(3):
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in stream.batch(i, 2, 16).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert res.losses == losses


def test_restart_restores_into_the_owners_tensors(tmp_path, monkeypatch):
    """A failure at step 5 restarts from the checkpoint at step 4 into the
    same tensors (one owner, its data_ptrs unchanged): the losses are the
    uninterrupted run's with steps 4 on replayed, and the reference's
    Supervisor over its jitted step gives the same losses (rtol 1e-5) and
    the same restart."""
    ref, params, lm, pp = _models()
    batches = _batches(7)

    def port_run(d, fail_at):
        owner = _owner(lm, pp, 1)
        ptrs = [x.data_ptr() for x in tr.leaves(owner.state)]

        def init_state():
            owner.reset()
            return owner.state

        def step_fn(state, step):
            assert state is owner.state
            return state, {"loss": float(owner(batches[step])["loss"])}

        res = Supervisor(str(d), save_every=2,
                         injector=FaultInjector(fail_at)).run(
            init_state=init_state, step_fn=step_fn, n_steps=7)
        assert [x.data_ptr() for x in tr.leaves(owner.state)] == ptrs
        return res

    clean = port_run(tmp_path / "clean", set())
    faulty = port_run(tmp_path / "faulty", {5})
    assert faulty.restarts == 1
    assert faulty.losses == clean.losses[:5] + clean.losses[4:]
    jstep = jax.jit(ref_make_train_step(
        ref.cfg, None, RefAdamWConfig(**OPT), remat="none"),
        donate_argnums=(0, 1))
    host = jax.tree.map(np.asarray, params)

    def ref_step(state, step):
        p, s, m = jstep(state["params"], state["opt"],
                        {k: jnp.asarray(v) for k, v in batches[step].items()})
        return {"params": p, "opt": s}, {"loss": float(m["loss"])}

    def ref_init():
        p = jax.tree.map(jnp.asarray, host)
        return {"params": p, "opt": ref_init_state(RefAdamWConfig(**OPT), p)}

    # the reference's writers are not joined before its restore (ROADMAP
    # section 3): its saves are made synchronous here, so that the restart
    # point does not depend on their timing
    real_save = ref_ckpt.save
    monkeypatch.setattr(ref_ckpt, "save", lambda *a, **k: real_save(
        *a, **{**k, "async_write": False}))
    ref_res = RefSupervisor(str(tmp_path / "ref"), save_every=2,
                            injector=RefInjector({5})).run(
        init_state=ref_init, step_fn=ref_step, n_steps=7)
    assert ref_res.restarts == 1 and len(ref_res.losses) == 8
    np.testing.assert_allclose(faulty.losses, ref_res.losses, rtol=1e-5)


def test_owner_refuses_a_batch_off_its_layout():
    _, _, lm, pp = _models(n_repeat=1)
    owner = _owner(lm, pp, 1)
    good = _batches(1)[0]
    with pytest.raises(ValueError, match="keys"):
        owner({"tokens": good["tokens"]})
    with pytest.raises(ValueError, match="static batch"):
        owner({**good, "labels": good["labels"][:, :4]})
    with pytest.raises(ValueError, match="static batch"):
        owner({**good, "tokens": good["tokens"].astype(np.int64)})


# ------------------------------------------------- restore, AdamW, embed


@pytest.mark.parametrize("bad", ["shape", "dtype"])
def test_restore_in_place_refuses_a_mismatch(tmp_path, bad):
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": torch.ones(4, dtype=torch.bfloat16)}
    ckpt.save(str(tmp_path), 1, tree, async_write=False)
    target = tr.tree_map(torch.zeros_like, tree)
    ptrs = [x.data_ptr() for x in tr.leaves(target)]
    out, _ = ckpt.restore(str(tmp_path), 1, target)
    assert out is target and [x.data_ptr() for x in tr.leaves(out)] == ptrs
    for a, b in zip(tr.leaves(out), tr.leaves(tree)):
        assert torch.equal(a, b)
    wrong = dict(target)
    wrong["w"] = torch.zeros((3, 2)) if bad == "shape" else \
        torch.zeros((2, 3), dtype=torch.float64)
    wrong["b"] = torch.full((4,), 7.0, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=r"leaf \d: checkpoint"):
        ckpt.restore(str(tmp_path), 1, wrong)
    # refused before anything is written
    assert torch.equal(wrong["b"], torch.full((4,), 7.0,
                                              dtype=torch.bfloat16))


def _adamw_copied_up(cfg, params, grads, state):
    """AdamW as optim.adamw_update computed it before its constants were
    made on the device (``torch.as_tensor`` of the betas, a host zero for
    the unclipped norm), in place."""
    step = state["step"] + 1
    lr = optim.lr_at(cfg, step)
    clip = None
    if cfg.grad_clip:
        gnorm = optim.global_norm(grads)
        clip = optim._clip_scale(gnorm, cfg.grad_clip)
    else:
        gnorm = torch.zeros((), dtype=torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(torch.as_tensor(b1, dtype=torch.float32),
                        step.float())
    bc2 = 1 - torch.pow(torch.as_tensor(b2, dtype=torch.float32),
                        step.float())
    for p, g, m, v in zip(tr.leaves(params), tr.leaves(grads),
                          tr.leaves(state["m"]), tr.leaves(state["v"])):
        if clip is not None:
            g = (g.float() * clip).to(g.dtype)
        gf = g.float()
        m32 = m.float() * b1 + gf * (1 - b1)
        v32 = v.float() * b2 + torch.square(gf) * (1 - b2)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m32)
        v.copy_(v32)
    state["step"].copy_(step)
    return lr, gnorm


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_with_device_constants_is_bitwise_the_old_form(state_dtype,
                                                             grad_clip):
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=20,
                            grad_clip=grad_clip, state_dtype=state_dtype)
    rng = np.random.default_rng(7)
    p0 = {"w": torch.from_numpy(rng.standard_normal((6, 5))
                                .astype(np.float32)),
          "n": [torch.from_numpy(rng.standard_normal(5).astype(np.float32))]}
    a, b = (tr.tree_map(torch.clone, p0) for _ in range(2))
    sa, sb = optim.init_state(cfg, a), optim.init_state(cfg, b)
    for i in range(5):
        g = tr.tree_map(lambda x: torch.from_numpy(
            rng.standard_normal(x.shape).astype(np.float32)), p0)
        _, _, m = optim.adamw_update(cfg, a, g, sa, in_place=True)
        lr, gn = _adamw_copied_up(cfg, b, g, sb)
        assert torch.equal(m["lr"], lr) and torch.equal(m["grad_norm"], gn)
        for x, y in zip(tr.leaves((a, sa)), tr.leaves((b, sb))):
            assert torch.equal(x, y)


def test_embedder_graph_buffers_give_the_eager_rows(monkeypatch):
    """``embed_batch``'s graph per B, its static (B, max_len) buffer
    refilled each call, with a stand-in for the capture whose replay runs
    the step: the rows are the eager encode's, bitwise, at B 1 and 3, and
    one graph a B."""

    class Replayed:
        pool_bytes = 0

        def __init__(self, fn, pool=None):
            self.fn = fn

        def replay(self):
            return self.fn()

    monkeypatch.setattr(graphs, "StepGraph", Replayed)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    emb = ModelEmbedder(dim=64, max_len=24, device="cpu")
    for texts in (["one"], ["two words", "", "x" * 40], ["four", "five"],
                  ["six"]):
        toks = np.stack([byte_tokens(t, emb.max_len) % emb.cfg.vocab_size
                         for t in texts])
        graph, buf = emb._graph_for(len(texts))
        buf.copy_(torch.from_numpy(toks))
        got = graph.replay().numpy()
        np.testing.assert_array_equal(got, emb.embed_batch(texts))
    assert sorted(emb._graphs) == [1, 2, 3]

