"""The port's optimizer, gradient compression, 8-bit AdamW, data stream,
checkpoint and supervisor (``repro_torch.train``): analogues of
tests/test_train.py's eight tests, each also holding the port's function
to the JAX package's on the same inputs.

Tolerances: AdamW, the schedule and clipping within 1e-6 (fp32 in
another order); int8 quantisation and the top-k selection exact;
the bigram stream byte for byte (within one process: its seed is
Python's salted ``hash``); checkpoint manifests equal but for the
``treedef`` string (JAX's repr against the port's).
"""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ckpt
from repro.train import compression as ref_comp
from repro.train import optim as ref_optim
from repro.train import quant_opt as ref_q8
from repro.train.data import BigramStream as RefStream
from repro.train.supervisor import FaultInjector as RefInjector
from repro.train.supervisor import Supervisor as RefSupervisor
from repro_torch.train import compression as comp
from repro_torch.train import optim
from repro_torch.train import quant_opt as q8
from repro_torch.train import tree as tr
from repro_torch.train.checkpoint import latest_step, restore, save
from repro_torch.train.data import BigramStream
from repro_torch.train.supervisor import FaultInjector, Supervisor

torch.set_num_threads(1)


def _tree(rng):
    """A parameter tree with 2-D weights (decayed) and 1-D norms (not)."""
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "blocks": [{"scale": (1 + 0.1 * rng.standard_normal(5))
                        .astype(np.float32)},
                       {"k": rng.standard_normal((5, 3)).astype(np.float32)}]}


def _t(tree):
    return tr.tree_map(torch.from_numpy, tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _close(got, want, atol=1e-6):
    for a, b in zip(tr.leaves(got), jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol)


def test_adamw_converges_quadratic():
    cfg = optim.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                            total_steps=200, schedule="const")
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = optim.init_state(cfg, params)
    target = torch.tensor([1.0, 1.0, 1.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        params, state, _ = optim.adamw_update(cfg, params, g, state)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                               atol=1e-2)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_steps_match_reference(rng, state_dtype):
    """Three clipped, decayed steps on a tree of 2-D and 1-D leaves."""
    kw = dict(lr=0.05, warmup_steps=2, total_steps=10, grad_clip=0.5,
              state_dtype=state_dtype)
    cfg, ref_cfg = optim.AdamWConfig(**kw), ref_optim.AdamWConfig(**kw)
    p = _tree(rng)
    params, ref_params = _t(p), _j(p)
    state, ref_state = optim.init_state(cfg, params), \
        ref_optim.init_state(ref_cfg, ref_params)
    for i in range(3):
        g = _tree(np.random.default_rng(10 + i))
        params, state, m = optim.adamw_update(cfg, params, _t(g), state)
        ref_params, ref_state, rm = ref_optim.adamw_update(
            ref_cfg, ref_params, _j(g), ref_state)
        np.testing.assert_allclose(float(m["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
    _close(params, ref_params)
    # bf16 moments: one bf16 step of values below 1 (both round to bf16)
    tol = 1e-6 if state_dtype == "float32" else 2.0 ** -8
    for key in ("m", "v"):
        _close(tr.tree_map(lambda x: x.float(), state[key]),
               jax.tree.map(lambda x: x.astype(jnp.float32), ref_state[key]),
               tol)
    assert int(state["step"]) == int(ref_state["step"]) == 3


def test_donated_update_writes_in_place(rng):
    cfg = optim.AdamWConfig(lr=0.05, warmup_steps=0)
    p, g = _t(_tree(rng)), _t(_tree(rng))
    pure_p, pure_s, _ = optim.adamw_update(cfg, p, g,
                                           optim.init_state(cfg, p))
    own = tr.tree_map(torch.clone, p)
    state = optim.init_state(cfg, own)
    new_p, new_s, _ = optim.adamw_update(cfg, own, g, state, in_place=True)
    assert new_s is state
    for a, b, c in zip(tr.leaves(new_p), tr.leaves(own), tr.leaves(pure_p)):
        assert a is b and torch.equal(a, c)


def test_lr_schedule_shapes():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    assert float(optim.lr_at(cfg, 0)) == 0.0
    assert abs(float(optim.lr_at(cfg, 10)) - 1.0) < 1e-6
    assert float(optim.lr_at(cfg, 100)) <= 1.0
    assert float(optim.lr_at(cfg, 100)) >= cfg.min_lr_frac - 1e-6
    for sched in ("cosine", "linear", "const"):
        kw = dict(lr=3e-4, warmup_steps=10, total_steps=100, schedule=sched)
        for step in (0, 3, 10, 37, 99, 100, 150):
            np.testing.assert_allclose(
                float(optim.lr_at(optim.AdamWConfig(**kw), step)),
                float(ref_optim.lr_at(ref_optim.AdamWConfig(**kw), step)),
                rtol=1e-6)


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, gn = optim.clip_by_global_norm(g, 1.0)
    total = torch.sqrt(sum(torch.sum(x ** 2) for x in tr.leaves(clipped)))
    assert abs(float(total) - 1.0) < 1e-5
    rng = np.random.default_rng(3)
    t = {"a": rng.standard_normal((4, 3)).astype(np.float32),
         "b": [rng.standard_normal(7).astype(np.float32)]}
    got, gn = optim.clip_by_global_norm(_t(t), 0.7)
    want, wn = ref_optim.clip_by_global_norm(_j(t), 0.7)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    _close(got, want)


def test_int8_roundtrip_bound(rng):
    x = (rng.standard_normal((1000,)) * 3.0).astype(np.float32)
    z = comp.int8_quantize(torch.from_numpy(x), block=128)
    y = comp.int8_dequantize(z)
    err = np.abs(x - y.numpy())
    scales = np.repeat(z.scale.numpy(), 128)[: x.size]
    assert (err <= scales * 0.5 + 1e-7).all()
    xt = {"x": torch.from_numpy(x)}
    assert comp.wire_bytes_int8(xt) < comp.wire_bytes_dense(xt) / 3
    # bit for bit the reference's, padding and a 2-D shape included
    for a, block in ((x, 128), (x[:999].reshape(27, 37), 256)):
        want = ref_comp.int8_quantize(jnp.asarray(a), block=block)
        got = comp.int8_quantize(torch.from_numpy(np.ascontiguousarray(a)),
                                 block=block)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))
        np.testing.assert_array_equal(
            comp.int8_dequantize(got).numpy(),
            np.asarray(ref_comp.int8_dequantize(want)))


def test_error_feedback_converges():
    """Top-k EF gradient descent still reaches the optimum (quadratic),
    and every step's compression is the reference's."""
    w = torch.tensor([4.0, -2.0, 1.5, 8.0])
    res = comp.ef_init({"w": w})
    rw, rres = jnp.asarray(w.numpy()), ref_comp.ef_init({"w": jnp.asarray(
        w.numpy())})
    for _ in range(300):
        comp_, res, dense = comp.ef_compress_tree({"w": 2 * w}, res, 0.25)
        rcomp, rres, rdense = ref_comp.ef_compress_tree({"w": 2 * rw}, rres,
                                                        0.25)
        np.testing.assert_array_equal(comp_[0][1].numpy(),
                                      np.asarray(rcomp[0][1]))
        w = w - 0.05 * dense["w"]
        rw = rw - 0.05 * rdense["w"]
    np.testing.assert_allclose(w.numpy(), 0.0, atol=1e-2)
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6)


def test_ef_compress_tree_matches_reference(rng):
    g, r = _tree(rng), _tree(np.random.default_rng(5))
    got_c, got_r, got_d = comp.ef_compress_tree(_t(g), _t(r), 0.3)
    want_c, want_r, want_d = ref_comp.ef_compress_tree(_j(g), _j(r), 0.3)
    for (gv, gi), (wv, wi) in zip(got_c, want_c, strict=True):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    _close(got_r, want_r, 0)
    _close(got_d, want_d, 0)


def test_adamw8_matches_reference(rng):
    kw = dict(lr=0.05, warmup_steps=0, grad_clip=1.0)
    cfg, ref_cfg = optim.AdamWConfig(**kw), ref_optim.AdamWConfig(**kw)
    p = _tree(rng)
    params, ref_params = _t(p), _j(p)
    state = q8.init_state8(params, block=4)
    ref_state = ref_q8.init_state8(ref_params, block=4)
    assert q8.state8_bytes(params, 4) == ref_q8.state8_bytes(ref_params, 4)
    for i in range(2):
        g = _tree(np.random.default_rng(20 + i))
        params, state, _ = q8.adamw8_update(cfg, params, _t(g), state)
        ref_params, ref_state, _ = ref_q8.adamw8_update(ref_cfg, ref_params,
                                                        _j(g), ref_state)
    _close(params, ref_params)


def test_bigram_stream_matches_reference_byte_for_byte():
    ref, port = RefStream(512, seed=3), BigramStream(512, seed=3)
    assert np.array_equal(ref.succ, port.succ)
    for step in (0, 5, 17):
        a, b = ref.batch(step, 3, 16), port.batch(step, 3, 16)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()
    assert port.bigram_entropy == ref.bigram_entropy


def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", "manifest.json")) as f:
        out = json.load(f)
    out.pop("treedef")
    return out


def test_checkpoint_roundtrip_and_atomicity(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16) * 1.5},
            "s": torch.tensor(7, dtype=torch.int32)}
    d = str(tmp_path / "port")
    th = save(d, 7, tree, extra={"next_step": 7}, async_write=True)
    th.join()
    assert latest_step(d) == 7
    assert not any(x.endswith(".tmp") for x in os.listdir(d))
    like = tr.tree_map(torch.zeros_like, tree)
    out, extra = restore(d, 7, like)
    assert extra["next_step"] == 7
    for a, b in zip(tr.leaves(out), tr.leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference writes the same manifest and files for the same tree,
    # and each package restores the other's checkpoint
    rd = str(tmp_path / "ref")
    jtree = {"a": jnp.arange(12).reshape(3, 4).astype(jnp.float32),
             "b": {"c": jnp.ones((5,), jnp.bfloat16) * 1.5},
             "s": jnp.int32(7)}
    ref_ckpt.save(rd, 7, jtree, extra={"next_step": 7}, async_write=False)
    assert _manifest(d, 7) == _manifest(rd, 7)
    for i in range(3):
        name = f"arr_{i:05d}.npy"
        assert np.load(os.path.join(d, "step_00000007", name)).tobytes() == \
            np.load(os.path.join(rd, "step_00000007", name)).tobytes()
    out, _ = restore(rd, 7, like)
    for a, b in zip(tr.leaves(out), tr.leaves(tree)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_async_checkpoint_keeps_the_values_at_save(tmp_path, monkeypatch,
                                                   dtype):
    """An asynchronous save writes the tree as it was when ``save``
    returned, though the caller (a donated step) changes it in place
    before the writer runs: the writer is held on an event until after
    the change, so the check does not depend on timing."""
    from repro_torch.train import checkpoint as ckpt_mod

    go = threading.Event()
    real_save = np.save

    def held_save(*a, **kw):
        assert go.wait(30)
        real_save(*a, **kw)

    monkeypatch.setattr(ckpt_mod.np, "save", held_save)
    tree = {"w": torch.arange(6, dtype=dtype).reshape(2, 3),
            "b": [torch.zeros(4, dtype=dtype)]}
    want = tr.tree_map(torch.clone, tree)
    th = save(str(tmp_path), 1, tree, async_write=True)
    for x in tr.leaves(tree):
        x.add_(1)
    go.set()
    th.join()
    out, _ = restore(str(tmp_path), 1, tr.tree_map(torch.zeros_like, tree))
    for a, b in zip(tr.leaves(out), tr.leaves(want), strict=True):
        assert a.dtype == dtype and torch.equal(a, b)


def test_checkpoint_retention(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        save(d, s, {"x": torch.zeros(2)}, async_write=False, keep_last=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(steps) == 2 and latest_step(d) == 5


def test_supervisor_restart_exactness(tmp_path):
    """The loss sequence with an injected failure and restart equals the
    uninterrupted one, and the reference's; every checkpoint writer is
    joined before the run returns, so its directory can go at once."""

    def make_run(fail_at, d, sup_cls=Supervisor, inj=FaultInjector,
                 t=torch.tensor):
        sup = sup_cls(str(d), save_every=5, injector=inj(fail_at))

        def step_fn(state, step):
            w = state["w"] * 0.9
            return {"w": w}, {"loss": float(w)}

        return sup.run(init_state=lambda: {"w": t(10.0)}, step_fn=step_fn,
                       n_steps=20)

    clean = make_run(set(), tmp_path / "clean")
    faulty = make_run({12}, tmp_path / "faulty")
    assert faulty.restarts == 1
    assert clean.losses[-1] == pytest.approx(faulty.losses[-1])
    # steps 0-11, then 10-19 again from the checkpoint at step 10
    assert faulty.losses == clean.losses[:12] + clean.losses[10:]
    assert not any(x.endswith(".tmp") for x in os.listdir(tmp_path / "faulty"))
    ref = make_run({12}, tmp_path / "ref", RefSupervisor, RefInjector,
                   lambda x: jnp.array(x, jnp.float32))
    np.testing.assert_allclose(faulty.losses[-1], ref.losses[-1], rtol=1e-6)
    assert ref.restarts == 1

