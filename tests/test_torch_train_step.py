"""The training path of the port (``models/lm.LM.loss_and_aux``,
``launch/steps``, ``launch/train``) against the JAX package's, on the
reference's parameters (``init_tree``, carried over with
``convert.lm_params_from_numpy``), shrunk, in fp32, on seeded numpy
batches.

Tolerances: the loss within rtol 1e-5 (sums in another order); each
gradient leaf within 1e-4 of its largest element (jamba's Mamba scan and
deepseek-v3's MoE and MTP sum over more terms; the worst leaf reads about
1.2e-5), xlstm's within 5e-4 (at these weights its gradients move by about
1e-3 of their scale when the weights are rounded by one fp32 ulp; the
worst leaf reads about 1.1e-4); one AdamW step's parameters and moments within 1e-6 (values near
1) at ``eps=1e-3``, so that each update is a continuous function of its
gradient (at the default 1e-8 a gradient element near 0 takes an update
of +-lr from its sign, which rounding can flip), and without weight
decay: the reference decays every leaf of 2 or more dims, and at
``n_repeat > 1`` it stacks each norm scale and bias over the repeats into
a 2-D leaf, which it then decays; the port's layers keep them 1-D, with
no decay, as both mean to treat norms and biases (ROADMAP section 3;
tests/test_torch_train.py holds the decay itself to the reference's).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models.lm import LM as RefLM
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro.train.optim import AdamWConfig as RefAdamWConfig
from repro.train.optim import init_state as ref_init_state
from repro_torch.configs import ASSIGNED, get_config, shrink
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.launch import train as train_mod
from repro_torch.launch.steps import (make_decode_step, make_prefill_step,
                                      make_train_step, split_mb,
                                      value_and_grad)
from repro_torch.models.lm import LM
from repro_torch.nn.param import init_params
from repro_torch.train import tree as tr
from repro_torch.train.optim import AdamWConfig, init_state

torch.set_num_threads(1)
CTX = ShardCtx(None)
VOCAB, D = 128, 64
GRAD_RTOL = 1e-4
# the gradient cases: dense GQA, sliding windows, MLA + MoE aux + MTP,
# Mamba + MoE, mLSTM + sLSTM, the encoder-decoder
GRAD_MODELS = ["granite-3-8b", "gemma3-12b", "deepseek-v3-671b",
               "jamba-1.5-large-398b", "xlstm-350m", "seamless-m4t-large-v2"]
GRAD_RTOL_OF = {"xlstm-350m": 5e-4}


def _models(name: str, n_repeat: int = 1, seed: int = 0):
    """Both models on the reference's parameters (1-d leaves moved off
    their constant init, so that each matters)."""
    size = dict(d_model=D, vocab=VOCAB, n_repeat=n_repeat, seq_chunk=4)
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_shrink(ref_get_config(name), **size),
                                  **fp32)
    cfg = dataclasses.replace(shrink(get_config(name), **size), **fp32)
    ref = RefLM(ref_cfg)
    params = init_tree(jax.random.PRNGKey(seed), ref.param_specs())
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda a: a + jnp.asarray(rng.uniform(-0.1, 0.1, a.shape),
                                  a.dtype) if a.ndim == 1 else a, params)
    tree = jax.tree.map(np.asarray, params)
    return ref, params, LM(cfg), lm_params_from_numpy(tree, cfg, "cpu")


def _batch(cfg, b: int = 2, s: int = 12, seed: int = 1) -> dict:
    """Tokens and labels, plus qwen2-vl's frontend embeddings on the first
    6 positions with (3, B, S) M-RoPE positions, and seamless's 5
    encoder frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, VOCAB, (b, s)).astype(np.int32),
           "labels": rng.integers(0, VOCAB, (b, s)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["frontend_emb"] = rng.standard_normal((b, s, D)).astype(
            np.float32)
        mask = np.zeros((b, s), bool)
        mask[:, :6] = True
        pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        pos[1, :, :6] = np.arange(6) // 2
        out.update(frontend_mask=mask, positions=pos)
    if cfg.enc_dec:
        out["enc_emb"] = rng.standard_normal((b, 5, D)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_leaves(got, want, rtol_of_max: float, what: str = ""):
    gl, wl = tr.leaves(got), tr.leaves(want)
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(gl, wl)):
        assert a.shape == b.shape and a.dtype == b.dtype, (what, i)
        lim = rtol_of_max * max(float(b.abs().max()), 1e-30)
        err = float((a - b).abs().max())
        assert err <= lim, (what, i, tuple(a.shape), err, lim)


@pytest.mark.parametrize("name", ASSIGNED)
def test_loss_and_aux_matches_reference(name):
    """The training loss of every assigned config (MoE aux, MTP, M-RoPE
    and the vision frontend, windows, Mamba/xLSTM, the encoder-decoder)
    equals the reference's, and so does its aux."""
    ref, params, lm, pp = _models(name)
    batch = _batch(lm.cfg)
    want, want_aux = ref.loss_and_aux(CTX, params, _jax(batch))
    got, got_aux = lm.loss_and_aux(pp, _torch(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got_aux["aux"]),
                               float(want_aux["aux"]), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", GRAD_MODELS)
def test_gradients_match_jax_grad(name):
    ref, params, lm, pp = _models(name)
    batch = _batch(lm.cfg)
    g_ref = jax.grad(lambda p: ref.loss_and_aux(CTX, p, _jax(batch))[0])(
        params)
    want = lm_params_from_numpy(jax.tree.map(np.asarray, g_ref), lm.cfg,
                                "cpu")
    loss, got = value_and_grad(lm, pp, _torch(batch))
    _close_leaves(got, want, GRAD_RTOL_OF.get(name, GRAD_RTOL), name)


@pytest.mark.parametrize("micro,remat", [(1, "none"), (2, "none"),
                                         (1, "dots"), (2, "dots")])
def test_train_step_matches_reference(micro, remat):
    """One make_train_step step (granite, 2 superblock repeats, batch 4 x
    8) gives the reference's new parameters and moments."""
    ref, params, lm, pp = _models("granite-3-8b", n_repeat=2)
    batch = _batch(lm.cfg, b=4, s=8)
    ref_opt = RefAdamWConfig(lr=1e-3, warmup_steps=0, eps=1e-3,
                             weight_decay=0.0)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, eps=1e-3, weight_decay=0.0)
    ref_state = ref_init_state(ref_opt, params)
    new_p, new_s, m = ref_make_train_step(
        ref.cfg, None, ref_opt, remat=remat, microbatches=micro)(
        params, ref_state, _jax(batch))
    state = init_state(opt, pp)
    got_p, got_s, got_m = make_train_step(
        lm.cfg, opt, remat=remat, microbatches=micro)(pp, state,
                                                     _torch(batch))
    np.testing.assert_allclose(float(got_m["loss"]), float(m["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got_m["grad_norm"]),
                               float(m["grad_norm"]), rtol=1e-5)
    want_p = lm_params_from_numpy(jax.tree.map(np.asarray, new_p), lm.cfg,
                                  "cpu")
    want_s = opt_state_from_numpy(jax.tree.map(np.asarray, new_s), lm.cfg,
                                  "cpu")
    assert int(got_s["step"]) == int(want_s["step"]) == 1
    for got, want in ((got_p, want_p), (got_s["m"], want_s["m"]),
                      (got_s["v"], want_s["v"])):
        for a, b in zip(tr.leaves(got), tr.leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    # the step is pure: its inputs are as they were
    for a, b in zip(tr.leaves(pp), tr.leaves(
            lm_params_from_numpy(jax.tree.map(np.asarray, params), lm.cfg,
                                 "cpu"))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("remat", ["dots", "save_outs"])
def test_remat_gives_the_loss_and_gradients_of_none(remat):
    """Recomputing each layer in the backward changes no value (deepseek-v3
    at 2 repeats: MLA, MoE, MTP)."""
    _, _, lm, pp = _models("deepseek-v3-671b", n_repeat=2)
    batch = _torch(_batch(lm.cfg))
    loss, grads = value_and_grad(lm, pp, batch, "none")
    loss_r, grads_r = value_and_grad(lm, pp, batch, remat)
    assert float(loss_r) == float(loss)
    for a, b in zip(tr.leaves(grads_r), tr.leaves(grads)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_unknown_remat_raises():
    _, _, lm, pp = _models("granite-3-8b")
    with pytest.raises(ValueError, match="remat"):
        lm.loss_and_aux(pp, _torch(_batch(lm.cfg)), remat="everything")


def test_split_mb_cuts_the_batch_dim_and_mrope_positions():
    b = {"tokens": torch.arange(24).reshape(4, 6),
         "positions": torch.arange(72).reshape(3, 4, 6)}
    parts = split_mb(b, 2)
    assert [p["tokens"].shape for p in parts] == [(2, 6), (2, 6)]
    assert [p["positions"].shape for p in parts] == [(3, 2, 6), (3, 2, 6)]
    assert torch.equal(parts[1]["positions"], b["positions"][:, 2:])
    with pytest.raises(ValueError, match="microbatches"):
        split_mb(b, 3)


def test_donated_step_updates_in_place():
    """``donate=True`` writes the step's result into the parameters' and
    state's own tensors, with the pure step's values."""
    _, _, lm, pp = _models("granite-3-8b")
    batch = _torch(_batch(lm.cfg))
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    pure_p, pure_s, _ = make_train_step(lm.cfg, opt, remat="none")(
        pp, init_state(opt, pp), batch)
    donated = tr.tree_map(torch.clone, pp)
    ptrs = [x.data_ptr() for x in tr.leaves(donated)]
    state = init_state(opt, donated)
    new_p, new_s, _ = make_train_step(lm.cfg, opt, remat="none",
                                      donate=True)(donated, state, batch)
    assert [x.data_ptr() for x in tr.leaves(new_p)] == ptrs
    assert new_s is state and int(state["step"]) == 1
    for a, b in zip(tr.leaves(new_p) + tr.leaves(new_s["m"]),
                    tr.leaves(pure_p) + tr.leaves(pure_s["m"])):
        assert torch.equal(a, b)


def test_train_main_smoke_runs_on_cpu(capsys, tmp_path):
    """``launch.train.main --smoke --device cpu``: a few steps of the
    shrunk granite on the bigram stream, the reference's lines printed,
    the loss finite; an injected failure restarts from the checkpoint and
    replays the same losses."""
    args = ["--arch", "granite-3-8b", "--smoke", "--device", "cpu",
            "--steps", "6", "--batch", "2", "--seq", "16",
            "--save-every", "3"]
    clean = train_mod.main(args + ["--ckpt-dir", str(tmp_path / "a")])
    out = capsys.readouterr().out
    assert "arch=granite-3-8b-smoke layers=2" in out and "done: 6 steps" in out
    assert len(clean.losses) == 6 and np.isfinite(clean.losses).all()
    faulty = train_mod.main(args + ["--ckpt-dir", str(tmp_path / "b"),
                                    "--fail-at", "4"])
    assert faulty.restarts == 1
    # steps 0-3, then 3-5 again from the checkpoint at step 3
    assert faulty.losses == clean.losses[:4] + clean.losses[3:]


def test_prefill_and_decode_steps_are_the_models():
    """make_prefill_step and make_decode_step call LM.prefill and
    LM.decode as they are."""
    _, _, lm, pp = _models("granite-3-8b")
    toks = torch.from_numpy(_batch(lm.cfg)["tokens"])
    got, caches = make_prefill_step(lm.cfg)(pp, {"tokens": toks})
    want, _ = lm.prefill(pp, toks)
    assert torch.equal(got, want)
    caches = lm.cache_specs(2, 4)
    c1, c2 = (init_params(caches, None, "cpu") for _ in range(2))
    got, _ = make_decode_step(lm.cfg)(pp, toks[:, :1], c1, 0)
    want, _ = lm.decode(pp, toks[:, :1], c2, 0)
    assert torch.equal(got, want)
