"""The port's stage-2 judge and embedder (``core/judge.ModelJudge``,
``core/embedder``) against the JAX package's, on the reference's own
parameters carried over as numpy arrays, and ``run_once`` with the model
judge's compute paid.

Tolerances: fp32 configs within 1e-5 (scores and unit embeddings); the
default bf16 configs within 5e-3 on a sigmoid score and 2e-2 on an
embedding coordinate (the two packages round bf16 at different places).
Micro-batch invariance is bitwise, as tests/test_judge_pipeline.py:117
holds the reference's.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.core.embedder import ModelEmbedder as RefEmbedder
from repro.core.embedder import byte_tokens as ref_byte_tokens
from repro.core.embedder import l2_normalize as ref_l2_normalize
from repro.core.judge import ModelJudge as RefJudge
from repro.core.judge_pipeline import default_judge_cfg as ref_judge_cfg
from repro.data.world import SemanticWorld as RefWorld
from repro.launch.serve import run_once as ref_run_once
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.embedder import (ModelEmbedder, WorldEmbedder,
                                       byte_tokens, l2_normalize)
from repro_torch.core.judge import ModelJudge, OracleJudge
from repro_torch.core.judge_pipeline import JudgePipeline, default_judge_cfg
from repro_torch.data.world import SemanticWorld
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.launch.serve import run_once

torch.set_num_threads(1)

WORLD = SemanticWorld(n_intents=60, dim=32, seed=7)
REF_WORLD = RefWorld(n_intents=60, dim=32, seed=7)
PAIRS = ([WORLD.query(i % 4, i) for i in range(6)],
         [WORLD.query(i % 4, i + 1) for i in range(6)])


def _fp32(cfg):
    return dataclasses.replace(cfg, param_dtype="float32",
                               compute_dtype="float32")


def _judges(dt: str):
    ref_cfg, cfg = ref_judge_cfg(d_model=64), default_judge_cfg(d_model=64)
    if dt == "float32":
        ref_cfg, cfg = _fp32(ref_cfg), _fp32(cfg)
    ref = RefJudge(cfg=ref_cfg, max_len=32, seed=3)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref.params), cfg,
                                  "cpu")
    return ref, ModelJudge(cfg=cfg, max_len=32, device="cpu", params=params)


@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_model_judge_matches_reference(dt, tol):
    ref, judge = _judges(dt)
    before = flash_attention_fwd.plain_calls
    got = judge.score_pairs(*PAIRS)
    assert flash_attention_fwd.plain_calls == before + judge.cfg.n_repeat
    want = ref.score_pairs(*PAIRS)
    assert got.dtype == np.float32 and got.shape == (6,)
    np.testing.assert_allclose(got, want, atol=tol)
    assert [judge.staticity(q) for q in PAIRS[0]] == \
        [ref.staticity(q) for q in PAIRS[0]]


def test_model_judge_batch_bit_identical_to_solo():
    """DESIGN.md §8: scores must not depend on micro-batch shape
    (tests/test_judge_pipeline.py:117's rule, on the port)."""
    judge = ModelJudge(cfg=default_judge_cfg(d_model=64), max_len=32, seed=3,
                       device="cpu")
    qs, ks = PAIRS
    batched = judge.score_pairs(qs, ks)
    solo = np.concatenate([judge.score_pairs([q], [k])
                           for q, k in zip(qs, ks)])
    assert np.array_equal(batched, solo)
    mid = judge.score_pairs(qs[:2], ks[:2]), judge.score_pairs(qs[2:], ks[2:])
    assert np.array_equal(batched, np.concatenate(mid))


def test_pipeline_scores_come_from_decisions_not_compute():
    oracle = OracleJudge(WORLD, accuracy=0.98, seed=1)
    ref = OracleJudge(WORLD, accuracy=0.98, seed=1)
    model = ModelJudge(cfg=default_judge_cfg(d_model=64), max_len=32, seed=3,
                       device="cpu")
    pipe = JudgePipeline(oracle, compute=model)
    q, k = [WORLD.query(0, 0)], [WORLD.query(0, 1)]
    before = flash_attention_fwd.plain_calls
    assert np.array_equal(pipe.score_pairs(q, k), ref.score_pairs(q, k))
    assert flash_attention_fwd.plain_calls > before     # compute was paid
    assert pipe.stats.judge_batches == 1


@pytest.mark.parametrize("dt,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_model_embedder_matches_reference(dt, tol):
    ref_cfg = ref_judge_cfg(d_model=64)
    cfg = default_judge_cfg(d_model=64)
    if dt == "float32":
        ref_cfg, cfg = _fp32(ref_cfg), _fp32(cfg)
    ref = RefEmbedder(cfg=ref_cfg, max_len=24, seed=5)
    emb = ModelEmbedder(cfg=cfg, max_len=24, device="cpu",
                        params=lm_params_from_numpy(
                            jax.tree.map(np.asarray, ref.params), cfg, "cpu"))
    texts = PAIRS[0] + ["", "a much longer text than the max len of 24 bytes"]
    got = emb.embed_batch(texts)
    want = ref.embed_batch(texts)
    assert emb.dim == ref.dim == 64 and got.shape == (8, 64)
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(np.linalg.norm(got[:-2], axis=1), 1, atol=1e-3)


def test_embedder_helpers_match_reference():
    for text in ("", "héllo wörld", "x" * 40):
        np.testing.assert_array_equal(byte_tokens(text, 32),
                                      ref_byte_tokens(text, 32))
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    x[2] = 0
    np.testing.assert_array_equal(l2_normalize(x), ref_l2_normalize(x))
    qs = [WORLD.query(i, 0) for i in range(3)]
    np.testing.assert_array_equal(WorldEmbedder(WORLD).embed_batch(qs),
                                  np.stack([REF_WORLD.embed(q) for q in qs]))
    assert WorldEmbedder(WORLD).dim == 32


@pytest.mark.parametrize("backend", ["numpy", "kernel"])
def test_run_once_with_model_judge_equals_reference_and_oracle(backend):
    """benchmarks/figures.py:933-938's gate on the port: paying the
    tiny-LM judge's prefill leaves the summary byte-identical to the
    reference's model-judge run and to the oracle-compute run."""
    kw = dict(n_requests=120, judge_band=0.1, judge_d_model=64)
    before = flash_attention_fwd.plain_calls
    got = run_once(judge_compute="model", backend=backend, device="cpu", **kw)
    assert flash_attention_fwd.plain_calls > before
    oracle = run_once(backend=backend, device="cpu", **kw)
    want = ref_run_once(judge_compute="model", **kw)
    dump = lambda s: json.dumps(s, sort_keys=True)   # noqa: E731
    assert dump(got) == dump(want) == dump(oracle)
    assert got["judge_calls"] > 0
