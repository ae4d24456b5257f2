"""The decode step with the cache position as a device value, the form
that the batcher's and the model judge's CUDA graphs capture
(``serving/generator.decode_step``, ``core/judge.ModelJudge``,
``kernels/graphs.StepGraph``), on the CPU against the host-int path and
the JAX package, at small widths from numpy seeds.

* ``LM.decode`` with a 0-d tensor ``pos`` is bitwise the host-int call
  (logits and every cache leaf) for GQA, gemma3's window ring past its
  length, MLA, Mamba (jamba) and xLSTM, and within 2e-4 of the
  reference's decode (tests/test_nn.py's tolerance);
* ``_dyn_write`` with a tensor index is ``lax.dynamic_update_slice``,
  clamp included;
* kernel 7's plain version with a tensor ``pos`` is bitwise its int form
  and within 3e-5 of the Pallas kernel in interpret mode;
* ``decode_step`` fed the reference batcher's inputs call by call gives
  its tokens exactly; the model judge's scores are the reference's;
* ``StepGraph``'s counts: a capture's launches counted once a replay.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.core.judge import ModelJudge as RefJudge
from repro.core.judge_pipeline import default_judge_cfg as ref_judge_cfg
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.models.lm import LM as RefLM
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro.serving.generator import ContinuousBatcher as RefBatcher
from repro.serving.generator import GenRequest as RefRequest
from repro_torch.configs import get_config, shrink
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.judge import ModelJudge
from repro_torch.core.judge_pipeline import default_judge_cfg
from repro_torch.kernels import graphs
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.models.lm import LM
from repro_torch.nn.attention import _dyn_write
from repro_torch.nn.param import init_params
from repro_torch.serving.generator import ContinuousBatcher, decode_step
from repro_torch.train import tree as tr

torch.set_num_threads(1)
CTX = ShardCtx(None)
TOL = 2e-4
VOCAB = 128
FP32 = dict(param_dtype="float32", compute_dtype="float32")
# name: decode steps (gemma3: past its shrunk window of 8, so that its
# local layers write and read a wrapped ring)
DECODE = {"granite-3-8b": 4, "gemma3-12b": 12, "deepseek-v2-236b": 2,
          "jamba-1.5-large-398b": 3, "xlstm-350m": 3}
S_CACHE = 16


def _models(name: str):
    size = dict(d_model=64, vocab=VOCAB, n_repeat=1, seq_chunk=4)
    ref_cfg = dataclasses.replace(ref_shrink(ref_get_config(name), **size),
                                  **FP32)
    cfg = dataclasses.replace(shrink(get_config(name), **size), **FP32)
    ref = RefLM(ref_cfg)
    params = init_tree(jax.random.PRNGKey(0), ref.param_specs())
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    return ref, params, LM(cfg), pp


@pytest.mark.parametrize("name", sorted(DECODE))
def test_decode_with_a_device_pos_is_the_host_int_path(name):
    ref, params, lm, pp = _models(name)
    caches = [init_params(lm.cache_specs(2, S_CACHE), None, "cpu")
              for _ in range(2)]
    ref_c = init_tree(jax.random.PRNGKey(1), ref.cache_specs(2, S_CACHE))
    toks = np.random.default_rng(1).integers(
        0, VOCAB, size=(2, DECODE[name])).astype(np.int32)
    ref_decode = jax.jit(functools.partial(ref.decode, CTX))
    for t in range(toks.shape[1]):
        tok = torch.from_numpy(toks[:, t:t + 1])
        with torch.inference_mode():
            at_int, _ = lm.decode(pp, tok, caches[0], t)
            at_dev, _ = lm.decode(pp, tok, caches[1],
                                  torch.tensor(t, dtype=torch.int32))
        assert torch.equal(at_dev, at_int), t
        want, ref_c = ref_decode(params, jnp.asarray(toks[:, t:t + 1]),
                                 ref_c, jnp.int32(t))
        np.testing.assert_allclose(at_dev.numpy(), np.asarray(want),
                                   atol=TOL)
    for a, b in zip(tr.leaves(caches[0]), tr.leaves(caches[1]), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("idx", [0, 4, 7, 9, 100])
def test_dyn_write_with_a_tensor_index_is_dynamic_update_slice(n, idx):
    """Index 0, the middle, ``total - n`` (7 at n 3), past it and far past
    it: the start clamped into ``0..total - n``."""
    rng = np.random.default_rng(idx + n)
    buf = rng.standard_normal((2, 10, 3)).astype(np.float32)
    val = rng.standard_normal((2, n, 3)).astype(np.float32)
    want = jax.lax.dynamic_update_slice(jnp.asarray(buf), jnp.asarray(val),
                                        (0, idx, 0))
    got = torch.from_numpy(buf.copy())
    _dyn_write(got, torch.from_numpy(val), torch.tensor(idx))
    at_int = torch.from_numpy(buf.copy())
    _dyn_write(at_int, torch.from_numpy(val), idx)
    assert torch.equal(got, at_int)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dyn_write_refuses_a_tensor_index_on_a_shard():
    with pytest.raises(ValueError, match="whole sequence"):
        _dyn_write(torch.zeros(1, 4, 2), torch.ones(1, 1, 2),
                   torch.tensor(1), off=4, total=8)


@pytest.mark.parametrize("pos", [0, 61, 127, 140])
def test_decode_plain_with_a_tensor_pos(pos):
    """The int form bitwise, the wrapper's CPU path too, and the Pallas
    kernel in interpret mode within 3e-5 (pos 140 past the cache's 128
    rows: all of them)."""
    rng = np.random.default_rng(pos)
    q = rng.standard_normal((2, 2, 4, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, 128, 2, 32)).astype(np.float32)
              for _ in range(2))
    tq, tk, tv = map(torch.from_numpy, (q, kc, vc))
    at = torch.tensor(pos, dtype=torch.int32)
    got, lse = decode_attention_plain(tq, tk, tv, at, 0.25, return_lse=True)
    want, want_lse = decode_attention_plain(tq, tk, tv, pos, 0.25,
                                            return_lse=True)
    assert torch.equal(got, want) and torch.equal(lse, want_lse)
    assert torch.equal(decode_attention(tq, tk, tv, at, scale=0.25), got)
    ref = jax_decode(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                     jnp.int32(pos), scale=0.25, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=3e-5)


def test_decode_refuses_a_pos_tensor_it_cannot_read():
    q = torch.zeros(1, 1, 1, 16)
    kc = torch.zeros(1, 8, 1, 16)
    for pos in (torch.tensor([3]), torch.tensor(3.0)):
        with pytest.raises(ValueError, match="0-d int32 or int64"):
            decode_attention(q, kc, kc, pos, scale=1.0)


def test_decode_step_gives_the_reference_batchers_tokens():
    """The reference batcher's jitted step recorded call by call
    (prefill-by-decode and batched steps, max(pos) writes, idle slots fed
    token 0); the port's step on the same inputs and carried parameters
    returns its tokens at every call. On the CPU the batcher has no
    graph."""
    size = dict(d_model=64, vocab=VOCAB, n_repeat=2)
    ref_cfg = dataclasses.replace(ref_shrink(ref_get_config("search-r1-7b"),
                                             **size), **FP32)
    cfg = dataclasses.replace(shrink(get_config("search-r1-7b"), **size),
                              **FP32)
    params = init_tree(jax.random.PRNGKey(4), RefLM(ref_cfg).param_specs())
    ref = RefBatcher(ref_cfg, params=params, slots=3, max_len=32)
    calls, real = [], ref._decode

    def spy(p, toks, caches, pos_vec):
        nxt, caches = real(p, toks, caches, pos_vec)
        # copies: a CPU jax array may share memory with the batcher's
        # ``pos``, which moves on after the call
        calls.append(tuple(np.array(a, copy=True)
                           for a in (toks, pos_vec, nxt)))
        return nxt, caches

    ref._decode = spy
    rng = np.random.default_rng(1)
    for i in range(4):
        ref.submit(RefRequest(i, rng.integers(1, VOCAB, size=int(
            rng.integers(3, 7))), max_new=4))
    ref.run()
    lm = LM(cfg)
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, params), cfg, "cpu")
    cb = ContinuousBatcher(cfg, params=pp, slots=3, max_len=32,
                           device="cpu")
    assert cb._graph is None and cb.graph_pool_bytes == 0
    assert len(calls) > 20
    for toks, pos_vec, want in calls:
        got = decode_step(lm, pp, cb.caches, torch.tensor(toks),
                          torch.tensor(pos_vec))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("b", [1, 3])
def test_model_judge_scores_equal_reference(b):
    ref_cfg = dataclasses.replace(ref_judge_cfg(d_model=64), **FP32)
    cfg = dataclasses.replace(default_judge_cfg(d_model=64), **FP32)
    ref = RefJudge(cfg=ref_cfg, max_len=32, seed=3)
    judge = ModelJudge(cfg=cfg, max_len=32, device="cpu",
                       params=lm_params_from_numpy(
                           jax.tree.map(np.asarray, ref.params), cfg, "cpu"))
    qs = [f"price of item {i}" for i in range(b)]
    ks = [f"item {i} price today" for i in range(b)]
    np.testing.assert_allclose(judge.score_pairs(qs, ks),
                               ref.score_pairs(qs, ks), atol=1e-5)
    assert judge._graphs == {} and judge.graph_pool_bytes == 0


class _FakeCuda:
    """The parts of ``torch.cuda`` that ``StepGraph`` calls, on the host:
    a capture runs the step (as the capture's Python does) but a replay
    runs nothing."""

    def __init__(self):
        self.mode = 0
        self.modes = []
        self.capture_modes = []

    def install(self, monkeypatch):
        import contextlib
        import types

        stream = types.SimpleNamespace(wait_stream=lambda other: None)
        for name, fn in {
                "Stream": lambda: stream,
                "current_stream": lambda: stream,
                "current_device": lambda: 0,
                "stream": lambda s: contextlib.nullcontext(),
                "get_sync_debug_mode": lambda: self.mode,
                "set_sync_debug_mode": self._set,
                "synchronize": lambda: None, "empty_cache": lambda: None,
                "memory_reserved": lambda: 0,
                "CUDAGraph": lambda: types.SimpleNamespace(
                    replay=lambda: None),
                "graph": self._graph}.items():
            monkeypatch.setattr(torch.cuda, name, fn)

    def _graph(self, g, pool=None, stream=None,
               capture_error_mode="global"):
        import contextlib

        self.capture_modes.append(capture_error_mode)
        return contextlib.nullcontext()

    def _set(self, mode):
        self.modes.append(mode)
        self.mode = mode


def test_step_graph_counts_a_capture_once_a_replay(monkeypatch):
    """The warm-up runs under the sync debug mode "error" and stays
    counted; the capture's counts are taken back; each replay adds them."""
    fake = _FakeCuda()
    fake.install(monkeypatch)
    w = decode_attention
    for name in graphs.COUNTS:
        monkeypatch.setattr(w, name, 0)
    out = torch.zeros(2)

    def step():
        w.launches += 2
        w.launches_tc += 2
        return out

    g = graphs.StepGraph(step)
    assert fake.modes == ["error", 0]
    # only the capturing thread's calls are checked: NCCL's watchdog
    # thread queries events during a capture over a mesh
    assert fake.capture_modes == ["thread_local"]
    assert (w.launches, w.launches_tc) == (2, 2)     # the warm-up
    assert g.launches[(w, "launches")] == 2
    for _ in range(3):
        assert g.replay() is out
    assert (w.launches, w.launches_tc, w.launches_simt,
            w.plain_calls) == (8, 8, 0, 0)
