"""The port's continuous batcher (``serving/generator.py``) on the CPU:
tests/test_generator_quant.py:13's behaviour, and the very tokens the
JAX package's ``ContinuousBatcher`` generates from the same parameters
(the reference's, carried over as numpy arrays) and prompts. The shrunk
agent runs in an fp32 config, so argmax near-ties cannot flip between the
two packages' roundings."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import shrink as ref_shrink
from repro.models.lm import LM as RefLM
from repro.nn.param import init_tree
from repro.serving.generator import ContinuousBatcher as RefBatcher
from repro.serving.generator import GenRequest as RefRequest
from repro_torch.configs import get_config, shrink
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.serving.generator import ContinuousBatcher, GenRequest

torch.set_num_threads(1)


def _requests(cls, n=6, vocab=128, seed=0, max_new=5):
    rng = np.random.default_rng(seed)
    return [cls(i, rng.integers(1, vocab, size=int(rng.integers(3, 8))),
                max_new=max_new) for i in range(n)]


def test_continuous_batching_with_colocated_judge():
    """tests/test_generator_quant.py:13 on the port: every request
    finishes with its tokens, a fresh batcher regenerates request 0, and
    the judge runs only on ticks with an empty admit queue."""
    cfg = shrink(get_config("search-r1-7b"), d_model=64, vocab=128,
                 n_repeat=2)
    judge_runs = []
    cb = ContinuousBatcher(cfg, slots=3, max_len=64, device="cpu",
                           judge=lambda: judge_runs.append(1))
    reqs = _requests(GenRequest)
    for r in reqs:
        cb.submit(r)
    before = (decode_attention.plain_calls, flash_attention_fwd.plain_calls)
    ticks = cb.run()
    assert all(r.done for r in reqs)
    assert all(len(r.out_tokens) == 5 for r in reqs)
    # every step went through the decode kernel's path, none through
    # prefill (the batcher prefills by decoding)
    assert decode_attention.plain_calls > before[0]
    assert flash_attention_fwd.plain_calls == before[1]
    cb2 = ContinuousBatcher(cfg, slots=3, max_len=64, device="cpu")
    r2 = GenRequest(0, reqs[0].prompt, max_new=5)
    cb2.submit(r2)
    cb2.run()
    assert r2.out_tokens == reqs[0].out_tokens
    assert cb.judge_batches_run == len(judge_runs) > 0
    assert cb.judge_batches_run <= ticks


@pytest.mark.parametrize("slots,max_len", [(3, 64), (2, 16)])
def test_generated_tokens_equal_reference(slots, max_len):
    """Same parameters, same prompts: the port's batcher generates the
    reference's tokens, its max(pos) cache writes and its idle slots fed
    token 0 included; max_len 16 also ends requests on the length cap."""
    size = dict(d_model=64, vocab=128, n_repeat=2)
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    ref_cfg = dataclasses.replace(ref_shrink(ref_get_config("search-r1-7b"),
                                             **size), **fp32)
    cfg = dataclasses.replace(shrink(get_config("search-r1-7b"), **size),
                              **fp32)
    params = init_tree(jax.random.PRNGKey(4), RefLM(ref_cfg).param_specs())
    ref = RefBatcher(ref_cfg, params=params, slots=slots, max_len=max_len)
    port = ContinuousBatcher(cfg, slots=slots, max_len=max_len, device="cpu",
                             params=lm_params_from_numpy(
                                 jax.tree.map(np.asarray, params), cfg,
                                 "cpu"))
    ref_reqs = _requests(RefRequest, n=5, seed=1, max_new=6)
    reqs = _requests(GenRequest, n=5, seed=1, max_new=6)
    for a, b in zip(ref_reqs, reqs):
        ref.submit(a)
        port.submit(b)
    assert port.run() == ref.run()
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert all(r.done for r in reqs)
    assert port.decode_steps == ref.decode_steps
