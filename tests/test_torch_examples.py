"""The port's examples (``repro_torch.examples``) on ``--device cpu``
against the reference's scripts under ``examples/``, each run in this
process (``runpy``) with its printed lines captured:

* ``quickstart``: the same lines.
* ``serve_cortex`` and ``multi_region``: the same lines at fewer requests
  (200 a mode, 40 a region), passed to both sides: the reference's
  ``run_once`` / ``region_workloads`` are wrapped to take them.
* ``colocated_serving``: the same tokens, decode steps and judge batches
  from the reference's batcher weights carried across
  (``convert.lm_params_from_numpy``), the shrunk agent in fp32 on both
  sides so that no argmax near-tie flips between the packages' roundings.
* ``train_lm``: the reference's ``launch.train.main`` at the example's
  argv cut to 30 steps (checkpoints every 10, the failure at step 24):
  losses within 1e-5 of each other and one restart each. Both sides
  train in fp32 without weight decay (the reference decays its stacked
  norms, the port does not: ROADMAP section 3), the port from the
  reference's initial parameters, and the reference's checkpoints are
  written synchronously (its writers are not joined before a restore).
* ``multi_pod_dryrun``: one cheap cell ends OK.

Every example's ``main`` defaults to CUDA and raises without it. About
45 s in one process.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.configs as ref_configs
import repro.data.workloads as ref_workloads
import repro.launch.serve as ref_serve
import repro.launch.train as ref_train
import repro.train.checkpoint as ref_ckpt
from repro.models.lm import LM as RefLM
from repro.nn.param import init_tree
from repro_torch.convert import lm_params_from_numpy
from repro_torch.examples import (colocated_serving, multi_pod_dryrun,
                                  multi_region, quickstart, serve_cortex,
                                  train_lm)
from repro_torch.launch import train as port_train
from repro_torch.models.lm import LM

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
FP32 = dict(param_dtype="float32", compute_dtype="float32")
N_SERVE = 200           # requests a mode (the example's: 600)
N_REGION = 40           # requests a region (the example's: 250)
TRAIN = dict(steps=30, save_every=10, fail_at=24)
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _fake_group():
    """The dry run's fake process group is left behind for no later file
    on the worker."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _reference(name: str, capsys) -> tuple[list[str], dict]:
    """The reference's script run as ``__main__``: its printed lines and
    its globals."""
    capsys.readouterr()
    glb = runpy.run_path(str(EXAMPLES / f"{name}.py"), run_name="__main__")
    return capsys.readouterr().out.splitlines(), glb


def _port_lines(lines: list[str]) -> list[str]:
    """A port example's returned lines as the reference prints them."""
    return "\n".join(lines).splitlines()


def test_quickstart_prints_the_references_lines(capsys):
    want, _ = _reference("quickstart", capsys)
    got = quickstart.main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == want
    assert _port_lines(got) == want


def test_serve_cortex_prints_the_references_lines(capsys, monkeypatch):
    real = ref_serve.run_once
    monkeypatch.setattr(ref_serve, "run_once", lambda **k: real(
        **{**k, "n_requests": N_SERVE}))
    want, _ = _reference("serve_cortex", capsys)
    got, summaries = serve_cortex.serve_cortex("cpu", n_requests=N_SERVE)
    assert _port_lines(got) == want
    assert summaries["cortex"]["hit_rate"] > 0


def test_multi_region_prints_the_references_lines(capsys, monkeypatch):
    real = ref_workloads.region_workloads
    monkeypatch.setattr(ref_workloads, "region_workloads",
                        lambda world, n, *a, **k: real(world, N_REGION, *a,
                                                       **k))
    want, _ = _reference("multi_region", capsys)
    got, summaries = multi_region.multi_region("cpu", n_requests=N_REGION)
    assert _port_lines(got) == want
    assert set(summaries) == set(multi_region.TOPOLOGIES)


def test_colocated_serving_generates_the_references_tokens(capsys,
                                                           monkeypatch):
    real_shrink = ref_configs.shrink
    monkeypatch.setattr(ref_configs, "shrink", lambda *a, **k:
                        dataclasses.replace(real_shrink(*a, **k), **FP32))
    want, ref = _reference("colocated_serving", capsys)
    port_cfg = colocated_serving.agent_config
    monkeypatch.setattr(colocated_serving, "agent_config", lambda:
                        dataclasses.replace(port_cfg(), **FP32))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, ref["cb"].params),
                                  colocated_serving.agent_config(), "cpu")
    lines, reqs, cb = colocated_serving.colocated("cpu", params=params)
    assert [r.out_tokens for r in reqs] == \
        [r.out_tokens for r in ref["reqs"]]
    assert all(r.done for r in reqs)
    assert cb.decode_steps == ref["cb"].decode_steps
    assert cb.judge_batches_run == ref["cb"].judge_batches_run > 0
    # the first line holds the run's seconds
    assert lines[1:] == want[1:]


def _in_spec_order(specs, tree, out: list) -> list:
    """The leaves of ``tree`` in the order of the spec tree ``specs`` (the
    order in which the trainer draws them)."""
    if isinstance(specs, dict):
        for k in specs:
            _in_spec_order(specs[k], tree[k], out)
    elif isinstance(specs, (list, tuple)):
        for s, t in zip(specs, tree):
            _in_spec_order(s, t, out)
    else:
        out.append(tree)
    return out


def test_train_lm_matches_the_reference_trainer(tmp_path, monkeypatch):
    for mod in (ref_train, port_train):
        real = mod.shrink
        monkeypatch.setattr(mod, "shrink", functools.partial(
            lambda shrink, *a, **k: dataclasses.replace(shrink(*a, **k),
                                                        **FP32), real))
        monkeypatch.setattr(mod, "AdamWConfig", functools.partial(
            mod.AdamWConfig, weight_decay=0.0))
    real_save = ref_ckpt.save
    monkeypatch.setattr(ref_ckpt, "save", lambda *a, **k: real_save(
        *a, **{**k, "async_write": False}))
    size = dict(d_model=128, vocab=256, n_repeat=2)
    ref = ref_train.main([
        "--arch", "granite-3-8b", "--smoke", "--steps", str(TRAIN["steps"]),
        "--batch", "16", "--seq", "64", "--d-model", "128", "--vocab", "256",
        "--n-repeat", "2", "--lr", "3e-3", "--ckpt-dir", str(tmp_path),
        "--save-every", str(TRAIN["save_every"]),
        "--fail-at", str(TRAIN["fail_at"])])
    ref_cfg = ref_train.shrink(ref_train.get_config("granite-3-8b"), **size)
    cfg = port_train.shrink(port_train.get_config("granite-3-8b"), **size)
    params = init_tree(jax.random.PRNGKey(0), RefLM(ref_cfg).param_specs())
    leaves = _in_spec_order(LM(cfg).param_specs(), lm_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu"), [])
    draws = itertools.cycle(leaves)         # a restart draws them again

    def init_leaf(spec, gen, dev):
        leaf = next(draws)
        assert tuple(leaf.shape) == tuple(spec.shape)
        return leaf.clone()

    monkeypatch.setattr(port_train, "init_leaf", init_leaf)
    res = train_lm.train_lm("cpu", **TRAIN)
    assert res.restarts == ref.restarts == 1
    assert len(res.losses) == len(ref.losses) == \
        TRAIN["steps"] + TRAIN["fail_at"] % TRAIN["save_every"]
    np.testing.assert_allclose(res.losses, ref.losses, rtol=LOSS_RTOL)


def test_multi_pod_dryrun_cell_ends_ok(capsys):
    recs = multi_pod_dryrun.main(["xlstm-350m", "long_500k", "--device",
                                  "cpu"])
    assert [r["status"] for r in recs] == ["OK"]
    assert recs[0]["mesh"] == "2x32x8"
    assert "1 OK, 0 SKIP, 0 FAIL" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="CUDA is available")
@pytest.mark.parametrize("example", [quickstart, serve_cortex, multi_region,
                                     colocated_serving, train_lm,
                                     multi_pod_dryrun])
def test_examples_default_to_cuda(example):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        example.main([])
