"""The port's MoE channel mixer (``nn/moe.py``) against the JAX package's
on one device (its ``use_ep=False`` path), on the same parameters (made
by the reference's ``init_tree`` and carried over as numpy arrays) and
the same seeded inputs.

The routing and the dispatch plan must be exact: the same top-k experts
in the same order (ties to the lower index), the same weights (fp32,
1e-6), and the same slot of every (token, choice) pair, so that the same
pairs overflow the capacity and drop. The output is held within 1e-5 in
fp32 (tests/test_torch_lm.py's layer tolerance: sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import moe as ref_moe
from repro.nn.config import MoEConfig as RefMoEConfig
from repro.nn.param import init_tree
from repro.nn.sharding import ShardCtx
from repro_torch.nn import moe
from repro_torch.nn.config import MoEConfig

torch.set_num_threads(1)
CTX = ShardCtx(None)


def _cfgs(**kw):
    a = dict(n_experts=6, top_k=2, d_ff_expert=24, **kw)
    return RefMoEConfig(**a), MoEConfig(**a)


def _params(ref_cfg, d=32, seed=0):
    p = init_tree(jax.random.PRNGKey(seed),
                  ref_moe.moe_specs(ref_cfg, d, jnp.float32))
    p = dict(p)
    p["router"] = p["router"] * 40.0    # spread the router's choices
    if "router_bias" in p:               # a non-zero balancing bias
        p["router_bias"] = jnp.asarray(np.random.default_rng(seed).uniform(
            -0.3, 0.3, ref_cfg.n_experts).astype(np.float32))
    tree = jax.tree.map(np.asarray, p)
    return p, jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _x(shape, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


@pytest.mark.parametrize("router_fn,scale", [("softmax", True),
                                             ("softmax", False),
                                             ("sigmoid", True)])
def test_route_matches_reference(router_fn, scale):
    ref_cfg, cfg = _cfgs(router_fn=router_fn, router_scale=scale)
    p, pt = _params(ref_cfg)
    x = _x((2, 40, 32))
    w, idx, aux = moe._route(pt, cfg, torch.from_numpy(x))
    rw, ridx, raux = ref_moe._route(p, ref_cfg, jnp.asarray(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), atol=1e-6)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_top_k_breaks_ties_to_the_lower_index():
    """jax.lax.top_k's order on equal values, which decides the dispatch
    plan's order and so which choices drop."""
    x = np.array([[0.5, 0.9, 0.5, 0.9, 0.1, 0.5]], np.float32)
    _, idx = moe._top_k(torch.from_numpy(x), 4)
    _, ridx = jax.lax.top_k(jnp.asarray(x), 4)
    assert idx.tolist() == np.asarray(ridx).tolist() == [[1, 3, 0, 2]]


@pytest.mark.parametrize("t,cap", [(40, 3), (9, 1), (12, 40)])
def test_dispatch_plan_is_exact(t, cap):
    """slot_src and tok_slot equal the reference's: capacity 3 and 1 drop
    many choices (an expert chosen by more tokens than it has slots),
    capacity 40 drops none."""
    rng = np.random.default_rng(t)
    idx = np.stack([rng.choice(6, 2, replace=False) for _ in range(t)]) \
        .astype(np.int32)
    slot_src, tok_slot = moe._dispatch_indices_1g(
        2, 6, cap, torch.from_numpy(idx).long())
    rs, rt = ref_moe._dispatch_indices_1g(2, 6, cap, jnp.asarray(idx))
    np.testing.assert_array_equal(slot_src.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(tok_slot.numpy(), np.asarray(rt))
    dropped = int((tok_slot == 6 * cap).sum())
    assert (dropped > 0) == (cap < 40)


@pytest.mark.parametrize("router_fn,n_shared,shape", [
    ("softmax", 0, (2, 20, 32)),     # capacity round(40*2/6*1.25) = 17
    ("softmax", 2, (1, 7, 32)),
    ("sigmoid", 1, (3, 1, 32)),      # decode: capacity max(1, round(1.25))
])
def test_moe_apply_matches_reference(router_fn, n_shared, shape):
    ref_cfg, cfg = _cfgs(router_fn=router_fn, n_shared=n_shared,
                         d_ff_shared=16 * n_shared)
    p, pt = _params(ref_cfg, seed=3)
    x = _x(shape, seed=4)
    got, aux = moe.moe_apply(pt, cfg, torch.from_numpy(x))
    want, raux = ref_moe.moe_apply(CTX, p, ref_cfg, jnp.asarray(x))
    assert got.shape == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(float(aux), float(raux), rtol=1e-5)


def test_moe_plan_counts_capacity_drops():
    """At capacity factor 0.5 the plan drops choices; the combined output
    still equals the reference's (a dropped choice weighs 0)."""
    ref_cfg, cfg = _cfgs(capacity_factor=0.5)
    p, pt = _params(ref_cfg, seed=5)
    x = _x((2, 16, 32), seed=6)
    _, _, _, _, _, tok_slot, cap = moe.moe_plan(pt, cfg, torch.from_numpy(x))
    assert cap == round(32 * 2 / 6 * 0.5)
    assert int((tok_slot == 6 * cap).sum()) > 0
    got, _ = moe.moe_apply(pt, cfg, torch.from_numpy(x))
    want, _ = ref_moe.moe_apply(CTX, p, ref_cfg, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_moe_specs_match_reference():
    for kw in (dict(router_fn="sigmoid", n_shared=1),
               dict(n_shared=2, d_ff_shared=0)):
        ref_cfg, cfg = _cfgs(**kw)
        ref = ref_moe.moe_specs(ref_cfg, 32, jnp.bfloat16)
        got = moe.moe_specs(cfg, 32, torch.bfloat16)
        flat = jax.tree_util.tree_flatten_with_path(
            ref, is_leaf=lambda s: hasattr(s, "shape"))[0]
        assert len(flat) == sum(1 for _ in jax.tree.leaves(
            got, is_leaf=lambda s: hasattr(s, "shape")))
        for path, spec in flat:
            node = got
            for key in path:
                node = node[key.key]
            assert node.shape == tuple(spec.shape)
            assert str(node.dtype).removeprefix("torch.") == \
                jnp.dtype(spec.dtype).name
    assert dataclasses.asdict(_cfgs()[0]) == dataclasses.asdict(_cfgs()[1])
