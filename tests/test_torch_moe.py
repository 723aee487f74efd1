"""The port's mixture of experts (``horovod_tpu_torch.parallel.moe``) held
against the JAX package's, case for case with ``tests/test_moe.py``.

The dense layer runs in this process on the reference's weights (the same
numpy draws); expert parallelism in a 4-rank gloo world
(``_torch_parallel.ep_worker``, 8 experts, 2 a rank) against the JAX
``moe_mlp_ep`` under ``shard_map`` on the first 4 devices of the
8-device CPU mesh and the dense layer per shard.

Routing is discrete: a router logit one ulp apart between the packages
could move a token to another expert or capacity slot.  Every seeded
input here is checked first to have no near tie at its top-k choice
(``_check_margins``: the gap between each token's k-th and (k+1)-th gate
at least ``MARGIN``, in float64), so the packages route alike and the
bounds below hold the arithmetic, not luck.  Bounds (fp32): outputs and
gradients 1e-5 against the JAX layer, the aux loss 1e-6; the reference
test's 1e-4 against its per-token float64 loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel
import _torch_world
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.parallel.moe import (MoEParams, init_moe_params, moe_mlp,
                                      moe_mlp_ep)
from horovod_tpu_torch.models import gpt, params_from_jax
from horovod_tpu_torch.parallel import MoEParams as TParams
from horovod_tpu_torch.parallel import moe_mlp as t_moe

EP = 4
AXIS = "ep"
D, FF, E = 16, 32, 8
TOL = 1e-5
# The gates sit near 1/E (router std 0.02), where an fp32 ulp is ~1.5e-8
# and the two packages' softmaxes differ by a few: a gap above 1e-6 cannot
# flip a choice.
MARGIN = 1e-6


def _x(seed=0, b=2, s=12):
    return (np.random.RandomState(seed).randn(b, s, D) * 0.5).astype(
        np.float32)


def _params(seed=0):
    return jax.tree_util.tree_map(
        np.asarray, init_moe_params(jax.random.PRNGKey(seed), D, FF, E))


def _t(p):
    return TParams(*(torch.from_numpy(np.array(a)) for a in p))


def _check_margins(x, router, top_k):
    """No near tie at any token's top-k choice: the packages pick the same
    experts (see the module docstring)."""
    logits = x.reshape(-1, D).astype(np.float64) @ np.asarray(
        router, np.float64)
    g = np.exp(logits - logits.max(-1, keepdims=True))
    g = np.sort(g / g.sum(-1, keepdims=True), axis=-1)[:, ::-1]
    gaps = g[:, :top_k] - g[:, 1:top_k + 1]
    assert gaps.min() > MARGIN, f"near tie in the routing: {gaps.min()}"


def _reference_loop(x, p, top_k):
    """Per-token routing without capacity limits, in float64 (the
    reference test's loop)."""
    x2 = np.asarray(x.reshape(-1, D), np.float64)
    router = np.asarray(p.router, np.float64)
    out = np.zeros_like(x2)
    for t in range(x2.shape[0]):
        logits = x2[t] @ router
        gates = np.exp(logits - logits.max())
        gates = gates / gates.sum()
        picks = np.argsort(-gates)[:top_k]
        weights = gates[picks] / gates[picks].sum()
        for w, e in zip(weights, picks):
            h = x2[t] @ np.asarray(p.w1[e], np.float64) + p.b1[e]
            h = np.asarray(jax.nn.gelu(jnp.asarray(h)))
            out[t] += w * (h @ np.asarray(p.w2[e], np.float64) + p.b2[e])
    return out.reshape(x.shape)


def _both(x, p, **kw):
    """(port y, port aux, JAX y, JAX aux) of the dense layer."""
    y, aux = t_moe(torch.from_numpy(x), _t(p), **kw)
    jy, jaux = moe_mlp(jnp.asarray(x), MoEParams(*p), **kw)
    return y.numpy(), float(aux), np.asarray(jy), float(jaux)


@pytest.mark.parametrize("top_k", [1, 2])
def test_dense_matches_reference_loop(top_k):
    x, p = _x(), _params()
    _check_margins(x, p.router, top_k)
    y, aux, jy, jaux = _both(x, p, top_k=top_k, capacity_factor=100.0)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    np.testing.assert_allclose(y, _reference_loop(x, p, top_k), atol=1e-4,
                               rtol=1e-4)
    assert np.isfinite(aux) and aux > 0


def test_capacity_overflow_drops_not_corrupts():
    """A tiny capacity drops most tokens: the kept ones still match the
    per-token loop, the dropped ones are exactly zero, as in the
    reference (and the same tokens drop in both packages)."""
    x, p = _x(1), _params(1)
    _check_margins(x, p.router, 1)
    y, _, jy, _ = _both(x, p, top_k=1, capacity_factor=0.01)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    y2 = y.reshape(-1, D)
    r2 = _reference_loop(x, p, 1).reshape(-1, D)
    kept = ~np.all(y2 == 0.0, axis=1)
    assert kept.sum() >= 1 and (~kept).sum() >= 1
    np.testing.assert_array_equal(kept, ~np.all(jy.reshape(-1, D) == 0.0,
                                                axis=1))
    np.testing.assert_allclose(y2[kept], r2[kept], atol=1e-4, rtol=1e-4)


def test_uniform_router_aux_is_one():
    x = _x(2)
    p = _params(2)._replace(router=np.zeros((D, E), np.float32))
    _, aux, _, jaux = _both(x, p, top_k=2)
    np.testing.assert_allclose(aux, 1.0, rtol=1e-5)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)


@pytest.fixture(scope="module")
def world():
    sets = {"plain": (_x(3, b=EP * 2, s=8), _params(3), {"top_k": 2}),
            "grouped": (_x(7, b=EP * 2, s=8), _params(7),
                        {"top_k": 2, "group_size": 8}),
            "recipe": (_x(5, b=EP * 2, s=8), _params(5), {"top_k": 2}),
            "overflow": (_x(9, b=EP * 2, s=8), _params(9),
                         {"top_k": 2, "capacity_factor": 0.5})}
    for x, p, _ in sets.values():
        _check_margins(x, p.router, 2)
    ranks = _torch_world.run_world(
        _torch_parallel.ep_worker,
        ({k: (x, p._asdict(), kw) for k, (x, p, kw) in sets.items()},
         "recipe"), world=EP, timeout=120)
    return {k: (x, p, ranks) for k, (x, p, _) in sets.items()}


def _jax_ep(x, p, **kw):
    mesh = Mesh(np.asarray(jax.devices()[:EP]), (AXIS,))
    fn = jax.jit(shard_map(
        lambda x_l, r, w1, b1, w2, b2: moe_mlp_ep(
            x_l, MoEParams(r, w1, b1, w2, b2), AXIS, **kw),
        mesh=mesh,
        in_specs=(P(AXIS), P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS)),
        out_specs=(P(AXIS), P()), check_vma=False))
    y, aux = fn(jnp.asarray(x), *(jnp.asarray(a) for a in p))
    return np.asarray(y), float(aux)


def test_ep_matches_dense_per_shard(world):
    """moe_mlp_ep over 4 ranks == the JAX EP layer == the dense layer on
    each rank's tokens with the whole expert set; aux the mean over the
    ranks."""
    x, p, ranks = world["plain"]
    y = np.concatenate([r["plain"][0] for r in ranks])
    jy, jaux = _jax_ep(x, p, top_k=2)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    per = x.shape[0] // EP
    dense = [t_moe(torch.from_numpy(x[r * per:(r + 1) * per]), _t(p),
                   top_k=2) for r in range(EP)]
    np.testing.assert_allclose(
        y, np.concatenate([d[0].numpy() for d in dense]), atol=TOL, rtol=TOL)
    for r in ranks:
        np.testing.assert_allclose(r["plain"][1], jaux, rtol=1e-6)
        np.testing.assert_allclose(
            r["plain"][1], np.mean([float(d[1]) for d in dense]), rtol=1e-6)


def test_gradients_flow():
    x, p = _x(4), _params(4)
    _check_margins(x, p.router, 2)
    tp = TParams(*(torch.from_numpy(np.array(a)).requires_grad_()
                   for a in p))
    y, aux = t_moe(torch.from_numpy(x), tp, top_k=2)
    ((y ** 2).mean() + 0.01 * aux).backward()

    def loss(p):
        y, aux = moe_mlp(jnp.asarray(x), p, top_k=2)
        return (y ** 2).mean() + 0.01 * aux

    want = jax.grad(loss)(MoEParams(*(jnp.asarray(a) for a in p)))
    for name in MoEParams._fields:
        g = getattr(tp, name).grad.numpy()
        assert np.all(np.isfinite(g)) and np.abs(g).max() > 0, name
        np.testing.assert_allclose(g, np.asarray(getattr(want, name)),
                                   atol=TOL, rtol=1e-4, err_msg=name)


def test_gpt_moe_trains_and_sows_aux():
    """``moe_experts`` puts experts in every block in place of fc1 / fc2
    (flax's names, so the reference's weights load); the logits and each
    block's aux loss (appended to ``losses``, the reference's ``"losses"``
    collection) match the reference model's; the model trains."""
    tokens = np.random.RandomState(0).randint(0, 1024, size=(2, 32))
    jm = jax_gpt("nano", moe_experts=4, dtype=jnp.float32,
                 attention_impl="reference")
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(tokens))
    jlogits, state = jm.apply({"params": params["params"]},
                              jnp.asarray(tokens), mutable=["losses"])
    tm = gpt("nano", device="cpu", moe_experts=4, dtype=torch.float32,
             attention_impl="reference")
    sd = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert "block0.w1" in sd and "block0.fc1.weight" not in sd
    assert set(sd) == set(tm.state_dict())
    tm.load_state_dict(sd)
    losses: list = []
    logits = tm(torch.from_numpy(tokens), losses=losses)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               atol=2e-5, rtol=2e-5)
    want = [float(a) for a in jax.tree_util.tree_leaves(state["losses"])]
    np.testing.assert_allclose([float(a.detach()) for a in losses], want,
                               rtol=1e-5)

    opt = torch.optim.Adam(tm.parameters(), lr=1e-3)
    toks = torch.from_numpy(tokens)
    nlls = []
    for _ in range(5):
        losses = []
        logits = tm(toks, losses=losses)
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), toks.reshape(-1))
        opt.zero_grad()
        (nll + 0.01 * torch.stack(losses).sum()).backward()
        opt.step()
        nlls.append(nll.item())
        assert all(np.isfinite(a.item()) for a in losses)
    assert nlls[-1] < nlls[0], f"MoE model did not train: {nlls}"


def test_ep_gradient_recipe_matches_dense(world):
    """The reference's EP recipe (the router's gradient averaged over the
    axis, the experts' divided by its size) gives the gradients of the
    mean of the per-rank losses, as the dense layer on each shard does."""
    x, p, ranks = world["recipe"]
    per = x.shape[0] // EP

    def loss_dense(p):
        total = 0.0
        for r in range(EP):
            y, aux = moe_mlp(jnp.asarray(x[r * per:(r + 1) * per]), p,
                             top_k=2)
            total = total + (y ** 2).mean() + 0.01 * aux
        return total / EP

    g = jax.grad(loss_dense)(MoEParams(*(jnp.asarray(a) for a in p)))
    e_loc = E // EP
    for r, res in enumerate(ranks):
        got = res["recipe"]
        np.testing.assert_allclose(got["router"], np.asarray(g.router),
                                   atol=2e-6, rtol=2e-5)
        for name in ("w1", "b1", "w2", "b2"):
            want = np.asarray(getattr(g, name))[r * e_loc:(r + 1) * e_loc]
            np.testing.assert_allclose(got[name], want, atol=2e-6,
                                       rtol=2e-5, err_msg=name)


def test_grouped_routing_matches_reference_loop():
    """Routing within groups (n 24, group 8: 3 groups) still matches the
    per-token loop at ample capacity, and the JAX layer."""
    x, p = _x(6), _params(6)
    _check_margins(x, p.router, 2)
    y, aux, jy, jaux = _both(x, p, top_k=2, capacity_factor=100.0,
                             group_size=8)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    np.testing.assert_allclose(y, _reference_loop(x, p, 2), atol=1e-4,
                               rtol=1e-4)


def test_ep_grouped_matches_dense_grouped(world):
    x, p, ranks = world["grouped"]
    y = np.concatenate([r["grouped"][0] for r in ranks])
    jy, _ = _jax_ep(x, p, top_k=2, group_size=8)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    per = x.shape[0] // EP
    dense = np.concatenate([
        t_moe(torch.from_numpy(x[r * per:(r + 1) * per]), _t(p), top_k=2,
              group_size=8)[0].numpy() for r in range(EP)])
    np.testing.assert_allclose(y, dense, atol=TOL, rtol=TOL)


def test_ep_overflow_drops_as_dense(world):
    """EP under a small capacity (0.5: 2 slots an expert for 16 local
    tokens, top 2): tokens overflow and drop on each rank exactly as in
    the dense layer on its shard, and as in the JAX EP layer."""
    x, p, ranks = world["overflow"]
    y = np.concatenate([r["overflow"][0] for r in ranks])
    jy, _ = _jax_ep(x, p, top_k=2, capacity_factor=0.5)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    per = x.shape[0] // EP
    dense = np.concatenate([
        t_moe(torch.from_numpy(x[r * per:(r + 1) * per]), _t(p), top_k=2,
              capacity_factor=0.5)[0].numpy() for r in range(EP)])
    np.testing.assert_allclose(y, dense, atol=TOL, rtol=TOL)
    # some token lost both of its experts to overflow: its output is zero
    assert np.all(y.reshape(-1, D) == 0.0, axis=1).any()


def test_padded_group_routing_matches_reference_loop():
    """n 22 in groups of 8: the last group pads 2 invalid rows, which claim
    no capacity and change nothing."""
    x = (np.random.RandomState(8).randn(2, 11, D) * 0.5).astype(np.float32)
    p = _params(8)
    _check_margins(x, p.router, 2)
    y, aux, jy, jaux = _both(x, p, top_k=2, capacity_factor=100.0,
                             group_size=8)
    np.testing.assert_allclose(y, jy, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(aux, jaux, rtol=1e-6)
    np.testing.assert_allclose(y, _reference_loop(x, p, 2), atol=1e-4,
                               rtol=1e-4)
