"""The port's Megatron tensor parallelism (``horovod_tpu_torch.parallel.
tensor_parallel``) held against the JAX package's, case for case with
``tests/test_tensor_parallel.py``.

The port runs a 2-rank gloo world (``_torch_parallel.tp_worker``, tp 2),
each rank on its shard of the reference's flax weights carried across;
the JAX side runs ``tp_gpt_apply`` under ``shard_map`` on the first 2
devices of the 8-device CPU mesh (``check_vma=True`` for the
gradients, as the reference test does) and the unsharded model.  Bounds
(fp32): logits and gradients 1e-5 against the JAX schedule (the same
products, reduced over 2 ranks in another order), and the reference
test's 2e-4 against the unsharded model.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import _torch_parallel
import _torch_world
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.parallel.tensor_parallel import (stack_tp_params,
                                                  tp_gpt_apply)
from horovod_tpu_torch.models import gpt, params_from_jax, tree_from_jax
from horovod_tpu_torch.parallel import stack_tp_params as t_stack
from horovod_tpu_torch.parallel import unstack_tp_params as t_unstack
from horovod_tpu_torch.parallel.tensor_parallel import flat_params

TP = 2
AXIS = "tp"
TOL = 1e-5
BASE = dict(num_layers=2, num_heads=4, emb_dim=64, max_len=64,
            vocab_size=512, attention_impl="reference")
CASES = {"learned": ({}, 0), "rope": ({"pos_embedding": "rope"}, 0),
         "gqa": ({"num_heads": 8, "num_kv_heads": 4}, 1)}


def _mesh():
    return Mesh(np.asarray(jax.devices()[:TP]), (AXIS,))


@functools.lru_cache(maxsize=None)
def _case(name):
    over, seed = CASES[name]
    cfg = dict(BASE, **over)
    model = jax_gpt("nano", dtype=jnp.float32, **cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(_tokens()))
    return model, params, cfg


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, 512, (2, 32))


def _stacking():
    W = np.random.RandomState(0).randn(TP, 2, 3).astype(np.float32)
    H = np.random.RandomState(2).randn(3, 5).astype(np.float32)
    x = np.random.RandomState(1).randn(1, 2).astype(np.float32)
    return W, H, x


@pytest.fixture(scope="module")
def world():
    cases = {}
    for name in CASES:
        _, params, cfg = _case(name)
        cases[name] = (jax.tree_util.tree_map(np.asarray, params), cfg)
    tokens = _tokens()
    return _torch_world.run_world(
        _torch_parallel.tp_worker,
        (cases, "learned", tokens, np.roll(tokens, -1, axis=1),
         _stacking()), world=TP, timeout=120)


def _jax_tp_logits(model, params, tokens):
    sharded, replicated = stack_tp_params(params, model.cfg, TP)
    fwd = jax.jit(shard_map(
        lambda s, r, t: tp_gpt_apply(s, r, model.cfg, t, AXIS),
        mesh=_mesh(), in_specs=(P(AXIS), P(), P()), out_specs=P(),
        check_vma=False))
    return np.asarray(fwd(sharded, replicated, jnp.asarray(tokens)))


def _check_logits(world, name):
    model, params, _ = _case(name)
    tokens = _tokens()
    want = _jax_tp_logits(model, params, tokens)
    ref = np.asarray(model.apply(params, jnp.asarray(tokens)))
    for r in world:
        np.testing.assert_allclose(r[name], want, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(r[name], ref, atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("pos_embedding", ["learned", "rope"])
def test_tp_matches_single_device(world, pos_embedding):
    _check_logits(world, pos_embedding)


def test_tp_gqa_matches_single_device(world):
    # true GQA: kv_heads (4) < num_heads (8), both divisible by tp
    _check_logits(world, "gqa")


def test_tp_gradients_match(world):
    """The sharded weights' gradients are the JAX schedule's (rank r's
    shard) and the matching slices of the unsharded model's; the
    replicated weights' are the unsharded model's, on every rank (the
    Megatron f / g placement)."""
    model, params, _ = _case("learned")
    tokens = jnp.asarray(_tokens())
    targets = jnp.roll(tokens, -1, axis=1)

    def nll(logits, tgt):
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    tgt[..., None], -1).mean()

    sharded, replicated = stack_tp_params(params, model.cfg, TP)
    g_sh, g_rep = jax.jit(shard_map(
        jax.grad(lambda s, r, t, y: nll(tp_gpt_apply(s, r, model.cfg, t,
                                                     AXIS), y),
                 argnums=(0, 1)),
        mesh=_mesh(), in_specs=(P(AXIS), P(), P(), P()),
        out_specs=(P(AXIS), P()), check_vma=True))(
            sharded, replicated, tokens, targets)
    g_sh, g_rep = (tree_from_jax(jax.tree_util.tree_map(np.asarray, g))
                   for g in (g_sh, g_rep))
    g_ref = jax.grad(lambda p: nll(model.apply(p, tokens), targets))(params)
    ref_sh, ref_rep = t_stack(
        params_from_jax(jax.tree_util.tree_map(np.asarray, g_ref)),
        model.cfg, TP)

    def check(got, want, atol, path=""):
        for k, v in want.items():
            if isinstance(v, dict):
                check(got[k], v, atol, f"{path}{k}.")
            else:
                np.testing.assert_allclose(got[k], v, atol=atol, rtol=atol,
                                           err_msg=path + k)

    for r, res in enumerate(world):
        got_sh, got_rep = res["grads"]
        want_sh = {k: _index(v, r) for k, v in g_sh.items()}
        check(got_sh, want_sh, TOL)
        check(got_rep, g_rep, TOL)
        check(got_sh, {k: _index(v, r) for k, v in ref_sh.items()}, 2e-4)
        check(got_rep, _numpy(ref_rep), 2e-4)


def _index(tree, r):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r:r + 1].numpy()


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def test_tp_replicated_stacking_scales_grads(world):
    """The reference's failure mode, reproduced with the operator it
    comes from: a replicated value meeting rank-varying weights goes
    through ``pvary`` (JAX inserts one when replicated weights are
    stacked and sharded), whose backward sums the ranks' cotangents, so
    the sharded weights' gradients come out ``tp`` times too large; with
    the weights truly replicated they equal the full gradient, as the
    reference's."""
    W, H, x = _stacking()

    def loss_full(W):
        y = sum(x @ W[r] for r in range(TP))
        return ((y @ H) ** 2).sum()

    g_full = np.asarray(jax.grad(loss_full)(jnp.asarray(W)))
    bad = np.stack([r["stacking_stacked"] for r in world])
    good = np.stack([r["stacking_replicated"] for r in world])
    ratio = float(np.median(bad / g_full))
    assert abs(ratio - TP) < 1e-3, f"expected the {TP}x artifact, {ratio}"
    np.testing.assert_allclose(good, g_full, rtol=1e-5)


def test_tp_divisibility_errors():
    tm = gpt("nano", device="cpu", **BASE)
    with pytest.raises(ValueError, match="must divide num_heads"):
        t_stack(tm, tm.cfg, 3)
    moe = gpt("nano", device="cpu", moe_experts=2, **BASE)
    with pytest.raises(ValueError, match="dense blocks only"):
        t_stack(moe, moe.cfg, 2)


def test_unstack_tp_round_trips():
    """stack -> unstack is the identity; the stacked trees are the
    reference's (carried across by ``tree_from_jax``) exactly; a wrong tp
    raises instead of reassembling a scrambled kernel."""
    model, params, _ = _case("gqa")
    tm = gpt("nano", device="cpu", **dict(BASE, **CASES["gqa"][0]))
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    sh, rep = t_stack(tm, tm.cfg, TP)
    want_sh, want_rep = (tree_from_jax(jax.tree_util.tree_map(np.asarray, t))
                         for t in stack_tp_params(params, model.cfg, TP))
    for got, want in ((flat_params(sh), flat_params(want_sh)),
                      (flat_params(rep), flat_params(want_rep))):
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(),
                                          err_msg=k)
    back = flat_params(t_unstack(sh, rep, tm.cfg, TP))
    own = tm.state_dict()
    assert set(back) == set(own)
    for k in own:
        assert np.array_equal(back[k].numpy(), own[k].numpy()), k
    with pytest.raises(ValueError, match="expected tp=4"):
        t_unstack(sh, rep, tm.cfg, 4)
