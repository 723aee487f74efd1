"""The port's GPipe and circular pipelines (``horovod_tpu_torch.parallel.
pipeline``) held against the JAX package's, case for case with
``tests/test_pipeline.py``, at pp 4 and pp 2.

The port runs one gloo world per pp (``_torch_parallel.pp_worker``), each
rank a stage holding its layers of the reference's flax weights carried
across; the JAX side runs the unsharded model on the same weights and,
for the schedule's own numbers, ``pp_gpt_apply`` / ``pp_gpt_loss`` /
``pp_gpt_loss_circular`` under ``shard_map`` on the first pp devices of
the 8-device CPU mesh (``check_vma=True`` for the gradients, as the
reference test does).  Bounds (fp32): 1e-5 on logits, losses and
gradients against both (a microbatch's products are the full batch's
rows; only the order of sums differs).
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
from horovod_tpu.parallel.pipeline import (
    pp_gpt_apply, pp_gpt_loss, pp_gpt_loss_circular, stack_pp_params,
    stack_pp_params_circular)
from horovod_tpu_torch.models import gpt, params_from_jax, tree_from_jax
from horovod_tpu_torch.parallel import (
    stack_pp_params as t_stack, stack_pp_params_circular as t_stack_circ,
    stack_tp_pp_params as t_stack_tp_pp, unstack_pp_params as t_unstack,
    unstack_pp_params_circular as t_unstack_circ,
    unstack_tp_pp_params as t_unstack_tp_pp)
from horovod_tpu_torch.parallel.tensor_parallel import flat_params

AXIS = "pp"
TOL = 1e-5
BASE = dict(num_heads=4, emb_dim=64, max_len=64, vocab_size=512,
            attention_impl="reference")

# name -> (pp, kind, layers, pos_embedding, seed, batch, kwargs)
CASES = {
    **{f"apply_{mb}_{pos}": (4, "apply", 4, pos, 0, 4,
                             {"microbatches": mb})
       for mb in (1, 2, 4) for pos in ("learned", "rope")},
    "apply_grads": (4, "apply", 4, "learned", 1, 4,
                    {"microbatches": 2, "grads": True}),
    "loss_False": (4, "loss", 4, "learned", 2, 4,
                   {"microbatches": 2, "remat": False}),
    "loss_True": (4, "loss", 4, "learned", 2, 4,
                  {"microbatches": 2, "remat": True}),
    "loss_grads": (4, "loss", 4, "learned", 3, 4,
                   {"microbatches": 2, "remat": True, "grads": True}),
    "apply_remat_False": (4, "apply", 4, "learned", 4, 4,
                          {"microbatches": 2, "remat": False}),
    "apply_remat_True": (4, "apply", 4, "learned", 4, 4,
                         {"microbatches": 2, "remat": True}),
    "circular_4_2_8_4": (4, "circular", 8, "learned", 5, 4,
                         {"microbatches": 4, "circles": 2}),
    "circular_2_2_4_4": (2, "circular", 4, "learned", 5, 4,
                         {"microbatches": 4, "circles": 2}),
    "circular_2_3_6_2": (2, "circular", 6, "learned", 5, 4,
                         {"microbatches": 2, "circles": 3}),
    "circular_grads": (2, "circular", 4, "learned", 6, 4,
                       {"microbatches": 4, "circles": 2, "grads": True}),
    "pp2_apply": (2, "apply", 4, "learned", 0, 4, {"microbatches": 2}),
    "pp2_loss_grads": (2, "loss", 4, "learned", 3, 4,
                       {"microbatches": 2, "grads": True}),
    "error_small_m": (2, "error_circular", 4, "learned", 0, 1,
                      {"microbatches": 1, "circles": 2}),
    "error_circular_into_contiguous": (2, "error_loss", 4, "learned", 0, 4,
                                       {"microbatches": 2, "circles": 2}),
}


@functools.lru_cache(maxsize=None)
def _setup(layers, pos, seed, batch):
    model = jax_gpt("nano", dtype=jnp.float32, num_layers=layers,
                    pos_embedding=pos, **BASE)
    tokens = np.random.RandomState(seed).randint(0, 512, (batch, 16))
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(tokens))
    return model, params, tokens


def _ref_loss(model, params, tokens):
    tokens = jnp.asarray(tokens)
    targets = jnp.roll(tokens, -1, axis=1)
    logits = model.apply(params, tokens)
    return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                targets[..., None], -1).mean()


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for pp in (4, 2):
        cases = {}
        for name, (p, kind, layers, pos, seed, batch, kw) in CASES.items():
            if p != pp:
                continue
            model, params, tokens = _setup(layers, pos, seed, batch)
            cfg = dict(BASE, num_layers=layers, pos_embedding=pos)
            cases[name] = (kind, jax.tree_util.tree_map(np.asarray, params),
                           cfg, tokens, dict(kw))
        ranks = _torch_world.run_world(_torch_parallel.pp_worker, (cases,),
                                       world=pp, timeout=180)
        for name in cases:
            out[name] = [r[name] for r in ranks]
        out[f"indivisible_{pp}"] = [r["indivisible_batch"] for r in ranks]
    return out


def _mesh(pp):
    return Mesh(np.asarray(jax.devices()[:pp]), (AXIS,))


def _every_rank(values, want, tol=TOL):
    for v in values:
        np.testing.assert_allclose(np.asarray(v), np.asarray(want), atol=tol,
                                   rtol=tol)


def _layer_grads(ref_tree, st_grads, stage, layer_of, lead=1):
    """Each staged leaf's gradient at this stage (``lead`` layer dims
    after the stage's) against the unsharded model's gradient of the
    layer it holds, ``layer_of(stage, *index)``."""
    for name in ("qkv", "proj", "fc1", "fc2", "ln1", "ln2"):
        for leaf, got in st_grads[name].items():
            for idx in np.ndindex(*got.shape[1:1 + lead]):
                want = ref_tree[f"block{layer_of(stage, *idx)}"][name][leaf]
                np.testing.assert_allclose(got[(0, *idx)], want.numpy(),
                                           atol=TOL, rtol=TOL,
                                           err_msg=f"{name}.{leaf}")


@pytest.mark.parametrize("microbatches", [1, 2, 4])
@pytest.mark.parametrize("pos_embedding", ["learned", "rope"])
def test_pp_matches_single_device(worlds, microbatches, pos_embedding):
    model, params, tokens = _setup(4, pos_embedding, 0, 4)
    _every_rank(worlds[f"apply_{microbatches}_{pos_embedding}"],
                model.apply(params, jnp.asarray(tokens)))
    if (microbatches, pos_embedding) == (2, "learned"):
        staged, rep = stack_pp_params(params, model.cfg, 4)
        want = jax.jit(shard_map(
            lambda s, r, t: pp_gpt_apply(s, r, model.cfg, t, AXIS,
                                         microbatches=2),
            mesh=_mesh(4), in_specs=(P(AXIS), P(), P()), out_specs=P(),
            check_vma=False))(staged, rep, jnp.asarray(tokens))
        _every_rank(worlds["apply_2_learned"], want)
        model2, params2, tokens2 = _setup(4, "learned", 0, 4)
        _every_rank(worlds["pp2_apply"],
                    model2.apply(params2, jnp.asarray(tokens2)))


def _ref_grads(layers, pos, seed, batch):
    model, params, tokens = _setup(layers, pos, seed, batch)
    g = jax.grad(lambda p: _ref_loss(model, p, tokens))(params)["params"]
    return tree_from_jax(jax.tree_util.tree_map(np.asarray, g))


def _check_replicated(got_rep, ref):
    for name in ("wte", "head", "lnf"):
        for leaf, got in got_rep[name].items():
            np.testing.assert_allclose(got, ref[name][leaf].numpy(),
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{name}.{leaf}")
    if "wpe" in got_rep:
        np.testing.assert_allclose(got_rep["wpe"], ref["wpe"].numpy(),
                                   atol=TOL, rtol=TOL)


def test_pp_gradients_match(worlds):
    """Through the logits path: each stage's layer gradients and the
    replicated weights' (on every rank) against the unsharded model."""
    ref = _ref_grads(4, "learned", 1, 4)
    for stage, (_, st, rep) in enumerate(worlds["apply_grads"]):
        _layer_grads(ref, st, stage, lambda s, j: s + j)
        _check_replicated(rep, ref)


@pytest.mark.parametrize("remat", [False, True])
def test_pp_loss_matches_single_device(worlds, remat):
    model, params, tokens = _setup(4, "learned", 2, 4)
    want = _ref_loss(model, params, tokens)
    _every_rank(worlds[f"loss_{remat}"], want)
    if remat:
        staged, rep = stack_pp_params(params, model.cfg, 4)
        tok = jnp.asarray(tokens)
        got = jax.jit(shard_map(
            lambda s, r, t, y: pp_gpt_loss(s, r, model.cfg, t, y, AXIS,
                                           microbatches=2),
            mesh=_mesh(4), in_specs=(P(AXIS), P(), P(), P()),
            out_specs=P(), check_vma=False))(
                staged, rep, tok, jnp.roll(tok, -1, axis=1))
        _every_rank(worlds["loss_True"], got)


@pytest.mark.parametrize("pp", [4, 2])
def test_pp_loss_gradients_match(worlds, pp):
    """Training-path gradients through the stage-local head and the scalar
    rejoin: the stages' layer gradients and the replicated embedding /
    head gradients on every rank, against the unsharded model; at pp 4
    also against the JAX schedule's under ``check_vma=True``."""
    case = "loss_grads" if pp == 4 else "pp2_loss_grads"
    ref = _ref_grads(4, "learned", 3, 4)
    per = 4 // pp
    for stage, (_, st, rep) in enumerate(worlds[case]):
        _layer_grads(ref, st, stage, lambda s, j: s * per + j)
        _check_replicated(rep, ref)
    if pp == 4:
        model, params, tokens = _setup(4, "learned", 3, 4)
        staged, rep = stack_pp_params(params, model.cfg, 4)
        tok = jnp.asarray(tokens)
        g_st, g_rep = jax.jit(shard_map(
            jax.grad(lambda s, r, t, y: pp_gpt_loss(
                s, r, model.cfg, t, y, AXIS, microbatches=2, remat=True),
                argnums=(0, 1)),
            mesh=_mesh(4), in_specs=(P(AXIS), P(), P(), P()),
            out_specs=(P(AXIS), P()), check_vma=True))(
                staged, rep, tok, jnp.roll(tok, -1, axis=1))
        g_st = tree_from_jax(jax.tree_util.tree_map(np.asarray, g_st))
        g_rep = tree_from_jax(jax.tree_util.tree_map(np.asarray, g_rep))
        for stage, (_, st, rep_got) in enumerate(worlds[case]):
            np.testing.assert_allclose(st["qkv"]["weight"][0],
                                       g_st["qkv"]["weight"][stage].numpy(),
                                       atol=TOL, rtol=TOL)
            np.testing.assert_allclose(rep_got["head"]["weight"],
                                       g_rep["head"]["weight"].numpy(),
                                       atol=TOL, rtol=TOL)


def test_pp_apply_remat_matches(worlds):
    """remat=True is a no-op for the logits path's values."""
    for a, b in zip(worlds["apply_remat_True"], worlds["apply_remat_False"]):
        np.testing.assert_allclose(a, b, atol=1e-6)


@pytest.mark.parametrize("pp,circles,layers,mbs", [
    (2, 2, 4, 4),   # 1 layer a group, the stream wraps twice
    (4, 2, 8, 4),   # M == pp: a ring slot written and read in one tick
    (2, 3, 6, 2),   # three circles
])
def test_pp_circular_loss_matches_single_device(worlds, pp, circles, layers,
                                                mbs):
    model, params, tokens = _setup(layers, "learned", 5, 4)
    _every_rank(worlds[f"circular_{pp}_{circles}_{layers}_{mbs}"],
                _ref_loss(model, params, tokens))
    if (pp, circles) == (2, 2):
        staged, rep = stack_pp_params_circular(params, model.cfg, pp,
                                               circles)
        tok = jnp.asarray(tokens)
        got = jax.jit(shard_map(
            lambda s, r, t, y: pp_gpt_loss_circular(
                s, r, model.cfg, t, y, AXIS, microbatches=mbs,
                circles=circles),
            mesh=_mesh(pp), in_specs=(P(AXIS), P(), P(), P()),
            out_specs=P(), check_vma=False))(
                staged, rep, tok, jnp.roll(tok, -1, axis=1))
        _every_rank(worlds["circular_2_2_4_4"], got)


def test_pp_circular_gradients_match(worlds):
    """Group gradients land on their (stage, circle) slots (layer ``(v *
    pp + s) * per_group + j`` at ``[s, v, j]``) and match the unsharded
    model's; the replicated gradients too, on every rank."""
    ref = _ref_grads(4, "learned", 6, 4)
    for stage, (_, st, rep) in enumerate(worlds["circular_grads"]):
        _layer_grads(ref, st, stage, lambda s, v, j: (v * 2 + s) + j,
                     lead=2)
        _check_replicated(rep, ref)


def test_pp_circular_validation_errors(worlds):
    tm = gpt("nano", device="cpu", num_layers=4, **BASE)
    with pytest.raises(ValueError, match="must divide"):
        t_stack_circ(tm, tm.cfg, 4, 2)  # 8 does not divide 4 layers
    for msg in worlds["error_small_m"]:
        assert "microbatches >= pp" in msg
    for msg in worlds["error_circular_into_contiguous"]:
        assert "pp_gpt_loss_circular" in msg


def test_pp_validation_errors(worlds):
    tm = gpt("nano", device="cpu", num_layers=3, **BASE)
    with pytest.raises(ValueError, match="must divide num_layers"):
        t_stack(tm, tm.cfg, 4)
    for pp in (4, 2):
        for msg in worlds[f"indivisible_{pp}"]:
            assert "microbatches" in msg


def test_unstack_round_trips():
    """stack -> unstack is the identity for the three layouts, the
    stacked trees are the reference's exactly (``tree_from_jax``), and
    unstacking with the wrong factors raises."""
    model, params, _ = _setup(4, "learned", 7, 4)
    tm = gpt("nano", device="cpu", num_layers=4, **BASE)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    own = tm.state_dict()

    def same(got, want):
        got, want = flat_params(got), flat_params(want)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]), err_msg=k)

    staged, rep = t_stack(tm, tm.cfg, 4)
    same(staged, tree_from_jax(jax.tree_util.tree_map(
        np.asarray, stack_pp_params(params, model.cfg, 4)[0])))
    same(t_unstack(staged, rep, tm.cfg, 4), own)
    with pytest.raises(ValueError, match="leading dims"):
        t_unstack(staged, rep, tm.cfg, 2)

    staged, rep = t_stack_circ(tm, tm.cfg, 2, 2)
    same(staged, tree_from_jax(jax.tree_util.tree_map(
        np.asarray, stack_pp_params_circular(params, model.cfg, 2, 2)[0])))
    same(t_unstack_circ(staged, rep, tm.cfg, 2, 2), own)
    with pytest.raises(ValueError, match="leading dims"):
        t_unstack_circ(staged, rep, tm.cfg, 2, 1)

    from horovod_tpu.parallel.pipeline import stack_tp_pp_params

    a, b, c = t_stack_tp_pp(tm, tm.cfg, 2, 2)
    ja, jb, _ = (tree_from_jax(jax.tree_util.tree_map(np.asarray, t))
                 for t in stack_tp_pp_params(params, model.cfg, 2, 2))
    same(a, ja)
    same(b, jb)
    same(t_unstack_tp_pp(a, b, c, tm.cfg, 2, 2), own)
    with pytest.raises(ValueError, match="leading dims"):
        t_unstack_tp_pp(a, b, c, tm.cfg, 4, 2)
