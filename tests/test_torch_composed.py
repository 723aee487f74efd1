"""The port's composed parallelism held against the JAX package's
unsharded step, case for case with ``tests/test_composed.py``: one SGD
(momentum 0.9) step of a 2-layer (4 for pp x tp) fp32 GPT over a 4-rank
gloo world laid out by ``basics.init_axes`` as dp x tp, dp x pp and
pp x tp (``_torch_parallel.composed_worker``).

Each rank's gradients are averaged over dp and stepped; the loss and the
updated trees (sharded, staged and replicated) must equal the reference's
unsharded step re-stacked with the reference's stacking functions
(carried across by ``tree_from_jax``): the loss 1e-5 and the parameters
the reference test's 2e-4.  The reference's 3-axis test runs dp 2 x pp 2
x tp 2 on 8 devices; here pp 2 x tp 2 on 4 ranks (dp 1), the dp axis
being held by the two 2-axis cases.  SGD, as in the reference test:
Adam's first step is +-lr x sign(g), which turns a sign flip of a
near-zero gradient into a 2 lr difference.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import _torch_parallel
import _torch_world
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.parallel.pipeline import stack_pp_params, stack_tp_pp_params
from horovod_tpu.parallel.tensor_parallel import stack_tp_params
from horovod_tpu_torch.models import tree_from_jax

CFG = dict(num_layers=4, num_heads=4, emb_dim=64, max_len=64,
           vocab_size=512, attention_impl="reference")
LR, MOMENTUM = 0.05, 0.9


@functools.lru_cache(maxsize=None)
def _setup():
    model = jax_gpt("nano", dtype=jnp.float32, **CFG)
    tokens = np.random.RandomState(0).randint(0, 512, (4, 16))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:1]))
    return model, params, tokens


@functools.lru_cache(maxsize=None)
def _unsharded_step():
    model, params, tokens = _setup()
    tok = jnp.asarray(tokens)
    tgt = jnp.roll(tok, -1, axis=1)
    tx = optax.sgd(LR, momentum=MOMENTUM)

    def loss_fn(p):
        logits = model.apply(p, tok)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    tgt[..., None], -1).mean()

    loss, grads = jax.value_and_grad(loss_fn)(params)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates), float(loss)


@pytest.fixture(scope="module")
def world():
    _, params, tokens = _setup()
    return _torch_world.run_world(
        _torch_parallel.composed_worker,
        (jax.tree_util.tree_map(np.asarray, params), CFG, tokens, LR,
         MOMENTUM), world=4, timeout=180)


def _port(tree):
    return tree_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _compare(got, want, index=lambda a: a, path=""):
    for k, v in want.items():
        if isinstance(v, dict):
            _compare(got[k], v, index, f"{path}{k}.")
        else:
            np.testing.assert_allclose(got[k], index(v.numpy()), atol=2e-4,
                                       rtol=2e-4, err_msg=path + k)


def test_dp_tp_step_matches_unsharded(world):
    """dp x tp: the batch split over dp, Megatron shards over tp."""
    model, _, _ = _setup()
    want_params, want_loss = _unsharded_step()
    want_sh, want_rep = (_port(t) for t in stack_tp_params(
        want_params, model.cfg, 2))
    for res in world:
        (got_sh, got_rep), loss = res["dp_tp"]
        np.testing.assert_allclose(loss, want_loss, atol=1e-5, rtol=1e-5)
        tp = res["rank"] % 2
        _compare(got_sh, want_sh, lambda a: a[tp:tp + 1])
        _compare(got_rep, want_rep)


def test_dp_pp_step_matches_unsharded(world):
    """dp x pp: the batch split over dp, the block stack over pp."""
    model, _, _ = _setup()
    want_params, want_loss = _unsharded_step()
    want_st, want_rep = (_port(t) for t in stack_pp_params(
        want_params, model.cfg, 2))
    for res in world:
        (got_st, got_rep), loss = res["dp_pp"]
        np.testing.assert_allclose(loss, want_loss, atol=1e-5, rtol=1e-5)
        pp = res["rank"] % 2
        _compare(got_st, want_st, lambda a: a[pp:pp + 1])
        _compare(got_rep, want_rep)


def test_dp_pp_tp_step_matches_unsharded(world):
    """pp x tp: each stage's blocks Megatron-sharded, one step through
    ``pp_tp_gpt_loss`` (the loss the same on every rank)."""
    model, _, _ = _setup()
    want_params, want_loss = _unsharded_step()
    want_sh, want_srep, want_r = (_port(t) for t in stack_tp_pp_params(
        want_params, model.cfg, 2, 2))
    for res in world:
        (got_sh, got_srep, got_r), loss = res["pp_tp"]
        np.testing.assert_allclose(loss, want_loss, atol=1e-5, rtol=1e-5)
        p, t = divmod(res["rank"], 2)
        assert res["coords"] == {"pp": p, "tp": t}
        _compare(got_sh, want_sh, lambda a: a[p:p + 1, t:t + 1])
        _compare(got_srep, want_srep, lambda a: a[p:p + 1])
        _compare(got_r, want_r)


def test_pp_tp_rejects_mismatched_pp_stack(world):
    """Params stacked for pp 4 on a pp 2 axis raise: the silent
    alternative runs half the layers with a finite loss."""
    for res in world:
        assert "different pp" in res["pp_tp_mismatch"]
