"""The port's sequence-parallel attention (``horovod_tpu_torch.parallel.
ring_attention``) held against the JAX package's, case for case with
``tests/test_ring_attention.py``.

The port runs one gloo world per axis size (sp 2 and sp 4), each rank on
its shard of the sequence (``_torch_parallel.sp_worker``); the JAX side
runs the same schedule under ``shard_map`` on the first sp devices of the
tests' 8-device CPU mesh, and its single-device ``local_attention``.
Inputs are numpy draws from fixed seeds; the GPT cases carry the
reference's flax weights across (``params_from_jax``).  Bounds (fp32):

* values 1e-5 against the JAX schedule (the same block math in the same
  order), and the reference test's 2e-5 against ``local_attention``;
* gradients 1e-5 against the JAX schedule's, and the reference test's
  bounds (5e-4 ring and Ulysses, 5e-5 zigzag) against
  ``local_attention``'s;
* bf16 inputs: the reference test's 0.05 against fp32 attention;
* the GPT on ring / zigzag / Ulysses: logits 2e-5 and the parameter
  gradients of the mean token loss (each rank's share summed over the
  axis) 1e-5 against the unsharded reference model.
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
from horovod_tpu.parallel import (
    local_attention, ring_attention, ring_attention_zigzag,
    ulysses_attention, zigzag_positions, zigzag_shard, zigzag_unshard)
from horovod_tpu_torch.models import tree_from_jax
from horovod_tpu_torch.parallel import local_attention as t_local
from horovod_tpu_torch.parallel import zigzag_positions as t_positions
from horovod_tpu_torch.parallel import zigzag_shard as t_shard
from horovod_tpu_torch.parallel import zigzag_unshard as t_unshard

B, S, H, D = 2, 32, 8, 16
AXIS = "sp"
SIZES = (2, 4)
TOL = 1e-5
GPT_CFG = dict(num_layers=2, num_heads=4, emb_dim=32, max_len=64,
               vocab_size=128)
GPT_GRADS = ("wte.weight", "block0.qkv.weight", "block1.fc2.weight",
             "head.weight")


def _qkv(seed=0):
    rng = np.random.RandomState(seed)
    return tuple((rng.randn(B, S, H, D) * 0.3).astype(np.float32)
                 for _ in range(3))


def _sharded(fn, sp, **kw):
    spec = P(None, AXIS)
    mesh = Mesh(np.asarray(jax.devices()[:sp]), (AXIS,))
    return jax.jit(shard_map(lambda q, k, v: fn(q, k, v, AXIS, **kw),
                             mesh=mesh, in_specs=(spec, spec, spec),
                             out_specs=spec, check_vma=False))


@functools.lru_cache(maxsize=None)
def _gpt_params():
    model = jax_gpt("nano", dtype=jnp.float32, attention_impl="reference",
                    **GPT_CFG)
    tokens = np.random.RandomState(7).randint(0, 128, (2, 16))
    params = model.init(jax.random.PRNGKey(7), jnp.asarray(tokens))
    return model, params, tokens


@functools.lru_cache(maxsize=None)
def _gpt_reference():
    """The unsharded reference GPT's logits and the gradients of its mean
    token loss (the port's names and layouts)."""
    model, params, tokens = _gpt_params()
    targets = jnp.asarray(np.roll(tokens, -1, axis=1))

    def loss(p):
        logits = model.apply(p, jnp.asarray(tokens))
        return -jnp.take_along_axis(jax.nn.log_softmax(logits),
                                    targets[..., None], -1).mean()

    logits = np.asarray(jax.jit(model.apply)(params, jnp.asarray(tokens)))
    grads = jax.jit(jax.grad(loss))(params)["params"]
    return logits, tree_from_jax(jax.tree_util.tree_map(np.asarray, grads))


def _cat(per_rank):
    return np.concatenate(per_rank, axis=1)


@pytest.fixture(scope="module")
def worlds():
    q, k, v = _qkv(1)
    w = np.random.RandomState(5).randn(B, S, H, D).astype(np.float32)
    rng = np.random.RandomState(9)
    kv_gqa = tuple((rng.randn(B, S, 2, D) * 0.3).astype(np.float32)
                   for _ in range(2))
    _, params, tokens = _gpt_params()
    state = jax.tree_util.tree_map(np.asarray, params)
    out = {}
    for sp in SIZES:
        out[sp] = _torch_world.run_world(
            _torch_parallel.sp_worker,
            (q, k, v, w, kv_gqa, state, GPT_CFG, tokens), world=sp,
            timeout=120)
    return {"inputs": (q, k, v, w, kv_gqa), "ranks": out}


def _got(worlds, sp, key):
    return _cat([r[key] for r in worlds["ranks"][sp]])


class TestRingAttention:
    @pytest.mark.parametrize("sp", SIZES)
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_local_attention(self, worlds, sp, causal):
        q, k, v = worlds["inputs"][:3]
        got = _got(worlds, sp, f"ring_{causal}")
        want = _sharded(ring_attention, sp, causal=causal)(q, k, v)
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL,
                                   rtol=TOL)
        ref = local_attention(q, k, v, causal=causal)
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)

    @pytest.mark.parametrize("sp", SIZES)
    def test_grads_match(self, worlds, sp):
        q, k, v = worlds["inputs"][:3]
        got = [_cat([r["ring_grads"][i] for r in worlds["ranks"][sp]])
               for i in range(3)]
        sharded = _sharded(ring_attention, sp, causal=True)
        want = jax.grad(lambda *a: (sharded(*a) ** 2).sum(),
                        argnums=(0, 1, 2))(q, k, v)
        ref = jax.grad(lambda *a: (local_attention(*a, causal=True) ** 2
                                   ).sum(), argnums=(0, 1, 2))(q, k, v)
        for a, b, c in zip(got, want, ref):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)
            np.testing.assert_allclose(a, np.asarray(c), atol=5e-4,
                                       rtol=5e-4)

    @pytest.mark.parametrize("sp", SIZES)
    def test_bfloat16_io(self, worlds, sp):
        q, k, v = worlds["inputs"][:3]
        dtypes = {r["ring_bf16"][0] for r in worlds["ranks"][sp]}
        assert dtypes == {"torch.bfloat16"}
        got = _cat([r["ring_bf16"][1] for r in worlds["ranks"][sp]])
        bf = [np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
              for x in (q, k, v)]
        ref = local_attention(*bf, causal=True)
        np.testing.assert_allclose(got, np.asarray(ref), atol=0.05,
                                   rtol=0.05)

    @pytest.mark.parametrize("sp", SIZES)
    def test_gqa_kv_travels_narrow(self, worlds, sp):
        """GQA K/V (2 heads for 8 query heads) go round the ring at kv
        width and broadcast after: equal to local attention on the
        repeated heads."""
        q, _, _, _, (k2, v2) = worlds["inputs"]
        got = _got(worlds, sp, "ring_gqa")
        rep = lambda x: np.repeat(x, H // 2, axis=2)
        ref = local_attention(q, rep(k2), rep(v2), causal=True)
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)

    def test_long_context_memory_shape(self):
        """Each rank folds (s_local x s_local) score blocks: the ring's
        output has the shard's shape and the schedule holds no (S, S)
        block (its scores are per block, as the reference's scan)."""
        import torch

        from horovod_tpu_torch.parallel.ring_attention import (
            _init_state, _online_softmax_update)

        q = torch.zeros(B, 4, H, D)
        o, m, l = _online_softmax_update(_init_state(B, 4, H, D, "cpu"), q,
                                         q, q, 1.0)
        assert o.shape == (B, 4, H, D) and m.shape == (B, H, 4)


class TestUlyssesAttention:
    @pytest.mark.parametrize("sp", SIZES)
    @pytest.mark.parametrize("causal", [False, True])
    def test_matches_local_attention(self, worlds, sp, causal):
        q, k, v = worlds["inputs"][:3]
        got = _got(worlds, sp, f"ulysses_{causal}")
        want = _sharded(ulysses_attention, sp, causal=causal)(q, k, v)
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL,
                                   rtol=TOL)
        ref = local_attention(q, k, v, causal=causal)
        np.testing.assert_allclose(got, np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)

    @pytest.mark.parametrize("sp", SIZES)
    def test_grads_match(self, worlds, sp):
        q, k, v = worlds["inputs"][:3]
        got = [_cat([r["ulysses_grads"][i] for r in worlds["ranks"][sp]])
               for i in range(3)]
        sharded = _sharded(ulysses_attention, sp, causal=True)
        want = jax.grad(lambda *a: (sharded(*a) ** 2).sum(),
                        argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)

    @pytest.mark.parametrize("sp", SIZES)
    def test_head_divisibility_error(self, worlds, sp):
        for r in worlds["ranks"][sp]:
            assert "divisible" in r["ulysses_heads_error"]


class TestLocalAttentionOffsets:
    def test_global_causal_offsets(self):
        """q_offset/kv_offset place the causal triangle in global
        coordinates, as the reference's."""
        import torch

        q, k, v = (torch.from_numpy(x) for x in _qkv(6))
        full = t_local(q, k, v, causal=True)
        half = t_local(q[:, S // 2:], k, v, causal=True, q_offset=S // 2,
                       kv_offset=0)
        np.testing.assert_allclose(half.numpy(), full[:, S // 2:].numpy(),
                                   atol=2e-5, rtol=2e-5)
        want = local_attention(*(x.numpy() for x in (q, k, v)), causal=True)
        np.testing.assert_allclose(full.numpy(), np.asarray(want), atol=TOL,
                                   rtol=TOL)


class TestZigzagRing:
    def test_shard_roundtrip(self):
        import torch

        x = np.arange(B * S * 3, dtype=np.float32).reshape(B, S, 3)
        z = t_shard(torch.from_numpy(x), 8, axis=1)
        np.testing.assert_array_equal(
            z.numpy(), np.asarray(zigzag_shard(jnp.asarray(x), 8, axis=1)))
        np.testing.assert_array_equal(t_unshard(z, 8, axis=1).numpy(), x)

    @pytest.mark.parametrize("sp", SIZES)
    def test_matches_local_attention_causal(self, worlds, sp):
        q, k, v = worlds["inputs"][:3]
        got = _got(worlds, sp, "zigzag")
        zz = lambda t: zigzag_shard(t, sp, axis=1)
        want = _sharded(ring_attention_zigzag, sp)(zz(q), zz(k), zz(v))
        np.testing.assert_allclose(got, np.asarray(want), atol=TOL,
                                   rtol=TOL)
        ref = local_attention(q, k, v, causal=True)
        np.testing.assert_allclose(
            np.asarray(zigzag_unshard(got, sp, axis=1)), np.asarray(ref),
            atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("sp", SIZES)
    def test_grads_match(self, worlds, sp):
        q, k, v, w = worlds["inputs"][:4]
        zz = lambda t: zigzag_shard(t, sp, axis=1)
        uz = lambda t: zigzag_unshard(t, sp, axis=1)
        got = [np.asarray(uz(_cat([r["zigzag_grads"][i]
                                   for r in worlds["ranks"][sp]])))
               for i in range(3)]

        def loss_zig(q, k, v):
            out = _sharded(ring_attention_zigzag, sp)(zz(q), zz(k), zz(v))
            return (uz(out) * w).sum()

        def loss_ref(q, k, v):
            return (local_attention(q, k, v, causal=True) * w).sum()

        want = jax.grad(loss_zig, argnums=(0, 1, 2))(q, k, v)
        ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
        for a, b, c in zip(got, want, ref):
            np.testing.assert_allclose(a, np.asarray(b), atol=TOL, rtol=TOL)
            np.testing.assert_allclose(a, np.asarray(c), atol=5e-5,
                                       rtol=5e-5)

    @pytest.mark.parametrize("sp", SIZES)
    def test_odd_local_length_rejected(self, worlds, sp):
        for r in worlds["ranks"][sp]:
            assert "even local sequence" in r["zigzag_odd_error"]


def test_zigzag_positions_match_layout():
    """zigzag_positions(i) are the global positions of rank i's rows after
    zigzag_shard and a contiguous split, and the reference's."""
    import torch

    size, s = 4, 24
    z = t_shard(torch.arange(s), size)
    s_local = s // size
    for i in range(size):
        got = t_positions(i, size, s_local).numpy()
        np.testing.assert_array_equal(
            got, z[i * s_local:(i + 1) * s_local].numpy())
        np.testing.assert_array_equal(
            got, np.asarray(zigzag_positions(i, size, s_local)))


@pytest.mark.parametrize("sp", SIZES)
@pytest.mark.parametrize("impl", ["ring", "zigzag", "ulysses"])
def test_gpt_sequence_parallel_matches_unsharded(worlds, sp, impl):
    """The whole model on each schedule: per-shard logits and the summed
    parameter gradients against the reference's unsharded GPT on the same
    weights."""
    want, g_ref = _gpt_reference()
    got = _got(worlds, sp, f"gpt_{impl}")
    if impl == "zigzag":
        got = np.asarray(zigzag_unshard(got, sp, axis=1))
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    grads = worlds["ranks"][sp][0][f"gpt_{impl}_grads"]
    for name in GPT_GRADS:
        node = g_ref
        for part in name.split("."):
            node = node[part]
        np.testing.assert_allclose(grads[name], node.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)
    # every rank holds the same summed gradients
    for r in worlds["ranks"][sp][1:]:
        for name in GPT_GRADS:
            np.testing.assert_array_equal(r[f"gpt_{impl}_grads"][name],
                                          grads[name])


def test_zigzag_needs_positions():
    import torch

    from horovod_tpu_torch.models import gpt

    tm = gpt("nano", device="cpu", attention_impl="zigzag", sp_axis="sp")
    with pytest.raises(ValueError, match="requires explicit positions"):
        tm(torch.zeros((1, 8), dtype=torch.long))
