"""The port's long-context serving (``horovod_tpu_torch.serve.longctx``)
held against the JAX package's, case for case with
``tests/test_serve.py``'s long-context section.

A 4-rank gloo world (``_torch_parallel.longctx_worker``), each rank
holding a contiguous quarter of the slot cache (decode) or of the prompt
(prefill).  The decode is held to the reference's replicated
``_attend_cached`` on the whole cache, the prefill to its
``local_attention``, both at 1e-5 (fp32; the partial-softmax merge sums
in another order).

The deeply negative case (q - 40, k + 40) is held at ``NEG_TOL``, with a
measured reason: its scores are sums of 16 products near -1600, about
-2.6e4, where an fp32 ulp is 2e-3; the BLAS sums a chunk's dot products in
another order than the whole cache's, which moves a score by an ulp or
two and each softmax weight by up to ~4e-3 relative, and the outputs (of
order 1) by up to 4.0e-5 (measured: the port's sharded decode against the
port's and the reference's replicated decode, which agree with each other
to 2.4e-7).  The reference's own sharded decode misses the reference
test's 1e-5 on this case in the same way (ROADMAP C0).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

import _torch_parallel
import _torch_world
from horovod_tpu.models.decode import _attend_cached
from horovod_tpu.models.transformer import TransformerConfig
from horovod_tpu.parallel.ring_attention import local_attention

TOL = 1e-5
NEG_TOL = 1e-4  # see the module docstring
CFG = dict(num_heads=4, num_kv_heads=2, emb_dim=64)


def _decode_inputs():
    cfg = TransformerConfig(dtype=jnp.float32, **CFG)
    rng = np.random.RandomState(3)
    b, s, h, hd = 3, 32, cfg.num_heads, cfg.head_dim
    q = rng.randn(b, h, hd).astype(np.float32)
    k = rng.randn(b, s, cfg.kv_heads, hd).astype(np.float32)
    v = rng.randn(b, s, cfg.kv_heads, hd).astype(np.float32)
    # per-slot positions: a fresh slot (0) and a full one
    pos = np.asarray([5, 0, s - 1], np.int64)
    return cfg, q, k, v, pos


def _prefill_inputs():
    rng = np.random.RandomState(4)
    return tuple(rng.randn(2, 32, 4, 8).astype(np.float32) for _ in range(3))


@pytest.fixture(scope="module")
def world():
    _, q, k, v, pos = _decode_inputs()
    return _torch_world.run_world(
        _torch_parallel.longctx_worker,
        (CFG, q, k, v, pos, *_prefill_inputs()), world=4, timeout=120)


def test_sharded_decode_attention_matches_replicated(world):
    cfg, q, k, v, pos = _decode_inputs()
    want = np.asarray(_attend_cached(cfg, jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jnp.asarray(pos)))
    # deeply negative scores: every real max far below the 0.0 a wholly
    # masked chunk's clamped max would offer; the merge must rescale
    # against the contributing max, not underflow to zero
    want_neg = np.asarray(_attend_cached(
        cfg, jnp.asarray(q) - 40.0, jnp.asarray(k) + 40.0, jnp.asarray(v),
        jnp.asarray(pos)))
    for r in world:
        np.testing.assert_allclose(r["decode"], want, atol=TOL, rtol=TOL)
        assert np.abs(r["decode_neg"]).max() > 0.0
        np.testing.assert_allclose(r["decode_neg"], want_neg, atol=NEG_TOL,
                                   rtol=NEG_TOL)


def test_ulysses_prefill_attention_matches_local(world):
    q, k, v = _prefill_inputs()
    want = np.asarray(local_attention(q, k, v, causal=True))
    got = np.concatenate([r["prefill"] for r in world], axis=1)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
