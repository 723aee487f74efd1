"""The port's flash attention (horovod_tpu_torch.ops.flash_attention) held
against the JAX package's Pallas kernels.

On the CPU the port runs its plain versions (the forward recurrence and
the blockwise backward); the JAX op runs its Pallas kernels through the
interpreter, as its own tests do.  Inputs are made with numpy from a seed
and fed to both.  Tolerances: fp32 1e-5 (the two run the same fp32
recurrence, summing in other orders), bf16 0.05 (as
tests/test_flash_attention.py holds the bf16 kernel).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as fa

FP32_TOL = 1e-5
BF16_TOL = 0.05


def _inputs(b=2, s=64, h=4, hkv=4, d=16, seed=0):
    rng = np.random.RandomState(seed)
    mk = lambda heads: (rng.randn(b, s, heads, d) * 0.5).astype(np.float32)
    return mk(h), mk(hkv), mk(hkv), rng.randn(b, s, h, d).astype(np.float32)


def _both(q, k, v, dtype, **kw):
    """Forward through both packages -> (port, jax) as fp32 numpy."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    got = fa.flash_attention(*(torch.from_numpy(x).to(dtype)
                               for x in (q, k, v)), **kw)
    want = jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                     interpret=True, **kw)
    assert got.dtype == dtype and got.shape == tuple(want.shape)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_jax(causal):
    q, k, v, _ = _inputs()
    got, want = _both(q, k, v, torch.float32, causal=causal, block_q=16,
                      block_k=16)
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)


def test_uneven_tiles():
    # S=48: _pick_block drops the 32-row request to 16 on both sides
    q, k, v, _ = _inputs(s=48, seed=1)
    got, want = _both(q, k, v, torch.float32, causal=True, block_q=32,
                      block_k=32)
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("hkv", [1, 2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_gqa_matches_jax(hkv, causal):
    q, k, v, _ = _inputs(s=32, hkv=hkv, seed=2)
    got, want = _both(q, k, v, torch.float32, causal=causal, block_q=16,
                      block_k=16)
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)


@pytest.mark.parametrize("window,bq,bk", [
    (8, 16, 16),    # band narrower than a tile
    (24, 16, 8),    # band spans several tiles, bq != bk
    (1, 8, 8),      # attend to self only
    (64, 16, 16),   # window == S: plain causal
    (200, 16, 16),  # window > S
])
def test_window_matches_jax(window, bq, bk):
    q, k, v, _ = _inputs(hkv=2, seed=3)
    got, want = _both(q, k, v, torch.float32, causal=True, block_q=bq,
                      block_k=bk, window=window)
    np.testing.assert_allclose(got, want, atol=FP32_TOL, rtol=FP32_TOL)


def test_bf16_matches_jax():
    q, k, v, _ = _inputs(seed=4)
    got, want = _both(q, k, v, torch.bfloat16, causal=True, block_q=16,
                      block_k=16)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("hkv,causal,window,bq,bk", [
    (4, False, None, 16, 16),
    (4, True, None, 16, 16),
    (2, False, None, 16, 8),
    (2, True, None, 16, 8),
    (1, True, 24, 16, 8),
])
def test_grads_match_jax(hkv, causal, window, bq, bk):
    q, k, v, w = _inputs(s=48, hkv=hkv, seed=5)
    kw = dict(causal=causal, block_q=bq, block_k=bk, window=window)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (fa.flash_attention(tq, tk, tv, **kw) * torch.from_numpy(w)).sum() \
        .backward()
    loss = lambda a, b_, c: (jax_flash(a, b_, c, interpret=True, **kw)
                             * jnp.asarray(w)).sum()
    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for name, got, ref in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert got.grad.shape == ref.shape  # dk/dv stay at hkv heads
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   atol=FP32_TOL, rtol=FP32_TOL,
                                   err_msg=name)


def test_plain_backward_matches_reference_blockwise():
    """The plain backward is a port of _flash_bwd_blockwise: same inputs,
    same outputs."""
    from horovod_tpu.ops.flash_attention import _flash_bwd_blockwise

    rng = np.random.RandomState(6)
    z, s, d, bk = 3, 64, 16, 16
    q, k, v, o, do = (rng.randn(z, s, d).astype(np.float32)
                      for _ in range(5))
    lse = rng.randn(z, s).astype(np.float32) + 4.0
    scale = d ** -0.5
    want = _flash_bwd_blockwise(*(jnp.asarray(x) for x in (q, k, v, o)),
                                jnp.asarray(lse), jnp.asarray(do), True,
                                scale, bk, window=20)
    got = fa.flash_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, o)),
                             torch.from_numpy(lse), torch.from_numpy(do),
                             True, scale, bk, 1, 1, 20)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_),
                                   atol=FP32_TOL, rtol=FP32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("causal,window", [
    (False, None), (True, None), (True, 1), (True, 5), (True, 24), (True, 40),
])
def test_tile_predicate_is_the_references(causal, window):
    """tile_needed against the reference's forward
    (flash_attention.py:171-175) and dk/dv (:304-308) predicates,
    transcribed.  The CUDA kernels hold a copy of it, whose skipping
    tests/test_torch_kernels_gpu.py times on the card."""
    for bq, bk in [(8, 8), (16, 8), (8, 32), (64, 32)]:
        for i in range(128 // bq):
            for j in range(128 // bk):
                fwd = (j * bk <= (i + 1) * bq - 1) if causal else True
                bwd = ((i + 1) * bq - 1 >= j * bk) if causal else True
                if window is not None:
                    band = (j + 1) * bk - 1 >= i * bq - (window - 1)
                    fwd, bwd = fwd and band, bwd and band
                got = fa.tile_needed(i, j, bq, bk, causal, window)
                assert got == fwd == bwd, (i, j, bq, bk)


def test_errors_match_jax():
    q, k, v, _ = _inputs()
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    cases = [
        ("matching", (tq, tk[:, :32], tv), {}, (jq, jk[:, :32], jv), {}),
        ("multiple of num_kv_heads", (tq, tk[:, :, :3], tv[:, :, :3]), {},
         (jq, jk[:, :, :3], jv[:, :, :3]), {}),
        ("causal", (tq, tk, tv), {"window": 8},
         (jq, jk, jv), {"window": 8}),
        (">= 1", (tq, tk, tv), {"causal": True, "window": 0},
         (jq, jk, jv), {"causal": True, "window": 0}),
    ]
    for match, targs, tkw, jargs, jkw in cases:
        with pytest.raises(ValueError, match=match):
            fa.flash_attention(*targs, **tkw)
        with pytest.raises(ValueError, match=match):
            jax_flash(*jargs, interpret=True, **jkw)


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors take the plain version: any other device goes to
    the kernel path, which refuses what it cannot launch."""
    q = torch.empty(4, 64, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA kernels on CUDA tensors"):
        fa.flash_fwd(q, q, q, True, 0.25, 16, 16, 4, 4, None)
