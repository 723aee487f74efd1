"""The port's threefry layer (horovod_tpu_torch.ops.prng) and replicated
sampler (horovod_tpu_torch.serve.sampling) held against ``jax.random`` and
horovod_tpu.serve.sampling.

Bits are held exactly: keys, folds, splits and random bits are integer
arithmetic.  Uniform floats are exact too (a bit pattern minus one).
Gumbel noise is ``-log(-log(u))`` with each side's own ``log``, which may
differ by an ulp: held within 2 ulp at the scale ``max(|g|, 1)`` (the
outer log of a value near 1 turns the inner log's ulp into an absolute
error of about one ulp of 1.0).  Tokens are held by the margin rule at
1e-5 on the reference's ``logits / temperature + noise``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import check_margin
from horovod_tpu.serve import sampling as jsamp
from horovod_tpu_torch.ops import prng
from horovod_tpu_torch.serve import sampling

SEEDS = [0, 7, 2**31 - 1, 2**31 + 5, 2**32 + 9, 2**40 + 3]
SHAPES = [(7,), (3, 5), (64,)]
TOKEN_TOL = 1e-5


def _bits(a):
    return np.asarray(a).astype(np.int64)


def _gumbel_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= 2 * scale).all(), \
        np.abs(got - want).max()


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(),
                                  _bits(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_match_jax(seed):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for data in (0, 1, 12345, 2**31 + 3, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tkey, data).numpy(),
                                      _bits(jax.random.fold_in(key, data)))
    for num in (2, 5, (3, 4)):
        np.testing.assert_array_equal(prng.split(tkey, num).numpy(),
                                      _bits(jax.random.split(key, num)))
    # a batch of keys and data folds row by row
    keys = prng.split(tkey, 3)
    got = prng.fold_in(keys, torch.tensor([4, 5, 6]))
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(),
            _bits(jax.random.fold_in(jax.random.split(key, 3)[i], 4 + i)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS[:4])
def test_bits_uniform_gumbel_match_jax(seed, shape):
    key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
    np.testing.assert_array_equal(
        prng.random_bits(tkey, shape).numpy(),
        _bits(jax.random.bits(key, shape, jnp.uint32)))
    np.testing.assert_array_equal(prng.uniform(tkey, shape).numpy(),
                                  np.asarray(jax.random.uniform(key, shape)))
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_equal(
        prng.uniform(tkey, shape, tiny, 1.0).numpy(),
        np.asarray(jax.random.uniform(key, shape, minval=tiny, maxval=1.0)))
    _gumbel_close(prng.gumbel(tkey, shape), jax.random.gumbel(key, shape))


def test_gumbel_over_a_vocabulary_row():
    """At the sampler's width (32000 draws of one key) the noise keeps
    its bound, and categorical draws jax's samples."""
    for seed in (0, 3):
        key, tkey = jax.random.PRNGKey(seed), prng.prng_key(seed)
        _gumbel_close(prng.gumbel(tkey, (32000,)),
                      jax.random.gumbel(key, (32000,)))
        logits = np.random.RandomState(seed).randn(8, 500).astype(np.float32)
        want = np.asarray(jax.random.categorical(key, logits))
        got = prng.categorical(tkey, torch.from_numpy(logits)).numpy()
        noise = np.asarray(jax.random.gumbel(key, logits.shape))
        for r in range(8):
            check_margin(got[r:r + 1], want[r:r + 1],
                         (logits + noise)[r:r + 1], TOKEN_TOL)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3])
def test_gumbel_is_within_two_ulp_of_float64_math(seed):
    """The reference ``chip_smoke.sampler_check`` holds the card's noise
    to: -log(-log(u)) in float64 on the same uniform draws.  The CPU's
    float32 noise keeps the same 2 ulp bound on every repeat (on the
    card's host it has once come out 840 ulp off, so the chip check no
    longer takes it as its reference)."""
    tkey = prng.prng_key(seed)
    u = prng.uniform(tkey, (32000,), np.finfo(np.float32).tiny, 1.0)
    exact = -np.log(-np.log(u.numpy().astype(np.float64)))
    scale = np.spacing(np.maximum(np.abs(exact), 1.0).astype(np.float32))
    for _ in range(5):
        off = np.abs(prng.gumbel(tkey, (32000,)).numpy() - exact) / scale
        assert off.max() <= 2.0, (off.max(), int(off.argmax()))


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 7, 2**33 + 1])
def test_request_and_token_keys_match_the_reference(seed):
    for rid in ("", "r0", "req-1", "ünïcode", "x" * 100):
        base = sampling.request_key(seed, rid)
        want = jsamp.request_key(seed, rid)
        np.testing.assert_array_equal(base.numpy(), _bits(want))
        for i in (0, 1, 17, 1000):
            np.testing.assert_array_equal(
                sampling.token_key(base, i).numpy(),
                _bits(jsamp.token_key(want, i)))
    assert sampling.KEY_SHAPE == jsamp.KEY_SHAPE


CASES = {
    "greedy": lambda rng, n: (np.zeros(n, np.float32), np.zeros(n, np.int32)),
    "no_top_k": lambda rng, n: (np.full(n, 0.8, np.float32),
                                np.zeros(n, np.int32)),
    "top_k_at_least_vocab": lambda rng, n: (
        np.full(n, 1.3, np.float32), rng.choice([128, 500], n).astype(
            np.int32)),
    "mixed": lambda rng, n: (
        rng.choice([0.0, 0.5, 1.0, 2.0], n).astype(np.float32),
        rng.choice([0, 1, 5, 40, 200], n).astype(np.int32)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_token_matches_the_reference(case):
    """64 rows of 128-token logits, each with its own request key and
    emission index, through the port's batched ``sample_token`` and the
    reference's per row."""
    rng = np.random.RandomState(len(case))
    n, vocab = 64, 128
    logits = (rng.randn(n, vocab) * 3).astype(np.float32)
    temps, topks = CASES[case](rng, n)
    jkeys = [jsamp.token_key(jsamp.request_key(5, f"r{i}"), i % 7)
             for i in range(n)]
    want = np.asarray(jax.vmap(jsamp.sample_token)(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(topks),
        jnp.stack(jkeys)))
    keys = sampling.token_key(
        torch.stack([sampling.request_key(5, f"r{i}") for i in range(n)]),
        torch.tensor([i % 7 for i in range(n)]))
    got = sampling.sample_token(torch.from_numpy(logits), temps,
                                torch.from_numpy(topks), keys).numpy()
    for i in range(n):
        if temps[i] <= 0:
            assert got[i] == want[i] == int(np.argmax(logits[i]))
            continue
        lt = logits[i] / temps[i]
        k = topks[i] if 0 < topks[i] < vocab else vocab
        lt = np.where(lt < np.sort(lt)[::-1][k - 1], -np.inf, lt)
        score = lt + np.asarray(jax.random.gumbel(jkeys[i], (vocab,)))
        check_margin(got[i:i + 1], want[i:i + 1], score[None], TOKEN_TOL)
        assert np.isfinite(lt[got[i]])  # inside the top k


def test_sample_token_math_matches_oracle_reimplementation():
    """The reference's hand-rolled case (tests/test_paged.py): a
    gumbel-max with the same key picks the same token, inside the top 5."""
    logits = np.random.RandomState(0).randn(32).astype(np.float32)
    key = sampling.token_key(sampling.request_key(3, "x"), 2)
    got = int(sampling.sample_token(torch.from_numpy(logits), 0.7, 5, key))
    jkey = jsamp.token_key(jsamp.request_key(3, "x"), 2)
    lt = logits / np.float32(0.7)
    lt = np.where(lt < np.sort(lt)[::-1][4], -np.inf, lt)
    g = np.asarray(jax.random.gumbel(jkey, (32,), dtype=jnp.float32))
    assert got == int(np.argmax(lt + g))
    assert got == int(jsamp.sample_token(jnp.asarray(logits),
                                         jnp.float32(0.7), jnp.int32(5),
                                         jkey))
    assert got in set(np.argsort(logits)[-5:].tolist())


def test_greedy_and_sampled_rows_mix_per_row():
    """A host temperature of 0 everywhere is the argmax; a mixed batch
    keeps the argmax on its greedy rows."""
    logits = torch.randn(4, 16, generator=torch.Generator().manual_seed(0))
    keys = prng.split(prng.prng_key(1), 4)
    greedy = torch.argmax(logits, dim=-1)
    assert torch.equal(sampling.sample_token(logits, 0.0, 0, keys), greedy)
    mixed = sampling.sample_token(logits, np.array([0, 1, 0, 1], np.float32),
                                  0, keys)
    assert mixed[0] == greedy[0] and mixed[2] == greedy[2]
