"""The port's KV-cache decoding (horovod_tpu_torch.models.decode) held
against the JAX package's (horovod_tpu.models.decode) on the same weights.

Tiny fp32 models (2 layers, 4 heads, emb 64, vocab 256, max_len 32,
``attention_impl="reference"``, as tests/test_decode.py builds them); the
flax parameters cross over through ``params_from_jax`` and the prompts
come from numpy seeds.  Logits are held at ``TOL`` = 1e-5 (both sides sum
in fp32, in other orders), tokens by the margin rule at ``TOL``
(``_torch_serving.py``).  Within the port, what the reference pins
bit for bit and the port computes by the same ops on the same shapes is
held bit for bit: the slots a write leaves alone, the legacy scalar
``pos``.  Prefill against the scanned prefill is held at ``TOL``: they sum
in other orders, and on this jax the reference's own pair differs by up
to 1.7e-6 (ROADMAP C0.2).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serving import check_margin
from horovod_tpu.models import decode as jd
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu_torch import NotPortedError
from horovod_tpu_torch.models import decode as td
from horovod_tpu_torch.models import gpt, params_from_jax
from horovod_tpu_torch.ops import prng

TOL = 1e-5

CONFIGS = {
    "learned": {},
    "rope": {"pos_embedding": "rope"},
    "gqa": {"num_kv_heads": 2},
    "mqa_rope": {"num_kv_heads": 1, "pos_embedding": "rope"},
    "window": {"attention_impl": "flash", "attention_window": 4,
               "flash_block_q": 8, "flash_block_k": 8},
}


def _pair(seed=0, **overrides):
    """(flax model, its params, the port's model on those params)."""
    kw = dict(num_layers=2, num_heads=4, emb_dim=64, max_len=32,
              vocab_size=256, attention_impl="reference")
    kw.update(overrides)
    jm = jax_gpt("nano", dtype=jnp.float32, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    tm = gpt("nano", device="cpu", dtype=torch.float32, **kw)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def _prompt(b=2, s=12, seed=0, vocab=256):
    return np.random.RandomState(seed).randint(0, vocab, (b, s))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(seed=i, **ov)
            for i, (name, ov) in enumerate(CONFIGS.items())}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_matches_jax(pairs, name):
    jm, params, tm = pairs[name]
    prompt = _prompt(s=16, seed=1)
    want, wcache = jd.prefill(jm.cfg, params, jnp.asarray(prompt))
    got, cache = td.prefill(tm, torch.from_numpy(prompt))
    _close(got, want)
    _close(cache["k"], wcache["k"])
    _close(cache["v"], wcache["v"])
    assert cache["pos"].tolist() == [16, 16]
    # and the full forward (the teacher-forced oracle) agrees too
    _close(got, tm(torch.from_numpy(prompt)).detach(), 2e-5)


@pytest.mark.parametrize("name", ["learned", "rope", "mqa_rope"])
def test_decode_step_extends_prefill(pairs, name):
    jm, params, tm = pairs[name]
    prompt, nxt = _prompt(s=10, seed=2), _prompt(s=1, seed=3)[:, 0]
    _, wcache = jd.prefill(jm.cfg, params, jnp.asarray(prompt))
    want, wcache = jd.decode_step(jm.cfg, params, wcache, jnp.asarray(nxt))
    _, cache = td.prefill(tm, torch.from_numpy(prompt))
    got, cache = td.decode_step(tm, cache, torch.from_numpy(nxt))
    _close(got, want)
    _close(cache["k"], wcache["k"])
    assert cache["pos"].tolist() == [11, 11]


@pytest.mark.parametrize("name", ["learned", "rope", "gqa", "mqa_rope"])
def test_prefill_matches_scanned_prefill(pairs, name):
    _, _, tm = pairs[name]
    prompt = torch.from_numpy(_prompt(s=12, seed=9))
    single, c1 = td.prefill(tm, prompt)
    scanned, c2 = td.prefill_scan(tm, prompt)
    _close(single, scanned)
    _close(c1["k"], c2["k"])
    _close(c1["v"], c2["v"])
    assert torch.equal(c1["pos"], c2["pos"])


def _forward_scores(jm, params, prompt, tokens):
    """The reference's logits at each generated step, teacher-forced:
    ``[b, steps, vocab]``."""
    seq = np.concatenate([prompt, tokens[:, :-1]], axis=1)
    logits = np.asarray(jm.apply(params, jnp.asarray(seq)))
    return logits[:, prompt.shape[1] - 1:]


@pytest.mark.parametrize("name", ["learned", "rope", "gqa"])
def test_greedy_generate_matches_jax(pairs, name):
    jm, params, tm = pairs[name]
    prompt = _prompt(s=8, seed=4)
    want = np.asarray(jd.generate(jm.cfg, params, jnp.asarray(prompt), 8))
    got = td.generate(tm, torch.from_numpy(prompt), 8).numpy()
    scores = _forward_scores(jm, params, prompt, want)
    for r in range(prompt.shape[0]):
        check_margin(got[r], want[r], scores[r], TOL)


@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.7, 5)])
def test_sampled_generate_matches_jax(pairs, temperature, top_k):
    """Sampling: the same jax key, split one key a step; the decision
    values are the logits / temperature (top-k truncated) plus jax's
    Gumbel noise of each step's key."""
    jm, params, tm = pairs["learned"]
    prompt = _prompt(s=6, seed=6)
    steps = 6
    want = np.asarray(jd.generate(
        jm.cfg, params, jnp.asarray(prompt), steps, temperature=temperature,
        top_k=top_k, key=jax.random.PRNGKey(7)))
    got = td.generate(tm, torch.from_numpy(prompt), steps,
                      temperature=temperature, top_k=top_k,
                      key=prng.prng_key(7)).numpy()
    lt = _forward_scores(jm, params, prompt, want) / temperature
    if top_k:
        kth = np.sort(lt, axis=-1)[..., -top_k][..., None]
        lt = np.where(lt < kth, -np.inf, lt)
    keys = jax.random.split(jax.random.PRNGKey(7), steps)
    noise = np.stack([np.asarray(jax.random.gumbel(k, lt.shape[::2]))
                      for k in keys], axis=1)
    scores = lt + noise
    for r in range(prompt.shape[0]):
        check_margin(got[r], want[r], scores[r], TOL)
    # reproducible, and top_k=1 is greedy
    again = td.generate(tm, torch.from_numpy(prompt), steps,
                        temperature=temperature, top_k=top_k,
                        key=prng.prng_key(7)).numpy()
    np.testing.assert_array_equal(again, got)
    greedy = td.generate(tm, torch.from_numpy(prompt), steps)
    top1 = td.generate(tm, torch.from_numpy(prompt), steps, temperature=0.5,
                       top_k=1, key=prng.prng_key(7))
    assert torch.equal(top1, greedy)
    with pytest.raises(ValueError, match="requires a PRNG key"):
        td.generate(tm, torch.from_numpy(prompt), steps, temperature=1.0)


def test_generate_eos_freezes_finished_rows(pairs):
    """``eos_id=``: a row that emits it repeats it as pad while the others
    produce exactly the eos-free run's tokens; equal to jax's."""
    jm, params, tm = pairs["rope"]
    prompt = _prompt(b=3, s=6, seed=8)
    steps = 6
    full = td.generate(tm, torch.from_numpy(prompt), steps).numpy()
    eos = int(full[0, steps // 2])
    got = td.generate(tm, torch.from_numpy(prompt), steps,
                      eos_id=eos).numpy()
    for r in range(full.shape[0]):
        hits = np.flatnonzero(full[r] == eos)
        stop = hits[0] if hits.size else steps
        np.testing.assert_array_equal(got[r, :stop + 1], full[r, :stop + 1])
        assert (got[r, stop + 1:] == eos).all()
    want = np.asarray(jd.generate(jm.cfg, params, jnp.asarray(prompt), steps,
                                  eos_id=eos))
    scores = _forward_scores(jm, params, prompt,
                             np.asarray(jd.generate(jm.cfg, params,
                                                    jnp.asarray(prompt),
                                                    steps)))
    for r in range(prompt.shape[0]):
        check_margin(got[r], want[r], scores[r], TOL)
    # an eos id that is never emitted changes nothing
    unused = int(np.setdiff1d(np.arange(256), full)[0])
    np.testing.assert_array_equal(
        td.generate(tm, torch.from_numpy(prompt), steps,
                    eos_id=unused).numpy(), full)


def test_decode_past_cache_end_poisons(pairs):
    """A slot at the cache end writes nothing and gets NaN logits; its
    batch peers are unaffected."""
    _, _, tm = pairs["learned"]
    prompt = torch.from_numpy(_prompt(s=4, seed=5))
    _, cache = td.prefill(tm, prompt, max_len=4)  # full
    before = cache["k"].clone()
    logits, cache = td.decode_step(tm, cache, prompt[:, 0])
    assert torch.isnan(logits).all()
    assert torch.equal(cache["k"], before)
    # one row full, one not: only the full row is poisoned
    _, cache = td.prefill(tm, prompt, max_len=8)
    cache["pos"] = torch.tensor([8, 4])
    logits, _ = td.decode_step(tm, cache, prompt[:, 0])
    assert torch.isnan(logits[0]).all() and torch.isfinite(logits[1]).all()
    # a frozen row at the cache end is not poisoned (it does not write)
    cache["pos"] = torch.tensor([8, 4])
    logits, _ = td.decode_step(tm, cache, prompt[:, 0],
                               write_mask=torch.tensor([False, True]))
    assert torch.isfinite(logits).all()


def test_assign_slot_isolated_and_matches_single_stream(pairs):
    """Admitting into one slot of a busy pool (prompt right-padded to a
    bucket) leaves every other slot's K/V bit for bit untouched, frozen
    slots never advance, and the slot's greedy continuation equals the
    port's single-stream ``generate`` and jax's."""
    jm, params, tm = pairs["mqa_rope"]
    prompt = _prompt(b=1, s=7, seed=11)
    steps = 5
    want = td.generate(tm, torch.from_numpy(prompt), steps).numpy()[0]
    cache = td.init_cache(tm, 4)
    other = torch.from_numpy(_prompt(b=1, s=5, seed=12)[0])
    cache, _ = td.assign_slot(tm, cache, 1, other)
    peer_k = cache["k"][:, 1].clone()
    padded = torch.zeros(16, dtype=torch.int64)
    padded[:7] = torch.from_numpy(prompt[0])
    cache, last = td.assign_slot(tm, cache, 2, padded, length=7)
    toks = [int(torch.argmax(last))]
    cur = torch.zeros(4, dtype=torch.int64)
    cur[2] = toks[0]
    active = torch.tensor([False, False, True, False])
    for _ in range(steps - 1):
        logits, cache = td.decode_step(tm, cache, cur, write_mask=active)
        toks.append(int(torch.argmax(logits[2])))
        cur[2] = toks[-1]
    scores = _forward_scores(jm, params, prompt, want[None])[0]
    check_margin(toks, want, scores, TOL)
    assert torch.equal(cache["k"][:, 1], peer_k)
    assert cache["pos"].tolist() == [0, 5, 7 + steps - 1, 0]
    jwant = np.asarray(jd.generate(jm.cfg, params, jnp.asarray(prompt),
                                   steps))[0]
    check_margin(toks, jwant, scores, TOL)


def test_reset_slot_clears_one_slot_only(pairs):
    _, _, tm = pairs["learned"]
    cache = td.init_cache(tm, 3)
    cache, _ = td.assign_slot(tm, cache, 0,
                              torch.from_numpy(_prompt(1, 4, 14)[0]))
    cache, _ = td.assign_slot(tm, cache, 2,
                              torch.from_numpy(_prompt(1, 6, 15)[0]))
    keep = cache["k"][:, 2].clone()
    cache = td.reset_slot(cache, 0)
    assert not cache["k"][:, 0].any()
    assert cache["pos"].tolist() == [0, 0, 6]
    assert torch.equal(cache["k"][:, 2], keep)


def test_legacy_scalar_pos_cache_still_decodes(pairs):
    """A cache with a scalar ``pos`` (from before the slot layout)
    broadcasts into the per-slot layout: the same logits bit for bit."""
    _, _, tm = pairs["learned"]
    prompt = torch.from_numpy(_prompt(s=4, seed=16))
    _, cache = td.prefill(tm, prompt)
    legacy = {"k": cache["k"].clone(), "v": cache["v"].clone(),
              "pos": torch.tensor(4)}
    want, _ = td.decode_step(tm, cache, prompt[:, 0])
    got, out = td.decode_step(tm, legacy, prompt[:, 0])
    assert torch.equal(got, want)
    assert out["pos"].tolist() == [5, 5]


def test_cache_validation_errors(pairs):
    import types
    from dataclasses import replace

    _, _, tm = pairs["learned"]
    moe = types.SimpleNamespace(cfg=replace(tm.cfg, moe_experts=4))
    with pytest.raises(ValueError, match="dense blocks only"):
        td.init_cache(moe, 2)
    with pytest.raises(ValueError, match="dense blocks only"):
        td.init_paged_pool(moe, 4, 8, 2)
    with pytest.raises(ValueError, match="exceeds the 8-token cache"):
        td.prefill(tm, torch.zeros((1, 9), dtype=torch.int64), max_len=8)
    cache = td.init_cache(tm, 2, max_len=8)
    with pytest.raises(ValueError, match="exceed the 8-token slot cache"):
        td.assign_slot(tm, cache, 0, torch.zeros(9, dtype=torch.int64))
    pool = td.init_paged_pool(tm, 4, 4, 2)
    tables = torch.full((2, 2), 4, dtype=torch.int64)
    with pytest.raises(ValueError, match="8-row virtual slot capacity"):
        td.assign_slot_paged(tm, pool, tables, 0,
                             torch.zeros(9, dtype=torch.int64))
    with pytest.raises(ValueError, match="exceeds max_len"):
        td.prefill(tm, torch.zeros((1, 40), dtype=torch.int64), max_len=64)


def test_width_sharded_decoding_is_not_ported(pairs):
    _, _, tm = pairs["learned"]
    pool = td.init_paged_pool(tm, 4, 4, 2)
    tables = torch.full((2, 2), 4, dtype=torch.int64)
    with pytest.raises(NotPortedError, match="A11"):
        td.decode_step_paged(tm, pool, tables, torch.zeros(2, dtype=torch.int64),
                             tp_axis="width")
    with pytest.raises(NotPortedError, match="A11"):
        td.assign_slot_paged(tm, pool, tables, 0,
                             torch.zeros(4, dtype=torch.int64),
                             tp_axis="width")


def test_paged_decode_matches_jax(pairs):
    """The block-table path against jax's on a churned table: pages out of
    order, a null page past a slot's prefix, a frozen row."""
    jm, params, tm = pairs["gqa"]
    ps, num_pages = 4, 6
    tables = np.array([[3, 0, 6, 6], [5, 1, 2, 6]])
    prompts = [_prompt(1, 7, 21)[0], _prompt(1, 5, 22)[0]]
    jpool = jd.init_paged_pool(jm.cfg, num_pages, ps, 2)
    pool = td.init_paged_pool(tm, num_pages, ps, 2)
    for slot, pr in enumerate(prompts):
        jpool, jlast = jd.assign_slot_paged(jm.cfg, params, jpool,
                                            jnp.asarray(tables), slot,
                                            jnp.asarray(pr))
        pool, last = td.assign_slot_paged(tm, pool, torch.from_numpy(tables),
                                          slot, torch.from_numpy(pr))
        _close(last, jlast)
    tok = np.array([3, 9])
    for mask in ([True, True], [False, True], [True, True]):
        jl, jpool = jd.decode_step_paged(
            jm.cfg, params, jpool, jnp.asarray(tables), jnp.asarray(tok),
            write_mask=jnp.asarray(mask))
        tl, pool = td.decode_step_paged(
            tm, pool, torch.from_numpy(tables), torch.from_numpy(tok),
            write_mask=torch.tensor(mask))
        _close(tl, jl)
        _close(pool["k"], jpool["k"])
        assert pool["pos"].tolist() == np.asarray(jpool["pos"]).tolist()
