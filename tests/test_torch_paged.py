"""The port's paged KV serving (horovod_tpu_torch.serve.paged and the
paged SlotEngine) against the JAX package's, and paged against contiguous
within the port.

The allocator copy is held decision for decision against
horovod_tpu.serve.paged on one trace.  Within the port, a paged engine
whose virtual slot length equals the contiguous cache length runs the same
ops on the same shapes, so its tokens are held bit for bit to the
contiguous engine's, across evictions and re-admissions, and a replay into
a pool of another shape continues a stream bit for bit.  Across the two
packages tokens are held by the margin rule at 1e-5
(``_torch_serving.py``); sampled ones on the reference's ``logits /
temperature`` (top-k truncated) plus its Gumbel noise.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

import horovod_tpu.serve as jserve
import horovod_tpu.serve.paged as jpaged
import horovod_tpu_torch.serve.paged as tpaged
from _torch_serving import check_margin, drive, serve_pair, teacher_scores
from horovod_tpu.serve import sampling as jsamp
from horovod_tpu_torch import NotPortedError
from horovod_tpu_torch.serve import (
    PagedKV, Request, SlotEngine, SlotScheduler, page_reject_reason,
    pages_for,
)

TOL = 1e-5


@pytest.fixture(scope="module")
def learned_pair():
    return serve_pair(0)


@pytest.fixture(scope="module")
def rope_pair():
    return serve_pair(1, pos_embedding="rope")


# ---------------------------------------------------------------------------
# The allocator copy against the reference's
# ---------------------------------------------------------------------------


def test_pages_for_and_reject_reason_match_the_reference():
    for tokens in range(0, 40):
        for ps in (1, 4, 8, 16):
            assert pages_for(tokens, ps) == jpaged.pages_for(tokens, ps)
    for prompt, budget in ((4, 4), (30, 10), (1, 1), (60, 5)):
        for ps, pages in ((4, 8), (8, 4), (16, 64)):
            assert page_reject_reason(prompt, budget, ps, pages) == \
                jpaged.page_reject_reason(prompt, budget, ps, pages)


def _alloc_trace(module, seed):
    """One random admit / grow / release trace through ``module``'s
    allocator; the tables, stats and refusals at every step."""
    rng = np.random.RandomState(seed)
    kv = module.PagedKV(4, 12, 4, 32)
    live, log = {}, []
    for _ in range(200):
        op = rng.randint(0, 4)
        event = None
        if op == 0 and len(live) < 4:
            slot = min(s for s in range(4) if s not in live)
            n, extra = int(rng.randint(1, 12)), int(rng.randint(0, 12))
            if kv.can_admit(n + extra):
                event = ("admit", kv.admit(slot, n, n + extra))
                live[slot] = n
            else:
                gate = kv.admission_gate()
                event = ("refused", gate(n + extra), gate(1), gate(40))
        elif op == 1 and live:
            slot = sorted(live)[rng.randint(0, len(live))]
            try:
                event = ("grow", kv.ensure_capacity(slot))
                kv.advance(slot)
            except RuntimeError as e:
                event = ("commitment", str(e))
        elif op == 2 and live:
            slot = sorted(live)[rng.randint(0, len(live))]
            kv.release(slot)
            del live[slot]
            event = ("release", slot)
        log.append((event, [kv.table_row(s) for s in range(4)],
                     kv.stats(3.0), kv.free_pages, kv.committed_pages))
    return log


def test_allocator_copy_decides_as_the_reference():
    for seed in (7, 8):
        want = _alloc_trace(jpaged, seed)
        assert _alloc_trace(tpaged, seed) == want
        assert any(e[0] and e[0][0] == "release" for e in want)


def test_allocator_refcounts_and_overcommit_match_the_reference():
    for mod in (jpaged, tpaged):
        kv = mod.PagedKV(num_slots=2, num_pages=4, page_size=4, max_len=16)
        pages = kv.admit(0, prefill_len=4, total_len=4)
        kv.retain(pages)
        kv.adopt(1, pages, prefill_len=4, total_len=4)
        kv.release(0)
        assert kv.free_pages == 3
        kv.release(1)
        assert kv.free_pages == 4
        kv.admit(0, prefill_len=2, total_len=10)
        with pytest.raises(RuntimeError, match="overcommit"):
            kv.admit(1, prefill_len=1, total_len=8)
    assert PagedKV is tpaged.PagedKV


# ---------------------------------------------------------------------------
# Paged decoding
# ---------------------------------------------------------------------------


def _requests(seed, n, lo=3, hi=11, budget=(2, 7), vocab=64):
    rng = np.random.RandomState(seed)
    return {f"r{i}": Request(
        rid=f"r{i}",
        prompt=tuple(int(t) for t in rng.randint(0, vocab,
                                                 rng.randint(lo, hi))),
        max_new_tokens=int(rng.randint(*budget))) for i in range(n)}


def test_paged_engine_equals_contiguous_across_churn(rope_pair):
    """Mixed-length requests through a bounded page pool, slots reused
    after eviction so tables churn through the free list: every stream bit
    for bit the contiguous engine's (virtual length 64 = the cache), and
    the JAX paged engine's under the margin rule; the pool drains clean."""
    jm, params, tm = rope_pair
    reqs = _requests(5, 6)
    paged = SlotEngine(tm, num_slots=2, kv_mode="paged", page_size=8,
                       num_pages=12)
    assert paged.cache_len == 64
    got, _ = drive(paged, SlotScheduler(2), reqs, paged=True)
    contig, _ = drive(SlotEngine(tm, num_slots=2), SlotScheduler(2), reqs)
    assert got == contig
    assert paged.paged.free_pages == 12
    want, _ = drive(jserve.SlotEngine(jm.cfg, params, num_slots=2,
                                      kv_mode="paged", page_size=8,
                                      num_pages=12),
                    jserve.SlotScheduler(2),
                    {r: jserve.Request(rid=q.rid, prompt=q.prompt,
                                       max_new_tokens=q.max_new_tokens)
                     for r, q in reqs.items()}, paged=True)
    for rid, req in reqs.items():
        scores = teacher_scores(jm, params, req.prompt, want[rid])
        assert check_margin(got[rid], want[rid], scores, TOL) == len(
            want[rid])


def test_paged_engine_equals_contiguous_lockstep(learned_pair):
    """Same calls through a paged and a contiguous engine: identical
    tokens, step by step."""
    _, _, tm = learned_pair
    paged = SlotEngine(tm, 2, kv_mode="paged", page_size=8)
    contig = SlotEngine(tm, 2)
    pra = tuple(int(t) for t in np.random.RandomState(1).randint(0, 64, 5))
    prb = tuple(int(t) for t in np.random.RandomState(2).randint(0, 64, 9))
    tp = [paged.admit(0, pra, rid="a"), paged.admit(1, prb, rid="b")]
    tc = [contig.admit(0, pra, rid="a"), contig.admit(1, prb, rid="b")]
    for _ in range(6):
        sp, sc = paged.step([0, 1]), contig.step([0, 1])
        tp += [sp[0], sp[1]]
        tc += [sc[0], sc[1]]
    assert tp == tc
    st = paged.kv_stats()
    # 5 + 6 and 9 + 6 rows written: two 8-row pages each
    assert st["slots_in_use"] == 2 and st["pages_used"] == 2 + 2
    assert st["contiguous_equiv_bytes"] == 2 * 64 * st["pool_bytes"] // (
        paged.num_pages * 8)


def test_page_exhaustion_queues_head_and_rejects_infeasible(learned_pair):
    """A request that cannot fit now waits at the head (FCFS is strict);
    one that can never fit is rejected by the pure verdict."""
    _, _, tm = learned_pair
    eng = SlotEngine(tm, num_slots=2, kv_mode="paged", page_size=8,
                     num_pages=4)
    sched = SlotScheduler(2)
    big = Request(rid="big", prompt=tuple(range(1, 17)), max_new_tokens=15)
    small = Request(rid="small", prompt=(1, 2, 3), max_new_tokens=4)
    sched.enqueue(big)
    sched.enqueue(small)
    adm = sched.admit(1, can_admit=eng.admission_gate())
    assert [a.req.rid for a in adm] == ["big"]
    eng.admit(0, big.prompt, total_len=31, rid="big")
    assert not eng.can_admit(7)
    assert sched.admit(2, can_admit=eng.admission_gate()) == []
    assert sched.queue_depth == 1
    assert page_reject_reason(30, 10, eng.page_size,
                              eng.num_pages) is not None
    eng.release_slot(0)
    del sched.active[0]
    assert eng.can_admit(7)
    assert [a.req.rid for a in
            sched.admit(3, can_admit=eng.admission_gate())] == ["small"]


def test_paged_replay_resumes_mid_stream_rebuilt_tables(learned_pair):
    """A fresh engine with another slot count and pool shape (the world
    re-formed) rebuilds its tables from prompt + emitted tokens and
    continues the uninterrupted stream bit for bit."""
    _, _, tm = learned_pair
    prompt = tuple(int(t) for t in np.random.RandomState(3).randint(0, 64, 6))
    whole = SlotEngine(tm, 2, kv_mode="paged", page_size=4, num_pages=8)
    want = [whole.admit(0, prompt, total_len=14, rid="r")]
    for _ in range(7):
        want.append(whole.step([0])[0])
    fresh = SlotEngine(tm, 2, kv_mode="paged", page_size=4, num_pages=8)
    toks = [fresh.admit(0, prompt, total_len=14, rid="r")]
    for _ in range(3):
        toks.append(fresh.step([0])[0])
    replay = SlotEngine(tm, 3, kv_mode="paged", page_size=8, num_pages=6)
    assert replay.admit(1, prompt, resume=tuple(toks), total_len=14,
                        rid="r") is None
    for _ in range(4):
        toks.append(replay.step([1])[1])
    assert toks == want


def _sampled(tm, seed, steps_before_replay=None, **kw):
    prompt = tuple(int(t) for t in np.random.RandomState(2).randint(0, 64, 6))
    eng = SlotEngine(tm, 1, kv_mode="paged", page_size=8, sample_seed=seed,
                     **kw)
    toks = [eng.admit(0, prompt, temperature=0.8, top_k=8, rid="r",
                      total_len=12)]
    n = 5 if steps_before_replay is None else steps_before_replay
    for _ in range(n):
        toks.append(eng.step([0])[0])
    if steps_before_replay is not None:
        eng = SlotEngine(tm, 1, kv_mode="paged", page_size=8,
                         sample_seed=seed)
        assert eng.admit(0, prompt, resume=tuple(toks), temperature=0.8,
                         top_k=8, rid="r", total_len=12) is None
        for _ in range(5 - n):
            toks.append(eng.step([0])[0])
    return prompt, toks


def test_sampled_stream_identical_across_engines_and_replay(learned_pair):
    """Two engines (simulated ranks) derive identical sampled tokens; a
    third replays mid-stream and continues bit for bit (sampling keys on
    rid, emission index and seed, never the serving step); another seed
    draws another stream; and the stream is the JAX engine's under the
    margin rule on its logits / temperature (top 8) + Gumbel noise."""
    jm, params, tm = learned_pair
    prompt, t1 = _sampled(tm, 11)
    assert _sampled(tm, 11)[1] == t1
    assert _sampled(tm, 11, steps_before_replay=2)[1] == t1
    assert _sampled(tm, 12)[1] != t1

    eng = jserve.SlotEngine(jm.cfg, params, 1, kv_mode="paged", page_size=8,
                            sample_seed=11)
    want = [eng.admit(0, prompt, temperature=0.8, top_k=8, rid="r",
                      total_len=12)]
    for _ in range(5):
        want.append(eng.step([0])[0])
    lt = teacher_scores(jm, params, prompt, want) / np.float32(0.8)
    lt = np.where(lt < np.sort(lt, axis=-1)[:, -8:-7], -np.inf, lt)
    base = jsamp.request_key(11, "r")
    noise = np.stack([np.asarray(jax.random.gumbel(
        jsamp.token_key(base, i), (64,))) for i in range(len(want))])
    assert check_margin(t1, want, lt + noise, TOL) == len(want)


def test_temperature_zero_is_greedy_bitwise(learned_pair):
    _, _, tm = learned_pair
    prompt = tuple(int(t) for t in np.random.RandomState(4).randint(0, 64, 5))
    greedy = SlotEngine(tm, 1, kv_mode="paged", page_size=8)
    want = [greedy.admit(0, prompt)]
    eng = SlotEngine(tm, 1, kv_mode="paged", page_size=8, sample_seed=99)
    toks = [eng.admit(0, prompt, temperature=0.0, top_k=5, rid="any")]
    for _ in range(4):
        want.append(greedy.step([0])[0])
        toks.append(eng.step([0])[0])
    assert toks == want


def test_width_sharding_is_not_ported(learned_pair):
    _, _, tm = learned_pair
    for mode in ("contiguous", "paged", "ring"):
        with pytest.raises(NotPortedError, match="A11"):
            SlotEngine(tm, 2, kv_mode=mode, width=2)
    with pytest.raises(ValueError, match="unknown kv_mode"):
        SlotEngine(tm, 2, kv_mode="ring")
    assert SlotEngine(tm, 2, kv_mode="paged", width=1).width == 1
