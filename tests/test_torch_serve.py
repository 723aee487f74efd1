"""The port's serving plane (horovod_tpu_torch.serve): the scheduler copy
against horovod_tpu.serve.SlotScheduler on one random trace, and the slot
engine against the JAX package's SlotEngine and single-stream ``generate``
on the same weights.

Tiny fp32 models as tests/test_serve.py builds them (1 layer, 2 heads,
emb 32, vocab 64, max_len 64, ``attention_impl="reference"``).  Tokens
across the two packages are held by the margin rule at 1e-5
(``_torch_serving.py``) on the reference's teacher-forced logits; within
the port, a replay that resumes mid-stream is held bit for bit.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.serve as jserve
from _torch_serving import check_margin, drive, serve_pair, teacher_scores
from horovod_tpu.models.decode import generate as jax_generate
from horovod_tpu.serve.engine import prompt_bucket as jax_prompt_bucket
from horovod_tpu_torch import serve
from horovod_tpu_torch.models import decode as td
from horovod_tpu_torch.serve import (
    Request, SlotEngine, SlotScheduler, TenantQoS, prompt_bucket,
)

TOL = 1e-5
SERVE_NAMES = ("SlotEngine", "SlotScheduler", "Request", "PagedKV",
               "pages_for", "page_reject_reason", "prompt_bucket")


@pytest.fixture(scope="module")
def rope_pair():
    return serve_pair(0, pos_embedding="rope")


def test_serve_exports_the_slice_names():
    """The seven names of the slice, each the port's own."""
    for name in SERVE_NAMES:
        assert name in serve.__all__
        assert getattr(serve, name).__module__.startswith(
            "horovod_tpu_torch.serve.")


# ---------------------------------------------------------------------------
# The scheduler copy against the reference's
# ---------------------------------------------------------------------------


def _sched_trace(module, qos_spec, seed):
    """One random trace of arrivals, admissions (some through a capacity
    gate), token records and evictions through ``module``'s scheduler;
    the log of every decision and snapshot."""
    rng = np.random.RandomState(seed)
    qos = module.TenantQoS.from_spec(qos_spec)
    sched = module.SlotScheduler(3, qos=qos)
    log = []
    rid = 0
    for step in range(1, 60):
        for _ in range(rng.randint(0, 3)):
            req = module.Request(
                rid=f"r{rid}", prompt=tuple(range(1, rng.randint(2, 6))),
                max_new_tokens=int(rng.randint(1, 6)),
                eos_id=int(rng.randint(40, 50)) if rng.rand() < 0.3
                else None,
                tenant=("a", "b", "c")[rng.randint(0, 3)],
                slo=module.SLO_CLASSES[rng.randint(0, 3)])
            resume = tuple(int(t) for t in rng.randint(0, 9, rng.randint(
                0, 2)))
            sched.enqueue(req, resume=resume)
            rid += 1
        budget = int(rng.randint(4, 30))

        def gate(req, resume, _left=[budget]):
            if req.cost > _left[0]:
                return False
            _left[0] -= req.cost
            return True

        admits = sched.admit(step, can_admit=gate if step % 2 else None)
        for a in admits:
            if not sched.active[a.slot].done:  # a resume may finish it
                sched.record(a.slot, int(rng.randint(0, 50)))
        evs = sched.evict_finished()
        for slot in sorted(sched.active):
            if not sched.active[slot].done:
                sched.record(slot, int(rng.randint(0, 50)))
        evs += sched.evict_finished()
        log.append((
            step,
            [(a.slot, a.req.rid, a.resume) for a in admits],
            [(e.slot, e.rid, e.reason, e.tokens) for e in evs],
            sched.snapshot(), sched.queue_depth, sched.active_slots,
            sched.tenant_depths(), dict(sched.throttled),
            sched.free_slots(),
        ))
    return log


@pytest.mark.parametrize("qos_spec", [
    None,
    {"weights": {"batch": 2}},
    {"budget_tokens": 12, "window_steps": 5},
])
def test_scheduler_copy_decides_as_the_reference(qos_spec):
    import horovod_tpu.serve.scheduler as jsched
    import horovod_tpu_torch.serve.scheduler as tsched

    for seed in (0, 1):
        want = _sched_trace(jsched, qos_spec, seed)
        got = _sched_trace(tsched, qos_spec, seed)
        assert got == want
        assert any(entry[2] for entry in want)  # something was evicted


def test_scheduler_validation_matches_the_reference():
    with pytest.raises(ValueError, match="empty prompt"):
        Request(rid="x", prompt=())
    with pytest.raises(ValueError, match="max_new_tokens"):
        Request(rid="x", prompt=(1,), max_new_tokens=0)
    with pytest.raises(ValueError, match="num_slots"):
        SlotScheduler(0)
    with pytest.raises(ValueError, match="budget_tokens"):
        TenantQoS(budget_tokens=0)


def test_prompt_bucket():
    for n, cache in ((1, 64), (3, 64), (8, 64), (9, 64), (40, 48),
                     (64, 64), (300, 1024), (769, 1024)):
        assert prompt_bucket(n, cache) == jax_prompt_bucket(n, cache)
    assert prompt_bucket(3, 64) == 8 and prompt_bucket(9, 64) == 16
    assert prompt_bucket(40, 48) == 48
    with pytest.raises(ValueError, match="exceeds"):
        prompt_bucket(65, 64)


def test_engine_serve_len_caps_oversized_cache(rope_pair):
    """An oversized slot cache must not let a prompt's power-of-two
    bucket pass the model's max_len."""
    _, _, tm = rope_pair
    eng = SlotEngine(tm, num_slots=1, max_len=128)
    assert eng.cache_len == 128 and eng.serve_len == 64
    assert eng.admit(0, [1] * 40) is not None     # bucket 64 <= max_len
    with pytest.raises(ValueError, match="exceeds"):
        eng.admit(0, [1] * 70)                    # fits the cache only


# ---------------------------------------------------------------------------
# The slot engine against the JAX engine and single-stream generate
# ---------------------------------------------------------------------------


def _requests(seed=5, n=5, vocab=64):
    rng = np.random.RandomState(seed)
    reqs = {}
    for i in range(n):
        prompt = tuple(int(t) for t in rng.randint(0, vocab,
                                                   rng.randint(3, 9)))
        reqs[f"r{i}"] = Request(rid=f"r{i}", prompt=prompt,
                                max_new_tokens=int(rng.randint(2, 6)))
    return reqs


def test_engine_continuous_batch_matches_jax_and_generate(rope_pair):
    """Requests admitted at different steps into a shared pool, some
    mid-decode, give the JAX engine's tokens and single-stream
    ``generate``'s (the port's and the reference's), under the margin
    rule."""
    jm, params, tm = rope_pair
    reqs = _requests()
    got, overlapped = drive(SlotEngine(tm, num_slots=2), SlotScheduler(2),
                            reqs)
    want, _ = drive(jserve.SlotEngine(jm.cfg, params, num_slots=2),
                    jserve.SlotScheduler(2),
                    {r: jserve.Request(rid=q.rid, prompt=q.prompt,
                                       max_new_tokens=q.max_new_tokens)
                     for r, q in reqs.items()})
    assert overlapped, "no admission ever overlapped a decode"
    assert set(got) == set(want) == set(reqs)
    for rid, req in reqs.items():
        assert len(got[rid]) == req.max_new_tokens
        scores = teacher_scores(jm, params, req.prompt, want[rid])
        assert check_margin(got[rid], want[rid], scores, TOL) == len(
            want[rid])
        single = td.generate(tm, torch.tensor([req.prompt]),
                             req.max_new_tokens)[0].tolist()
        jsingle = np.asarray(jax_generate(
            jm.cfg, params, jnp.asarray([req.prompt], jnp.int32),
            req.max_new_tokens))[0]
        check_margin(got[rid], jsingle, scores, TOL)
        check_margin(single, jsingle, scores, TOL)


def test_engine_replay_resumes_mid_stream(rope_pair):
    """Rebuilding a slot from prompt + the tokens already streamed
    continues the generation: the same tokens, bit for bit, as the
    uninterrupted engine."""
    _, _, tm = rope_pair
    prompt = tuple(int(t) for t in np.random.RandomState(2).randint(0, 64, 6))
    fresh = SlotEngine(tm, num_slots=1)
    want = [fresh.admit(0, prompt)]
    for _ in range(5):
        want.append(fresh.step([0])[0])
    interrupted = SlotEngine(tm, num_slots=1)
    toks = [interrupted.admit(0, prompt)]
    for _ in range(2):
        toks.append(interrupted.step([0])[0])
    assert toks == want[:3]
    replay = SlotEngine(tm, num_slots=2)
    assert replay.admit(1, prompt, resume=tuple(toks)) is None
    for _ in range(3):
        toks.append(replay.step([1])[1])
    assert toks == want


def test_engine_kv_stats_step_flops_set_params_and_reset():
    _, _, tm = serve_pair(3, pos_embedding="rope")
    eng = SlotEngine(tm, num_slots=2)
    eng.admit(0, [3, 4, 5])
    eng.admit(1, list(range(1, 12)))
    st = eng.kv_stats(active=[0, 1])
    pool = 2 * tm.cfg.num_layers * 2 * 64 * tm.cfg.emb_dim * 4
    assert st["pool_bytes"] == pool
    assert st["allocated_bytes"] == pool
    assert st["live_bytes"] == (3 + 11) * pool // 128
    cfg, b, e = tm.cfg, 2, tm.cfg.emb_dim
    assert eng.step_flops() == cfg.num_layers * (
        2 * b * e * 3 * e + 2 * b * e * e + 16 * b * e * e + 4 * b * e * 64
    ) + 2 * b * e * cfg.vocab_size
    # hot swap: same names and shapes in place; another model refused
    before = eng.step([0, 1])
    eng.set_params({n: torch.zeros_like(p)
                    for n, p in tm.state_dict().items()})
    assert not any(p.any() for p in tm.parameters())
    with pytest.raises(ValueError, match="tree mismatch"):
        eng.set_params({"wte.weight": torch.zeros(3)})
    eng.reset()
    assert not eng.cache["k"].any() and eng.kv_stats()["slots_in_use"] == 0
    assert set(before) == {0, 1}
