"""Helpers of the port's serving tests: the margin rule tokens are held
by, a (flax, port) model pair on the same weights, the scheduler loop and
the reference's teacher-forced logits.

The margin rule: two implementations that agree on logits to ~1e-6 may
still pick another token where a random-weight model's top two logits
are closer than that.  So a stream is held token by token: the port's
token equals the reference's, or the reference scores the port's token
within ``tol`` of its own pick (a near tie: with two candidates, the top
two within ``tol`` and the port's token one of them).  After the first
near tie the two streams have different histories and the comparison
stops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu_torch.models import gpt, params_from_jax


def check_margin(got, want, scores, tol: float) -> int:
    """Hold token stream ``got`` against ``want`` under the margin rule;
    ``scores [steps, vocab]`` are the reference's decision values (logits,
    or logits / temperature + Gumbel noise) at each step.  Returns the
    number of steps compared; raises AssertionError on a violation."""
    got, want = np.asarray(got), np.asarray(want)
    scores = np.asarray(scores, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    for i, (g, w) in enumerate(zip(got.tolist(), want.tolist())):
        if g == w:
            continue
        gap = scores[i][w] - scores[i][g]
        assert gap <= tol, (
            f"step {i}: token {g} != reference {w}, {gap:.3g} below it in "
            f"the reference's scores (tolerance {tol})")
        return i + 1
    return len(want)


def serve_pair(seed=0, **overrides):
    """(flax model, its params, the port's model on those params): the
    tiny fp32 model of tests/test_serve.py."""
    kw = dict(num_layers=1, num_heads=2, emb_dim=32, max_len=64,
              vocab_size=64, attention_impl="reference")
    kw.update(overrides)
    jm = jax_gpt("nano", dtype=jnp.float32, **kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    tm = gpt("nano", device="cpu", dtype=torch.float32, **kw)
    tm.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jm, params, tm


def drive(engine, sched, reqs, paged=False, arrive_every=3, steps=100):
    """The scheduler loop of tests/test_serve.py: two requests up front,
    the rest dripped in mid-decode; admit, record, evict, step, record,
    evict (and ``release_slot`` in paged mode).  Returns ``{rid: tokens}``
    and whether an admission overlapped a decode."""
    pending = list(reqs.values())
    finished, overlapped = {}, False

    def evict():
        for ev in sched.evict_finished():
            finished[ev.rid] = list(ev.tokens)
            if paged:
                engine.release_slot(ev.slot)

    for step in range(1, steps):
        if pending and (step == 1 or step % arrive_every == 0):
            sched.enqueue(pending.pop(0))
        admits = sched.admit(step, can_admit=engine.admission_gate())
        for adm in admits:
            overlapped |= sched.active_slots > len(admits)
            tok = engine.admit(
                adm.slot, adm.req.prompt, adm.resume,
                total_len=len(adm.req.prompt) + adm.req.max_new_tokens,
                temperature=adm.req.temperature, top_k=adm.req.top_k,
                rid=adm.req.rid)
            sched.record(adm.slot, tok)
        evict()
        active = sorted(sched.active)
        if active:
            toks = engine.step(active)
            for slot in active:
                sched.record(slot, toks[slot])
        evict()
        if len(finished) == len(reqs):
            break
    return finished, overlapped


def teacher_scores(jm, params, prompt, tokens):
    """The reference's logits at each generated position, teacher-forced
    over ``prompt + tokens[:-1]``: ``[len(tokens), vocab]``."""
    seq = np.asarray(list(prompt) + list(tokens[:-1]))[None]
    logits = np.asarray(jm.apply(params, jnp.asarray(seq)))[0]
    return logits[len(prompt) - 1:]
