"""The port's width-sharded serving held against the JAX package's:
``models.decode.WidthShard`` (the reference's ``decode_step_paged(
tp_axis=, rep=)`` / ``assign_slot_paged(tp_axis=)`` / ``init_paged_pool(
kv_heads=)``), ``SlotEngine(width=2)`` and the width-sharded fleet
(``spec["width"]``, the reference's ``test_serve.py`` width fleet).

A width shard is a process with its own device in a width group, where
the reference shards over the local devices of one process.  The decode
and engine cases run in a 2-rank gloo world (``_torch_parallel.
width_worker``) on the reference's weights: the width-2 logits against
the replicated paged decode on the same weights at 1e-5 (fp32; the
row-parallel products are summed over 2 ranks in another order), the
engine's greedy streams against the reference's ``generate`` by the
margin rule of ``tests/_torch_serving.py``.  The fleet runs 4 ranks as 2
width-2 groups over the request-log partition, with a rank killed
mid-stream: its group's width group re-forms in the next epoch and every
stream completes, held to the reference's greedy streams by the margin
rule.
"""

from __future__ import annotations

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parallel
import _torch_world
from _torch_serving import check_margin, teacher_scores
from horovod_tpu.models.decode import generate as jax_generate
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu_torch.serve import ServeJob
from horovod_tpu_torch.serve.service import build_model

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5
MARGIN = 1e-3
STEPS = 6
BASE = dict(num_layers=2, num_heads=4, emb_dim=64, max_len=64,
            vocab_size=256, attention_impl="reference")
CASES = {"learned": {}, "rope": {"pos_embedding": "rope"},
         "gqa": {"num_heads": 8, "num_kv_heads": 4}}
PROMPTS = [[5, 17, 3, 9, 44], [100, 2, 7, 7, 7, 1, 0, 250, 13, 4, 8]]


@functools.lru_cache(maxsize=None)
def _case(name):
    cfg = dict(BASE, **CASES[name])
    jm = jax_gpt("nano", dtype=jnp.float32, **cfg)
    params = jm.init(jax.random.PRNGKey(len(name)),
                     jnp.zeros((1, 8), jnp.int32))
    return jm, params, cfg


@pytest.fixture(scope="module")
def world():
    cases = {}
    for name in CASES:
        _, params, cfg = _case(name)
        cases[name] = (jax.tree_util.tree_map(np.asarray, params), cfg,
                       PROMPTS)
    return _torch_world.run_world(_torch_parallel.width_worker,
                                  (cases, STEPS, "learned"), world=2,
                                  timeout=120)


@pytest.mark.parametrize("name", list(CASES))
def test_width_sharded_paged_decode_matches_replicated(world, name):
    """Width-2 admission and decode steps: the prefill's last logits and
    every step's logits equal the replicated paged decode's on every
    rank; each rank's pool holds half the kv heads."""
    _, _, cfg = _case(name)
    kv = cfg.get("num_kv_heads") or cfg["num_heads"]
    for r in world:
        width, repl = r[name]["width"], r[name]["replicated"]
        np.testing.assert_allclose(width[0], repl[0], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(width[1], repl[1], atol=TOL, rtol=TOL)
        assert width[2][3] == kv // 2 and repl[2][3] == kv


def test_width_engine_greedy_matches_reference(world):
    """A width-2 ``SlotEngine``: every rank emits the same tokens, and
    they are the reference's greedy streams by the margin rule."""
    jm, params, _ = _case("learned")
    assert world[0]["engine"] == world[1]["engine"]
    assert world[0]["engine_pool_heads"] == BASE["num_heads"] // 2
    compared = 0
    for prompt, got in zip(PROMPTS, world[0]["engine"]):
        want = np.asarray(jax_generate(jm.cfg, params,
                                       jnp.asarray([prompt], jnp.int32),
                                       len(got)))[0].tolist()
        compared += check_margin(got, want,
                                 teacher_scores(jm, params, prompt, want),
                                 MARGIN)
    assert compared >= STEPS


SMALL = dict(num_layers=2, num_heads=2, emb_dim=32, max_len=64,
             vocab_size=64, attention_impl="reference")
WORKER_ENV = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


def test_width_fleet_partition_and_regroup_after_a_kill():
    """4 ranks as 2 width-2 groups serving the log partition ``n % 2``,
    rank 1 killed mid-stream: no request dropped, both groups served,
    and the killed rank's group formed its width group again in the next
    epoch (the streams after the kill come from a re-formed group)."""
    spec = {"size": "nano", "overrides": dict(SMALL, dtype=torch.float32),
            "seed": 3, "num_slots": 2, "idle_secs": 0.005, "device": "cpu",
            "width": 2, "kv_mode": "paged", "page_size": 8}
    rng = np.random.RandomState(4)
    reqs = [(f"w{i}", rng.randint(0, 64, rng.randint(3, 10)).tolist(),
             int(rng.randint(4, 10))) for i in range(8)]
    job = ServeJob(spec, np=4,
                   env=dict(WORKER_ENV,
                            HVDTPU_FAULT_SPEC="worker_exit:step=6:rank=1"),
                   timeout=240.0).start()
    try:
        for rid, prompt, new in reqs:
            job.client.submit(prompt, max_new_tokens=new, rid=rid)
        docs = {rid: job.client.result(rid, timeout=180)
                for rid, _, _ in reqs}
        results, ejob = job.stop(timeout=90)
    finally:
        job.shutdown()
    events = [e[0] for e in ejob.trace]
    assert events.count("failure") == 1 and events.count("respawn") == 1
    assert sorted(results) == [0, 1, 2, 3]
    assert {v.get("group") for v in results.values()} == {0, 1}
    assert any(d["epoch"] >= 1 for d in docs.values())
    model = build_model(spec)
    with torch.inference_mode():
        for rid, prompt, new in reqs:
            toks = docs[rid]["tokens"]
            assert len(toks) == new                      # no drop
            logits = model(torch.tensor([prompt + toks[:-1]]))[0]
            scores = logits[len(prompt) - 1:].numpy()
            check_margin(toks, scores.argmax(-1), scores, MARGIN)
