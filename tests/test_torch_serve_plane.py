"""The port's serving plane end to end on the CPU (horovod_tpu_torch.serve:
service, __main__, the launcher's ``--serve`` and the bench's ``--serve``)
and its observability books (``obs.slo``, ``obs.goodput``), each held
against the reference.

* ``SLOPlane`` and ``TokenGoodput`` keep the same books as the
  reference's on the same seeded event streams: alerts, burn rates,
  summaries and the published instruments, exactly (the same float
  arithmetic in the same order).
* A ``ServeJob`` fleet of one rank at the 2-layer size (vocab 64, fp32)
  is switched to the reference's weights (carried across by
  ``params_from_jax``) through the port's ``publish_weights`` as hot-swap
  version 1, then serves greedy requests whose streams are held against
  the reference's single-stream ``generate`` by the margin rule at 1e-3
  (``tests/_torch_serving.py``).
* A fleet of two ranks has its leader killed mid-stream
  (``worker_exit:step=5:rank=0``): one respawn, zero dropped requests,
  every greedy stream by the margin rule at 1e-3 against the served
  model's teacher-forced forward.
* ``python -m horovod_tpu_torch.run --elastic --serve`` with
  ``python -m horovod_tpu_torch.serve --cpu``: a client submits through
  the printed endpoint and the launcher's secret; the worker's flags map
  onto the reference's spec.
* ``bench --serve --cpu``: one record with the reference's field names.

Each fleet test bounds its own time (the launcher's job timeout, the
client's result timeout, the drain's timeout).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import horovod_tpu.obs.goodput as jgoodput
import horovod_tpu.obs.slo as jslo
from _torch_serving import check_margin, teacher_scores
from horovod_tpu.models.decode import generate as jax_generate
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.serve.__main__ import parse_spec as jax_parse_spec
from horovod_tpu_torch.obs import goodput, slo
from horovod_tpu_torch.models import params_from_jax
from horovod_tpu_torch.run.rendezvous import KVStoreClient
from horovod_tpu_torch.serve import ServeClient, ServeJob, publish_weights
from horovod_tpu_torch.serve.__main__ import parse_spec
from horovod_tpu_torch.serve.service import build_model

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(num_layers=2, num_heads=2, emb_dim=32, max_len=64,
             vocab_size=64, attention_impl="reference")
MARGIN = 1e-3
FLEET_TIMEOUT = 150.0
WORKER_ENV = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


# ---------------------------------------------------------------------------
# SLO and goodput books
# ---------------------------------------------------------------------------


class _Rec:
    def __init__(self):
        self.value = 0.0

    def set(self, v):
        self.value = v

    def inc(self, n=1.0):
        self.value += n


class _Registry:
    """The registry surface ``publish`` writes through, recording every
    instrument by (kind, name, tags)."""

    def __init__(self):
        self.items = {}

    def _get(self, kind, name, tags):
        return self.items.setdefault(
            (kind, name, tuple(sorted(tags.items()))), _Rec())

    def gauge(self, name, **tags):
        return self._get("gauge", name, tags)

    def counter(self, name, **tags):
        return self._get("counter", name, tags)

    def values(self):
        return {k: v.value for k, v in self.items.items()}


SLO_SPEC = {"slo": {"interactive": {"ttft_ms": 500, "tpot_ms": 80,
                                    "objective": 0.99},
                    "standard": {"ttft_ms": 2000, "objective": 0.95},
                    "batch": {}, "junk": "not a dict"}}


def _slo_events(seed, n=600):
    """A seeded stream of (kind, tenant, slo, ms, t): three tenants, the
    three classes, a cliff, a slow burn and healthy traffic."""
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.5))
        tenant = ("acme", "bigco", "anon")[rng.randint(3)]
        cls = ("interactive", "standard", "batch")[rng.randint(3)]
        kind = ("ttft", "tpot")[rng.randint(2)]
        base = 300.0 if kind == "ttft" else 40.0
        cliff = 3.0 if 200 <= i < 260 else 1.0
        out.append((kind, tenant, cls,
                    float(base * cliff * rng.lognormal(0.0, 0.6)), t))
    return out


def _drive_slo(mod, events, checks):
    plane = mod.SLOPlane(mod.targets_from_spec(SLO_SPEC))
    reg = _Registry()
    log = []
    for i, (kind, tenant, cls, ms, t) in enumerate(events):
        getattr(plane, f"observe_{kind}")(tenant, cls, ms, t)
        if i in checks:
            log.append((plane.evaluate(t), plane.burn_rates(t),
                        plane.summary(t)))
            plane.publish(reg, t)
    return log, reg.values(), plane.armed, plane.observed


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_plane_keeps_the_references_books(seed):
    events = _slo_events(seed)
    checks = set(range(0, len(events), 37)) | {len(events) - 1}
    got = _drive_slo(slo, events, checks)
    want = _drive_slo(jslo, events, checks)
    assert got == want
    log = got[0]
    assert any(alerts for alerts, _, _ in log)          # the cliff paged
    assert set(slo.targets_from_spec(SLO_SPEC)) == {"interactive",
                                                    "standard"}


def test_slo_targets_and_objective_bounds_as_the_reference():
    for spec in ({}, {"slo": None}, {"slo": {"batch": {}}}, SLO_SPEC):
        got = {k: v.as_dict() for k, v in
               slo.targets_from_spec(spec).items()}
        want = {k: v.as_dict() for k, v in
                jslo.targets_from_spec(spec).items()}
        assert got == want
    for bad in (0.0, 1.0, 1.5):
        with pytest.raises(ValueError):
            slo.SLOTarget(ttft_ms=500.0, objective=bad)


@pytest.mark.parametrize("seed", [0, 1])
def test_token_goodput_keeps_the_references_books(seed):
    rng = np.random.RandomState(seed)
    slots = int(rng.randint(1, 17))
    books = []
    for mod in (goodput, jgoodput):
        tg = mod.TokenGoodput(slots, 100.0)
        reg, log, t = _Registry(), [], 100.0
        for _ in range(200):
            tg.observe_step(int(rng.randint(-1, slots + 1)))
            t += float(rng.exponential(0.02))
            log.append((tg.tokens, tg.fraction(), tg.per_slot_second(t)))
            tg.publish(reg, t)
        books.append((log, reg.values()))
        rng = np.random.RandomState(seed)
        slots = int(rng.randint(1, 17))
    assert books[0] == books[1]


def test_the_ledger_hooks_record_nothing_until_a13():
    """Since A13a the hooks arm the reference's wall-clock ledger: the
    same books as the reference's ledger on the same clock."""
    try:
        ledger = goodput.install(now=100.0, epoch=2)
        assert goodput.get_ledger() is ledger
        ref = jgoodput.GoodputLedger(100.0, epoch=2)
        mine, want = _Registry(), _Registry()
        goodput.publish(mine, now=107.5)
        ref.publish(want, 107.5)
        assert mine.values() == want.values() and mine.items
    finally:
        goodput.uninstall()
    assert goodput.get_ledger() is None


# ---------------------------------------------------------------------------
# The worker's flags
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv,env", [
    ([], {}),
    (["--size", "small", "--slots", "16", "--kv-pages", "512",
      "--page-size", "16", "--seed", "7", "--max-len", "900"], {}),
    (["--kv-mode", "contiguous", "--weights-dir", "/w"],
     {"HVDTPU_SERVE_SWAP_POLL_STEPS": "4"}),
    ([], {"HVDTPU_SERVE_MODEL": "medium", "HVDTPU_SERVE_SLOTS": "8",
          "HVDTPU_SERVE_TENANT_BUDGET": "64",
          "HVDTPU_SERVE_SLO_TTFT_MS": "500",
          "HVDTPU_SERVE_SLO_CLASS": "standard"}),
    (["--slo-tpot-ms", "80", "--slo-objective", "0.9"], {}),
])
def test_worker_flags_give_the_references_spec(argv, env, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got, want = parse_spec(argv), jax_parse_spec(argv)
    assert got == want
    assert "device" not in parse_spec(argv)
    assert parse_spec(argv + ["--cpu"])["device"] == "cpu"


def test_worker_width_above_one_names_a11():
    """``--width 2`` is ported: the worker's spec carries it, as the
    reference's does (the fleet itself: ``test_torch_width_serving.py``)."""
    got = parse_spec(["--width", "2"])
    assert got == jax_parse_spec(["--width", "2"])
    assert got["width"] == 2


# ---------------------------------------------------------------------------
# Fleets
# ---------------------------------------------------------------------------


def _spec(**kw):
    spec = {"size": "nano", "overrides": dict(SMALL, dtype=torch.float32),
            "seed": 3, "num_slots": 4, "idle_secs": 0.005,
            "device": "cpu"}
    spec.update(kw)
    return spec


def _requests(seed, n, sampled_every=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        sampled = sampled_every and (i + 1) % sampled_every == 0
        out.append((f"q{i}", rng.randint(0, 64, rng.randint(3, 12)).tolist(),
                    int(rng.randint(4, 13)),
                    {"temperature": 0.9, "top_k": 8} if sampled else {}))
    return out


def _wait_for(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out waiting for {what}")
        time.sleep(0.05)


def test_fleet_serves_the_references_greedy_streams(tmp_path):
    """One rank, the reference's weights as hot-swap version 1: greedy
    streams by the margin rule against the reference's ``generate``,
    sampled streams their budgets, the flip reported by the rank."""
    jm = jax_gpt("nano", dtype=jnp.float32, **SMALL)
    params = jm.init(jax.random.PRNGKey(11), jnp.zeros((1, 8), jnp.int32))
    state = params_from_jax(jax.tree_util.tree_map(np.asarray, params))
    wdir = str(tmp_path / "weights")
    job = ServeJob(_spec(weights_dir=wdir, swap_poll_steps=1), np=1,
                   env=WORKER_ENV, timeout=FLEET_TIMEOUT).start()
    try:
        kv = KVStoreClient(job.addr, job.secret)
        publish_weights(wdir, state, 1, kv=kv)
        _wait_for(lambda: kv.get("serve", "weight_version") == b"1", 60,
                  "the flip to weight version 1")
        reqs = _requests(0, 8, sampled_every=4)
        for rid, prompt, new, kw in reqs:
            job.client.submit(prompt, max_new_tokens=new, rid=rid, **kw)
        docs = {rid: job.client.result(rid, timeout=60)
                for rid, _, _, _ in reqs}
        results, ejob = job.stop(timeout=60)
    finally:
        job.shutdown()
    compared = 0
    for rid, prompt, new, kw in reqs:
        toks = docs[rid]["tokens"]
        assert len(toks) == new and all(0 <= t < 64 for t in toks)
        if kw:
            continue
        want = np.asarray(jax_generate(jm.cfg, params,
                                       jnp.asarray([prompt], jnp.int32),
                                       new))[0].tolist()
        scores = teacher_scores(jm, params, prompt, want)
        compared += check_margin(toks, want, scores, MARGIN)
    assert compared >= 30
    (summary,) = results.values()
    assert summary["weight_version"] == 1
    assert len(summary["weight_flips"]) == 1
    assert summary["completed"] == len(reqs)
    assert summary["kernel_launches"] == {}
    assert [e[0] for e in ejob.trace] == ["spawn"]


def test_fleet_survives_a_leader_kill_with_zero_drops():
    reqs = _requests(1, 8)
    job = ServeJob(_spec(), np=2,
                   env=dict(WORKER_ENV,
                            HVDTPU_FAULT_SPEC="worker_exit:step=5:rank=0"),
                   timeout=FLEET_TIMEOUT).start()
    try:
        for rid, prompt, new, _ in reqs:
            job.client.submit(prompt, max_new_tokens=new, rid=rid)
        docs = {rid: job.client.result(rid, timeout=90)
                for rid, _, _, _ in reqs}
        results, ejob = job.stop(timeout=60)
    finally:
        job.shutdown()
    events = [e[0] for e in ejob.trace]
    assert events.count("failure") == 1 and events.count("respawn") == 1
    assert sorted(results) == [0, 1]
    assert any(d["epoch"] >= 1 for d in docs.values())
    model = build_model(_spec())
    with torch.inference_mode():
        for rid, prompt, new, _ in reqs:
            toks = docs[rid]["tokens"]
            assert len(toks) == new                      # no drop
            logits = model(torch.tensor([prompt + toks[:-1]]))[0]
            scores = logits[len(prompt) - 1:].numpy()
            check_margin(toks, scores.argmax(-1), scores, MARGIN)


def _endpoint(proc, timeout=60.0):
    deadline = time.monotonic() + timeout
    lines = []
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        lines.append(line)
        if line.startswith("[serve] ingest endpoint http://"):
            return line.split("http://", 1)[1].split()[0]
    raise AssertionError(f"no endpoint line: {lines}")


def test_hvdrun_serve_cli_serves_a_client():
    """``--elastic --serve`` with the worker CLI: the launcher prints the
    endpoint, takes its secret from ``HVDTPU_SECRET``, forwards the
    ``--serve-*`` flags as env, and the rank's summary comes back."""
    secret = "f00d" * 8
    cmd = [sys.executable, "-m", "horovod_tpu_torch.run", "--serve", "-np",
           "1", "--serve-slots", "2", "--serve-seed", "5", "--frontends",
           "2", "--", sys.executable, "-m", "horovod_tpu_torch.serve",
           "--cpu", "--size", "nano"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, **WORKER_ENV,
                                 "HVDTPU_SECRET": secret}, cwd=str(REPO))
    try:
        client = ServeClient(_endpoint(proc), secret)
        assert client.frontends() == 2
        rids = [client.submit([1, 2, 3 + i], max_new_tokens=4, rid=f"c{i}")
                for i in range(3)]
        docs = [client.result(r, timeout=90) for r in rids]
        client.stop()
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out[-3000:]
    assert all(len(d["tokens"]) == 4 for d in docs)
    summaries = [json.loads(ln[3:])["serve_summary"]
                 for ln in out.splitlines() if ln.startswith("[0]{")]
    assert len(summaries) == 1 and summaries[0]["completed"] == 3
    assert summaries[0]["frontends"] == 2


def test_bench_serve_lands_the_references_record_fields(monkeypatch):
    from horovod_tpu_torch import bench
    from horovod_tpu_torch.bench import _parser, serve_main

    monkeypatch.setattr(bench, "SERVE_TIMEOUT", FLEET_TIMEOUT)
    args = _parser().parse_args([
        "--serve", "--cpu", "--model", "gpt-nano", "--serve-requests", "6",
        "--serve-rate", "20"])
    env = {k: os.environ.get(k) for k in WORKER_ENV}
    os.environ.update(WORKER_ENV)
    try:
        record = serve_main(args)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    assert record["metric"] == "serve_nano_tokens_per_sec"
    assert record["value"] == record["serve"]["tokens_per_sec"] > 0
    served = record["serve"]
    for key in ("np", "width", "frontends", "groups", "slots", "requests",
                "arrival_rate_per_sec", "total_tokens", "tokens_per_sec",
                "sustained_tokens_per_sec", "ttft_ms", "tpot_ms",
                "frontdoor", "completed_per_rank", "admitted_while_busy",
                "kv", "requests_per_sec"):
        assert key in served, key
    assert served["completed_per_rank"]["0"] == 6 + 3      # + warm-up
    assert set(served["ttft_ms"]) == {"p50", "p90", "p99"}
    assert record["degraded"] is True
