"""The port's serving autoscale (``horovod_tpu_torch/serve/autoscale.py``
and its launcher wiring) held against the reference's
(``horovod_tpu/serve/autoscale.py``).

The policy, config, world token, Prometheus and ``gauges_from_views``
cases of ``tests/test_autoscale_swap.py:63-226`` run as the same decision
sequences through both packages, which must decide alike step for step
(the policy is a pure function of its observations).  Two CPU fleets of a
tiny fp32 GPT (``ServeJob``, 1 slot) then run the grow/drain story of
``:407-455``: a backlog grows the world 1 -> 2 through a re-minted epoch,
the drain shrinks it back, no request is dropped and every stream equals
the model's own ``generate`` token for token; and, with
``scale_admit:action=scale_fail``, the first grow is refused, the policy
backs off, and the next grow goes through.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu.obs.registry import MetricsRegistry as JRegistry
from horovod_tpu.serve import autoscale as jautoscale
from horovod_tpu_torch.obs import get_registry
from horovod_tpu_torch.obs.registry import MetricsRegistry
from horovod_tpu_torch.serve import ServeJob
from horovod_tpu_torch.serve import autoscale
from horovod_tpu_torch.testing import faults

REPO = Path(__file__).resolve().parent.parent
PKGS = ((autoscale, MetricsRegistry), (jautoscale, JRegistry))


def _cfg(mod, **kw):
    base = dict(min_workers=1, max_workers=4, scale_up_queue=4,
                up_window_secs=1.0, scale_down_idle_secs=5.0,
                up_cooldown_secs=10.0, down_cooldown_secs=10.0,
                backoff_base_secs=2.0, backoff_max_secs=60.0)
    base.update(kw)
    return mod.AutoscaleConfig(**base)


def _decide(cfg_kw, script):
    """Run ``script(policy)`` -> list of outcomes through both packages'
    policies; they must agree (decisions, traces); returns the port's."""
    outs = []
    for mod, _ in PKGS:
        p = mod.AutoscalePolicy(_cfg(mod, **cfg_kw))
        got = [None if d is None else
               (d.direction, d.target) if hasattr(d, "direction") else d
               for d in script(p)]
        outs.append((got, list(p.trace)))
    assert outs[0] == outs[1]
    return outs[0]


def _obs(p, t, q, a, w, **kw):
    return p.observe(t, queue_depth=q, active_slots=a, world_size=w, **kw)


def test_policy_grow_needs_sustained_pressure():
    got, _ = _decide({}, lambda p: [
        _obs(p, 0.0, 9, 4, 2),    # one pressured round is a spike
        _obs(p, 0.5, 0, 0, 2),    # interrupted: the window restarts
        _obs(p, 0.6, 9, 4, 2),
        _obs(p, 1.5, 9, 4, 2),    # only 0.9 s sustained
        _obs(p, 1.7, 9, 4, 2),
    ])
    assert got == [None, None, None, None, ("up", 3)]


def test_policy_up_cooldown_blocks_consecutive_grows():
    got, _ = _decide({}, lambda p: [
        _obs(p, 0.0, 9, 4, 2), _obs(p, 1.0, 9, 4, 2),
        _obs(p, 2.5, 9, 4, 3), _obs(p, 10.5, 9, 4, 3),
        _obs(p, 12.1, 9, 4, 3),
    ])
    assert got == [None, ("up", 3), None, None, ("up", 4)]


def test_policy_envelope_caps_both_directions():
    got, _ = _decide({"max_workers": 2}, lambda p: [
        _obs(p, 0.0, 9, 4, 2), _obs(p, 2.0, 9, 4, 2)])
    assert got == [None, None]  # already at max
    got, _ = _decide({"min_workers": 2}, lambda p: [
        _obs(p, 0.0, 0, 0, 2), _obs(p, 20.0, 0, 0, 2)])
    assert got == [None, None]  # already at min


def test_policy_shrink_needs_sustained_idle_and_cooldown():
    got, _ = _decide({}, lambda p: [
        _obs(p, 0.0, 0, 0, 3), _obs(p, 3.0, 0, 1, 3),  # a busy blip
        _obs(p, 3.1, 0, 0, 3), _obs(p, 7.0, 0, 0, 3),
        _obs(p, 8.2, 0, 0, 3),
    ])
    assert got == [None, None, None, None, ("down", 2)]


def test_policy_no_flapping_across_directions():
    """An up decision starts the cooldown for down too: never up, down
    within one cooldown window."""
    got, trace = _decide(
        {"up_window_secs": 0.1, "scale_down_idle_secs": 0.1}, lambda p: [
            _obs(p, 1.0, 9, 4, 2), _obs(p, 1.2, 9, 4, 2),
            *(_obs(p, t, 0, 0, 3) for t in (2.0, 5.0, 9.0, 11.0)),
            _obs(p, 11.4, 0, 0, 3),
        ])
    assert got == [None, ("up", 3), None, None, None, None, ("down", 2)]
    assert [e[1] for e in trace] == ["up", "down"]
    assert trace[1][0] - trace[0][0] >= 10.0


def test_policy_grow_failure_backs_off_exponentially():
    got, _ = _decide(
        {"up_window_secs": 0.1, "up_cooldown_secs": 0.1}, lambda p: [
            _obs(p, 1.0, 9, 4, 1), _obs(p, 1.2, 9, 4, 1),
            p.record_grow_failed(1.2),
            _obs(p, 2.0, 9, 4, 1),   # pressured, but backed off
            _obs(p, 3.5, 9, 4, 1),
            p.record_grow_failed(3.5), p.record_grow_failed(8.0),
            p.record_grow_ok(), p.record_grow_failed(20.0),
        ])
    assert got == [None, ("up", 2), 2.0, None, ("up", 2), 4.0, 8.0, None,
                   2.0]


def test_policy_ttft_pressure_when_configured():
    got, _ = _decide({"scale_up_ttft_ms": 500.0, "up_window_secs": 0.1},
                     lambda p: [_obs(p, 0.0, 0, 2, 1, ttft_p50_ms=900.0),
                                _obs(p, 0.2, 0, 2, 1, ttft_p50_ms=900.0)])
    assert got == [None, ("up", 2)]


@pytest.mark.parametrize("kw", [
    {"min_workers": 3, "max_workers": 2}, {"min_workers": 0,
                                           "max_workers": 2},
    {"min_workers": 1, "max_workers": 2, "scale_up_queue": 0},
    {"min_workers": 1, "max_workers": 2, "grow_step": 0},
])
def test_config_envelope_validated(kw):
    for mod, _ in PKGS:
        with pytest.raises(ValueError):
            mod.AutoscaleConfig(**kw)


@pytest.mark.parametrize("args", [(None, 4), (4, 4), (4, 6, 12), (6, 4),
                                  (None, 2, 0)])
def test_world_token_formats(args):
    assert autoscale.world_token(*args) == jautoscale.world_token(*args)
    assert autoscale.world_token(4, 6, 12) == "world 4→6 v=12"


def test_controller_prometheus_exposition():
    """The launcher-local series render the same exposition lines as the
    reference's (HELP/TYPE once per family, counters by direction)."""
    bodies = []
    for mod, reg_cls in PKGS:
        c = mod.AutoscaleController(_cfg(mod), registry=reg_cls())
        c.executed(mod.Decision("up", 3, "test"), epoch=1, world_size=3)
        c.executed(mod.Decision("down", 2, "test"), epoch=2, world_size=2)
        c.grow_failed(0.0, rank=3)
        bodies.append(c.prometheus())
    body = bodies[0]
    assert body == bodies[1]
    assert "hvdtpu_autoscale_world 2" in body.replace(".0", "")
    assert 'hvdtpu_autoscale_decisions{direction="up"} 1' in body
    assert 'hvdtpu_autoscale_decisions{direction="down"} 1' in body
    assert "hvdtpu_autoscale_backoffs 1" in body
    for family in ("hvdtpu_autoscale_world", "hvdtpu_autoscale_decisions",
                   "hvdtpu_autoscale_backoffs"):
        assert body.count(f"# TYPE {family} ") == 1
    assert body.endswith("\n")


class _V:
    def __init__(self, metrics):
        self.metrics = metrics


@pytest.mark.parametrize("views,world", [
    ({}, None),
    ({0: _V({"a": {"name": "serve.queue_depth", "value": 2},
             "b": {"name": "serve.active_slots", "value": 1}}),
      1: _V({"a": {"name": "serve.queue_depth", "value": 7},
             "c": {"name": "serve.ttft_ms", "count": 3, "p50": 40.0}})},
     None),
    # a released rank's frozen view is ignored
    ({0: _V({"a": {"name": "serve.queue_depth", "value": 0}}),
      3: _V({"a": {"name": "serve.queue_depth", "value": 9},
             "b": {"name": "serve.active_slots", "value": 4}})}, [0]),
    ({0: _V({"c": {"name": "serve.ttft_ms", "count": 0, "p50": None}})},
     None),
])
def test_gauges_from_views_silence_and_worst_rank(views, world):
    got = autoscale.gauges_from_views(views, world)
    assert got == jautoscale.gauges_from_views(views, world)
    if len(views) == 2 and world is None:
        assert got == {"queue_depth": 7, "active_slots": 1,
                       "ttft_p50_ms": 40.0}
    if world == [0]:
        assert got == {"queue_depth": 0, "active_slots": 0.0}


def test_controller_ticks_on_current_members_only():
    """The controller feeds the policy the current world's gauges only and
    publishes the world size it saw, as the reference's does."""
    views = {0: _V({"a": {"name": "serve.queue_depth", "value": 9},
                    "b": {"name": "serve.active_slots", "value": 1}}),
             5: _V({"a": {"name": "serve.queue_depth", "value": 0}})}
    for mod, reg_cls in PKGS:
        reg = reg_cls()
        c = mod.AutoscaleController(_cfg(mod, up_window_secs=0.0), reg)
        d = c.tick(1.0, views, [0])
        assert (d.direction, d.target) == ("up", 2)
        assert reg.gauge("autoscale.world").value == 1


# ---------------------------------------------------------------------------
# CPU fleets: grow under a backlog, drain-driven release, refused admission
# ---------------------------------------------------------------------------

TINY = dict(num_layers=1, num_heads=2, emb_dim=32, max_len=64,
            vocab_size=64, attention_impl="reference", dtype=torch.float32)
WORKER_ENV = {"PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
SCALE = {"scale_up_queue": 2, "up_window_secs": 0.2,
         "scale_down_idle_secs": 1.0, "up_cooldown_secs": 1.0,
         "down_cooldown_secs": 1.0, "backoff_base_secs": 1.0}


def _spec():
    return {"size": "nano", "overrides": dict(TINY), "seed": 3,
            "num_slots": 1, "idle_secs": 0.005, "device": "cpu"}


def _oracle(prompts, steps):
    """Each stream from the model's own greedy ``generate``."""
    from horovod_tpu_torch.models.decode import generate
    from horovod_tpu_torch.serve.service import build_model

    model = build_model(_spec())
    with torch.inference_mode():
        return [generate(model, torch.tensor([p]), s)[0].tolist()
                for p, s in zip(prompts, steps)]


def _fleet_story(n_req: int):
    """A 1-slot fleet of one rank (up to 2) under a backlog of
    ``n_req`` 24-token requests; waits for the drain-driven release,
    then stops.  Returns (prompts, steps, docs, results, trace)."""
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, 64, rs.randint(3, 9)).tolist()
               for _ in range(n_req)]
    steps = [24] * n_req
    job = ServeJob(_spec(), np=1, min_workers=1, max_workers=2,
                   autoscale=dict(SCALE), live_stats_secs=0.2,
                   env=WORKER_ENV, timeout=150).start()
    try:
        rids = [job.client.submit(p, max_new_tokens=s)
                for p, s in zip(prompts, steps)]
        docs = [job.client.result(r, timeout=120) for r in rids]
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if get_registry().counter("autoscale.decisions",
                                      direction="down").value:
                break
            time.sleep(0.1)
        results, ejob = job.stop(timeout=60)
    finally:
        job.shutdown()
    return prompts, steps, docs, results, ejob.trace


@pytest.fixture
def launcher_registry():
    from horovod_tpu_torch.obs.registry import reset_registry

    reset_registry()
    faults.reset()
    yield
    reset_registry()
    faults.reset()


def test_fleet_grows_under_backlog_then_drains_and_releases(
        launcher_registry):
    """Grow through a re-minted epoch with requests in flight, drain-driven
    shrink releasing the standby; zero dropped, every stream generate's."""
    prompts, steps, docs, results, trace = _fleet_story(8)
    assert [d["tokens"] for d in docs] == _oracle(prompts, steps)
    events = [e[0] for e in trace]
    assert events.count("scale_up") == 1 and events.count("scale_down") == 1
    assert events.index("scale_up") < events.index("scale_down")
    assert "failure" not in events           # resizes are not failures
    up = next(e for e in trace if e[0] == "scale_up")
    assert up[2] == (1,)                      # the standby rank admitted
    assert results[1].get("released") is True
    assert results[0]["completed"] == len(prompts)
    reg = get_registry()
    assert reg.counter("autoscale.decisions", direction="up").value == 1
    assert reg.gauge("autoscale.world").value == 1


def test_refused_admission_backs_off_then_grows(launcher_registry,
                                                 monkeypatch):
    """``scale_admit:action=scale_fail`` refuses the first admission: the
    controller backs off (one ``autoscale.backoffs``) and a later grow
    goes through; still zero dropped."""
    monkeypatch.setenv(faults.SPEC_ENV, "scale_admit:action=scale_fail")
    prompts, steps, docs, results, trace = _fleet_story(10)
    assert [d["tokens"] for d in docs] == _oracle(prompts, steps)
    events = [e[0] for e in trace]
    assert events.count("scale_fail") == 1
    assert events.index("scale_fail") < events.index("scale_up")
    assert get_registry().counter("autoscale.backoffs").value == 1
    assert results[0]["completed"] == len(prompts)
