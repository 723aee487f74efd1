"""The training step's phase spans (``obs/trace.py``'s ``phase``), on the
CPU in a gloo world of one.

``train.build_step`` (resnet18, batch 2, 32²) and ``train.build_gpt_step``
(gpt-nano) run three steps each three ways: with no profiler and no
``HVDTPU_TRACE``, under ``torch.profiler`` (CPU activity) and under
``HVDTPU_TRACE``.

* under the profiler, each step is one ``hvd.step`` range holding
  ``hvd.forward``, ``hvd.backward``, ``hvd.grad_reduce``,
  ``hvd.optimizer`` and ``hvd.loss_reduce``, in that order, disjoint;
* under ``HVDTPU_TRACE`` the same phases are ring spans of trace
  ``train.steps``, the step's carrying its 1-based ``step``;
* with neither, no ``record_function`` is entered and no ring is made;
* the losses are the same bit for bit all three ways;
* an ``OverlapPlan`` ``bucket`` step shows ``grad_reduce``, one
  ``bucket`` phase a bucket inside the backward, and one ring span
  ``overlap/bucket{i}`` of positive duration a bucket (its fill);
* ``trace_merge`` lanes a training dump as steps: no request, and no
  training ``step`` span in the serving tpot decomposition.
"""

from __future__ import annotations

import json
import os

import pytest

import _torch_world
from horovod_tpu_torch.obs import trace, trace_merge

STEPS = 3
PHASES = ("forward", "backward", "grad_reduce", "optimizer", "loss_reduce")
BUCKET_MB = 1.0       # gpt-nano (fp32) in a few buckets of many leaves
EPS_US = 1e-2         # the profiler's trace rounds times to the ns


def _build(model: str, overlap_mode: str = "off"):
    import torch

    from horovod_tpu_torch.train import build_gpt_step, build_step

    torch.manual_seed(0)
    if model == "resnet18":
        return build_step("resnet18", "fp32", 2, 32, device="cpu")
    return build_gpt_step("nano", "fp32", 2, 16, overlap_mode=overlap_mode,
                          grad_bucket_mb=BUCKET_MB, device="cpu")


def _steps(step, state, static, n: int) -> list:
    losses = []
    for _ in range(n):
        *carry, loss = step(*state)
        state = tuple(carry) + state[static["carry_len"]:]
        losses.append(loss.item())
    return losses


def _profiled(run, path: str) -> tuple:
    """``run()`` under ``torch.profiler``: its value and the ``hvd.*``
    ranges of the Chrome trace as ``(name, start, end)`` (µs), in the
    order they start."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = run()
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, sorted(
        ((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
         for e in events
         if e.get("ph") == "X" and e.get("cat") == "user_annotation"
         and e.get("name", "").startswith("hvd.")), key=lambda r: r[1])


def phases_worker(model: str, out_dir: str) -> dict:
    """The three ways of module docstring, each on a fresh build."""
    from torch.autograd import profiler

    entered = [0]

    class counted(profiler.record_function):
        # torch.optim opens ranges of its own on every step and zero_grad
        def __enter__(self):
            entered[0] += self.name.startswith("hvd.")
            return super().__enter__()

    profiler.record_function = counted
    os.environ.pop("HVDTPU_TRACE", None)
    res = {"off": _steps(*_build(model), STEPS)}
    res["entered_off"] = entered[0]
    res["ring_made_off"] = trace._buffer is not None

    built = _build(model)
    res["profiled"], res["ranges"] = _profiled(
        lambda: _steps(*built, STEPS), os.path.join(out_dir, "prof.json"))
    res["entered_profiled"] = entered[0]

    os.environ["HVDTPU_TRACE"] = os.path.join(out_dir, "spans") + os.sep
    try:
        trace.reset_buffer()
        res["ring"] = _steps(*_build(model), STEPS)
        res["spans"] = trace.get_buffer().snapshot()
        res["dump"] = trace.flush()
    finally:
        os.environ.pop("HVDTPU_TRACE")
        trace.reset_buffer()
    return res


def bucket_worker(out_dir: str) -> dict:
    """Two ``bucket`` steps of gpt-nano under ``HVDTPU_TRACE``, then one
    under the profiler: the ring spans, the ranges and the layout."""
    step, state, static = _build("nano", "bucket")
    plan = state[1]
    os.environ["HVDTPU_TRACE"] = os.path.join(out_dir, "spans") + os.sep
    try:
        trace.reset_buffer()
        _steps(step, state, static, 2)
        spans = trace.get_buffer().snapshot()
    finally:
        os.environ.pop("HVDTPU_TRACE")
        trace.reset_buffer()
    _, ranges = _profiled(lambda: _steps(step, state, static, 1),
                          os.path.join(out_dir, "prof.json"))
    return {"spans": spans, "ranges": ranges,
            "buckets": [(b.nbytes, len(b.sizes))
                        for b in plan.layout.buckets]}


@pytest.fixture(scope="module", params=["resnet18", "nano"])
def phases(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(request.param)
    return _torch_world.run_world(phases_worker, (request.param, str(out)),
                                  world=1, timeout=240)[0]


def _inside(inner, outer, eps=EPS_US) -> bool:
    return outer[1] - eps <= inner[1] and inner[2] <= outer[2] + eps


def _assert_in_order(spans, eps) -> None:
    """Each of ``spans`` (``(name, start, end)``) ends before the next
    starts."""
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1] + eps, (a, b)


def test_profiler_ranges_nest_each_step(phases):
    ranges = phases["ranges"]
    steps = [r for r in ranges if r[0] == "hvd.step"]
    assert len(steps) == STEPS
    _assert_in_order(steps, EPS_US)
    for s in steps:
        inner = [r for r in ranges if r[0] != "hvd.step" and _inside(r, s)]
        assert [r[0] for r in inner] == [f"hvd.{p}" for p in PHASES]
        _assert_in_order(inner, EPS_US)
    # nothing of the program's outside its steps
    assert all(any(_inside(r, s) for s in steps) for r in ranges)


def test_ring_spans_nest_each_step(phases):
    spans = [(s["name"], s["t0"], s["t0"] + s["dur"], s)
             for s in phases["spans"] if s["trace"] == trace.TRAIN_TRACE]
    steps = sorted((s for s in spans if s[0] == "step"),
                   key=lambda s: s[1])
    assert [s[3]["args"]["step"] for s in steps] == list(range(1, STEPS + 1))
    for s in steps:
        inner = sorted((r for r in spans if r[0] != "step"
                        and _inside(r, s, 1e-6)), key=lambda r: r[1])
        assert [r[0] for r in inner] == list(PHASES)
        _assert_in_order(inner, 1e-6)
    assert len(spans) == STEPS * (1 + len(PHASES))


def test_no_range_and_no_ring_when_off(phases):
    assert phases["entered_off"] == 0
    assert not phases["ring_made_off"]
    # the counter sees the ranges when a profiler records
    assert phases["entered_profiled"] == STEPS * (1 + len(PHASES))


def test_losses_bitwise_the_same_off_and_on(phases):
    assert phases["off"] == phases["profiled"] == phases["ring"]
    assert len(set(phases["off"])) == STEPS   # the steps train


def test_training_dump_is_no_request(phases):
    doc = trace_merge.report([phases["dump"]])
    assert doc["requests"] == {}
    assert doc["tpot_components"] == {}


def test_training_step_spans_feed_no_serving_component(phases, tmp_path):
    """A serving rank's dump with training spans of the same step numbers
    beside it reads the same tpot decomposition as without them."""
    serving = [
        {"trace": "serve.steps", "name": name, "t0": 100.0 + step,
         "dur": dur, "epoch": 0, "args": {"step": step}}
        for step in (1, 2, 3)
        for name, dur in (("step", 0.009), ("decode_compute", 0.006))]
    training = [s for s in phases["spans"] if s["trace"] == trace.TRAIN_TRACE]
    assert {s["args"]["step"] for s in training if s["name"] == "step"} \
        == {1, 2, 3}
    reports = []
    for spans in (serving, serving + training):
        path = tmp_path / f"spans.rank.{len(reports)}.json"
        path.write_text(json.dumps({"rank": 0, "spans": spans}))
        reports.append(trace_merge.report([str(path)]))
    assert reports[0]["tpot_components"]["scheduler"]["p50"] == 3.0
    assert reports[1] == reports[0]


def test_waterfall_lanes_training_as_steps(phases, tmp_path):
    out = str(tmp_path / "wf.json")
    assert trace_merge.merge([phases["dump"]], out) == len(phases["spans"])
    events = json.load(open(out))
    lanes = {e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    assert lanes == {trace.TRAIN_TRACE}


@pytest.fixture(scope="module")
def bucket(tmp_path_factory):
    out = tmp_path_factory.mktemp("bucket")
    return _torch_world.run_world(bucket_worker, (str(out),), world=1,
                                  timeout=240)[0]


def test_bucket_plan_spans(bucket):
    n = len(bucket["buckets"])
    assert n > 1
    spans = bucket["spans"]
    fills = [s for s in spans if s["trace"] == "overlap"]
    assert sorted(s["name"] for s in fills) == sorted(
        f"bucket{i}" for i in range(n) for _ in range(2))
    for s in fills:
        i = s["args"]["bucket"]
        assert s["name"] == f"bucket{i}" and s["dur"] > 0
        assert (s["args"]["bytes"], s["args"]["leaves"]) == \
            tuple(bucket["buckets"][i])
        assert s["args"]["mode"] == "bucket"
    phases = [s for s in spans if s["trace"] == trace.TRAIN_TRACE]
    names = [s["name"] for s in phases]
    for name, count in (("step", 2), ("grad_reduce", 2), ("optimizer", 2),
                        ("bucket", 2 * n)):
        assert names.count(name) == count, name
    # each fill ends where its bucket's issue begins
    issues = sorted((s["args"]["bucket"], s["t0"]) for s in phases
                    if s["name"] == "bucket")
    ends = sorted((s["args"]["bucket"], s["t0"] + s["dur"]) for s in fills)
    assert all(e <= t + 1e-6 for (_, e), (_, t) in zip(ends, issues))

    ranges = bucket["ranges"]
    backward = [r for r in ranges if r[0] == "hvd.backward"]
    issued = [r for r in ranges if r[0] == "hvd.bucket"]
    assert len(backward) == 1 and len(issued) == n
    assert all(_inside(r, backward[0]) for r in issued)
    assert [r[0] for r in ranges].count("hvd.grad_reduce") == 1
