"""``benchmark/phases.py`` on a synthetic Chrome trace, on the CPU:

    python -m pytest benchmark/tests -q

Three steps of the harness's spans (the first left out of the window),
each holding the program's ``hvd.*`` ranges, the launches of its device
ops (``cudaLaunchKernel`` and ``cuLaunchKernel``, the backward's from
another thread, a bucket's collective inside the backward) and the ops
themselves, lagging their launches on the device's clock.  Checked: each
phase reading, the relabelled idle gaps, a trace without the program's
ranges, and the pin: ``trace.Profile`` and the five accepted readers read
the same values with and without the ``hvd.*`` ranges, and
:class:`~benchmark.phases.PhaseProfile` reads them too.
"""

from __future__ import annotations

import pytest

from benchmark import phases, session
from benchmark.common import Cell
from benchmark.trace import Profile

MAIN, AUTOGRAD = 1, 2


def _span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _launch(corr, ts, tid=MAIN, driver=False):
    return {"ph": "X", "cat": "cuda_driver" if driver else "cuda_runtime",
            "name": "cuLaunchKernel" if driver else "cudaLaunchKernel",
            "ts": ts, "dur": 3, "pid": 1, "tid": tid,
            "args": {"correlation": corr}}


def _op(cat, name, corr, ts, dur, stream=7):
    args = {"stream": stream}
    if corr is not None:
        args["correlation"] = corr
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": stream, "args": args}


def _events(program: bool) -> list:
    """Three steps of 1000 µs; with ``program`` the ``hvd.*`` ranges."""
    ev = []
    for k in range(3):
        t, c = 1000.0 * k, 100 * k
        ev += [_span("bench.step", t, 900), _span("bench.issue", t, 500),
               _span("bench.loss_read", t + 500, 390)]
        if program:
            ev += [_span("hvd.step", t + 10, 480),
                   _span("hvd.forward", t + 20, 130),
                   _span("hvd.backward", t + 160, 140),
                   _span("hvd.bucket", t + 260, 10, AUTOGRAD),
                   _span("hvd.grad_reduce", t + 310, 40),
                   _span("hvd.optimizer", t + 360, 90),
                   _span("hvd.loss_reduce", t + 460, 20)]
        ev += [
            # forward: a BatchNorm kernel, a driver-launched convolution
            _launch(c + 1, t + 30),
            _op("kernel", "batch_norm_collect_statistics", c + 1, t + 40,
                100),
            _launch(c + 2, t + 100, driver=True),
            _op("kernel", "conv_fprop", c + 2, t + 140, 60),
            # backward, launched from autograd's thread
            _launch(c + 3, t + 200, AUTOGRAD),
            _op("kernel", "bn_bw_reduce", c + 3, t + 200, 120),
            _launch(c + 4, t + 250, AUTOGRAD),
            _op("kernel", "elementwise_add", c + 4, t + 320, 80),
            # a bucket's collective, issued inside the backward
            _launch(c + 5, t + 265, AUTOGRAD),
            _op("kernel", "ncclDevKernel_AllReduce", c + 5, t + 300, 30,
                stream=9),
            # the gradient reduction's copy, the update, the loss's mean
            _launch(c + 6, t + 320),
            _op("gpu_memcpy", "Memcpy DtoD", c + 6, t + 400, 10),
            _launch(c + 7, t + 400),
            _op("kernel", "sgd_foreach", c + 7, t + 420, 50),
            _launch(c + 8, t + 470),
            _op("gpu_memset", "Memset (Device)", c + 8, t + 470, 5),
            # the harness's loss read, and an op with no launch in the
            # trace
            _launch(c + 9, t + 505),
            _op("gpu_memcpy", "Memcpy DtoH", c + 9, t + 510, 5),
            _op("kernel", "unlaunched", None, t + 600, 10),
        ]
    return ev


# What the parent's trace.Profile and readers give on this trace, with and
# without the hvd.* ranges.
BUSY_US = 880.0
DEVICE_OPS = [["bn_bw_reduce", 0.00024], ["batch_norm_collect_statistics",
                                          0.0002],
              ["elementwise_add", 0.00016], ["conv_fprop", 0.00012],
              ["sgd_foreach", 0.0001], ["ncclDevKernel_AllReduce", 6e-05],
              ["Memcpy DtoD", 2e-05], ["unlaunched", 2e-05],
              ["Memset (Device)", 1e-05], ["Memcpy DtoH", 1e-05]]
IDLE_GAPS = [["bench.loss_read", 0.00043], ["bench.loss_read", 0.00029],
             ["bench.loss_read", 8.5e-05], ["bench.loss_read", 8.5e-05],
             ["bench.issue", 4e-05], ["bench.issue", 3.5e-05],
             ["bench.issue", 3.5e-05], ["bench.issue", 1e-05],
             ["bench.issue", 1e-05]]
READINGS = {"mfu.resnet": 9.478875114643163,
            "host_issue_ms.resnet": 31.0,
            "step_ms_p95.resnet": 67.9,
            "bn_device_ms.resnet": 0.22,
            "device_idle.resnet": 53.68421052631579}


def _readings(profile) -> dict:
    cell = Cell("resnet50.b256.1gpu")
    window = session.Window()
    window.issue_s = [0.030, 0.031, 0.032]
    window.step_s = [0.066, 0.067, 0.068]
    window.seconds = 0.201
    fam = session.family(cell.config["family"])
    return session.per_layer(cell, fam, window, profile)


@pytest.mark.parametrize("kind, program", [
    (Profile, False), (Profile, True), (phases.PhaseProfile, True)])
def test_accepted_readings_are_pinned(kind, program):
    p = kind(_events(program), 3)
    assert p.steps == 2
    assert p.busy_us() == BUSY_US
    out = p.breakdown()
    assert out["device_ops"] == DEVICE_OPS
    if kind is Profile:
        assert out["idle_gaps"] == IDLE_GAPS
    else:   # the same gaps, relabelled
        assert [us for _, us in out["idle_gaps"]] == \
            [us for _, us in IDLE_GAPS]
    assert _readings(p) == READINGS


def test_phase_readings():
    p = phases.PhaseProfile(_events(True), 3)
    assert p.launched.count(None) == 2          # the unlaunched op, twice
    got = phases.readings(p)
    assert got == pytest.approx({
        "fwd_device_ms": 0.160,
        # autograd's thread launched these, inside hvd.backward
        "bwd_device_ms": 0.200,
        # the copy, the loss's memset and the bucket's collective, which
        # hvd.bucket holds inside hvd.backward
        "reduce_device_ms": 0.045,
        "opt_device_ms": 0.050,
        # idle inside hvd.step: before the first kernel, between the
        # copy and the update, after the memset
        "host_gap_ms": 0.055}, abs=1e-12)
    # the four phases, the loss read's copy and the unlaunched op make
    # the busy time, less the collective that ran beside the backward
    outside = p.phase_device_ms((None,))
    assert outside == pytest.approx(0.005)
    assert sum(got[k] for k in phases.PHASES) + outside + 0.010 - 0.030 == \
        pytest.approx(p.busy_us() / 1e3 / p.steps)


def test_top_ops_of_a_phase():
    p = phases.PhaseProfile(_events(True), 3)
    assert p.top_ops(phases.PHASES["reduce_device_ms"]) == [
        ["ncclDevKernel_AllReduce", 0.03], ["Memcpy DtoD", 0.01],
        ["Memset (Device)", 0.005]]
    assert [n for n, _ in p.top_ops(("hvd.backward",), 1)] == \
        ["bn_bw_reduce"]


def test_idle_gaps_take_the_program_range():
    p = phases.PhaseProfile(_events(True), 3)
    labels = sorted(p.idle_gaps(), key=lambda g: -g[1])
    assert [n for n, _ in labels] == [
        "bench.loss_read", "bench.loss_read", "bench.loss_read",
        "bench.loss_read", "hvd.forward", "bench.issue", "bench.issue",
        "hvd.optimizer", "hvd.optimizer"]
    base = Profile(_events(True), 3).idle_gaps()
    assert [us for _, us in p.idle_gaps()] == [us for _, us in base]


def test_a_program_without_ranges_reads_nothing():
    p = phases.PhaseProfile(_events(False), 3)
    assert phases.readings(p) == {}
    assert p.idle_gaps() == Profile(_events(False), 3).idle_gaps()
