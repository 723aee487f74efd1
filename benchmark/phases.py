"""The traced steps split by the program's phases: the device time of the
kernels, copies and memsets each phase launched, and the device's idle
time inside the program's steps.

    python3 -m benchmark.phases --workload <name> --seed <n> [--steps <k>]

from the root of a checkout, on a machine with a card: builds the cell's
program, runs its check and warm-up steps, traces ``--steps`` more (the
traffic's ``profile_steps`` by default; the first is left out of the
window, as in ``trace.Profile``) under ``torch.profiler`` inside the
harness's spans, and prints one JSON line of the readings below.

The phases are the ``hvd.*`` ranges that ``horovod_tpu_torch``'s
``obs.trace.phase`` opens while a profiler records: ``hvd.step`` holds
``hvd.forward``, ``hvd.backward``, ``hvd.grad_reduce``, ``hvd.optimizer``
and ``hvd.loss_reduce``; ``hvd.bucket`` holds a bucket's collective.  A
device op belongs to the innermost range open at the host time of the
launch that issued it (the runtime or driver call of the same
``correlation``), whatever thread launched it: the backward's kernels
are launched by autograd's device thread while the main thread is inside
``hvd.backward``.

The harness's per-layer readers do not read these numbers: they read a
``trace.Profile``, which keeps neither the program's ranges nor the
launches.  :class:`PhaseProfile` is that profile with both.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile

from .trace import DEVICE_CATS, NAME_CHARS, Profile, merged, total

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PREFIX = "hvd."
# each device-ms reading and the ranges whose ops it sums
PHASES = {
    "fwd_device_ms": ("hvd.forward",),
    "bwd_device_ms": ("hvd.backward",),
    "reduce_device_ms": ("hvd.grad_reduce", "hvd.loss_reduce", "hvd.bucket"),
    "opt_device_ms": ("hvd.optimizer",),
}


class PhaseProfile(Profile):
    """A :class:`~benchmark.trace.Profile` (its ops, spans, window and
    readings unchanged) that also keeps the program's ``hvd.*`` ranges
    (``ranges``: ``(start, end, name)`` by start) and, beside each of its
    ``ops``, the host time of the launch that issued it (``launched``;
    None where the trace holds no launch of that correlation)."""

    def __init__(self, events: list, steps: int):
        super().__init__(events, steps)
        launch_at = {}
        ranges = []
        launched = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            if cat in LAUNCH_CATS:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch_at[corr] = float(e["ts"])
            elif cat == "user_annotation" and \
                    e.get("name", "").startswith(PREFIX):
                ts = float(e["ts"])
                ranges.append((ts, ts + float(e["dur"]), e["name"]))
        for e in events:
            if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS:
                ts = float(e["ts"])
                if ts + float(e["dur"]) > self.start and ts < self.end:
                    launched.append(launch_at.get(
                        (e.get("args") or {}).get("correlation")))
        if len(launched) != len(self.ops):
            raise RuntimeError("the device ops and their launches differ "
                               "in number")
        self.ranges = sorted(ranges)
        self.launched = launched

    def phase_at(self, t: float):
        """The innermost ``hvd.*`` range open at host time ``t`` (the
        latest to start of those that hold it), or None."""
        inner = None
        for s, e, name in self.ranges:
            if s > t:
                break
            if t < e:
                inner = name
        return inner

    def idle(self) -> list:
        """The window's stretches with no device op, as ``(start, end)``."""
        busy = merged((s, e) for _, s, e, _ in self.ops)
        edges = [self.start] + [x for iv in busy for x in iv] + [self.end]
        return [(s, e) for s, e in zip(edges[::2], edges[1::2]) if e > s]

    def idle_gaps(self) -> list:
        """:meth:`Profile.idle_gaps`, but a gap whose middle lies inside a
        ``hvd.*`` range takes the innermost one's name."""
        return [(self.phase_at((s + e) / 2) or label, us)
                for (label, us), (s, e) in zip(super().idle_gaps(),
                                               self.idle())]

    def ops_of(self, names) -> list:
        """The ops whose launch lies in a range of ``names`` and in none
        inside it (``(None,)``: in no range)."""
        return [op for op, t in zip(self.ops, self.launched)
                if t is not None and self.phase_at(t) in names]

    def phase_device_ms(self, names) -> float:
        """Device ms a traced step of :meth:`ops_of` (their union)."""
        return total((s, e) for _, s, e, _ in self.ops_of(names)) \
            / 1e3 / self.steps

    def top_ops(self, names, n: int = 5) -> list:
        """The ``n`` device ops of :meth:`ops_of` (by name, ms a traced
        step) that took most time."""
        by_name: dict = {}
        for op, s, e, _ in self.ops_of(names):
            by_name[op] = by_name.get(op, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[op[:NAME_CHARS], us / 1e3 / self.steps] for op, us in top]

    def host_gap_ms(self) -> float:
        """Device-idle ms a traced step inside the program's ``hvd.step``
        ranges: the card waiting on the step's own host issue, not on the
        harness's read of the loss."""
        steps = merged((s, e) for s, e, n in self.ranges if n == "hvd.step")
        return sum(max(0.0, min(e, b) - max(s, a))
                   for s, e in self.idle() for a, b in steps) \
            / 1e3 / self.steps


def readings(p: PhaseProfile) -> dict:
    """The phase split of a traced run; empty where the program opened no
    ``hvd.step`` range (a program without phase spans)."""
    if not any(n == "hvd.step" for _, _, n in p.ranges):
        return {}
    out = {name: p.phase_device_ms(names) for name, names in PHASES.items()}
    out["host_gap_ms"] = p.host_gap_ms()
    return out


def traced_events(run_step, steps: int, sync) -> list:
    """The Chrome trace's events of ``steps`` calls of ``run_step(span)``
    under ``torch.profiler`` (CPU and CUDA activity), as
    ``trace.profile_steps`` traces them; the file goes to a temporary one
    under ``TMPDIR``, deleted once read."""
    from torch.profiler import (  # noqa: PLC0415
        ProfilerActivity, profile, record_function)

    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            run_step(record_function)
        sync()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_phases_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.phases")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=None,
                   help="steps traced (default: the traffic's "
                        "profile_steps)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from .common import HERE, Cell, family, load_json, log  # noqa: PLC0415

    cell = Cell(args.workload)
    import torch  # noqa: PLC0415

    if cell.chips != 1 or not torch.cuda.is_available():
        log(f"{cell.name} needs one CUDA device here")
        return 2
    traffic = cell.traffic
    steps = args.steps or traffic["profile_steps"]
    prog = family(cell.config["family"]).Program(cell.config, traffic,
                                                 args.seed)
    dev = next(prog.model.parameters()).device
    at = [0]
    for _ in range(traffic["check_steps"] + traffic["warmup_steps"]):
        prog.step(at[0]).item()
        at[0] += 1

    def run_step(span):
        with span("bench.step"):
            with span("bench.issue"):
                loss = prog.step(at[0])
            with span("bench.loss_read"):
                loss.item()
        at[0] += 1

    events = traced_events(run_step, steps,
                           lambda: torch.cuda.synchronize(dev))
    prog.close()
    from horovod_tpu_torch import shutdown  # noqa: PLC0415

    shutdown()
    p = PhaseProfile(events, steps)
    per_step = 1e3 * p.steps
    bn = load_json(HERE / "metrics" / "bn_device_ms.json")["kernels"]
    issue = [(e - s) / 1e3 for s, e in p.spans["bench.issue"]
             if s >= p.start]
    out = {"device": torch.cuda.get_device_name(0), "steps": p.steps,
           **readings(p),
           "outside_ms": p.phase_device_ms((None,)),
           "busy_ms": p.busy_us() / per_step,
           "window_ms": p.window_us / per_step,
           "device_idle": 100.0 * (1.0 - p.busy_us() / p.window_us),
           "bn_device_ms": total((s, e) for _, s, e, _ in p.matching(bn))
           / per_step,
           "issue_ms_median": statistics.median(issue),
           "issue_ms": issue,
           "unlaunched_ops": sum(t is None for t in p.launched),
           "top_ops": {name: p.top_ops(names)
                       for name, names in PHASES.items()},
           "idle_gaps": p.breakdown()["idle_gaps"]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
