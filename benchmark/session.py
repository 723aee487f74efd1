"""One run of a training cell on its card, and what follows the window:
the reference, the comparison that decides ``correct``, and the metrics.

The order of a run:

1. set-up: the program's entry builds its step; the seeded weights are
   loaded into it; the pool of seeded inputs is made on the device;
2. the check steps: the first ``check_steps`` steps, through the
   window's own call on the pool's first entries, read the losses, the
   first step's gradient from the optimizer's state, and each leaf's
   change after the last of them;
3. ``warmup_steps`` more steps, then the timed window: steps until
   ``--seconds`` have passed, each ending in the host's read of its loss;
4. with ``--trace 1``, ``profile_steps`` more steps under the profiler;
5. the peak of device memory, and the program's state freed.

The reference then works the check steps out again in float32 from the
same seeded weights and inputs, once the program's state is gone.
"""

from __future__ import annotations

import gc
import importlib.util
import math
import statistics
import time

from .common import HERE, family, load_json, log
from .families import leaf_norms


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear between order statistics)."""
    return statistics.quantiles(values, n=100, method="inclusive")[
        round(q) - 1] if len(values) > 1 else values[0]


def _sync(dev) -> None:
    import torch  # noqa: PLC0415

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Window:
    """The timed steps: ``issue_s`` (the call to its return), ``step_s``
    (the call to the host holding its loss) and the losses."""

    def __init__(self):
        self.issue_s: list = []
        self.step_s: list = []
        self.losses: list = []
        self.seconds = 0.0
        self.wall_start = 0.0


def timed_window(prog, first: int, seconds: float) -> Window:
    """Steps from pool entry ``first`` until ``seconds`` have passed on
    the host's clock."""
    w = Window()
    i = first
    w.wall_start = time.time()
    begin = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        loss = prog.step(i)
        t1 = time.perf_counter()
        value = loss.item()
        t2 = time.perf_counter()
        w.issue_s.append(t1 - t0)
        w.step_s.append(t2 - t0)
        w.losses.append(value)
        i += 1
        if t2 - begin >= seconds:
            w.seconds = time.perf_counter() - begin
            return w


class LayerContext:
    """What a per-layer reader reads: the cell (``config``, ``traffic``,
    ``family``), the traced run's unprofiled window (``window``), its
    profile (``profile``) and the reader's data (``data``, None where it
    has none)."""

    def __init__(self, cell, fam, window: Window, profile):
        self.config, self.traffic, self.family = cell.config, cell.traffic, fam
        self.window, self.profile = window, profile
        self.data = None


def reader(name: str):
    """The reader of metric ``name``, found by its base, the name up to
    its first dot (``mfu.resnet`` is read by ``mfu``): the ``read(ctx)``
    of ``metrics/<base>.py``, and its data: the kernel names of
    ``metrics/<base>.json`` and of any ``metrics/<base>.kernels-<tag>.json``
    (a later kernel is named in a file of its own), or None where there
    is no such file."""
    base = name.split(".")[0]
    where = HERE / "metrics"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{base}", where / f"{base}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    files = [p for p in [where / f"{base}.json"] if p.exists()]
    files += sorted(where.glob(f"{base}.kernels-*.json"))
    if not files:
        return mod.read, None
    return mod.read, {"kernels": [k for p in files
                                  for k in load_json(p)["kernels"]]}


def per_layer(cell, fam, window, profile) -> dict:
    """``name -> value`` of the cell's per-layer metrics; a reader that
    finds nothing returns None and its metric is left out."""
    ctx = LayerContext(cell, fam, window, profile)
    out = {}
    for m in cell.per_layer:
        read, ctx.data = reader(m["name"])
        value = read(ctx)
        if value is not None:
            out[m["name"]] = value
    return out


def run_program(cell, seed: int, seconds: float, trace: bool, *,
                device=None, dtype=None, fault=None) -> dict:
    """The program's run (module docstring): its readings for the
    comparison, its window and, traced, its per-layer metrics."""
    import torch  # noqa: PLC0415

    fam = family(cell.config["family"])
    traffic = cell.traffic
    t = time.perf_counter()
    prog = fam.Program(cell.config, traffic, seed, device, dtype, fault)
    dev = next(prog.model.parameters()).device
    log(f"set-up: program built, weights and inputs made "
        f"{time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    losses = []
    for i in range(traffic["check_steps"]):
        losses.append(prog.step(i).item())
        if i == 0:
            grad_norms = leaf_norms(prog.grads(), prog.split)
    w0 = fam.weights(cell.config, seed, dev)
    with torch.no_grad():
        change = leaf_norms({k: v - w0[k] for k, v in prog.leaves().items()},
                            prog.split)
    del w0
    log(f"set-up: check steps {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    first = traffic["check_steps"]
    for i in range(first, first + traffic["warmup_steps"]):
        prog.step(i).item()
    first += traffic["warmup_steps"]
    log(f"set-up: warm-up steps {time.perf_counter() - t:.3f} s")
    window = timed_window(prog, first, seconds)
    out = {"readings": {"losses": losses, "grad_norms": grad_norms,
                        "change_norms": change},
           "wall_start": window.wall_start, "step_s": window.step_s,
           "issue_s": window.issue_s, "window_s": window.seconds,
           "window_losses": window.losses}
    if trace:
        at = [first + len(window.step_s)]

        def run_step(span):
            with span("bench.step"):
                with span("bench.issue"):
                    loss = prog.step(at[0])
                with span("bench.loss_read"):
                    loss.item()
            at[0] += 1

        from .trace import profile_steps  # noqa: PLC0415

        prof = profile_steps(run_step, traffic["profile_steps"],
                             lambda: _sync(dev))
        out["per_layer"] = per_layer(cell, fam, window, prof)
        out["busy_s"] = prof.busy_us() / 1e6
        out["traced_s"] = prof.window_us / 1e6
        out["breakdown"] = prof.breakdown()
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else 0)
    prog.close()
    del prog
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def gap(a: float, b: float, scale: float) -> float:
    """``|a - b| / scale``; infinite where a reading is not finite."""
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / scale


def compare(run: dict, ref: dict) -> dict:
    """The compared numbers:

    * ``loss_gap``: the largest ``|loss - reference loss|`` of the check
      steps (nats);
    * ``grad_gap``: the worst leaf's gap between the program's and the
      reference's gradient norms at the first step, against the larger of
      that leaf's reference norm and the median leaf's;
    * ``change_gap``: the same of each leaf's change over the check
      steps, leaving out the leaves whose reference gradient is under a
      thousandth of the median leaf's (they move under Adam by rounding
      alone).
    """
    rg, rc = ref["grad_norms"], ref["change_norms"]
    med_g = statistics.median(rg.values())
    med_c = statistics.median(rc.values())
    moved = [k for k in rc if k not in rg or rg[k] >= 1e-3 * med_g]
    pg, pc = run["grad_norms"], run["change_norms"]
    if set(pg) != set(rg) or set(pc) != set(rc):
        raise RuntimeError("the program's leaves are not the reference's")
    return {
        "loss_gap": max(gap(a, b, 1.0)
                        for a, b in zip(run["losses"], ref["losses"])),
        "grad_gap": max(gap(pg[k], rg[k], max(rg[k], med_g)) for k in rg),
        "change_gap": max(gap(pc[k], rc[k], max(rc[k], med_c))
                          for k in moved)}


def reference_of(cell, seed: int, device) -> dict:
    """The reference's readings of the cell's check steps."""
    fam = family(cell.config["family"])
    t = time.perf_counter()
    ref = fam.reference_readings(cell.config, cell.traffic, seed, device,
                                 cell.traffic["check_steps"])
    log(f"reference: {time.perf_counter() - t:.3f} s")
    return ref


def judge(cell, numbers: dict) -> tuple:
    """``(correct, check)``: each number beside its limit of
    ``limits/<workload>.json``; correct when every one is at most its
    limit (a number that is not finite never is)."""
    check = {k: {"value": v, "limit": cell.limits[k]}
             for k, v in numbers.items()}
    return all(c["value"] <= c["limit"] for c in check.values()), check


def end_to_end(cell, fam, run: dict, setup_s: float) -> dict:
    """The cell's end-to-end metrics from the run's window.  A metric's
    name up to its first dot says what it is, so a cell may report one
    under a name of its own, with a bound of its own."""
    steps = len(run["step_s"])
    values = {
        fam.RATE_METRIC: fam.units(cell.traffic) * steps / run["window_s"],
        "peak_mem_gib": run["memory_peak_bytes"] / 2 ** 30,
        "setup_s": setup_s,
    }
    log(f"window: {steps} steps in {run['window_s']:.4f} s; step ms median "
        f"{statistics.median(run['step_s']) * 1e3:.3f}, p95 "
        f"{percentile(run['step_s'], 95) * 1e3:.3f} of {steps} steps")
    return {m["name"]: {"value": values[m["name"].split(".")[0]],
                        "unit": m["unit"]}
            for m in cell.end_to_end}
