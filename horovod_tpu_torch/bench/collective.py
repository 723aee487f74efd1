"""Collective microbench of the eager engines: allreduce goodput by world
size and message size, and the recorder of the scaling gate's baseline
(counterpart of ``scripts/collective_bench.py`` and
``scripts/record_scaling_baseline.py``).

    python -m horovod_tpu_torch.bench.collective --engine python --np 4
                                                  # four cards, NCCL
    python -m horovod_tpu_torch.bench.collective --engine native \\
        --np 2 --sizes-kb 4 1024 16384 --iters 50 # two ranks, one card
    python -m horovod_tpu_torch.bench.collective --device cpu \\
        --engine native --np 2 4                  # host payloads
    python -m horovod_tpu_torch.bench.collective --record-baseline

Each (world, size) cell is one world of ``--np`` workers on this host
through ``horovod_tpu_torch.run.run`` (the launcher, one process a rank)
with the engine chosen by ``HVDTPU_EAGER_ENGINE`` and a 1 ms cycle; rank
0's goodput (payload bytes reduced a second, one buffer an op) fills the
table, printed as the reference prints it.  ``--device``:

* ``cuda`` (the default; it refuses with exit 2 when no card is visible):
  the payload on the card.  The Python engine runs in a NCCL
  world and reduces it on its device plane (``runtime/device_plane.py``),
  so each rank needs a card of its own; the native engine runs in a gloo
  world and takes the payload to the host and back around its TCP ring
  (``runtime/native.py``), each rank on card ``local_rank`` modulo the
  cards there are, so two ranks may share one;
* ``cpu`` (``use_cpu=True``, the GPUs hidden): host payloads, the Python
  engine's gloo plane or the native engine's TCP ring, as the reference's
  CPU runs.

:func:`measure` is what one rank does, in a world it already has (the
card's smoke script calls it inside its own two-rank world); every result
is checked to equal the world size times the input, exactly (the input's
values are small integers).

The scaling gate (``tests/test_torch_scaling.py``) holds the native
engine's rate of tiny host allreduces at np 4 over np 2 against
:data:`BASELINE_PATH`, which ``--record-baseline`` writes: the median of
``--trials`` ratios, the trials, the band, a note.  The reference gates
np 8 over np 2; the port gates np 4 over np 2 to keep the test suite's
worlds small (its tests run in parallel on shared hosts).  ``--np 2 4 8``
still measures the np 8 leg.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

__all__ = ["BASELINE_PATH", "payload", "measure", "goodput_table",
           "rate_ratio", "main"]

BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "scaling_baseline.json")
# the gate's band: best-of-2 live ratios fail below band x the recorded
# median, never below the reference's cliff floor.  The median op is
# quantised by the 1 ms cycle (one or two cycles an op): an idle host
# gives ~0.97 (np 4 takes as many cycles as np 2), a loaded one ~0.55
# (one more at np 4); 0.5 x ~0.97 fails np 4 ops that cost more than
# about twice np 2's, growth in the world size no longer sublinear
BAND = 0.5
FLOOR = 0.25
# the engines' 1 ms cycle (the reference's HVDTPU_CYCLE_TIME=1)
CYCLE_MS = "1"
# the gate's cycle-bound measure: timed allreduces of 256 bytes (the
# reference's _rate_worker payload), 200 of them (the reference's 40 x 5)
# so that the median op is stable
RATE_BYTES, RATE_ITERS = 256, 200
# seconds one world of the bench may take
WORLD_TIMEOUT = 600
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def payload(nbytes: int, device) -> "torch.Tensor":
    """The float32 input of ``nbytes`` (at least one element): values
    0..250, so sums over any world this bench runs are exact."""
    import torch

    n = max(nbytes // 4, 1)
    return (torch.arange(n, dtype=torch.int64) % 251).to(
        torch.float32).to(device)


def measure(nbytes: int, iters: int, device=None,
            name: str = "bench") -> dict:
    """One rank's share of a cell, in the initialised world on its engine:
    3 allreduces (Sum) to warm the response cache, then ``iters``
    timed ones of the same name, each waited for; the device is
    synchronised before the clock stops.  Returns the goodput (payload
    bytes a second), ops a second, the seconds, the median op's seconds
    on the host's clock (each call to its return: the whole op for host
    payloads), whether every result equalled world x input, and the
    engine's counters over the timed loop.  ``device`` defaults to the
    world's."""
    import torch

    from .. import _engine_registry, basics
    from ..ops import eager
    from ..ops.collectives import Sum

    dev = torch.device(device) if device is not None else basics.device()
    cuda = dev.type == "cuda"
    world = basics.size()
    x = payload(nbytes, dev)
    want = x * world
    exact = True
    for _ in range(3):
        exact &= bool(torch.equal(eager.allreduce(x, op=Sum, name="warm"),
                                  want))
    eng = _engine_registry.get_engine()
    before = dict(eng.stats)
    if cuda:
        torch.cuda.synchronize(dev)
    outs, ends = [], []
    t0 = time.perf_counter()
    for _ in range(iters):
        outs.append(eager.allreduce(x, op=Sum, name=name))
        ends.append(time.perf_counter())
    if cuda:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    after = dict(eng.stats)
    exact &= all(bool(torch.equal(o, want)) for o in outs)
    return {"rank": basics.rank(), "world": world, "device": str(dev),
            "engine": type(eng).__name__, "bytes": x.numel() * 4,
            "iters": iters, "seconds": dt,
            "goodput": x.numel() * 4 * iters / dt,
            "ops_per_sec": iters / dt,
            "op_s_median": statistics.median(
                b - a for a, b in zip([t0] + ends, ends)),
            "exact": exact,
            "stats": {k: after[k] - before.get(k, 0) for k in after
                      if isinstance(after[k], (int, float))}}


def _init(device: str, engine: str):
    """Start this worker's world: gloo on the CPU, NCCL for the Python
    engine's CUDA payloads, gloo with the payload on ``cuda:local_rank``
    (mod the cards) for the native engine's; returns the payload's
    device."""
    import torch

    import horovod_tpu_torch as hvd

    if device == "cpu":
        hvd.init(device="cpu")
        return "cpu"
    if engine == "python":
        hvd.init()
        return str(hvd.device())
    topo = hvd.init(device="cpu")
    return f"cuda:{topo.local_rank % torch.cuda.device_count()}"


def _worker(nbytes: int, iters: int, device: str = "cpu",
            engine: str = "python") -> dict:
    """One rank of a cell (through ``run()``): init, :func:`measure`,
    shutdown."""
    import horovod_tpu_torch as hvd

    dev = _init(device, engine)
    try:
        return measure(nbytes, iters, dev)
    finally:
        hvd.shutdown()


def _env(engine: str) -> dict:
    return {"HVDTPU_EAGER_ENGINE": engine, "HVDTPU_CYCLE_TIME": CYCLE_MS,
            "PYTHONPATH": os.pathsep.join(
                p for p in (_REPO, os.environ.get("PYTHONPATH")) if p)}


def run_cell(engine: str, np_: int, nbytes: int, iters: int,
             device: str = "cuda") -> list:
    """Every rank's :func:`measure` of one cell, in rank order."""
    from ..run import run

    return run(_worker, (nbytes, iters, device, engine), np=np_,
               use_cpu=device == "cpu", timeout=WORLD_TIMEOUT,
               env=_env(engine))


def goodput_table(engine: str, iters: int, worlds, sizes_kb,
                  goodput) -> str:
    """The reference's table: ``goodput[(kb, np)]`` in bytes a second,
    shown in MB/s."""
    lines = [f"# engine={engine} iters={iters} "
             "(goodput = payload bytes/sec, rank 0)",
             "size_kb " + " ".join(f"np={n:<12d}" for n in worlds)]
    for kb in sizes_kb:
        lines.append(" ".join([f"{kb:7d}"] + [
            f"{goodput[(kb, n)] / 1e6:9.1f} MB/s" for n in worlds]))
    return "\n".join(lines)


def rate_ratio(trials: int, stop_at=None, log=None) -> list:
    """``trials`` ratios of the native engine's tiny host-allreduce rate
    at np 4 over np 2 (each a pair of fresh worlds on the host);
    ``stop_at``: stop once a ratio reaches it.  The rate is rank 0's
    median op, not the reference's mean over the loop: on a shared host
    one rank descheduled for a few hundred milliseconds sets the mean of
    a short loop (ratios of 0.18 where the median gave 0.64, beside a
    full test run), while a cost that every op pays, the regression the
    gate is for, moves the median as much as the mean."""
    def rate(np_):
        return 1.0 / run_cell("native", np_, RATE_BYTES, RATE_ITERS,
                              "cpu")[0]["op_s_median"]

    ratios = []
    for t in range(trials):
        lo, hi = rate(2), rate(4)
        ratios.append(hi / lo)
        if log is not None:
            log(f"# trial {t}: rate2={lo:.1f} rate4={hi:.1f} "
                f"ratio={hi / lo:.3f}")
        if stop_at is not None and hi / lo >= stop_at:
            break
    return ratios


def record_baseline(trials: int, path: str = BASELINE_PATH) -> dict:
    """Measure ``trials`` np 4 / np 2 ratios and write the baseline."""
    ratios = rate_ratio(trials, log=lambda m: print(m, file=sys.stderr))
    record = {
        # the median: one loaded-machine outlier must not set the bar
        "np4_over_np2": round(statistics.median(ratios), 3),
        "trials": [round(r, 3) for r in ratios],
        "band": BAND,
        "note": "refresh with python -m horovod_tpu_torch.bench.collective "
                "--record-baseline on an idle host; gate = max(0.25, band * "
                "np4_over_np2), best of 2 live trials; np 4 over np 2 (the "
                "reference's np 8 over np 2), to keep the test suite's "
                "worlds small; the rate is rank 0's median op of 200",
    }
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
        f.write("\n")
    return record


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.bench.collective")
    p.add_argument("--engine", default="python",
                   choices=["python", "native"])
    p.add_argument("--np", type=int, nargs="+", default=[2, 4],
                   dest="worlds")
    p.add_argument("--sizes-kb", type=int, nargs="+",
                   default=[4, 1024, 16384])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the payload lives (cuda: the Python "
                   "engine's NCCL plane, the native engine's host round "
                   "trip; cpu: host payloads, the GPUs hidden)")
    p.add_argument("--record-baseline", action="store_true",
                   help=f"record the scaling gate's baseline "
                   f"({os.path.basename(BASELINE_PATH)}) instead")
    p.add_argument("--trials", type=int, default=5)
    p.add_argument("--out", default=BASELINE_PATH,
                   help="where --record-baseline writes")
    return p


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.record_baseline:
        print(json.dumps(record_baseline(args.trials, args.out)))
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("collective: no CUDA device is visible", file=sys.stderr)
            return 2
    goodput, inexact = {}, []
    for kb in args.sizes_kb:
        for n in args.worlds:
            res = run_cell(args.engine, n, kb * 1024, args.iters,
                           args.device)
            goodput[(kb, n)] = res[0]["goodput"]
            inexact += [(kb, n, r["rank"]) for r in res if not r["exact"]]
    print(goodput_table(args.engine, args.iters, args.worlds,
                        args.sizes_kb, goodput), flush=True)
    if inexact:
        print(f"collective: results not world x input at (size_kb, np, "
              f"rank) {inexact}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
