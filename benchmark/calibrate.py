"""The readings the limits of ``limits/<workload>.json`` are set from, on
the card at the cell's own size (the benchmark's own runs never run
this):

    python3 -m benchmark.calibrate --workload <name> --seeds 1,2,...,12 \\
        --control-seeds 1,2,3 --fault-seeds 1,2,3

For every seed the program's check steps as a run makes them (``sound``);
on the control seeds the program with its own lower-precision path
switched on (``control``: ``dtype="fp8"``, bf16 compute with the
activations stored through e4m3); on the fault seeds the faults a
training cell can have (``half``: half of each batch left out, the mean
over the rest).  A state left unchanged reads 1 by the measure and
needs no run.  Each reading is compared with the float32 reference of
its seed; one JSON line a reading, then the summary: the largest sound
reading and the smallest of each other kind, per number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import session
from .common import Cell, log


def plan_of(args) -> list:
    """``[seed, dtype, fault]`` of every program run."""
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    faults = [int(s) for s in args.fault_seeds.split(",") if s]
    plan = [[s, None, None] for s in seeds]
    plan += [[s, "fp8", None] for s in control]
    plan += [[s, None, "half"] for s in faults]
    return plan


def kind_of(dtype, fault) -> str:
    return fault or ("control" if dtype else "sound")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    args = p.parse_args(argv)
    import torch  # noqa: PLC0415

    cell = Cell(args.workload)
    plan = plan_of(args)
    t = time.time()
    readings = [session.run_program(cell, seed, 0.0, False, dtype=dtype,
                                    fault=fault)["readings"]
                for seed, dtype, fault in plan]
    log(f"program runs: {time.time() - t:.1f} s")
    refs = {}
    summary: dict = {}
    for (seed, dtype, fault), run in zip(plan, readings):
        if seed not in refs:
            refs[seed] = session.reference_of(cell, seed,
                                              torch.device("cuda", 0))
        numbers = session.compare(run, refs[seed])
        kind = kind_of(dtype, fault)
        print(json.dumps({"workload": cell.name, "seed": seed, "kind": kind,
                          **numbers}), flush=True)
        for k, v in numbers.items():
            agg = summary.setdefault(kind, {}).setdefault(k, v)
            summary[kind][k] = max(agg, v) if kind == "sound" else min(agg, v)
    print(json.dumps({"workload": cell.name, "summary": summary,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
