"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with a card.  The cell runs
in this process, on one card.

Standard output's last line is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace
1`` ``breakdown``, and last ``check``: each number compared with the
reference beside its limit.  Standard error ends with the same numbers,
one a line.  No result is printed, and the exit code is not 0, when the
card is missing, when the process holds a module of JAX or of the JAX
package, or when the run fails.
"""

from __future__ import annotations

import time

T0 = time.time()  # the command's start: set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result(cell, run: dict, ref: dict, trace: bool, setup_s: float,
           device_kind: str) -> dict:
    """The result line's object (module docstring)."""
    from . import session  # noqa: PLC0415
    from .common import family  # noqa: PLC0415

    correct, check = session.judge(
        cell, session.compare(run["readings"], ref))
    fam = family(cell.config["family"])
    if trace:
        metrics = {m["name"]: {"value": run["per_layer"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.per_layer if m["name"] in run["per_layer"]}
    else:
        metrics = session.end_to_end(cell, fam, run, setup_s)
    device = {"platform": "gpu", "kind": device_kind, "count": cell.chips,
              "memory_peak_bytes": run["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": len(run["step_s"]),
           "failed": sum(1 for v in run["window_losses"]
                         if v != v or v in (float("inf"), float("-inf"))),
           "metrics": metrics, "device": device}
    if trace:
        device["busy_s"] = run["busy_s"]
        device["window_s"] = run["traced_s"]
        out["breakdown"] = run["breakdown"]
    out["check"] = check
    return out


def main(argv=None) -> int:
    args = parse(argv)
    from .common import Cell, forbidden_modules, log  # noqa: PLC0415

    cell = Cell(args.workload)
    import torch  # noqa: PLC0415

    if cell.chips != 1:
        log(f"{cell.name} asks for {cell.chips} cards; this harness runs a "
            f"cell on one")
        return 2
    if not torch.cuda.is_available():
        log(f"{cell.name} needs a CUDA device; this machine shows none")
        return 2
    from . import session  # noqa: PLC0415

    run = session.run_program(cell, args.seed, args.seconds, bool(args.trace))
    # the program's world of one closes here, so nothing it prints at exit
    # comes after the compared numbers on standard error
    from horovod_tpu_torch import shutdown  # noqa: PLC0415

    shutdown()
    setup_s = run["wall_start"] - T0
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 3
    ref = session.reference_of(cell, args.seed, torch.device("cuda", 0))
    out = result(cell, run, ref, bool(args.trace), setup_s,
                 torch.cuda.get_device_name(0))
    found = forbidden_modules()
    if found:
        log(f"JAX or the JAX package was loaded: {found}")
        return 3
    for name, c in out["check"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
