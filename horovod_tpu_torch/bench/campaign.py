"""Resumable benchmark campaigns: a sweep as one durable session
(counterpart of ``horovod_tpu/bench/campaign.py``).

A campaign is a declarative spec — a grid over the bench's knobs (overlap
mode, gradient bucket size via ``autotune.grad_bucket_candidates()``,
hierarchical allreduce, schedule replay) or an explicit list of named
points — expanded into points and executed one
``python -m horovod_tpu_torch.bench`` process per point.  The design
constraints, in order:

* **Durability** — a ``campaign.json`` journal under the record dir is
  rewritten atomically (``obs/pathspec.py``'s write-then-rename) after
  every point, so a crash or an injected SIGABRT loses at most the
  in-flight point: the journal on disk is always a complete, parseable
  account of every finished point.
* **Resume** — restarting with the same spec (matched by content hash)
  skips ``done`` points and retries ``degraded``/``failed`` ones up to
  ``retry_degraded`` extra attempts; a changed spec is refused rather
  than silently mixed (``--force-new`` starts over).
* **Isolation** — each point is its own process: a point that hangs or
  dies cannot take the campaign (or the other points' results) with it.
  The journal records per point whether a point of the same
  configuration key (``compile_key``: the flags that change the step the
  bench builds) already ran in this campaign (``reused``) or not
  (``cold``).  The port has no compiled executable to reuse: its CUDA
  kernels are built once per checkout, and the key only says which
  points share the step's configuration.
* **Deterministic chaos** — ``testing.faults.maybe_fail("campaign_point",
  step=<1-based point index>)`` runs between the previous point's
  commit and the next launch: ``action=abort`` dies exactly there,
  advisory ``action=degrade`` records the point as degraded without
  running it.

Axes map to the port's bench: ``overlap`` to ``--overlap``,
``grad_bucket_mb`` to ``--grad-bucket-mb``, ``hierarchical`` and
``replay`` to ``HVDTPU_HIERARCHICAL_ALLREDUCE`` and
``HVDTPU_SCHEDULE_REPLAY`` in the point's environment.  The reference's
runner also hands each point ``--total-budget-secs`` and
``HVDTPU_BENCH_RECORD_DIR``; the port's bench has neither (it retries
nothing and writes no record file: its record is its last stdout line),
so the runner passes neither, and the point's budget is enforced by the
outer timeout alone.  The records live in the journal.

The journal lands in ``--record-dir``, else ``HVDTPU_RECORD_DIR``, else
the current directory.  No torch import: the driver must outlive a point
whose CUDA start-up hangs.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from ..obs.pathspec import write_json_atomic

__all__ = ["load_spec", "expand_points", "run_campaign", "main",
           "JOURNAL_SCHEMA", "JOURNAL_NAME", "CampaignError"]

JOURNAL_SCHEMA = "hvdtpu-campaign-v1"
JOURNAL_NAME = "campaign.json"

# Grace the outer kill adds past the point's budget (the reference's
# bench bounds its own wall clock; the outer timeout stays larger).
OUTER_TIMEOUT_GRACE_SECS = 120

# Axes that map to bench CLI flags and change the step the bench builds —
# two points differing here do not share a configuration.
_COMPILE_ARG_AXES = {
    "overlap": "--overlap",
    "grad_bucket_mb": "--grad-bucket-mb",
}
# Axes that map to environment knobs the engine reads at run time — the
# step is the same across their values.
_RUNTIME_ENV_AXES = {
    "hierarchical": "HVDTPU_HIERARCHICAL_ALLREDUCE",
    "replay": "HVDTPU_SCHEDULE_REPLAY",
}


class CampaignError(RuntimeError):
    """A spec/journal problem the operator must resolve (exit 2)."""


# ------------------------------------------------------------------ spec

def load_spec(path: str) -> dict:
    try:
        with open(path) as f:
            spec = json.load(f)
    except (OSError, ValueError) as exc:
        raise CampaignError(f"unreadable campaign spec {path}: {exc}")
    if not isinstance(spec, dict):
        raise CampaignError(f"campaign spec {path} must be a JSON object")
    spec.setdefault("name", os.path.splitext(os.path.basename(path))[0])
    spec.setdefault("base_args", [])
    spec.setdefault("axes", {})
    spec.setdefault("points", [])
    spec.setdefault("retry_degraded", 1)
    spec.setdefault("point_budget_secs", 1440)
    if not isinstance(spec["base_args"], list) or not all(
            isinstance(a, str) for a in spec["base_args"]):
        raise CampaignError("spec base_args must be a list of strings")
    if not isinstance(spec["axes"], dict):
        raise CampaignError("spec axes must be an object")
    if not isinstance(spec["points"], list):
        raise CampaignError("spec points must be a list")
    if spec["points"] and spec["axes"]:
        raise CampaignError(
            "spec has both axes and points; a campaign is either a "
            "grid or an explicit point list, not a mix")
    return spec


def spec_sha(spec: dict) -> str:
    """Content hash over the fields that define WHAT the campaign runs
    (not how patiently): the resume identity."""
    ident = {k: spec.get(k) for k in ("name", "base_args", "axes")}
    return hashlib.sha256(
        json.dumps(ident, sort_keys=True).encode()).hexdigest()[:16]


def _axis_values(axes: dict, key: str) -> Optional[List]:
    vals = axes.get(key)
    if vals is None:
        return None
    if vals == "auto" and key == "grad_bucket_mb":
        from ..runtime.autotune import grad_bucket_candidates  # noqa: PLC0415

        return list(grad_bucket_candidates())
    if not isinstance(vals, list) or not vals:
        raise CampaignError(
            f"axis {key!r} must be a non-empty list (or 'auto' for "
            f"grad_bucket_mb), got {vals!r}")
    return vals


def _knob_token(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _explicit_points(spec: dict) -> List[dict]:
    """An explicit point list (named heterogeneous configs, not a
    grid).  Each entry: {"name", "args",
    "env"?}.  Order is preserved — a hardware plan runs its headline
    number first."""
    points = []
    seen = set()
    for i, raw in enumerate(spec["points"]):
        if not isinstance(raw, dict) or not raw.get("name"):
            raise CampaignError(
                f"spec points[{i}] must be an object with a 'name'")
        pid = str(raw["name"])
        if pid in seen:
            raise CampaignError(f"duplicate point name {pid!r}")
        seen.add(pid)
        extra = raw.get("args", [])
        env = raw.get("env", {})
        if not isinstance(extra, list) or not all(
                isinstance(a, str) for a in extra):
            raise CampaignError(
                f"points[{i}].args must be a list of strings")
        argv = list(spec["base_args"]) + list(extra)
        # Every explicit arg is conservatively compile-relevant: an
        # unclassified knob must never be credited with reuse.
        compile_key = " ".join(argv)
        point = {
            "id": pid,
            "knobs": {"args": " ".join(extra)},
            "argv": argv,
            "env": {str(k): str(v) for k, v in env.items()},
            "compile_key": hashlib.sha256(
                compile_key.encode()).hexdigest()[:12],
        }
        if raw.get("budget_secs"):
            point["budget_secs"] = int(raw["budget_secs"])
        points.append(point)
    return points


def expand_points(spec: dict) -> List[dict]:
    """Cartesian product of the axes, as [{id, knobs, argv, env,
    compile_key}].  A point with ``overlap=off`` drops the bucket-size
    axis (the knob is inert without overlap) and the resulting
    duplicates collapse, so a 2x3 grid over {overlap, bucket} yields
    1 + 3 points, not 6.  Unknown axes pass through as ``--axis-name
    value`` bench flags and count as compile-relevant (conservative:
    an unclassified knob must never be credited with a shared
    configuration).  A spec with an explicit ``points`` list bypasses the grid
    entirely."""
    if spec.get("points"):
        return _explicit_points(spec)
    axes = spec["axes"]
    grids: List[List] = [[{}]]

    def _cross(key: str, values: List) -> None:
        grids[0] = [dict(p, **{key: v}) for p in grids[0] for v in values]

    for key in axes:
        vals = _axis_values(axes, key)
        if vals is not None:
            _cross(key, vals)
    points: Dict[str, dict] = {}
    for knobs in grids[0]:
        if knobs.get("overlap") == "off":
            knobs = {k: v for k, v in knobs.items()
                     if k != "grad_bucket_mb"}
        argv = list(spec["base_args"])
        env: Dict[str, str] = {}
        compile_knobs = {}
        for key in sorted(knobs):
            v = knobs[key]
            if key in _COMPILE_ARG_AXES:
                argv += [_COMPILE_ARG_AXES[key], _knob_token(v)]
                compile_knobs[key] = _knob_token(v)
            elif key in _RUNTIME_ENV_AXES:
                env[_RUNTIME_ENV_AXES[key]] = _knob_token(v)
            elif isinstance(v, bool):
                if v:
                    argv.append("--" + key.replace("_", "-"))
                compile_knobs[key] = _knob_token(v)
            else:
                argv += ["--" + key.replace("_", "-"), _knob_token(v)]
                compile_knobs[key] = _knob_token(v)
        pid = ",".join(f"{k}={_knob_token(v)}" for k, v in sorted(
            knobs.items())) or "default"
        compile_key = "|".join(
            [" ".join(spec["base_args"])]
            + [f"{k}={v}" for k, v in sorted(compile_knobs.items())])
        points[pid] = {
            "id": pid,
            "knobs": {k: _knob_token(v) for k, v in sorted(knobs.items())},
            "argv": argv,
            "env": env,
            "compile_key": hashlib.sha256(
                compile_key.encode()).hexdigest()[:12],
        }
    return [points[pid] for pid in sorted(points)]


# --------------------------------------------------------------- journal

def _journal_path(record_dir: str) -> str:
    return os.path.join(record_dir, JOURNAL_NAME)


def load_journal(record_dir: str) -> Optional[dict]:
    path = _journal_path(record_dir)
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError:
        return None
    except ValueError as exc:
        # A torn journal would mean the atomic-write contract broke —
        # refuse to guess what completed rather than re-run (or skip)
        # the wrong points.
        raise CampaignError(f"corrupt campaign journal {path}: {exc}")
    if not isinstance(doc, dict) or doc.get("schema") != JOURNAL_SCHEMA:
        raise CampaignError(
            f"{path} is not a {JOURNAL_SCHEMA} journal; move it aside "
            f"or pass --force-new")
    return doc


def _new_journal(spec: dict, points: List[dict]) -> dict:
    return {
        "schema": JOURNAL_SCHEMA,
        "name": spec["name"],
        "spec_sha": spec_sha(spec),
        "spec": {k: spec[k] for k in ("name", "base_args", "axes",
                                      "retry_degraded",
                                      "point_budget_secs")},
        "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "updated": None,
        "order": [p["id"] for p in points],
        "points": {
            p["id"]: {
                "status": "pending",
                "attempts": 0,
                "knobs": p["knobs"],
                "compile_key": p["compile_key"],
            }
            for p in points
        },
    }


def _commit(record_dir: str, journal: dict) -> None:
    journal["updated"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    write_json_atomic(_journal_path(record_dir), journal)


# ---------------------------------------------------------------- runner

def _parse_result_line(stdout: str) -> Optional[dict]:
    """The last stdout line must be a strict JSON OBJECT (no bare
    scalars, no NaN/Infinity) — a traceback tail must not corrupt the
    journal."""
    lines = [ln for ln in (stdout or "").splitlines() if ln.strip()]
    if not lines:
        return None

    def _no_const(c):
        raise ValueError(c)

    try:
        doc = json.loads(lines[-1], parse_constant=_no_const)
    except ValueError:
        return None
    return doc if isinstance(doc, dict) else None


def subprocess_runner(point: dict, spec: dict, *, bench_cmd: List[str],
                      record_dir: str) -> dict:
    """Run one point as a child process, killed after its budget plus
    :data:`OUTER_TIMEOUT_GRACE_SECS`; returns {rc, parsed, tail}.
    ``record_dir`` is the journal's (the port's bench writes no record
    file of its own)."""
    budget = int(point.get("budget_secs") or spec["point_budget_secs"])
    cmd = list(bench_cmd) + list(point["argv"])
    env = dict(os.environ)
    env.update(point["env"])
    # The campaign owns chaos at its own seam; a fault spec aimed at
    # campaign_point must not leak into the child and fire nowhere.
    env.pop("HVDTPU_FAULT_SPEC", None)
    try:
        proc = subprocess.run(
            cmd, env=env, capture_output=True, text=True,
            timeout=budget + OUTER_TIMEOUT_GRACE_SECS,
        )
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc = 124
        stdout = (exc.stdout or b"").decode("utf-8", "replace") \
            if isinstance(exc.stdout, bytes) else (exc.stdout or "")
        stderr = ("campaign outer timeout after "
                  f"{budget + OUTER_TIMEOUT_GRACE_SECS}s")
    except OSError as exc:
        return {"rc": 127, "parsed": None, "tail": str(exc)}
    return {
        "rc": rc,
        "parsed": _parse_result_line(stdout),
        "tail": (stderr or "").strip()[-2000:],
    }


def _point_status(result: dict) -> str:
    parsed = result.get("parsed")
    if result.get("rc") == 0 and isinstance(parsed, dict):
        return "degraded" if parsed.get("degraded") else "done"
    return "failed"


def run_campaign(spec: dict, record_dir: str, *,
                 bench_cmd: Optional[List[str]] = None,
                 runner=None, force_new: bool = False,
                 max_points: int = 0,
                 log=lambda msg: print(msg, file=sys.stderr)) -> dict:
    """Execute (or resume) a campaign; returns the final journal.

    ``runner(point, spec)`` is injectable for tests; the default shells
    out to ``bench_cmd`` (default: ``python -m horovod_tpu_torch.bench``)
    per point.
    """
    from ..testing import faults  # noqa: PLC0415

    points = expand_points(spec)
    if not points:
        raise CampaignError("campaign spec expands to zero points")
    os.makedirs(record_dir, exist_ok=True)
    journal = None if force_new else load_journal(record_dir)
    if journal is not None and journal.get("spec_sha") != spec_sha(spec):
        raise CampaignError(
            f"journal {_journal_path(record_dir)} belongs to a different "
            f"spec (sha {journal.get('spec_sha')} != {spec_sha(spec)}); "
            f"finish that campaign, move it aside, or pass --force-new")
    resumed = journal is not None
    if journal is None:
        journal = _new_journal(spec, points)
        _commit(record_dir, journal)
    if bench_cmd is None:
        bench_cmd = [sys.executable, "-m", "horovod_tpu_torch.bench"]
    if runner is None:
        def runner(point, spec):
            return subprocess_runner(point, spec, bench_cmd=bench_cmd,
                                     record_dir=record_dir)

    max_attempts = 1 + int(spec["retry_degraded"])
    # Configuration keys already run in this campaign, whatever their
    # status (a degraded run still built and ran the step).
    warm_keys = {
        e["compile_key"] for e in journal["points"].values()
        if e.get("attempts", 0) > 0
    }
    ran = skipped = 0
    log(f"campaign {journal['name']}: {len(points)} points"
        + (" (resumed)" if resumed else ""))
    for idx, point in enumerate(points, start=1):
        entry = journal["points"][point["id"]]
        status = entry.get("status")
        if status == "done":
            skipped += 1
            continue
        if status in ("degraded", "failed") \
                and entry.get("attempts", 0) >= max_attempts:
            log(f"  [{idx}/{len(points)}] {point['id']}: {status} after "
                f"{entry['attempts']} attempts — retry budget spent")
            skipped += 1
            continue
        if max_points and ran >= max_points:
            break
        # The chaos seam: between the previous point's committed journal
        # and this point's launch.  action=abort dies exactly here;
        # advisory action=degrade forces this point down the
        # degraded-record path without running it.
        advice = faults.maybe_fail("campaign_point", step=idx,
                                   name=point["id"])
        reuse = "reused" if point["compile_key"] in warm_keys else "cold"
        if advice == "degrade":
            entry.update({
                "status": "degraded",
                "attempts": entry.get("attempts", 0) + 1,
                "rc": 0,
                "compile": reuse,
                "record": {"degraded": True,
                           "why": "injected campaign_point degrade"},
                "forced_degraded": True,
            })
            warm_keys.add(point["compile_key"])
            _commit(record_dir, journal)
            ran += 1
            log(f"  [{idx}/{len(points)}] {point['id']}: DEGRADED "
                f"(injected)")
            continue
        log(f"  [{idx}/{len(points)}] {point['id']}: running "
            f"({reuse} configuration)")
        t0 = time.time()
        result = runner(point, spec)
        entry.update({
            "status": _point_status(result),
            "attempts": entry.get("attempts", 0) + 1,
            "rc": result.get("rc"),
            "compile": reuse,
            "elapsed_secs": round(time.time() - t0, 2),
            "record": result.get("parsed"),
        })
        if entry["status"] == "failed" and result.get("tail"):
            entry["tail"] = result["tail"]
        else:
            entry.pop("tail", None)
        warm_keys.add(point["compile_key"])
        _commit(record_dir, journal)
        ran += 1
        log(f"  [{idx}/{len(points)}] {point['id']}: "
            f"{entry['status'].upper()} rc={entry['rc']} "
            f"({entry.get('elapsed_secs', 0)}s)")
    return journal


def summarize_journal(journal: dict) -> dict:
    counts = {"done": 0, "degraded": 0, "failed": 0, "pending": 0}
    reused = 0
    for entry in journal["points"].values():
        counts[entry.get("status", "pending")] = counts.get(
            entry.get("status", "pending"), 0) + 1
        if entry.get("compile") == "reused":
            reused += 1
    return {
        "campaign": journal["name"],
        "spec_sha": journal["spec_sha"],
        "points": len(journal["points"]),
        "compile_reused": reused,
        **counts,
    }


# ------------------------------------------------------------------- CLI

def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.bench.campaign",
        description="Run (or resume) a resumable benchmark campaign "
                    "from a declarative sweep spec.")
    p.add_argument("--spec", required=True,
                   help="campaign spec JSON (name, base_args, axes, "
                        "retry_degraded, point_budget_secs)")
    p.add_argument("--record-dir", default=None,
                   help="where campaign.json lands (default: "
                        "HVDTPU_RECORD_DIR, else the current directory)")
    p.add_argument("--bench", default=None,
                   help="bench command to run per point (default: "
                        "'<python> -m horovod_tpu_torch.bench'); split on "
                        "whitespace")
    p.add_argument("--force-new", action="store_true",
                   help="discard an existing journal and start over")
    p.add_argument("--max-points", type=int, default=0,
                   help="run at most N points this session (0 = all)")
    p.add_argument("--dry-run", action="store_true",
                   help="print the expanded points and exit")
    args = p.parse_args(argv)

    try:
        spec = load_spec(args.spec)
        points = expand_points(spec)
        if args.dry_run:
            for point in points:
                print(json.dumps(point))
            return 0
        record_dir = args.record_dir
        if record_dir is None:
            from ..obs.trend import repo_record_dir  # noqa: PLC0415

            record_dir = repo_record_dir() or os.getcwd()
        journal = run_campaign(
            spec, record_dir,
            bench_cmd=args.bench.split() if args.bench else None,
            force_new=args.force_new, max_points=args.max_points,
        )
    except CampaignError as exc:
        print(f"campaign error: {exc}", file=sys.stderr)
        return 2
    summary = summarize_journal(journal)
    summary["journal"] = _journal_path(record_dir)
    print(json.dumps(summary))
    return 1 if summary["failed"] else 0


if __name__ == "__main__":
    sys.exit(main())
