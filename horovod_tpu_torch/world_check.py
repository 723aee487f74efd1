"""Multi-process check of the port's reductions, one process per GPU:

    python -m horovod_tpu_torch.world_check                 # every GPU
    python -m horovod_tpu_torch.world_check --cpu --world 4 # gloo rehearsal

Spawns a world of ``--world`` processes laid out as hosts of
``--local-size`` ranks (cross-major, as torchrun numbers them), each on its
own GPU (NCCL) or on the CPU (gloo), and holds what a world of one cannot
show against exact references computed in numpy from the same seeded
inputs:

* Adasum over the world and over each host's local group (the XOR-pair
  exchanges): against ``_numpy_adasum_rows``, every rank of a group
  bit-identical;
* the two-level schedules: ``hierarchical_allreduce`` (an uneven length,
  fp32 and a bf16 cross leg), ``hierarchical_reduce_scatter`` (rank (c, l)
  keeps shard l x cross + c) and ``hierarchical_all_gather``;
* ``allreduce`` of IndexedSlices with ragged rows;
* a GPT training step (gpt-small bf16 seq 1024 batch 8 per GPU on the
  card, gpt-nano fp32 on the CPU): 2 warm-up and 5 timed steps from the
  same weights and global batch in ``off``, ``bucket``, the two-level
  ``bucket`` and ``bucket+zero1``, the two-level ``bucket`` with a bf16
  cross leg, and ``DistributedOptimizer(op=Adasum)``: losses finite, the
  mean-reducing ones within 1e-3 of ``off`` (0.01 with the bf16 leg),
  step times.

Prints three JSON lines (every rank's checks, rank 0's training runs, the
verdict) and exits nonzero if any check fails on any rank.  Times are the
host clock around ``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import os
import queue
import socket
import sys
import time
import traceback

__all__ = ["main"]

LENGTH = 4099          # not a multiple of any local size
TOL = 1e-5             # fp32 sums of a few terms in another order
STEPS, WARMUP = 5, 2
LOSS_RTOL = {"mean": 1e-3, "bf16_cross": 1e-2}


def _rows(world: int, seed: int = 0):
    import numpy as np

    return np.random.RandomState(seed).randn(world, LENGTH).astype(np.float32)


def _rel(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _same_on_every_rank(hvd, torch, t) -> bool:
    """Whether ``t`` holds the same bits on every rank of the world."""
    gathered = hvd.allgather(t.reshape(1, -1).float())
    return bool((gathered == gathered[:1]).all())


def _collective_checks(hvd, torch) -> dict:
    import numpy as np

    from .basics import local_group
    from .ops.adasum import _numpy_adasum_rows, adasum_allreduce
    from .ops.sparse import IndexedSlices, to_dense
    from .parallel import hierarchical as hier

    r, world = hvd.rank(), hvd.size()
    local, cross = hvd.local_size(), hvd.cross_size()
    dev = hvd.device()
    rows = _rows(world)
    mine = torch.from_numpy(rows[r]).to(dev)
    out = {}

    y = hvd.allreduce(mine, hvd.Adasum)
    out["adasum_world"] = {
        "rel_err": _rel(y.cpu().numpy(), _numpy_adasum_rows(rows)),
        "same_on_every_rank": _same_on_every_rank(hvd, torch, y)}
    first = r - r % local
    y = adasum_allreduce(mine, group=local_group())
    pair = hvd.allgather(y[None].float()).cpu().numpy()
    out["adasum_local_group"] = {
        "rel_err": _rel(y.cpu().numpy(),
                        _numpy_adasum_rows(rows[first:first + local])),
        "same_in_group": bool((pair[first:first + local]
                               == pair[first]).all())}

    y = hier.hierarchical_allreduce(mine, hvd.Average)
    out["hierarchical_allreduce"] = {
        "rel_err": _rel(y.cpu().numpy(), rows.mean(0))}
    y = hier.hierarchical_allreduce(mine, hvd.Average, compression="bf16")
    partial = np.abs(rows.reshape(cross, local, -1).sum(1)).max()
    out["hierarchical_allreduce_bf16_cross"] = {
        "abs_err": float(np.abs(y.cpu().numpy() - rows.mean(0)).max()),
        "bound": float(2.0 ** -8 * partial / world * 2),
        "dtype": str(y.dtype)}

    flat = torch.arange(8 * world, dtype=torch.float32, device=dev) * (r + 1)
    shard = hier.hierarchical_reduce_scatter(flat)
    total = np.arange(8 * world, dtype=np.float64) * sum(range(1, world + 1))
    index = hier.hierarchical_shard_index(hvd.local_rank(), hvd.cross_rank(),
                                          cross)
    back = hier.hierarchical_all_gather(shard)
    out["hierarchical_scatter_gather"] = {
        "shard_index": index,
        "shard_ok": bool(np.array_equal(shard.cpu().numpy(),
                                        total[8 * index:8 * index + 8])),
        "gather_ok": bool(np.array_equal(back.cpu().numpy(), total))}

    n = 3 + r % 3  # ragged rows
    rng = np.random.RandomState(1)
    values = [rng.randn(3 + q % 3, 4).astype(np.float32) for q in range(world)]
    indices = [rng.randint(0, 16, 3 + q % 3) for q in range(world)]
    s = hvd.allreduce(IndexedSlices(torch.from_numpy(values[r]).to(dev),
                                    torch.from_numpy(indices[r]).to(dev),
                                    (16, 4)), hvd.Average)
    want = np.zeros((16, 4))
    for v, i in zip(values, indices):
        np.add.at(want, i, v / world)
    out["sparse_allreduce"] = {
        "rows": int(s.values.shape[0]), "mine": n,
        "abs_err": float(np.abs(to_dense(s).cpu().numpy() - want).max())}
    return out


def _training(hvd, torch, cpu: bool) -> dict:
    from .optim.overlap import OverlapPlan
    from .train import build_gpt_step, make_adamw

    step_args = (("nano", "fp32", 2, 32) if cpu
                 else ("small", "bf16", 8, 1024))
    axes = (hvd.LOCAL_AXIS, hvd.CROSS_AXIS)
    plans = {
        "off": None,
        "bucket": lambda m: OverlapPlan(m.parameters(), make_adamw,
                                        mode="bucket"),
        "two_level_bucket": lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket",
            hierarchical_axes=axes),
        "two_level_bucket+zero1": lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket+zero1",
            hierarchical_axes=axes),
        "two_level_bucket_bf16_cross": lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket",
            hierarchical_axes=axes, dcn_compression="bf16"),
        "adasum": lambda m: hvd.DistributedOptimizer(
            make_adamw(m.parameters()), op=hvd.Adasum),
    }
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    out = {}
    for name, make in plans.items():
        step, state, _ = build_gpt_step(*step_args,
                                        device="cpu" if cpu else None)
        if make is not None:
            state = (state[0], make(state[0]), state[2])
        losses = []
        for k in range(WARMUP + STEPS):
            if k == WARMUP:
                sync()
                t0 = time.perf_counter()
            model, opt, loss = step(*state)
            state = (model, opt, state[2])
            losses.append(loss)
        sync()
        secs = (time.perf_counter() - t0) / STEPS
        out[name] = {"losses": [float(x) for x in losses],
                     "step_ms": secs * 1e3}
        del step, state, model, opt
    off = out["off"]["losses"]
    for name, run in out.items():
        run["max_rel_loss_diff_vs_off"] = max(
            abs(a - b) / abs(b) for a, b in zip(run["losses"], off))
    out["model"] = "gpt-%s %s seq %d batch %d per rank" % (
        step_args[0], step_args[1], step_args[3], step_args[2])
    return out


def _failures(checks: dict, train: dict) -> list:
    bad = []
    for name in ("adasum_world", "adasum_local_group",
                 "hierarchical_allreduce"):
        if checks[name]["rel_err"] > TOL:
            bad.append(name)
    if not (checks["adasum_world"]["same_on_every_rank"]
            and checks["adasum_local_group"]["same_in_group"]):
        bad.append("adasum ranks disagree")
    c = checks["hierarchical_allreduce_bf16_cross"]
    if c["abs_err"] > c["bound"] or c["dtype"] != "torch.float32":
        bad.append("hierarchical_allreduce_bf16_cross")
    c = checks["hierarchical_scatter_gather"]
    if not (c["shard_ok"] and c["gather_ok"]):
        bad.append("hierarchical_scatter_gather")
    if checks["sparse_allreduce"]["abs_err"] > TOL:
        bad.append("sparse_allreduce")
    for name, run in train.items():
        if name == "model":
            continue
        if not all(math.isfinite(x) for x in run["losses"]):
            bad.append(f"{name}: non-finite loss")
        tol = (LOSS_RTOL["bf16_cross"] if name.endswith("bf16_cross")
               else LOSS_RTOL["mean"])
        if name != "adasum" and run["max_rel_loss_diff_vs_off"] > tol:
            bad.append(f"{name}: losses off by "
                       f"{run['max_rel_loss_diff_vs_off']:.2e}")
    return bad


def _worker(rank, world, local_size, port, cpu, out):
    os.environ.update({
        "HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(world),
        "HVDTPU_LOCAL_RANK": str(rank % local_size),
        "HVDTPU_LOCAL_SIZE": str(local_size),
        "HVDTPU_CROSS_RANK": str(rank // local_size),
        "HVDTPU_CROSS_SIZE": str(world // local_size),
        "HVDTPU_COORDINATOR": f"127.0.0.1:{port}",
    })
    import torch

    import horovod_tpu_torch as hvd

    if cpu:
        torch.set_num_threads(1)
    try:
        # one GPU per process: its local rank counts the GPUs of this
        # machine, so the world's ranks are spread over them
        device = "cpu" if cpu else f"cuda:{rank % torch.cuda.device_count()}"
        hvd.init(device=device)
        checks = _collective_checks(hvd, torch)
        train = _training(hvd, torch, cpu)
        out.put((rank, True, {"checks": checks, "train": train,
                              "failures": _failures(checks, train)}))
    except BaseException:  # noqa: BLE001 - reported to the parent, re-raised
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        hvd.shutdown()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m horovod_tpu_torch."
                                "world_check")
    p.add_argument("--world", type=int, default=None,
                   help="processes (default: every GPU; 4 with --cpu)")
    p.add_argument("--local-size", type=int, default=2,
                   help="ranks per host of the two-level layout")
    p.add_argument("--cpu", action="store_true",
                   help="a gloo world on the CPU (a rehearsal of the "
                   "paths; its times are no device's)")
    p.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args(argv)
    import torch

    if not args.cpu:
        if not torch.cuda.is_available():
            print("world_check: no CUDA device is visible", file=sys.stderr)
            return 2
        from .ops import kernels

        kernels.build_all()  # once, before the ranks load the libraries
    world = args.world or (4 if args.cpu else torch.cuda.device_count())
    if world % args.local_size or world < 2:
        raise SystemExit(f"--world {world} must be >= 2 and a multiple of "
                         f"--local-size {args.local_size}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(r, world, args.local_size,
                                                port, args.cpu, out))
             for r in range(world)]
    for proc in procs:
        proc.start()
    results, errors = {}, []
    try:
        while len(results) + len(errors) < world:
            rank, ok, val = out.get(timeout=args.timeout)
            (results.__setitem__(rank, val) if ok
             else errors.append(f"rank {rank}:\n{val}"))
    except queue.Empty:
        errors.append(f"timed out after {args.timeout}s "
                      f"({sorted(results)} finished)")
    finally:
        for proc in procs:
            proc.join(timeout=30)
            if proc.is_alive():
                proc.kill()
                proc.join(timeout=10)
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    failures = sorted({f for res in results.values()
                       for f in res["failures"]})
    print(json.dumps({"world": world, "local_size": args.local_size,
                      "device": "cpu" if args.cpu
                      else torch.cuda.get_device_name(0),
                      "checks": {r: results[r]["checks"]
                                 for r in sorted(results)}}), flush=True)
    print(json.dumps({"train": results[0]["train"]}), flush=True)
    print(json.dumps({"ok": not failures, "failures": failures}), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
