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
* the eager engine (``eager``): every async op on this rank's tensors
  (CUDA on the card) against numpy — allreduce Sum / Average / Min / Max /
  scaled / int Average / bf16 / Adasum, allgather ragged, broadcast,
  alltoall, reducescatter even and ragged — results on the input's device
  in its dtype and, on the card, ``host_data_ops == 0`` (no CUDA payload
  left the card); ``join`` with rank r submitting r more ops (the joined
  ranks contribute zeros, Average divides by the world); a burst of 16
  small named tensors (fused responses); repeated named ops (cache hits,
  and a schedule-replay epoch after 5 stable cycles, this check's engine
  only); the engine's stats;
* the engine's two-level allreduce (``eager_two_level``): an engine
  started with ``HVDTPU_HIERARCHICAL_ALLREDUCE=1``, once with the cross
  leg exact and once with ``HVDTPU_DCN_COMPRESSION=bf16``, reduces a
  scaled Average, an int32 Sum and a fused burst through ``enqueue``; on
  the card every one runs the two-level schedule (``hierarchical_ops``)
  and none takes a host path;
* a GPT training step (gpt-small bf16 seq 1024 batch 8 per GPU on the
  card, gpt-nano fp32 on the CPU): 2 warm-up and 5 timed steps from the
  same weights and global batch in ``off``, ``bucket``, the two-level
  ``bucket`` and ``bucket+zero1``, the two-level ``bucket`` with a bf16
  cross leg, ``DistributedOptimizer(op=Adasum)`` and ``interop.torch``'s
  hook ``DistributedOptimizer`` on the eager engine (``eager_hook`` with
  the engine's defaults, again with a 1 ms cycle, and again with a 0.5 ms
  interpreter switch interval): losses finite, the
  mean-reducing ones within 1e-3 of ``off`` (0.01 with the bf16 leg,
  1.7e-5 through the engine), step times; for the engine runs the time
  ``step()`` waits in ``synchronize``, the engine's mean cycle work and
  negotiation times, and its cycles, responses and fused responses per
  step.

* the parallel schedules (``a11``, ROADMAP A11): on gpt-small at full
  width in fp32 with TF32 off (12 heads: tp 4 holds 3 a rank), batch 4,
  seq 1024, each rank holds against the unsharded model, which it computes
  itself from the same seed-0 weights and tokens, the loss and the
  gradients of ring, zigzag and Ulysses attention at sp = the world, of
  ``tp_gpt_apply`` at tp = the world, ``pp_gpt_loss`` at pp = the world,
  ``pp_gpt_loss_circular`` at pp 2 x circles 2, ``pp_tp_gpt_loss`` at
  pp 2 x tp 2, ``moe_mlp_ep`` at ep = the world against ``moe_mlp`` (the
  reference's gradient recipe), ``sharded_decode_attention`` against the
  replicated decode, and a width-2 ``SlotEngine`` per pair of ranks
  against the replicated engine's greedy streams.  :func:`a11_checks`
  runs the same at any world size (``chip_smoke.py`` at a world of one).

* the observability planes (``a13``, ROADMAP A13a): gpt-nano bf16 in
  ``bucket`` mode through ``OverlapPlan(health=True)`` and the
  divergence sentinel (``StepHealth``, one check after step 2) with a
  ``grad_ready`` ``flip_bits`` on rank 2's bucket 1 in step 2: every rank
  names rank 2 alone, and the same bucket and leaf; then eager
  allreduces with an ``enqueue`` ``delay`` of 300 ms on rank 3: the
  straggler gauges rank 0's controller keeps blame rank 3 for every
  delayed collective.

* the schedule gate (``a13b6``, ROADMAP A13b item 6; only with ``--only
  a13b6``): every rank runs gpt-nano bf16 in ``bucket`` mode for two steps
  with torch's flight recorder on and dumps its collective schedule
  (``obs.collective_schedule``); rank 0 runs ``python -m
  horovod_tpu_torch.analysis.schedule`` over every rank's dump, which must
  exit 0.

* the SPMD surface (``a14``, ROADMAP A14; only with ``--only a14``):
  ``mesh("hierarchical")``'s dimensions are the port's cross and local
  groups (``group_of_axis``'s, not copies) over the hosts x ranks grid;
  from the same weights and global batch, the gradients of one step
  through ``hvd.distribute`` + ``sync_gradients`` (each rank on the block
  ``P(DP_AXIS)`` gives it: rows ``rank x batch`` on) equal ``off``'s
  (``DistributedOptimizer.synchronize``) within ``TOL``; then the GPT step
  of the training runs written that way (``sync_gradients`` →
  ``DistributedGradientTransform`` → AdamW, through ``distribute``) against
  ``off``: losses within 1e-3, step times.

* the collective microbench (``a17``, ROADMAP A17; only with ``--only
  a17``): ``bench.collective.measure`` at this world for each engine, on
  the payload's card: the Python engine over NCCL (its device plane; on
  the card no op may take a host path) and the native engine around its
  TCP ring with a host round trip of each payload, ``A17_ITERS``
  allreduces of each of ``A17_KB``; every result exactly world x input.
  Rank 0's goodput is printed as the reference's table, one per engine.

``--only a11`` / ``--only a13`` / ``--only a13b6`` / ``--only a14`` /
``--only a17`` runs that section alone.  Prints three
JSON lines (every
rank's checks, rank 0's training runs, the verdict) and exits nonzero if
any check fails on any rank.  Times are the host clock around
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import multiprocessing as mp
import os
import queue
import shutil
import socket
import sys
import tempfile
import time
import traceback

__all__ = ["main", "a11_checks", "a11_failures", "a13_checks",
           "a13_failures", "a13b6_checks", "a13b6_failures", "a14_checks",
           "a14_failures", "a17_checks", "a17_failures"]

# the a13 section's faults: one flipped bit in rank 2's bucket 1 in step 2,
# and rank 3 late by 300 ms to its first A13_DELAYED collectives
A13_FLIP = "grad_ready:rank=2:step=2:name=bucket1:action=flip_bits"
A13_DELAYED = 4
A13_DELAY = f"enqueue:rank=3:action=delay:300:count={A13_DELAYED}"

A13B6_STEPS = 2

# the a17 section: payload sizes (KB, scripts/collective_bench.py's) and
# timed allreduces of each
A17_KB = (4, 1024, 16384)
A17_ITERS = 20

LENGTH = 4099          # not a multiple of any local size
TOL = 1e-5             # fp32 sums of a few terms in another order
STEPS, WARMUP = 5, 2
LOSS_RTOL = {"mean": 1e-3, "bf16_cross": 1e-2, "eager_hook": 1.7e-5,
             "eager_hook_cycle_1ms": 1.7e-5,
             "eager_hook_switch_0.5ms": 1.7e-5}
# the engine's replay threshold in the eager checks: 5 stable cycles (the
# default 50 is longer than the checks' loop of repeated ops); the training
# runs keep the default
REPLAY_CYCLES = "5"
# the engines of the eager training runs: the defaults, and a 1 ms cycle
# (the multi-process default is 10 ms)
HOOK_ENV = {"eager_hook_cycle_1ms": {"HVDTPU_CYCLE_TIME": "1"}}


def _rows(world: int, seed: int = 0):
    import numpy as np

    return np.random.RandomState(seed).randn(world, LENGTH).astype(np.float32)


def _rel(got, want) -> float:
    """Largest difference over the largest reference value (numpy arrays
    or tensors)."""
    import numpy as np

    def arr(x):
        if hasattr(x, "detach"):
            x = x.detach().double().cpu().numpy()
        return np.asarray(x, np.float64)

    got, want = arr(got), arr(want)
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


@contextlib.contextmanager
def _engine_env(**env):
    """A fresh eager engine for the block, started (on the block's first
    eager call) with ``env`` set, and stopped after the block."""
    from . import _engine_registry

    _engine_registry.shutdown_engine()
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        _engine_registry.shutdown_engine()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _two_level_checks(hvd, torch) -> dict:
    """The engine's two-level allreduce, selected by
    ``HVDTPU_HIERARCHICAL_ALLREDUCE=1``, with the cross leg exact and in
    bf16: every op through ``enqueue`` against numpy, and the engine's
    count of two-level executions."""
    import numpy as np

    from . import _engine_registry

    r, world = hvd.rank(), hvd.size()
    dev = hvd.device()
    rng = np.random.RandomState(3)
    x_all = rng.randn(world, 7, 5).astype(np.float32)
    i_all = rng.randint(-40, 40, (world, 9)).astype(np.int32)
    out = {}
    for wire in ("none", "bf16"):
        with _engine_env(HVDTPU_HIERARCHICAL_ALLREDUCE="1",
                         HVDTPU_DCN_COMPRESSION=wire):
            x = torch.from_numpy(x_all[r]).to(dev)
            avg = hvd.synchronize(hvd.allreduce_async(
                x, name="h.avg", prescale_factor=0.5, postscale_factor=2.0))
            isum = hvd.synchronize(hvd.allreduce_async(
                torch.from_numpy(i_all[r]).to(dev), hvd.Sum, name="h.isum"))
            burst = [hvd.allreduce_async(torch.full((4,), float(k),
                                                    device=dev),
                                         hvd.Sum, name=f"h.fuse.{k}")
                     for k in range(16)]
            fused = max(_rel(hvd.synchronize(h).cpu().numpy(),
                             np.full(4, float(k * world)))
                        for k, h in enumerate(burst))
            engine = _engine_registry.get_engine()
            out[wire] = {
                "hierarchical": engine.hierarchical,
                "average_rel_err": _rel(avg.cpu().numpy(), x_all.mean(0)),
                "int_sum_exact": bool(np.array_equal(
                    isum.cpu().numpy(), i_all.sum(0))),
                "fuse_rel_err": fused,
                "device_ok": all(t.device == x.device for t in (avg, isum)),
                "stats": {k: engine.stats[k] for k in (
                    "hierarchical_ops", "fused_responses", "device_data_ops",
                    "host_data_ops", "host_staged_ops")}}
    return out


def _eager_checks(hvd, torch, cpu: bool) -> dict:
    """The eager engine on this world: every async op against numpy, join
    with uneven submissions, repeated ops, and the engine's stats."""
    import numpy as np

    from . import _engine_registry
    from .ops import eager

    r, world = hvd.rank(), hvd.size()
    dev = hvd.device()
    rng = np.random.RandomState(2)
    x_all = rng.randn(world, 5, 3).astype(np.float32)
    i_all = rng.randint(-40, 40, (world, 6)).astype(np.int32)
    x = torch.from_numpy(x_all[r]).to(dev)
    rows = torch.from_numpy(np.arange(world * 2 * 3, dtype=np.float32)
                            .reshape(world * 2, 3) * (r + 1)).to(dev)
    ragged = torch.full((1 + r, 3), float(r), device=dev)
    ops = {
        "sum": (lambda: hvd.allreduce_async(x, hvd.Sum, name="e.sum"),
                x_all.sum(0)),
        "average": (lambda: hvd.allreduce_async(x, name="e.avg"),
                    x_all.mean(0)),
        "min": (lambda: hvd.allreduce_async(x, hvd.Min, name="e.min"),
                x_all.min(0)),
        "max": (lambda: hvd.allreduce_async(x, hvd.Max, name="e.max"),
                x_all.max(0)),
        "scaled": (lambda: hvd.allreduce_async(
            x, hvd.Sum, name="e.scaled", prescale_factor=0.5,
            postscale_factor=4.0), x_all.sum(0) * 2.0),
        "int_average": (lambda: hvd.allreduce_async(
            torch.from_numpy(i_all[r]).to(dev), name="e.iavg"),
            np.floor_divide(i_all.astype(np.int64).sum(0), world)),
        "bf16_sum": (lambda: hvd.allreduce_async(
            x.bfloat16(), hvd.Sum, name="e.bf16"), x_all.sum(0)),
        "adasum": (lambda: hvd.allreduce_async(x, hvd.Adasum,
                                               name="e.adasum"),
                   _adasum_rows(x_all)),
        "allgather_ragged": (lambda: hvd.allgather_async(
            ragged, name="e.ag"), np.concatenate(
                [np.full((1 + q, 3), float(q)) for q in range(world)])),
        "broadcast": (lambda: hvd.broadcast_async(x, world - 1,
                                                  name="e.bcast"),
                      x_all[world - 1]),
        "alltoall": (lambda: eager.alltoall_async(rows, name="e.a2a"),
                     np.concatenate([np.arange(world * 6, dtype=np.float64)
                                     .reshape(world * 2, 3)[2 * r:2 * r + 2]
                                     * (q + 1) for q in range(world)])),
        "reducescatter": (lambda: eager.reducescatter_async(
            rows, hvd.Sum, name="e.rs"),
            (np.arange(world * 6, dtype=np.float64).reshape(world * 2, 3)
             * sum(range(1, world + 1)))[2 * r:2 * r + 2]),
        "reducescatter_ragged": (lambda: eager.reducescatter_async(
            x, hvd.Average, name="e.rs_ragged"), None),
    }
    out = {}
    handles = {k: fn() for k, (fn, _) in ops.items()}
    for k, h in handles.items():
        got = hvd.synchronize(h)
        want = ops[k][1]
        if k == "reducescatter_ragged":  # 5 rows: the first 5 % world ranks
            base, rem = divmod(5, world)  # keep one more
            lo = r * base + min(r, rem)
            want = x_all.mean(0)[lo:lo + base + (r < rem)]
        out[k] = {"rel_err": _rel(got.float().cpu().numpy(), want),
                  "device_ok": got.device == x.device,
                  "dtype": str(got.dtype)}
    # join with uneven submissions: rank r submits r more averages
    late = [hvd.synchronize(hvd.allreduce_async(
        torch.full((4,), float((r + 1) * (k + 1)), device=dev),
        name=f"e.late.{k}")) for k in range(r)]
    out["join_last"] = hvd.join()
    out["join_rel_err"] = max(
        [_rel(got.cpu().numpy(), np.full(4, sum(
            (q + 1) * (k + 1) for q in range(k + 1, world)) / world))
         for k, got in enumerate(late)] or [0.0])
    burst = [hvd.allreduce_async(torch.full((4,), float(k), device=dev),
                                 hvd.Sum, name=f"e.fuse.{k}")
             for k in range(16)]  # small same-kind tensors: they fuse
    out["fuse_rel_err"] = max(_rel(hvd.synchronize(h).cpu().numpy(),
                                   np.full(4, float(k * world)))
                              for k, h in enumerate(burst))
    for _ in range(40):  # one name again and again: cache hits, replay
        hvd.synchronize(hvd.allreduce_async(x, hvd.Sum, name="e.repeat"))
    stats = dict(_engine_registry.get_engine().stats)
    out["stats"] = {k: stats[k] for k in (
        "cycles", "negotiated_cycles", "replay_cycles", "replay_epochs",
        "cache_hits", "fused_responses", "negotiated_responses",
        "cached_responses", "control_bytes", "payload_bytes",
        "host_data_ops", "host_staged_ops", "device_data_ops",
        "device_payload_bytes")}
    out["on_card"] = not cpu
    return out


def _adasum_rows(rows):
    from .ops.adasum import _numpy_adasum_rows

    return _numpy_adasum_rows(rows.reshape(rows.shape[0], -1)).reshape(
        rows.shape[1:])


def _time_synchronize(opt) -> list:
    """Record the seconds each ``opt.synchronize()`` takes (the step's
    wait on the engine) into the returned list."""
    waits = []
    inner = opt.synchronize

    def timed():
        t0 = time.perf_counter()
        inner()
        waits.append(time.perf_counter() - t0)

    opt.synchronize = timed
    return waits


def _cycle_hists():
    """``(count, sum)`` of the engine's cycle work time (a cycle's time
    without its sleep) and of its negotiation time, in ms."""
    from .obs import get_registry

    reg = get_registry()
    return tuple((h.count, h.sum) for h in (
        reg.histogram("engine.cycle_time_ms"),
        reg.histogram("engine.negotiation_ms")))


def _training(hvd, torch, cpu: bool) -> dict:
    from . import _engine_registry
    from .interop import torch as ht
    from .optim.overlap import OverlapPlan
    from .train import build_gpt_step, make_adamw

    step_args = _gpt_step_args(cpu)
    axes = (hvd.LOCAL_AXIS, hvd.CROSS_AXIS)

    def hook(m):
        return ht.DistributedOptimizer(make_adamw(m.parameters()),
                                       named_parameters=m.named_parameters())

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
        "eager_hook": hook,
        "eager_hook_cycle_1ms": hook,
        # the same with the interpreter's thread switch interval cut from
        # 5 ms to 0.5 ms: the engine's thread and the training thread share
        # the GIL, and each GIL-releasing call of the engine (every gloo
        # and NCCL call) waits up to one interval to take it back
        "eager_hook_switch_0.5ms": hook,
    }
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    out = {}
    for name, make in plans.items():
        step, state, _ = build_gpt_step(*step_args,
                                        device="cpu" if cpu else None)
        if make is not None:
            state = (state[0], make(state[0]), state[2])
        eager_run = name.startswith("eager_hook")
        if eager_run:
            waits = _time_synchronize(state[1])
        switch = sys.getswitchinterval()
        if name == "eager_hook_switch_0.5ms":
            sys.setswitchinterval(0.0005)
        losses = []
        # each engine run starts an engine of its own, with its knobs
        with (_engine_env(**HOOK_ENV.get(name, {})) if eager_run
              else contextlib.nullcontext()):
            try:
                for k in range(WARMUP + STEPS):
                    if k == WARMUP:
                        sync()
                        t0 = time.perf_counter()
                        if eager_run:
                            stats0 = dict(_engine_registry.get_engine().stats)
                            hist0 = _cycle_hists()
                            waits.clear()
                    model, opt, loss = step(*state)
                    state = (model, opt, state[2])
                    losses.append(loss)
                sync()
                secs = (time.perf_counter() - t0) / STEPS
            finally:
                sys.setswitchinterval(switch)
            out[name] = {"losses": [float(x) for x in losses],
                         "step_ms": secs * 1e3}
            if eager_run:
                stats = _engine_registry.get_engine().stats
                (n, work), (m, neg) = (
                    (c - c0, s_ - s0) for (c, s_), (c0, s0)
                    in zip(_cycle_hists(), hist0))
                out[name].update(
                    synchronize_ms=sum(waits) * 1e3 / STEPS,
                    cycle_work_ms=work / max(n, 1),
                    negotiation_ms=neg / max(m, 1),
                    per_step={k: (stats[k] - stats0[k]) / STEPS for k in (
                        "cycles", "negotiated_cycles", "replay_cycles",
                        "cached_responses", "negotiated_responses",
                        "fused_responses", "device_data_ops",
                        "host_data_ops", "host_staged_ops")})
        del step, state, model, opt
    off = out["off"]["losses"]
    for name, run in out.items():
        run["max_rel_loss_diff_vs_off"] = max(
            abs(a - b) / abs(b) for a, b in zip(run["losses"], off))
    out["model"] = "gpt-%s %s seq %d batch %d per rank" % (
        step_args[0], step_args[1], step_args[3], step_args[2])
    return out


# ---------------------------------------------------------------------------
# the parallel schedules (ROADMAP A11)
# ---------------------------------------------------------------------------

# the fp32 gates: losses as train_fp32's (chip_smoke.FP32_LOSS_RTOL), the
# gradients' largest difference against the unsharded model's largest
# gradient (sums over ranks and microbatches in other orders)
A11_LOSS_RTOL = 1e-5
A11_GRAD_RTOL = 1e-4
# the MoE layer at gpt-small width, 8 experts (2 a rank at ep 4)
A11_EXPERTS = 8
# greedy streams of the width-sharded engine: requests and tokens
A11_ENGINE = {"slots": 4, "prompt": 24, "new": 16}
# a diverging greedy token is allowed only at a near tie of the
# replicated model's logits
A11_MARGIN = 1e-3


def _a11_config(small: bool):
    """(model overrides, batch, seq): gpt-small at full width, or a small
    fp32 model (the CPU's, and the GPU test's)."""
    import torch

    if small:
        return (dict(num_layers=4, num_heads=4, emb_dim=64, max_len=64,
                     vocab_size=256, dtype=torch.float32), 4, 32)
    return dict(dtype=torch.float32), 4, 1024


def _a11_layouts(world: int) -> dict:
    """Axis sizes of each check at this world size."""
    pp2 = 2 if world % 2 == 0 else 1
    tp2 = 2 if world % 4 == 0 else 1
    return {"sp": {"sp": world}, "tp": {"tp": world}, "pp": {"pp": world},
            "ep": {"ep": world}, "seq": {"seq": world},
            "circular": {"dp": world // pp2, "pp": pp2},
            "pp_tp": {"dp": world // (pp2 * tp2), "pp": pp2, "tp": tp2},
            "width": {"replica": world // pp2, "width": pp2}}


def _tree_rel(got: dict, want: dict) -> float:
    from .parallel.tensor_parallel import flat_params

    got, want = flat_params(got), flat_params(want)
    return max(_rel(got[k], want[k]) for k in want)


def a11_checks(hvd, torch, cpu: bool, small=None) -> dict:
    """Every A11 schedule at this world's size against the unsharded model
    on this rank (see the module docstring); per check the loss's relative
    difference, the gradients' (``grad_rel``), the host ms of one forward
    and backward and, where the kernels run, their launches.  ``small``
    (default: on the CPU) takes the small model.  TF32 matmuls are off for
    the checks and restored after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _a11_checks(hvd, torch, cpu,
                           cpu if small is None else small)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def _a11_checks(hvd, torch, cpu: bool, small: bool) -> dict:
    import numpy as np
    import torch.nn.functional as F

    from . import basics
    from .models import decode, gpt
    from .ops import flash_attention as fa
    from .ops.collectives import _axis
    from .parallel import (
        MoEParams, init_moe_params, local_shard, moe_mlp, moe_mlp_ep,
        pp_gpt_loss, pp_gpt_loss_circular, pp_tp_gpt_loss, stack_pp_params,
        stack_pp_params_circular, stack_tp_params, stack_tp_pp_params,
        tp_gpt_apply, zigzag_positions, zigzag_shard)
    from .parallel.tensor_parallel import param_tree
    from .serve.longctx import sharded_decode_attention

    world, rank = hvd.size(), hvd.rank()
    dev = hvd.device()
    over, batch, seq = _a11_config(small)
    layouts = _a11_layouts(world)
    sync = (lambda: None) if cpu else torch.cuda.synchronize

    def model_of(impl, **kw):
        return gpt("nano" if small else "small", device=dev,
                   attention_impl=impl, generator=torch.Generator()
                   .manual_seed(0), **over, **kw)

    vocab = model_of("reference").cfg.vocab_size
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, vocab, (batch, seq + 1))).to(dev)
    toks, tgt = tokens[:, :-1], tokens[:, 1:]

    def nll(logits, y):
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               y.reshape(-1))

    def leaves(tree):
        return {k: (leaves(v) if isinstance(v, dict)
                    else v.detach().clone().requires_grad_())
                for k, v in tree.items()}

    def grads(tree):
        return {k: (grads(v) if isinstance(v, dict) else v.grad)
                for k, v in tree.items()}

    refs = {}
    for impl in ("reference", "flash"):
        model = model_of(impl)
        loss = nll(model(toks), tgt)
        loss.backward()
        refs[impl] = (loss.item(), {n: p.grad.detach().clone()
                                    for n, p in model.named_parameters()})
        del model
    base = model_of("flash")

    def timed(fn):
        sync()
        fa.reset_launch_counts()
        t0 = time.perf_counter()
        loss = fn()
        loss.backward()
        sync()
        return loss, (time.perf_counter() - t0) * 1e3, dict(fa.LAUNCHES)

    def record(loss, ms, launches, ref, grad_rel):
        loss = loss.item()
        return {"loss": loss, "loss_rel": abs(loss - ref[0]) / abs(ref[0]),
                "grad_rel": grad_rel, "ms": ms,
                "launches": {k: v for k, v in launches.items() if v}}

    out = {}
    # -- sequence parallelism: this rank's shard of every row; the mean
    # token loss summed over the axis, the parameter gradients too
    basics.init_axes(layouts["sp"])
    s_loc = seq // world
    for impl in ("ring", "zigzag", "ulysses"):
        model = model_of(impl, sp_axis="sp")
        if impl == "zigzag":
            zz = lambda t: zigzag_shard(t, world, axis=1)  # noqa: E731
            tk = zz(toks)[:, rank * s_loc:(rank + 1) * s_loc]
            ty = zz(tgt)[:, rank * s_loc:(rank + 1) * s_loc]
            kw = {"positions": zigzag_positions(rank, world, s_loc,
                                                device=dev)}
        else:
            tk = toks[:, rank * s_loc:(rank + 1) * s_loc]
            ty = tgt[:, rank * s_loc:(rank + 1) * s_loc]
            kw = {"pos_offset": rank * s_loc}
        loss, ms, launches = timed(lambda: nll(model(tk, **kw), ty) / world)
        total = loss.detach().clone()
        g = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
        if world > 1:
            torch.distributed.all_reduce(total)
            for t in g.values():
                torch.distributed.all_reduce(t)
        ref = refs["reference"]
        out[f"sp_{impl}"] = record(total, ms, launches, ref, max(
            _rel(g[n], ref[1][n]) for n in ref[1]))
        del model

    # -- tensor parallelism: whole heads a rank, flash attention on them
    basics.init_axes(layouts["tp"])
    ref = refs["flash"]
    sh, rep = stack_tp_params(base, base.cfg, world)
    sh, rep = leaves(local_shard(sh, rank)), leaves(rep)
    loss, ms, launches = timed(
        lambda: nll(tp_gpt_apply(sh, rep, base.cfg, toks, "tp"), tgt))
    want_sh, want_rep = stack_tp_params(ref[1], base.cfg, world)
    out["tp"] = record(loss, ms, launches, ref, max(
        _tree_rel(grads(sh), local_shard(want_sh, rank)),
        _tree_rel(grads(rep), want_rep)))
    out["tp"]["heads_per_rank"] = base.cfg.num_heads // world

    # -- the pipelines: one microbatch a sequence row
    def pipeline(name, layout, stack, run, index):
        coords = basics.init_axes(layout)
        st, rp = stack(base)
        st, rp = leaves(index(st, coords)), leaves(rp)
        loss, ms, launches = timed(lambda: run(st, rp))
        want_st, want_rp = stack(ref[1])
        out[name] = record(loss, ms, launches, ref, max(
            _tree_rel(grads(st), index(want_st, coords)),
            _tree_rel(grads(rp), want_rp)))

    pp_idx = lambda t, c: local_shard(t, c["pp"])  # noqa: E731
    pipeline("pp", layouts["pp"],
             lambda m: stack_pp_params(m if isinstance(m, dict)
                                       else m.state_dict(), base.cfg, world),
             lambda st, rp: pp_gpt_loss(st, rp, base.cfg, toks, tgt, "pp",
                                        microbatches=batch), pp_idx)
    pp2 = layouts["circular"]["pp"]
    pipeline("pp_circular", layouts["circular"],
             lambda m: stack_pp_params_circular(
                 m if isinstance(m, dict) else m.state_dict(), base.cfg,
                 pp2, 2),
             lambda st, rp: pp_gpt_loss_circular(
                 st, rp, base.cfg, toks, tgt, "pp", microbatches=batch,
                 circles=2), pp_idx)
    lay = layouts["pp_tp"]

    def tp_pp_stack(m):
        a, b, c = stack_tp_pp_params(m if isinstance(m, dict)
                                     else m.state_dict(), base.cfg,
                                     lay["pp"], lay["tp"])
        return {"sh": a, "srep": b}, c

    def tp_pp_index(t, c):
        p, q = c["pp"], c["tp"]
        from .parallel.tensor_parallel import _map

        return {"sh": _map(lambda a: a[p:p + 1, q:q + 1], t["sh"]),
                "srep": local_shard(t["srep"], p)}

    pipeline("pp_tp", lay, tp_pp_stack,
             lambda st, rp: pp_tp_gpt_loss(st["sh"], st["srep"], rp,
                                           base.cfg, toks, tgt, "pp", "tp",
                                           microbatches=batch), tp_pp_index)

    # -- expert parallelism against the dense layer, the reference's
    # recipe: the router's gradient averaged over the axis, the experts'
    # divided by its size
    basics.init_axes(layouts["ep"])
    d = base.cfg.emb_dim
    p = init_moe_params(torch.Generator().manual_seed(1), d, 4 * d,
                        A11_EXPERTS, device=dev)
    x = (torch.randn((world * 2, seq, d), generator=torch.Generator()
                     .manual_seed(2)) * 0.5).to(dev)
    e_loc = A11_EXPERTS // world
    mine = slice(rank * e_loc, (rank + 1) * e_loc)
    lp = MoEParams(p.router.clone().requires_grad_(),
                   *(t[mine].clone().requires_grad_() for t in p[1:]))
    xr = x[rank * 2:(rank + 1) * 2]
    sync()
    t0 = time.perf_counter()
    y, aux = moe_mlp_ep(xr, lp, "ep")
    ((y ** 2).mean() + 0.01 * aux).backward()
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    dp = MoEParams(*(t.clone().requires_grad_() for t in p))
    total = 0.0
    for r in range(world):
        yd, auxd = moe_mlp(x[r * 2:(r + 1) * 2], dp)
        total = total + ((yd ** 2).mean() + 0.01 * auxd) / world
        if r == rank:
            y_want, aux_want = yd.detach(), auxd.item()
    total.backward()
    router = lp.router.grad.clone()
    if world > 1:
        torch.distributed.all_reduce(router)
        router /= world
    aux_all = aux.detach().clone()
    out["moe_ep"] = {
        "y_rel": _rel(y, y_want), "ms": ms, "aux": float(aux_all),
        "grad_rel": max([_rel(router, dp.router.grad)] + [
            _rel(getattr(lp, f).grad / world, getattr(dp, f).grad[mine])
            for f in ("w1", "b1", "w2", "b2")]),
        "aux_dense_rank": aux_want, "experts_per_rank": e_loc}

    # -- long-context decode: this rank's chunk of every slot's cache
    basics.init_axes(layouts["seq"])
    cfg = base.cfg
    gen = torch.Generator().manual_seed(3)
    b_dec, s_dec = 8, seq
    q = torch.randn((b_dec, cfg.num_heads, cfg.head_dim), generator=gen)
    kc = torch.randn((b_dec, s_dec, cfg.kv_heads, cfg.head_dim),
                     generator=gen)
    vc = torch.randn(kc.shape, generator=gen)
    pos = torch.randint(0, s_dec, (b_dec,), generator=gen)
    q, kc, vc, pos = (t.to(dev) for t in (q, kc, vc, pos))
    chunk = s_dec // world
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        got = sharded_decode_attention(
            cfg, q, kc[:, rank * chunk:(rank + 1) * chunk],
            vc[:, rank * chunk:(rank + 1) * chunk], pos, "seq")
        sync()
        ms = (time.perf_counter() - t0) * 1e3
        want = decode._attend_cached(cfg, q, kc, vc, pos)
    out["sharded_decode"] = {"rel": _rel(got, want), "ms": ms}

    # -- a width-sharded engine per pair of ranks against the replicated
    # engine on this rank: the same greedy streams, or a divergence only at
    # a near tie of the replicated model's logits
    lay = layouts["width"]
    if lay["width"] > 1:
        basics.init_axes(lay)
        out["width_engine"] = _width_engine_check(torch, base, dev)
    basics.init_axes({"world": world})
    return out


def _width_engine_check(torch, model, dev) -> dict:
    import numpy as np

    from .serve import SlotEngine

    n = A11_ENGINE["slots"]
    rng = np.random.RandomState(5)
    prompts = [rng.randint(0, model.cfg.vocab_size,
                           A11_ENGINE["prompt"] - 3 * i).tolist()
               for i in range(n)]
    new = A11_ENGINE["new"]

    def streams(width):
        eng = SlotEngine(model, n, kv_mode="paged", page_size=16,
                         width=width)
        toks = {s: [eng.admit(s, p)] for s, p in enumerate(prompts)}
        for _ in range(new - 1):
            for s, t in eng.step(list(toks)).items():
                toks[s].append(t)
        return [toks[s] for s in range(n)], eng

    t0 = time.perf_counter()
    got, eng = streams(2)
    ms = (time.perf_counter() - t0) * 1e3
    heads = int(eng.cache["k"].shape[3])
    want, _ = streams(1)
    compared, near_ties = 0, 0
    with torch.inference_mode():
        for prompt, g, w in zip(prompts, got, want):
            logits = model(torch.tensor([prompt + w[:-1]], device=dev))[0]
            scores = logits[len(prompt) - 1:].float().cpu().numpy()
            for i, (a, b) in enumerate(zip(g, w)):
                compared += 1
                if a != b:
                    top = np.sort(scores[i])[-2:]
                    if top[1] - top[0] > A11_MARGIN:
                        return {"ok": False, "compared": compared,
                                "diverged_at": i, "gap": float(
                                    top[1] - top[0])}
                    near_ties += 1
                    break
    return {"ok": True, "compared": compared, "near_ties": near_ties,
            "ms": ms, "pool_kv_heads": heads}


def a11_failures(checks: dict) -> list:
    """The A11 checks out of bounds."""
    bad = []
    for name, c in checks.items():
        if name.startswith(("sp_", "tp", "pp")):
            if not (c["loss_rel"] <= A11_LOSS_RTOL
                    and c["grad_rel"] <= A11_GRAD_RTOL):
                bad.append(f"a11 {name}: loss {c['loss_rel']:.2e} grad "
                           f"{c['grad_rel']:.2e}")
    c = checks["moe_ep"]
    if not (c["y_rel"] <= A11_LOSS_RTOL and c["grad_rel"] <= A11_GRAD_RTOL
            and math.isfinite(c["aux"])):
        bad.append(f"a11 moe_ep: {c}")
    if checks["sharded_decode"]["rel"] > A11_LOSS_RTOL:
        bad.append(f"a11 sharded_decode: {checks['sharded_decode']}")
    if "width_engine" in checks and not checks["width_engine"]["ok"]:
        bad.append(f"a11 width_engine: {checks['width_engine']}")
    return bad


def a13_checks(hvd, torch, cpu: bool) -> dict:
    """The divergence sentinel localizing a flipped bit, and straggler
    attribution naming a delayed rank (the module docstring's ``a13``)."""
    from .obs import straggler
    from .obs.health import HealthConfig, StepHealth
    from .testing import faults
    from .train import build_gpt_step

    out = {}
    with _engine_env(HVDTPU_FAULT_SPEC=A13_FLIP):
        faults.reset()
        step, (model, plan, toks), _ = build_gpt_step(
            "nano", "bf16", 4, 128, overlap_mode="bucket",
            grad_bucket_mb=0.25, device="cpu" if cpu else None, health=True)
        names = [n for n, _ in model.named_parameters()]
        sh = StepHealth(plan, rank=hvd.rank(), leaf_names=names,
                        config=HealthConfig(enabled=True, check_steps=2,
                                            divergence_action="warn"))
        for k in (1, 2):
            out_k = step(model, plan, toks)
            sh.after_step(k, out_k[3])
        sh.drain()
        rep = sh.reports[0] if sh.reports else None
        out["sentinel"] = None if rep is None else {
            "minority": list(rep.minority_ranks), "bucket": rep.bucket,
            "leaf": rep.leaf_name, "checks": sh.sentinel.checks}
        plan.close()
    faults.reset()
    straggler.reset()
    with _engine_env(HVDTPU_FAULT_SPEC=A13_DELAY):
        faults.reset()
        for i in range(A13_DELAYED):
            hvd.synchronize(hvd.allreduce_async(torch.ones(8),
                                                name=f"a13.late{i}"))
        from .obs import get_registry

        blamed = {m["tags"]["rank"]: m["value"]
                  for m in get_registry().snapshot()
                  if m["name"] == straggler.PREFIX + "last_arrivals"}
        out["straggler"] = {"last_arrivals": blamed}
    faults.reset()
    return out


def a13_failures(checks: dict) -> list:
    """The A13 checks out of bounds on one rank's checks (the verdicts
    across ranks and the straggler books are ``_a13_world_failures``')."""
    bad = []
    rep = checks["sentinel"]
    if rep is None or rep["minority"] != [2]:
        bad.append(f"a13 sentinel: {rep}")
    return bad


def _a13_world_failures(per_rank: dict) -> list:
    """Across ranks: one verdict (bucket and leaf) everywhere, and rank 0's
    straggler books blaming rank 3 the most, for every delayed
    collective."""
    bad = []
    verdicts = {(c["sentinel"] or {}).get("bucket") for c in per_rank.values()}
    leaves = {(c["sentinel"] or {}).get("leaf") for c in per_rank.values()}
    if len(verdicts) != 1 or len(leaves) != 1 or None in leaves:
        bad.append(f"a13 sentinel verdicts differ: {verdicts} {leaves}")
    blamed = per_rank[0]["straggler"]["last_arrivals"]
    top = max(blamed, key=blamed.get) if blamed else None
    if top != "3" or blamed["3"] < A13_DELAYED:
        bad.append(f"a13 straggler: {blamed}")
    return bad


def a13b6_checks(hvd, torch, cpu: bool, out_dir: str) -> dict:
    """Two ``bucket`` steps with the flight recorder on, this rank's schedule
    dumped to ``out_dir``; rank 0 then runs the schedule CLI over every
    rank's dump (the module docstring's ``a13b6``)."""
    import subprocess

    import torch.distributed as dist

    from .obs.collective_schedule import dump_collective_schedule
    from .train import build_gpt_step

    step, (model, plan, toks), _ = build_gpt_step(
        "nano", "bf16", 4, 128, overlap_mode="bucket", grad_bucket_mb=0.25,
        device="cpu" if cpu else None)
    for _ in range(A13B6_STEPS):
        step(model, plan, toks)
    if not cpu:
        torch.cuda.synchronize()
    entries = dump_collective_schedule(
        os.path.join(out_dir, f"rank{hvd.rank()}.json"))
    dist.barrier()  # every dump is on disk
    out = {"entries": entries, "buckets": len(plan.layout.buckets)}
    plan.close()
    if hvd.rank() == 0:
        pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
        cli = subprocess.run(
            [sys.executable, "-m", "horovod_tpu_torch.analysis.schedule",
             "--expect-collectives", "1",
             *(f"rank{r}={os.path.join(out_dir, f'rank{r}.json')}"
               for r in range(hvd.size()))],
            capture_output=True, text=True, timeout=300,
            env={**os.environ, "PYTHONPATH": pkg_parent + os.pathsep
                 + os.environ.get("PYTHONPATH", "")})
        out["cli_rc"] = cli.returncode
        out["cli_out"] = (cli.stdout + cli.stderr)[-3000:]
    return out


def a13b6_failures(checks: dict) -> list:
    bad = []
    if checks["entries"] <= 0:
        bad.append(f"a13b6: empty schedule {checks}")
    if checks.get("cli_rc", 0) != 0:
        bad.append(f"a13b6: the schedule CLI exited {checks['cli_rc']}:\n"
                   f"{checks['cli_out']}")
    return bad


def _gpt_step_args(cpu: bool) -> tuple:
    return ("nano", "fp32", 2, 32) if cpu else ("small", "bf16", 8, 1024)


def a14_checks(hvd, torch, cpu: bool) -> dict:
    """The module docstring's ``a14``: the hierarchical mesh's groups, one
    step's gradients through ``distribute`` + ``sync_gradients`` against
    ``off``'s, and the two training runs."""
    import numpy as np
    import torch.distributed as dist

    from . import basics
    from .optim import P
    from .train import build_gpt_step, lm_loss, lm_loss_fn, make_adamw

    r, world = hvd.rank(), hvd.size()
    local_n, cross_n = hvd.local_size(), hvd.cross_size()
    m = hvd.mesh("hierarchical")
    names = m.mesh_dim_names
    out = {"mesh": {
        "names": list(names), "shape": list(m.shape),
        "grid": m.mesh.tolist(),
        "ranks": [dist.get_process_group_ranks(m.get_group(a))
                  for a in names],
        "own": [m.get_group(a) is basics.group_of_axis(a) for a in names],
        "want_grid": [[c * local_n + l for l in range(local_n)]
                      for c in range(cross_n)],
        "want_ranks": [
            [c * local_n + hvd.local_rank() for c in range(cross_n)],
            [hvd.cross_rank() * local_n + l for l in range(local_n)]]}}

    args = _gpt_step_args(cpu)
    device = "cpu" if cpu else None
    sync = (lambda: None) if cpu else torch.cuda.synchronize
    # build_gpt_step's global batch: every rank holds all of it, and
    # distribute hands each its block
    _, (model, opt, local), _ = build_gpt_step(*args, device=device)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, model.cfg.vocab_size, size=(args[2] * world, args[3] + 1))).to(
            local.device)
    opt.zero_grad()
    lm_loss(model, local).backward()
    opt.synchronize()
    want = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    params = dict(model.named_parameters())
    blocks = []

    def grads_of(toks):
        blocks.append(toks)
        return hvd.sync_gradients(lm_loss_fn(model), params, toks)[1]

    grads = hvd.distribute(grads_of, out_specs=P())(tokens)
    out["grads_rel_err"] = max(_rel(grads[n], w) for n, w in want.items())
    out["block_ok"] = bool(torch.equal(blocks[0], local)) and bool(
        torch.equal(blocks[0], tokens[r * args[2]:(r + 1) * args[2]]))
    del model, opt, params, grads, want, blocks

    runs = {}
    for name in ("off", "spmd"):
        step, (model, opt, local), _ = build_gpt_step(*args, device=device)
        toks = local
        if name == "spmd":
            params = dict(model.named_parameters())
            opt = make_adamw(params.values())
            tx = hvd.DistributedGradientTransform()
            loss_fn = lm_loss_fn(model)

            def local_step(model, opt, toks, params=params, tx=tx,
                           loss_fn=loss_fn):
                loss, g = hvd.sync_gradients(loss_fn, params, toks)
                g, _ = tx.update(g, tx.init(params))
                for n, p in params.items():
                    p.grad = g[n]
                opt.step()
                return model, opt, hvd.allreduce(loss)

            step, toks = hvd.distribute(local_step), tokens
        losses = []
        for k in range(WARMUP + STEPS):
            if k == WARMUP:
                sync()
                t0 = time.perf_counter()
            model, opt, loss = step(model, opt, toks)
            losses.append(loss)
        sync()
        runs[name] = {"losses": [float(x) for x in losses],
                      "step_ms": (time.perf_counter() - t0) / STEPS * 1e3}
        del step, model, opt
    off = runs["off"]["losses"]
    runs["spmd"]["max_rel_loss_diff_vs_off"] = max(
        abs(a - b) / abs(b) for a, b in zip(runs["spmd"]["losses"], off))
    out["train"] = runs
    out["model"] = "gpt-%s %s seq %d batch %d per rank" % (
        args[0], args[1], args[3], args[2])
    return out


def a14_failures(checks: dict) -> list:
    bad = []
    m = checks["mesh"]
    if m["grid"] != m["want_grid"] or m["ranks"] != m["want_ranks"] \
            or m["own"] != [True, True]:
        bad.append(f"a14: mesh('hierarchical') {m}")
    if checks["grads_rel_err"] > TOL:
        bad.append(f"a14: gradients off by {checks['grads_rel_err']:.2e}")
    if not checks["block_ok"]:
        bad.append("a14: a rank's block is not the one P(DP_AXIS) gives")
    spmd = checks["train"]["spmd"]
    if not all(math.isfinite(x) for x in spmd["losses"]
               + checks["train"]["off"]["losses"]):
        bad.append("a14: non-finite loss")
    if spmd["max_rel_loss_diff_vs_off"] > LOSS_RTOL["mean"]:
        bad.append(f"a14: losses off by "
                   f"{spmd['max_rel_loss_diff_vs_off']:.2e}")
    return bad


def a17_checks(hvd, torch, cpu: bool) -> dict:
    """Each engine's microbench cells at this world (the a17 section)."""
    from .bench import collective

    dev = str(hvd.device())
    out = {}
    for engine in ("python", "native"):
        with _engine_env(HVDTPU_EAGER_ENGINE=engine,
                         HVDTPU_CYCLE_TIME=collective.CYCLE_MS):
            out[engine] = [collective.measure(kb * 1024, A17_ITERS, dev,
                                              name=f"bench.{kb}")
                           for kb in A17_KB]
    return out


def a17_failures(checks: dict) -> list:
    bad = []
    for engine, cells in checks.items():
        for c in cells:
            if not c["exact"]:
                bad.append(f"a17 {engine} {c['bytes']} B: not world x input")
            s = c["stats"]
            if not c["device"].startswith("cuda"):
                continue
            if engine == "python" and (s["host_data_ops"]
                                       or s["host_staged_ops"]
                                       or not s["device_data_ops"]):
                bad.append(f"a17 python {c['bytes']} B: a CUDA payload "
                           f"took a host path {s}")
            if engine == "native" and s["device_payloads"] < c["iters"]:
                bad.append(f"a17 native {c['bytes']} B: {s['device_payloads']}"
                           f" CUDA payloads for {c['iters']} ops")
    return bad


def _failures(checks: dict, train: dict) -> list:
    if "a17" in checks:  # --only a17
        return a17_failures(checks["a17"])
    if "a14" in checks:  # --only a14
        return a14_failures(checks["a14"])
    if "a13" in checks:  # --only a13
        return a13_failures(checks["a13"])
    if "a13b6" in checks:  # --only a13b6
        return a13b6_failures(checks["a13b6"])
    if "eager" not in checks:  # --only a11
        return a11_failures(checks["a11"])
    bad = a11_failures(checks["a11"])
    e = checks["eager"]
    for name, c in e.items():
        if isinstance(c, dict) and "rel_err" in c and (
                c["rel_err"] > (2.0 ** -7 if "bf" in name else TOL)
                or not c["device_ok"]):
            bad.append(f"eager {name}")
    if e["join_rel_err"] > TOL:
        bad.append("eager join")
    if e["fuse_rel_err"] > TOL:
        bad.append("eager fused burst")
    s = e["stats"]
    if not (s["fused_responses"] and s["cache_hits"] and s["replay_epochs"]):
        bad.append(f"eager stats {s}")
    if e["on_card"] and (s["host_data_ops"] or s["host_staged_ops"]
                         or not s["device_data_ops"]):
        bad.append(f"eager: a CUDA payload took a host path {s}")
    for wire, c in checks["eager_two_level"].items():
        s = c["stats"]
        if (c["average_rel_err"] > (2.0 ** -7 if wire == "bf16" else TOL)
                or c["fuse_rel_err"] > TOL or not c["int_sum_exact"]
                or not c["device_ok"]):
            bad.append(f"eager two-level ({wire})")
        # on the card every allreduce (2 ops and the fused burst) runs the
        # two-level schedule; the CPU world has no two-level engine plane
        if e["on_card"] and not (c["hierarchical"]
                                 and s["hierarchical_ops"] >= 3
                                 and s["fused_responses"]
                                 and not s["host_data_ops"]
                                 and not s["host_staged_ops"]):
            bad.append(f"eager two-level ({wire}): {c['hierarchical']} {s}")
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
               else LOSS_RTOL.get(name, LOSS_RTOL["mean"]))
        if name != "adasum" and run["max_rel_loss_diff_vs_off"] > tol:
            bad.append(f"{name}: losses off by "
                       f"{run['max_rel_loss_diff_vs_off']:.2e}")
    return bad


def _worker(rank, world, local_size, port, cpu, out, only, out_dir):
    os.environ.update({
        "HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(world),
        "HVDTPU_LOCAL_RANK": str(rank % local_size),
        "HVDTPU_LOCAL_SIZE": str(local_size),
        "HVDTPU_CROSS_RANK": str(rank // local_size),
        "HVDTPU_CROSS_SIZE": str(world // local_size),
        "HVDTPU_COORDINATOR": f"127.0.0.1:{port}",
    })
    if only == "a13b6":
        from .obs.collective_schedule import recorder_env

        # before init: the recorder must see the process groups created
        os.environ.update(recorder_env())
    import torch

    import horovod_tpu_torch as hvd

    if cpu:
        torch.set_num_threads(1)
    try:
        # one GPU per process: its local rank counts the GPUs of this
        # machine, so the world's ranks are spread over them
        device = "cpu" if cpu else f"cuda:{rank % torch.cuda.device_count()}"
        hvd.init(device=device)
        checks, train = {}, {}
        if only in ("a13", "a13b6", "a14", "a17"):
            checks[only] = (
                a13_checks(hvd, torch, cpu) if only == "a13" else
                a14_checks(hvd, torch, cpu) if only == "a14" else
                a17_checks(hvd, torch, cpu) if only == "a17" else
                a13b6_checks(hvd, torch, cpu, out_dir))
            out.put((rank, True, {"checks": checks, "train": train,
                                  "failures": _failures(checks, train)}))
            return
        if only != "a11":
            checks = _collective_checks(hvd, torch)
            with _engine_env(HVDTPU_SCHEDULE_REPLAY_CYCLES=REPLAY_CYCLES):
                checks["eager"] = _eager_checks(hvd, torch, cpu)
            checks["eager_two_level"] = _two_level_checks(hvd, torch)
            train = _training(hvd, torch, cpu)
        checks["a11"] = a11_checks(hvd, torch, cpu)
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
    p.add_argument("--only", choices=["a11", "a13", "a13b6", "a14", "a17"],
                   default=None,
                   help="run one section alone (a11: the parallel "
                   "schedules; a13: the observability planes; a13b6: the "
                   "schedule gate; a14: the SPMD surface; a17: the "
                   "collective microbench)")
    args = p.parse_args(argv)
    import torch

    if not args.cpu:
        if not torch.cuda.is_available():
            print("world_check: no CUDA device is visible", file=sys.stderr)
            return 2
        from .ops import kernels

        kernels.build_all()  # once, before the ranks load the libraries
    if args.only == "a17":
        from .runtime import native_build

        native_build.build()  # once, before the ranks load it
    world = args.world or (4 if args.cpu else torch.cuda.device_count())
    if world % args.local_size or world < 2:
        raise SystemExit(f"--world {world} must be >= 2 and a multiple of "
                         f"--local-size {args.local_size}")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    out_dir = tempfile.mkdtemp(prefix="hvdtpu_a13b6_") \
        if args.only == "a13b6" else None
    procs = [ctx.Process(target=_worker, args=(r, world, args.local_size,
                                                port, args.cpu, out,
                                                args.only, out_dir))
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
        if out_dir is not None:
            shutil.rmtree(out_dir, ignore_errors=True)
    if errors:
        print("\n".join(errors), file=sys.stderr)
        return 1
    failures = sorted({f for res in results.values()
                       for f in res["failures"]})
    if args.only == "a13":
        failures += _a13_world_failures(
            {r: results[r]["checks"]["a13"] for r in results})
    if args.only == "a17":
        from .bench.collective import goodput_table

        for engine, cells in results[0]["checks"]["a17"].items():
            print(goodput_table(engine, A17_ITERS, [world], A17_KB, {
                (kb, world): c["goodput"]
                for kb, c in zip(A17_KB, cells)}), flush=True)
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
