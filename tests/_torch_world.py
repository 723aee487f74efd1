"""A small gloo world of horovod_tpu_torch processes for the port's tests.

:func:`run_world` spawns ``world`` fresh processes (``spawn``: no JAX and
no state of the test process carried over), gives each the hvdrun
rendezvous environment, calls ``horovod_tpu_torch.init(device="cpu")``,
runs ``fn(*args)`` and returns the per-rank results in rank order.
``local_size`` lays the world out as ``world / local_size`` hosts of
``local_size`` ranks, numbered cross-major (rank = cross_rank x local_size
+ local_rank), as the two-level schedules need.  The worker functions below
import only torch and the port.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import traceback


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(fn, rank, world, port, args, out, local_size):
    os.environ.update({
        "HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(world),
        "HVDTPU_LOCAL_RANK": str(rank % local_size),
        "HVDTPU_LOCAL_SIZE": str(local_size),
        "HVDTPU_CROSS_RANK": str(rank // local_size),
        "HVDTPU_CROSS_SIZE": str(world // local_size),
        "HVDTPU_COORDINATOR": f"127.0.0.1:{port}",
    })
    import torch

    torch.set_num_threads(1)
    import horovod_tpu_torch as hvd

    try:
        hvd.init(device="cpu")
        out.put((rank, True, fn(*args)))
    except BaseException:  # noqa: BLE001 - reported to the parent, re-raised
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        hvd.shutdown()


def bench_env() -> dict:
    """The environment of a bench CLI child: this process's, with two
    intra-op threads.  With a thread per core, a child started beside the
    suite's other workers spends most of its time in OpenMP's spin-waits
    (a CPU gpt-nano bench: 56 s against 15 s with two threads, beside six
    busy processes on an 8-core host)."""
    return dict(os.environ, OMP_NUM_THREADS="2")


def run_world(fn, args=(), world: int = 2, timeout: float = 60.0,
              local_size=None) -> list:
    """Run ``fn(*args)`` on every rank of a fresh gloo world (one host of
    ``world`` ranks, or hosts of ``local_size``); results in rank order.
    Raises with the failing rank's traceback, or on timeout."""
    local_size = local_size or world
    if world % local_size:
        raise ValueError(f"local_size {local_size} does not divide the "
                         f"world {world}")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry,
                         args=(fn, r, world, port, args, out, local_size),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    try:
        while len(results) < world:
            rank, ok, val = out.get(timeout=timeout)
            if not ok:
                raise AssertionError(f"rank {rank} failed:\n{val}")
            results[rank] = val
    except queue.Empty:
        raise AssertionError(
            f"world of {world} timed out after {timeout}s "
            f"({sorted(results)} finished)") from None
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# worker functions (run inside the world)
# ---------------------------------------------------------------------------


def collectives_worker(xs, ws, bf16_xs, rows):
    """Every collective's values and grads on this rank's inputs
    (``xs[rank]`` etc.; ``rows`` holds the row-wise ops' inputs and loss
    weights by case), returned as numpy."""
    import torch

    import horovod_tpu_torch as hvd

    r = hvd.rank()
    res = _row_collectives(hvd, torch, r, rows)
    res.update(_reduce_collectives(hvd, torch, r, xs, ws, bf16_xs))
    return res


def _row_collectives(hvd, torch, r, rows):
    """allgather (even and ragged dim 0), alltoall, reducescatter (even and
    ragged, Sum and Average), the flat pair, and Min/Max: per case the
    value and the gradient of ``sum(op(x) * w)``; Min/Max record the error
    their backward raises."""
    ops = {
        "allgather": hvd.allgather,
        "allgather_ragged": hvd.allgather,
        "alltoall": hvd.alltoall,
        "reducescatter_sum": lambda x: hvd.reducescatter(x, hvd.Sum),
        "reducescatter_avg": lambda x: hvd.reducescatter(x, hvd.Average),
        "reducescatter_ragged": lambda x: hvd.reducescatter(x, hvd.Sum),
        "reduce_scatter_flat_sum": hvd.reduce_scatter_flat,
        "reduce_scatter_flat_avg": lambda x: hvd.reduce_scatter_flat(
            x, hvd.Average),
        "all_gather_flat": hvd.all_gather_flat,
    }
    res = {}
    for case, fn in ops.items():
        x_np, w_np = rows[case]
        x = torch.from_numpy(x_np[r]).requires_grad_()
        y = fn(x)
        (y * torch.from_numpy(w_np[r])).sum().backward()
        res[case] = (y.detach().numpy(), x.grad.numpy())
    for case, op in (("min", hvd.Min), ("max", hvd.Max)):
        x = torch.from_numpy(rows["extreme"][r]).requires_grad_()
        y = hvd.allreduce(x, op)
        try:
            y.sum().backward()
            err = None
        except NotImplementedError as e:
            err = str(e)
        res[case] = (y.detach().numpy(), err)
    try:
        hvd.alltoall(torch.zeros(3, 2))
        res["alltoall_odd"] = None
    except ValueError as e:
        res["alltoall_odd"] = str(e)
    return res


def _reduce_collectives(hvd, torch, r, xs, ws, bf16_xs):
    """allreduce / grouped_allreduce / broadcast values and grads."""
    res = {"rank": r, "size": hvd.size(), "local_rank": hvd.local_rank(),
           "local_size": hvd.local_size(), "cross_rank": hvd.cross_rank(),
           "cross_size": hvd.cross_size(),
           "homogeneous": hvd.is_homogeneous()}
    w = torch.from_numpy(ws[r])
    cases = {
        "avg": dict(op=hvd.Average),
        "sum": dict(op=hvd.Sum),
        "avg_scaled": dict(op=hvd.Average, prescale_factor=0.5,
                           postscale_factor=3.0),
        "sum_scaled": dict(op=hvd.Sum, prescale_factor=2.0,
                           postscale_factor=0.25),
    }
    for name, kw in cases.items():
        x = torch.from_numpy(xs[r]).requires_grad_()
        y = hvd.allreduce(x, **kw)
        (y * w).sum().backward()
        res[name] = (y.detach().numpy(), x.grad.numpy())
    x = torch.from_numpy(xs[r]).requires_grad_()
    y = hvd.broadcast(x, root_rank=1)
    (y * w).sum().backward()
    res["broadcast"] = (y.detach().numpy(), x.grad.numpy())
    # two float32 tensors and one bf16 tensor: two fusion bins per dtype
    # at a 64-byte threshold
    parts = [torch.from_numpy(xs[r][:3]).requires_grad_(),
             torch.from_numpy(xs[r][3:]).reshape(1, -1).requires_grad_(),
             torch.from_numpy(bf16_xs[r]).to(torch.bfloat16)]
    outs = hvd.grouped_allreduce(parts, hvd.Average,
                                 fusion_threshold_bytes=64)
    (outs[0] * w[:3]).sum().add((outs[1].reshape(-1) * w[3:]).sum()) \
        .backward()
    res["grouped"] = ([o.detach().float().numpy() for o in outs],
                      [parts[0].grad.numpy(), parts[1].grad.numpy()])
    return res


def optim_worker(state_np, tokens, steps, k_passes):
    """Data-parallel AdamW steps of gpt-nano (fp32) from ``state_np`` on
    this rank's rows of ``tokens``; also checks broadcast_parameters and
    broadcast_optimizer_state.  Returns losses and final parameters."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.train import lm_loss

    r, n = hvd.rank(), hvd.size()
    model = gpt("nano", device="cpu", dtype=torch.float32,
                flash_block_q=16, flash_block_k=16)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_np.items()})
    if r != 0:  # a replica that drifted: the broadcast must overwrite it
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    bcast_ok = all(torch.equal(model.state_dict()[k], torch.from_numpy(v))
                   for k, v in state_np.items())

    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW(model.parameters(), lr=1e-4, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        backward_passes_per_step=k_passes)
    rows = tokens.shape[0] // n
    mine = torch.from_numpy(tokens[r * rows:(r + 1) * rows])
    micro = rows // k_passes
    losses = []
    for _ in range(steps):
        for m in range(k_passes):
            opt.zero_grad()
            loss = lm_loss(model, mine[m * micro:(m + 1) * micro])
            loss.backward()
            opt.step()
        losses.append(hvd.allreduce(loss.detach()).item())

    # optimizer state: perturb a replica, then broadcast from rank 0
    if r != 0:
        for st in opt.state.values():
            st["exp_avg"].mul_(3.0)
            st["step"].add_(5.0)
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    digest = [float(st["exp_avg"].double().sum()) + float(st["step"])
              for st in opt.state.values()]
    return {"losses": losses, "bcast_ok": bcast_ok, "state_digest": digest,
            "params": {k: v.numpy() for k, v in model.state_dict().items()}}


def train_step_worker(steps):
    """build_gpt_step on a CPU world: losses, this rank's token rows, and
    a parameter checksum (replicas must agree)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.train import build_gpt_step

    step, state, static = build_gpt_step(
        "nano", "fp32", 2, 16, device="cpu", flash_block_q=16,
        flash_block_k=16)
    losses = []
    for _ in range(steps):
        model, opt, loss = step(*state)
        state = (model, opt) + state[2:]
        losses.append(loss.item())
    checksum = float(sum(p.double().sum() for p in model.parameters()))
    return {"rank": hvd.rank(), "losses": losses, "static": static,
            "tokens": state[2].numpy(), "checksum": checksum,
            "device": str(hvd.device()),
            "dtype": str(next(model.parameters()).dtype)}


def gpt_step_worker(state_np, steps, batch, seq, block):
    """build_gpt_step("nano", "fp32", ...) from the weights ``state_np``
    (a port state_dict of numpy arrays): the losses of ``steps`` steps on
    its own seeded tokens, the tokens, and the parameters after."""
    import torch

    from horovod_tpu_torch.train import build_gpt_step

    step, state, static = build_gpt_step(
        "nano", "fp32", batch, seq, device="cpu", flash_block_q=block,
        flash_block_k=block)
    state[0].load_state_dict({k: torch.from_numpy(v)
                              for k, v in state_np.items()}, strict=True)
    losses = []
    for _ in range(steps):
        model, opt, loss = step(*state)
        state = (model, opt) + state[2:]
        losses.append(loss.item())
    return {"losses": losses, "tokens": state[2].numpy(), "static": static,
            "params": {n: p.detach().numpy().copy()
                       for n, p in state[0].named_parameters()}}


def reduce_worker(grads):
    """The gradient DistributedOptimizer hands to SGD(lr=1) for this
    rank's ``grads[rank]``, under each wire option."""
    import torch

    import horovod_tpu_torch as hvd

    options = {
        "average": {},
        "sum": {"op": hvd.Sum},
        "bf16": {"compression": hvd.Compression.bf16},
        "fp16": {"compression": hvd.Compression.fp16},
        "predivide": {"gradient_predivide_factor": 4.0},
    }
    out = {}
    for name, kw in options.items():
        p = torch.nn.Parameter(torch.zeros(grads.shape[1:]))
        opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0), **kw)
        p.grad = torch.from_numpy(grads[hvd.rank()]).clone()
        opt.step()
        out[name] = (-p.detach()).numpy()
    return out


def overlap_worker(state_np, tokens, steps, bucket_mb, rebucket_mb):
    """gpt-nano (fp32) AdamW steps through the overlap plane in every mode
    from ``state_np`` on this rank's rows of ``tokens``.  Returns, per
    run, the world-mean losses and the final parameters by name, and the
    issue-order record of one ``bucket`` step."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.optim.overlap import OverlapPlan
    from horovod_tpu_torch.train import lm_loss, make_adamw

    r, n = hvd.rank(), hvd.size()
    rows = tokens.shape[0] // n
    mine = torch.from_numpy(tokens[r * rows:(r + 1) * rows])

    def fresh():
        model = gpt("nano", device="cpu", dtype=torch.float32,
                    flash_block_q=16, flash_block_k=16)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_np.items()})
        return model

    def train(model, plan, k, set_to_none=False):
        losses = []
        for _ in range(k):
            if set_to_none:  # drops the plan's gradient views
                model.zero_grad(set_to_none=True)
            else:
                plan.zero_grad()
            loss = lm_loss(model, mine)
            loss.backward()
            plan.step()
            losses.append(hvd.allreduce(loss.detach()).item())
        return losses

    def params(model):
        return {k: v.detach().numpy().copy()
                for k, v in model.state_dict().items()}

    out = {}
    for mode in ("off", "bucket", "bucket+zero1"):
        model = fresh()
        plan = OverlapPlan(model.parameters(), make_adamw, mode=mode,
                           bucket_mb=bucket_mb)
        out[mode] = {"losses": train(model, plan, steps),
                     "params": params(model),
                     "buckets": len(plan.layout.buckets)}
        if mode == "bucket+zero1":
            # each rank's state is its own shard: nothing to broadcast
            hvd.broadcast_optimizer_state(plan, root_rank=0)
            out[mode]["shard_sizes"] = [s.numel() for s in plan.shards]
            out[mode]["materialized"] = all(
                torch.equal(a, b) for a, b in zip(plan.materialize(),
                                                  model.parameters()))
    model = fresh()
    plan = OverlapPlan(model.parameters(), make_adamw, mode="bucket",
                       bucket_mb=bucket_mb)
    out["bucket_set_to_none"] = {
        "losses": train(model, plan, steps, set_to_none=True),
        "params": params(model)}

    # N -> M buckets after 2 steps, against 2 + 2 steps un-rebucketed
    model = fresh()
    plan = OverlapPlan(model.parameters(), make_adamw, mode="bucket+zero1",
                       bucket_mb=bucket_mb)
    losses = train(model, plan, 2)
    new = OverlapPlan(model.parameters(), make_adamw, mode="bucket+zero1",
                      bucket_mb=rebucket_mb)
    plan = plan.rebucket(new)
    out["rebucket"] = {"losses": losses + train(model, plan, 2),
                       "params": params(model),
                       "buckets": (out["bucket+zero1"]["buckets"],
                                   len(new.layout.buckets))}
    model = fresh()
    plan = OverlapPlan(model.parameters(), make_adamw, mode="bucket+zero1",
                       bucket_mb=bucket_mb)
    out["zero1_4_steps"] = {"losses": train(model, plan, 4),
                            "params": params(model)}
    bucket = OverlapPlan(fresh().parameters(), make_adamw, mode="bucket",
                         bucket_mb=bucket_mb)
    try:
        bucket.rebucket(plan)
        out["rebucket_refusal"] = None
    except ValueError as e:
        out["rebucket_refusal"] = str(e)

    # issue order: bucket collectives issued on the host before the last
    # flash backward of the step (block 0's attention)
    model = fresh()
    plan = OverlapPlan(model.parameters(), make_adamw, mode="bucket",
                       bucket_mb=bucket_mb)
    events = []
    plan.on_issue = lambda index: events.append(("bucket", index))
    plain_bwd = fa.flash_bwd

    def recording_bwd(*args):
        events.append(("attention_backward", None))
        return plain_bwd(*args)

    fa.flash_bwd = recording_bwd
    try:
        train(model, plan, 1)
    finally:
        fa.flash_bwd = plain_bwd
    out["issue"] = {
        "events": events,
        "names": [name for name, _ in model.named_parameters()],
        "buckets": [b.leaf_indices for b in plan.layout.buckets]}
    return out


def dropped_plan_worker(mode):
    """Whether an OverlapPlan is garbage once dropped: with its model, and
    with the model kept (whose parameters still hold the plan's hooks);
    the kept model then trains under a new plan."""
    import gc
    import weakref

    import torch

    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.optim.overlap import OverlapPlan
    from horovod_tpu_torch.train import lm_loss, make_adamw

    toks = torch.randint(0, 1024, (2, 9), generator=torch.Generator()
                         .manual_seed(0))

    def plan_for(model):
        plan = OverlapPlan(model.parameters(), make_adamw, mode=mode,
                           bucket_mb=0.25)
        lm_loss(model, toks).backward()
        plan.step()
        return plan

    model = gpt("nano", device="cpu", dtype=torch.float32)
    gone = weakref.ref(plan_for(model))
    del model
    gc.collect()
    freed = gone() is None
    model = gpt("nano", device="cpu", dtype=torch.float32)
    gone = weakref.ref(plan_for(model))
    gc.collect()
    freed_kept = gone() is None
    plan = plan_for(model)  # the dead plan's hooks stand aside
    return {"plan_freed": freed, "plan_freed_model_kept": freed_kept,
            "steps_after": all(p.grad is not None for p in plan.params)}


def sync_bn_worker(xs, ws, scale, bias, momentum):
    """``SyncBatchNorm`` in training mode on this rank's NHWC batch
    ``xs[rank]``, loss ``sum(y * ws[rank])``: the output (NHWC), the
    gradients of x, scale and bias, and the running statistics; at world 1
    also ``layers.BatchNorm``'s on the same batch."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models.layers import BatchNorm, from_nhwc
    from horovod_tpu_torch.parallel import SyncBatchNorm

    def run(cls):
        bn = cls(scale.shape[0], momentum=momentum)
        with torch.no_grad():
            bn.weight.copy_(torch.from_numpy(scale))
            bn.bias.copy_(torch.from_numpy(bias))
        x = from_nhwc(xs[hvd.rank()].copy()).requires_grad_()
        y = bn(x)
        (y * from_nhwc(ws[hvd.rank()])).sum().backward()
        return {"y": y.detach().permute(0, 2, 3, 1).numpy(),
                "dx": x.grad.permute(0, 2, 3, 1).numpy(),
                "dscale": bn.weight.grad.numpy(),
                "dbias": bn.bias.grad.numpy(),
                "mean": bn.running_mean.numpy(),
                "var": bn.running_var.numpy()}

    out = {"sync": run(SyncBatchNorm)}
    if hvd.size() == 1:
        out["local"] = run(BatchNorm)
    return out


def conv_step_worker(steps, batch, size, modes):
    """``build_step("resnet18", "fp32", batch, size)`` on the CPU, ``steps``
    steps in each overlap mode: per mode the world-mean losses, whether
    the parameters, running statistics and losses equal ``off``'s bit for
    bit, and a digest of the parameters (replicas must agree); for
    ``off`` also the parameters, statistics, this rank's images and
    labels, and ``static``."""
    import hashlib

    import torch

    from horovod_tpu_torch.train import build_step

    out, ref = {}, None
    for mode in modes:
        step, state, static = build_step("resnet18", "fp32", batch, size,
                                         overlap_mode=mode, grad_bucket_mb=4,
                                         device="cpu")
        images, labels = state[3].clone(), state[4].clone()
        losses = []
        for _ in range(steps):
            *carry, loss = step(*state)
            state = tuple(carry) + state[3:]
            losses.append(loss.item())
        model = state[0]
        params = {n: p.detach().clone() for n, p in model.named_parameters()}
        stats = {n: b.clone() for n, b in model.named_buffers()}
        digest = hashlib.sha256()
        for n in sorted(params):
            digest.update(params[n].contiguous().numpy().tobytes())
        res = {"losses": losses, "digest": digest.hexdigest()}
        if ref is None:
            ref = (params, stats, losses)
            res.update(params={n: t.numpy() for n, t in params.items()},
                       stats={n: t.numpy() for n, t in stats.items()},
                       images=images.permute(0, 2, 3, 1).numpy(),
                       labels=labels.numpy(), static=static,
                       channels_last=images.is_contiguous(
                           memory_format=torch.channels_last))
        else:
            res["bitwise_equal_to_first"] = (
                losses == ref[2]
                and all(torch.equal(params[n], t)
                        for n, t in ref[0].items())
                and all(torch.equal(stats[n], t) for n, t in ref[1].items()))
        out[mode] = res
    return out


def _nano_train(hvd, torch, state_np, tokens, steps, make_plan):
    """``steps`` AdamW steps of gpt-nano (fp32) from ``state_np`` on this
    rank's rows of ``tokens`` through ``make_plan(model)`` (used like an
    optimizer); the world-mean losses and the final parameters."""
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.train import lm_loss

    r, n = hvd.rank(), hvd.size()
    model = gpt("nano", device="cpu", dtype=torch.float32,
                flash_block_q=16, flash_block_k=16)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_np.items()})
    plan = make_plan(model)
    rows = tokens.shape[0] // n
    mine = torch.from_numpy(tokens[r * rows:(r + 1) * rows])
    losses = []
    for _ in range(steps):
        plan.zero_grad()
        loss = lm_loss(model, mine)
        loss.backward()
        plan.step()
        losses.append(hvd.allreduce(loss.detach()).item())
    return {"losses": losses,
            "params": {k: v.detach().numpy().copy()
                       for k, v in model.state_dict().items()}}


def adasum_worker(xs, ws, leaves, state_np, tokens, steps):
    """Adasum on a 4-rank world laid out as 2 hosts of 2: ``allreduce(x,
    Adasum)`` over the world and over this rank's local pair (values and
    the gradient of ``sum(y * w)``), a bf16 input, the refusal of a 3-rank
    group, two leaves reduced by ``grouped_allreduce`` against each alone
    and against their concatenation, and ``DistributedOptimizer(op=Adasum)``
    steps of gpt-nano."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.basics import local_group
    from horovod_tpu_torch.ops.adasum import adasum_allreduce
    from horovod_tpu_torch.train import make_adamw

    r = hvd.rank()
    res = {}
    for case, reduce in (("world", lambda x: hvd.allreduce(x, hvd.Adasum)),
                         ("pair", lambda x: adasum_allreduce(
                             x, group=local_group()))):
        x = torch.from_numpy(xs[r]).requires_grad_()
        y = reduce(x)
        (y * torch.from_numpy(ws[r])).sum().backward()
        res[case] = (y.detach().numpy(), x.grad.numpy())
    y = hvd.allreduce(torch.from_numpy(xs[r]).to(torch.bfloat16), hvd.Adasum)
    res["bf16"] = (str(y.dtype), y.float().numpy())
    three = dist.new_group([0, 1, 2])  # every rank creates every group
    if r < 3:
        try:
            adasum_allreduce(torch.ones(2), group=three)
            res["three"] = None
        except ValueError as e:
            res["three"] = str(e)
    a, b = (torch.from_numpy(leaf[r]) for leaf in leaves)
    res["grouped"] = [t.numpy() for t in hvd.grouped_allreduce(
        [a, b], hvd.Adasum)]
    res["alone"] = [hvd.allreduce(t, hvd.Adasum).numpy() for t in (a, b)]
    res["fused"] = hvd.allreduce(torch.cat([a, b]), hvd.Adasum).numpy()
    res["optimizer"] = _nano_train(
        hvd, torch, state_np, tokens, steps,
        lambda m: hvd.DistributedOptimizer(make_adamw(m.parameters()),
                                           op=hvd.Adasum))
    return res


def sparse_worker(cases, rows, dim, state, emb_idx, emb_w, steps):
    """The sparse path on a 2-rank world with ragged row counts:
    ``allreduce`` of IndexedSlices (Average, Sum, inside a mixed list),
    ``DistributedOptimizer`` with a sparse gradient densified or kept
    sparse (and Adasum's refusal of the latter), the COO round trip, and
    ``steps`` SGD steps of an ``nn.Embedding(sparse=True)`` under each
    ``sparse_as_dense``."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.sparse import (IndexedSlices, from_coo,
                                              to_coo, to_dense)

    r = hvd.rank()
    res = {}
    values, indices = (torch.from_numpy(a) for a in cases[r])
    slices = IndexedSlices(values, indices, (rows, dim))
    for name, op in (("average", hvd.Average), ("sum", hvd.Sum)):
        out = hvd.allreduce(slices, op)
        res[name] = (out.values.numpy(), out.indices.numpy(),
                     out.dense_shape, to_dense(out).numpy())
    out = hvd.allreduce_sparse(slices, hvd.Sum)
    res["mixed_w"] = hvd.allreduce(torch.ones(dim), hvd.Sum).numpy()
    res["mixed_dense"] = to_dense(out).numpy()

    def grad_after(sparse_as_dense, op=hvd.Average):
        p = torch.nn.Parameter(torch.zeros(rows, dim))
        p.grad = to_coo(slices)
        opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=1.0), op=op,
                                       sparse_as_dense=sparse_as_dense)
        opt.synchronize()
        return p.grad

    res["as_dense"] = grad_after(True).numpy()
    kept = grad_after(False)
    res["kept"] = (kept.is_sparse, kept.is_coalesced(),
                   tuple(kept._values().shape), kept.to_dense().numpy())
    try:
        grad_after(False, hvd.Adasum)
        res["adasum_sparse"] = None
    except ValueError as e:
        res["adasum_sparse"] = str(e)
    coo = to_coo(slices)
    back = from_coo(coo)
    res["coo"] = (coo.is_coalesced(), back.values.numpy(),
                  back.indices.numpy(), back.dense_shape)

    for sparse_as_dense in (True, False):
        emb = torch.nn.Embedding(rows, dim, sparse=True)
        with torch.no_grad():
            emb.weight.copy_(torch.from_numpy(state))
        opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(),
                                                       lr=0.5),
                                       sparse_as_dense=sparse_as_dense)
        idx, w = torch.from_numpy(emb_idx[r]), torch.from_numpy(emb_w[r])
        for _ in range(steps):
            opt.zero_grad()
            (emb(idx) * w).sum().backward()
            opt.step()
        res[f"embedding_{sparse_as_dense}"] = emb.weight.detach().numpy()
    return res


def hierarchical_worker(xs, wire_xs, flat, state_np, tokens, steps,
                        bucket_mb):
    """The two-level schedules on a 2 x 2 world (2 hosts of 2 ranks):
    the four functions (values, the allreduce's gradient, the bf16 and
    fp16 wires, the uneven pad), the shard a rank keeps, ZeRO-1's shard
    index, and gpt-nano AdamW steps through ``OverlapPlan`` with
    ``hierarchical_axes`` in ``bucket`` and ``bucket+zero1`` (and through
    the flat plan, which they must match)."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim.overlap import OverlapPlan
    from horovod_tpu_torch.parallel import hierarchical as hier
    from horovod_tpu_torch.train import make_adamw

    r = hvd.rank()
    res = {"layout": (hvd.local_rank(), hvd.cross_rank()),
           "topology": (hvd.num_devices(), hvd.device_rank(),
                        hvd.num_slices(), hvd.slice_id(), hvd.slice_size(),
                        hvd.slice_of_rank(3))}
    for name, x_np in xs.items():
        for op_name, op in (("sum", hvd.Sum), ("average", hvd.Average)):
            x = torch.from_numpy(x_np[r]).requires_grad_()
            y = hier.hierarchical_allreduce(x, op)
            y.sum().backward()
            res[f"allreduce_{name}_{op_name}"] = (y.detach().numpy(),
                                                  x.grad.numpy())
        res[f"adasum_{name}"] = hier.hierarchical_adasum(
            torch.from_numpy(x_np[r])).numpy()
    for wire in ("bf16", "fp16"):
        res[f"wire_{wire}"] = hier.hierarchical_allreduce(
            torch.from_numpy(wire_xs[r]), hvd.Average,
            compression=wire).numpy()
    shard = hier.hierarchical_reduce_scatter(torch.from_numpy(flat[r]))
    res["scatter"] = shard.numpy()
    res["scatter_bf16"] = hier.hierarchical_reduce_scatter(
        torch.from_numpy(flat[r]), hvd.Average, compression="bf16").numpy()
    res["gather"] = hier.hierarchical_all_gather(shard).numpy()
    for bad in ("ef_bf16", hvd.ErrorFeedbackCompressor()):
        try:
            hier.hierarchical_allreduce(torch.ones(2), compression=bad)
            res.setdefault("refused", []).append(None)
        except ValueError as e:
            res.setdefault("refused", []).append(str(e))

    axes = (hvd.LOCAL_AXIS, hvd.CROSS_AXIS)
    for mode in ("bucket", "bucket+zero1"):
        for hier_axes, tag in ((axes, "hier"), (None, "flat")):
            plans = []

            def make(model, mode=mode, hier_axes=hier_axes):
                plans.append(OverlapPlan(model.parameters(), make_adamw,
                                         mode=mode, bucket_mb=bucket_mb,
                                         hierarchical_axes=hier_axes))
                return plans[-1]

            out = _nano_train(hvd, torch, state_np, tokens, steps, make)
            if mode == "bucket+zero1":
                plan = plans[-1]
                out["shard_index"] = plan.shard_index
                b = plan.layout.buckets[0]
                chunk = b.padded_size // plan.world
                out["shard_is_own"] = torch.equal(
                    plan.shards[0].detach(),
                    plan._flat[0][plan.shard_index * chunk:
                                  (plan.shard_index + 1) * chunk])
            res[f"{mode}_{tag}"] = out
    res["bucket_bf16"] = _nano_train(
        hvd, torch, state_np, tokens, steps,
        lambda m: OverlapPlan(m.parameters(), make_adamw, mode="bucket",
                              bucket_mb=bucket_mb, hierarchical_axes=axes,
                              dcn_compression="bf16"))
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD([torch.nn.Parameter(torch.ones(3))], lr=1.0),
        hierarchical_axes=axes, gradient_predivide_factor=2.0)
    opt.param_groups[0]["params"][0].grad = torch.ones(3)
    try:
        opt.step()
        res["predivide"] = None
    except ValueError as e:
        res["predivide"] = str(e)
    return res


def fp8_contract_worker(steps, conv_batch):
    """The losses of ``steps`` steps of the port's ``build_gpt_step("nano",
    ...)`` (reference attention, batch 2, seq 64) and ``build_step(
    "resnet18", ..., conv_batch, 32)`` in bf16 and fp8, the reference's
    ``test_fp8.py`` runs; and VGG's refusal of fp8."""
    from horovod_tpu_torch.train import build_gpt_step, build_step

    def run(step, state, carry):
        losses = []
        for _ in range(steps):
            *out, loss = step(*state)
            state = tuple(out) + state[carry:]
            losses.append(loss.item())
        return losses

    res = {}
    for dtype in ("bf16", "fp8"):
        step, state, static = build_gpt_step(
            "nano", dtype, 2, 64, attention="reference", device="cpu")
        res[f"gpt_{dtype}"] = run(step, state, static["carry_len"])
        step, state, static = build_step("resnet18", dtype, conv_batch, 32,
                                         device="cpu")
        res[f"resnet_{dtype}"] = run(step, state, static["carry_len"])
    try:
        build_step("vgg16", "fp8", 2, 32, device="cpu")
        res["vgg"] = None
    except ValueError as e:
        res["vgg"] = str(e)
    return res


def adasum_odd_world_worker():
    """``allreduce(op=Adasum)`` on this world: the error it raises."""
    import torch

    import horovod_tpu_torch as hvd

    try:
        hvd.allreduce(torch.ones(3), hvd.Adasum)
        return None
    except ValueError as e:
        return str(e)


def replay_worker(n, tuned):
    """``n`` blocking Sum allreduces of ones under one name through the
    eager engine; the values and the engine's stats.  Then ``tuned`` more
    on a second engine started with the online autotuner on (a sample per
    cycle, no warm-up, and a search longer than the ``tuned`` samples the
    ops can give): their values, and the engine's parameters before and
    after, read once the coordinated shutdown has stopped every rank's
    cycle on the same one.

    The search stays open on purpose.  With the default 12 samples a
    category and one category, the tuner settles inside the 20 ops on the
    best point it scored, and the start's own window scores best often
    enough under CPU load (a window's busy time is the cycle before it,
    which load stretches at random): the parameters then end where they
    started, which is the tuner's design, not a lost proposal."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _engine_registry

    values = [float(hvd.synchronize(hvd.allreduce_async(
        torch.ones(8), hvd.Sum, name="grad"))[0]) for _ in range(n)]
    stats = dict(_engine_registry.get_engine().stats)
    stats["values"] = values

    _engine_registry.shutdown_engine()
    os.environ.update({"HVDTPU_AUTOTUNE": "1",
                       "HVDTPU_AUTOTUNE_WARMUP_SAMPLES": "0",
                       "HVDTPU_AUTOTUNE_STEPS_PER_SAMPLE": "1",
                       "HVDTPU_AUTOTUNE_BAYES_OPT_MAX_SAMPLES":
                           str(tuned + 1)})
    eng = _engine_registry.get_engine()
    start = (eng.fusion_bytes, eng.cycle_s)
    values = [float(hvd.synchronize(hvd.allreduce_async(
        torch.ones(8), hvd.Sum, name="tuned"))[0]) for _ in range(tuned)]
    _engine_registry.shutdown_engine()
    stats["tuner"] = {
        "values": values, "tuning": eng._pm is not None, "start": start,
        "end": (eng.fusion_bytes, eng.cycle_s, eng.cache_enabled)}
    return stats


def _np(t):
    """A tensor as numpy; bf16 (which numpy lacks) as fp32."""
    return (t.float() if str(t.dtype) == "torch.bfloat16" else t).numpy()


def eager_worker(inputs):
    """Every eager op on this rank's ``inputs[case][rank]``, the engine's
    fused responses, the duplicate-name and dtype-mismatch errors, ``join``
    with rank 1 submitting three more ops, then rank 0's ``shutdown`` while
    rank 1 holds a pending op.  Returns numpy results and the errors' text.
    On either engine: the Python one's executed responses are recorded
    with their names and sizes; the native one's through its counters (a
    count, and the largest fused allreduce since it started)."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _engine_registry
    from horovod_tpu_torch.exceptions import HorovodShutdownError
    from horovod_tpu_torch.ops import eager

    r = hvd.rank()
    mine = {k: torch.from_numpy(v[r]) for k, v in inputs.items()
            if k != "ragged"}
    eng = _engine_registry.get_engine()
    fused = []
    native = not hasattr(eng, "_perform_operation")
    if not native:
        perform = eng._perform_operation

        def record(resp):  # every response the engine executes, and size
            fused.append((list(resp.tensor_names),
                          sum(int(torch.Size(s).numel()) * 4
                              for s in getattr(resp, "_shapes", []))))
            perform(resp)

        eng._perform_operation = record
    ops = {
        "sum": lambda: hvd.allreduce_async(mine["x"], hvd.Sum, name="sum"),
        "avg": lambda: hvd.allreduce_async(mine["x"], name="avg"),
        "min": lambda: hvd.allreduce_async(mine["x"], hvd.Min, name="min"),
        "max": lambda: hvd.allreduce_async(mine["x"], hvd.Max, name="max"),
        "scaled": lambda: hvd.allreduce_async(
            mine["x"], hvd.Sum, name="scaled", prescale_factor=2.0,
            postscale_factor=0.25),
        "int_avg": lambda: hvd.allreduce_async(mine["i"], name="int_avg"),
        "i64_sum": lambda: hvd.allreduce_async(mine["l"], hvd.Sum,
                                               name="i64_sum"),
        "bf16_sum": lambda: hvd.allreduce_async(mine["x"].bfloat16(),
                                                hvd.Sum, name="bf16_sum"),
        "f64_avg": lambda: hvd.allreduce_async(mine["x"].double(),
                                               name="f64_avg"),
        "adasum": lambda: hvd.allreduce_async(mine["x"], hvd.Adasum,
                                              name="adasum"),
        "allgather": lambda: hvd.allgather_async(mine["rows"],
                                                 name="allgather"),
        "allgather_ragged": lambda: hvd.allgather_async(
            torch.from_numpy(inputs["ragged"][r]), name="ragged"),
        "broadcast": lambda: hvd.broadcast_async(mine["x"], 1,
                                                 name="broadcast"),
        "alltoall": lambda: eager.alltoall_async(mine["rows"],
                                                 name="alltoall"),
        "reducescatter": lambda: eager.reducescatter_async(
            mine["rows"], hvd.Sum, name="reducescatter"),
        "reducescatter_ragged": lambda: eager.reducescatter_async(
            mine["odd"], hvd.Average, name="reducescatter_ragged"),
    }
    handles = {k: fn() for k, fn in ops.items()}
    inplace = mine["x"].clone()
    handles_inplace = hvd.allreduce_async_(inplace, hvd.Sum, name="inplace")
    out = {k: _np(hvd.synchronize(h)) for k, h in handles.items()}
    out["inplace_is_arg"] = hvd.synchronize(handles_inplace) is inplace
    out["inplace"] = inplace.numpy()
    out["dtypes"] = {k: str(hvd.synchronize(h).dtype)
                     for k, h in handles.items()}
    eager.barrier()

    # N small named tensors in one burst: fewer responses than tensors
    fused.clear()
    before = eng.stats["responses"] if native else 0
    burst = [hvd.allreduce_async(torch.full((4,), float(i)), hvd.Sum,
                                 name=f"fuse.{i}") for i in range(16)]
    out["burst"] = [float(hvd.synchronize(h)[0]) for h in burst]
    if native:
        out["burst_responses"] = eng.stats["responses"] - before
        out["largest_response"] = eng.stats["largest_response_bytes"]
    else:
        out["burst_responses"] = [f for f in fused
                                  if f[0][0].startswith("fuse.")]

    # the duplicate-name error: a second in-flight op under one name
    first = hvd.allreduce_async(mine["x"], hvd.Sum, name="dup")
    try:
        hvd.synchronize(hvd.allreduce_async(mine["x"], hvd.Sum, name="dup"))
        out["duplicate"] = None
    except ValueError as e:
        out["duplicate"] = str(e)
    hvd.synchronize(first)

    # a dtype mismatch raises on both ranks
    t = mine["x"] if r == 0 else mine["i"]
    try:
        hvd.synchronize(hvd.allreduce_async(t, hvd.Sum, name="mismatch"))
        out["mismatch"] = None
    except RuntimeError as e:
        out["mismatch"] = str(e)

    # join with uneven submissions: rank 1 reduces three more tensors while
    # rank 0 has joined (it contributes zeros; AVERAGE divides by the world)
    if r == 1:
        out["after_join"] = [
            hvd.synchronize(hvd.allreduce_async(
                mine["x"] * (k + 1), name=f"late.{k}")).numpy()
            for k in range(3)]
    out["join"] = hvd.join()
    out["stats"] = dict(eng.stats)

    # shutdown with a peer's collective pending
    if r == 1:
        pending = hvd.allreduce_async(mine["x"], name="pending")
    dist.barrier()
    if r == 0:
        hvd.shutdown()
        out["shutdown_error"] = None
    else:
        try:
            hvd.synchronize(pending)
            out["shutdown_error"] = None
        except HorovodShutdownError as e:
            out["shutdown_error"] = type(e).__name__
    return out


def interop_worker(state_np, tokens, steps, bn_xs, bn_ws, env):
    """``interop.torch``'s hook DistributedOptimizer against the port's flat
    one on gpt-nano (fp32) from ``state_np``: AdamW steps with 1 and 2
    backward passes a step, and the synchronize / clip / step pattern;
    broadcast_parameters and broadcast_optimizer_state through the engine;
    the Adasum delta optimizer; SyncBatchNorm on ``bn_xs[rank]``.  ``env``
    is set before the engine starts (the engine reads its knobs then)."""
    import os

    os.environ.update(env)
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.interop.torch as ht
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.train import lm_loss, make_adamw

    r, n = hvd.rank(), hvd.size()
    rows = tokens.shape[0] // n
    mine = torch.from_numpy(tokens[r * rows:(r + 1) * rows])

    def model():
        m = gpt("nano", device="cpu", dtype=torch.float32, flash_block_q=16,
                flash_block_k=16)
        m.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_np.items()})
        if r != 0:  # a drifted replica: the broadcast must overwrite it
            with torch.no_grad():
                for p in m.parameters():
                    p.add_(1.0)
        ht.broadcast_parameters(m.state_dict(), root_rank=0)
        return m

    def params(m):
        return {k: v.detach().numpy().copy()
                for k, v in m.state_dict().items()}

    def flat_run(k=1, clip=None):
        m = model()
        opt = hvd.DistributedOptimizer(make_adamw(m.parameters()),
                                       backward_passes_per_step=k)
        micro, losses = rows // k, []
        for _ in range(steps):
            for j in range(k):
                opt.zero_grad()
                loss = lm_loss(m, mine[j * micro:(j + 1) * micro])
                loss.backward()
                if clip is None:
                    opt.step()
            if clip is not None:
                opt.synchronize()
                torch.nn.utils.clip_grad_norm_(m.parameters(), clip)
                opt.optimizer.step()
            losses.append(hvd.allreduce(loss.detach()).item())
        return losses, params(m)

    def hook_run(k=1, clip=None):
        m = model()
        opt = ht.DistributedOptimizer(make_adamw(m.parameters()),
                                      named_parameters=m.named_parameters(),
                                      backward_passes_per_step=k)
        micro, losses = rows // k, []
        for _ in range(steps):
            opt.zero_grad()
            for j in range(k):
                loss = lm_loss(m, mine[j * micro:(j + 1) * micro])
                loss.backward()
            if clip is None:
                opt.step()
            else:
                opt.synchronize()
                torch.nn.utils.clip_grad_norm_(m.parameters(), clip)
                with opt.skip_synchronize():
                    opt.step()
            losses.append(hvd.allreduce(loss.detach()).item())
        return losses, params(m), opt

    out = {}
    out["flat"] = flat_run()
    losses, p, opt = hook_run()
    out["hook"] = (losses, p)
    # optimizer state: perturb a replica, then broadcast from rank 0
    if r != 0:
        for st in opt.state.values():
            st["exp_avg"].mul_(3.0)
    ht.broadcast_optimizer_state(opt, root_rank=0)
    out["state_digest"] = [float(st["exp_avg"].double().sum())
                           for st in opt.state.values()]
    out["flat_k2"] = flat_run(k=2)
    out["hook_k2"] = hook_run(k=2)[:2]
    out["flat_clip"] = flat_run(clip=0.5)
    out["hook_clip"] = hook_run(clip=0.5)[:2]

    # the Adasum delta optimizer: one SGD step of a linear map
    torch.manual_seed(0)
    lin = torch.nn.Linear(3, 2)
    start = {k: v.detach().clone() for k, v in lin.named_parameters()}
    aopt = ht.DistributedOptimizer(torch.optim.SGD(lin.parameters(), lr=0.1),
                                   named_parameters=lin.named_parameters(),
                                   op=ht.Adasum)
    (lin(torch.full((1, 3), float(r + 1))) * (r - 0.5)).sum().backward()
    grads = {k: v.grad.detach().clone() for k, v in lin.named_parameters()}
    aopt.step()
    out["adasum"] = {k: (start[k].numpy(), grads[k].numpy(),
                         v.detach().numpy()) for k, v in
                     lin.named_parameters()}

    # SyncBatchNorm over the world's batch
    bn = ht.SyncBatchNorm(bn_xs.shape[2])
    x = torch.from_numpy(bn_xs[r]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(bn_ws[r])).sum().backward()
    out["sync_bn"] = (y.detach().numpy(), x.grad.numpy(),
                      bn.running_mean.numpy(), bn.running_var.numpy())
    return out


def elastic_state_worker(modes, total, commit_at):
    """``elastic.State`` on gpt-nano at 2 layers (fp32, AdamW) in each
    overlap mode of ``modes``: the losses of ``total`` uninterrupted steps
    (step k on ``RandomState(k)``'s tokens); the same steps after
    ``restore()`` rewound two steps to the initial snapshot (an empty
    optimizer state); the steps from ``commit_at`` on after a commit, two
    more steps and a ``restore()``; and a fresh model and optimizer (a
    respawned worker) that adopt the committed snapshot through
    ``sync()``.  With each, whether the live tensors kept their
    identities: the parameter objects, their storage (ZeRO-1's flat
    buffers) and their gradients' storage (the buckets)."""
    import numpy as np
    import torch

    from horovod_tpu_torch.elastic.context import LocalContext
    from horovod_tpu_torch.elastic.state import State, dumps_snapshot
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.optim import DistributedOptimizer
    from horovod_tpu_torch.optim.overlap import OverlapPlan
    from horovod_tpu_torch.train import lm_loss, make_adamw

    def build(mode):
        model = gpt("nano", device="cpu", dtype=torch.float32,
                    num_layers=2, flash_block_q=16, flash_block_k=16)
        if mode == "off":
            return model, DistributedOptimizer(make_adamw(model.parameters()))
        return model, OverlapPlan(model.parameters(), make_adamw, mode=mode,
                                  bucket_mb=0.05)

    def step(model, opt, k):
        toks = torch.from_numpy(np.random.RandomState(k).randint(
            0, 1024, (2, 17)))
        opt.zero_grad()
        loss = lm_loss(model, toks)
        loss.backward()
        opt.step()
        return loss.item()

    def ids(model, mode):
        # the gradients' storage is fixed only where they view a bucket
        # (under "off" each backward allocates them anew)
        ps = list(model.parameters())
        return ([id(p) for p in ps], [p.data_ptr() for p in ps],
                [p.grad.data_ptr() for p in ps] if mode != "off" else None)

    out = {}
    for mode in modes:
        model, opt = build(mode)
        ref = [step(model, opt, k) for k in range(total)]

        model, opt = build(mode)
        state = State(model=model, opt=opt, step=0)
        step(model, opt, 0)
        before = ids(model, mode)
        step(model, opt, 1)
        state.restore()
        restored_empty = ids(model, mode) == before
        from_start = [step(model, opt, k) for k in range(total)]

        model, opt = build(mode)
        state = State(model=model, opt=opt, step=0)
        for k in range(commit_at):
            step(model, opt, k)
        state.step = commit_at
        state.commit()
        before = ids(model, mode)
        step(model, opt, commit_at)
        step(model, opt, commit_at + 1)
        state.restore()
        restored = ids(model, mode) == before and state.step == commit_at
        rolled_back = [step(model, opt, k) for k in range(commit_at, total)]
        blob = dumps_snapshot(state._snapshot, state.commits)

        class Peer(LocalContext):
            def sync_state(self, make_blob, commit_count):
                return blob

        model2, opt2 = build(mode)
        step(model2, opt2, 0)  # gradients exist (the bucket views)
        before = ids(model2, mode)
        state2 = State(model=model2, opt=opt2, step=0)
        state2.sync(Peer())
        adopted = (ids(model2, mode) == before and state2.step == commit_at
                   and state2.last_restore["source"] == "peer")
        after_adopt = [step(model2, opt2, k) for k in range(commit_at, total)]
        out[mode] = {"ref": ref, "from_start": from_start,
                     "rolled_back": rolled_back, "after_adopt": after_adopt,
                     "identities_kept": [restored_empty, restored, adopted]}
    return out


def checkpoint_worker(directory, fault):
    """A 2-rank world's checkpoint round: rank 0 saves, every rank
    restores (rank 0 reads, the others receive the broadcast), metrics are
    averaged; then with ``fault`` (an ``HVDTPU_FAULT_SPEC``) armed, an
    async save whose rank-0 write fails must raise at ``wait()`` on every
    rank."""
    import os

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import callbacks
    from horovod_tpu_torch.testing import faults

    r = hvd.rank()
    state = {"w": torch.arange(4.0) * (r + 1),
             "step": torch.tensor(3, dtype=torch.int32)}
    hvd.save_checkpoint(directory, state, 3)
    out = hvd.restore_checkpoint(directory, {
        "w": torch.zeros(4), "step": torch.tensor(0, dtype=torch.int32)})
    avg = callbacks.metric_average(float(r))
    synced = callbacks.BroadcastGlobalVariablesCallback(0)(
        {"v": torch.full((2,), float(r))})
    os.environ[faults.SPEC_ENV] = fault
    faults.reset()
    handle = hvd.save_checkpoint_async(directory, state, 5)
    try:
        handle.wait()
        raised, msg = False, ""
    except Exception as exc:  # noqa: BLE001 - the contract under test
        raised, msg = True, str(exc)
    return {"restored": out["w"].tolist(), "step": int(out["step"]),
            "avg": avg,
            "synced": synced["v"].tolist(), "raised": raised, "msg": msg,
            "latest": hvd.latest_checkpoint_step(directory)}


def health_worker(state_np, tokens, steps, bucket_mb, flip, overrides):
    """gpt-nano (fp32) AdamW steps through ``OverlapPlan(health=True)`` in
    ``bucket`` and ``bucket+zero1`` from ``state_np`` on this rank's rows
    of ``tokens``: each step's health bundle and local loss.  Then a
    ``bucket`` run under the fault spec ``flip`` (a ``grad_ready``
    ``flip_bits``) with the divergence sentinel (``StepHealth``, a check
    every ``steps`` steps): its report and this rank's final parameters
    by name.  ``overrides``: gpt-nano's config overrides."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.obs.health import HealthConfig, StepHealth
    from horovod_tpu_torch.optim.overlap import OverlapPlan
    from horovod_tpu_torch.testing import faults
    from horovod_tpu_torch.train import lm_loss, make_adamw

    r, n = hvd.rank(), hvd.size()
    rows = tokens.shape[0] // n
    mine = torch.from_numpy(tokens[r * rows:(r + 1) * rows])

    def run(mode, health=None):
        model = gpt("nano", device="cpu", dtype=torch.float32,
                    **overrides)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in state_np.items()})
        plan = OverlapPlan(model.parameters(), make_adamw, mode=mode,
                           bucket_mb=bucket_mb, health=True)
        sh = health(plan) if health else None
        losses, bundles = [], []
        for k in range(1, steps + 1):
            plan.zero_grad()
            loss = lm_loss(model, mine)
            loss.backward()
            plan.step(loss=loss.detach())
            losses.append(loss.item())
            bundles.append(plan.bundle.tolist())
            if sh is not None:
                sh.after_step(k, plan.bundle)
        plan.close()
        return model, plan, sh, losses, bundles

    out = {"names": [name for name, _ in gpt(
        "nano", device="cpu", dtype=torch.float32,
        **overrides).named_parameters()]}
    for mode in ("bucket", "bucket+zero1"):
        _, plan, _, losses, bundles = run(mode)
        out[mode] = {"losses": losses, "bundles": bundles,
                     "buckets": [list(b.leaf_indices)
                                 for b in plan.layout.buckets]}
    os.environ["HVDTPU_FAULT_SPEC"] = flip
    faults.reset()
    config = HealthConfig(enabled=True, check_steps=steps,
                          divergence_action="warn")
    model, plan, sh, _, _ = run(
        "bucket", lambda plan: StepHealth(plan, rank=r, config=config,
                                          leaf_names=out["names"]))
    sh.drain()
    rep = sh.reports[0] if sh.reports else None
    out["sentinel"] = None if rep is None else {
        "bucket": rep.bucket, "leaf": rep.leaf_name,
        "minority": list(rep.minority_ranks),
        "buckets": [list(b.leaf_indices) for b in plan.layout.buckets],
        "params": {k: v.detach().numpy().copy()
                   for k, v in model.named_parameters()}}
    out["alerts"] = sh.monitor.judge.alerts_total
    del os.environ["HVDTPU_FAULT_SPEC"]
    faults.reset()
    return out


# ---------------------------------------------------------------------------
# the native (C++) engine's worlds (HVDTPU_EAGER_ENGINE=native in the
# parent's environment; tests/test_torch_native_engine.py)
# ---------------------------------------------------------------------------


def native_four_worker():
    """``tests/test_native_engine.py``'s four-process case on the port: a
    1000-element Sum (the ring chunks it over four ranks), Adasum over
    four (the VHDD path), the dtype grid, bf16, pre- and postscale and a
    barrier, through the eager ops."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _engine_registry
    from horovod_tpu_torch.ops import eager

    r = hvd.rank()
    rng = np.random.RandomState(100 + r)
    # init() started it (a world of more than one process)
    out = {"started_at_init": _engine_registry._engine is not None,
           "engine": type(_engine_registry.get_engine()).__name__}
    big = torch.from_numpy(rng.randn(1000).astype(np.float32))
    out["big_sum"] = eager.allreduce(big, hvd.Sum, name="big").numpy()
    out["big_local"] = big.numpy()
    ada = torch.from_numpy(rng.randn(64).astype(np.float32))
    out["ada"] = eager.allreduce(ada, hvd.Adasum, name="ada").numpy()
    out["ada_local"] = ada.numpy()
    for dtype in ("float64", "int32", "int64", "uint8"):
        x = torch.from_numpy((np.arange(6) % 5).astype(dtype) + r)
        out[f"sum_{dtype}"] = eager.allreduce(x, hvd.Sum,
                                              name=f"dt_{dtype}").numpy()
    xb = torch.tensor([1.5, 2.5, -3.0], dtype=torch.bfloat16)
    out["sum_bf16"] = _np(eager.allreduce(xb, hvd.Sum, name="dt_bf16"))
    h = eager.allreduce_async(torch.full((3,), 2.0), hvd.Sum, name="scaled",
                              prescale_factor=0.5, postscale_factor=10.0)
    out["scaled"] = eager.synchronize(h).tolist()
    eager.barrier()
    out["barrier"] = True
    return out


def native_adasum_worker(n):
    """Adasum of this rank's row: ``[1 + r, 2 (r + 1), -r]`` at ``n`` 0,
    else ``n`` normals from ``RandomState(100 + r)`` (a non-power-of-two
    world folds its extra ranks into their partners)."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager

    r = hvd.rank()
    if n == 0:
        v = np.asarray([1.0 + r, 2.0 * (r + 1), -1.0 * r], np.float32)
    else:
        v = np.random.RandomState(100 + r).randn(n).astype(np.float32)
    out = eager.allreduce(torch.from_numpy(v), hvd.Adasum, name="ada")
    return {"v": v, "out": out.numpy()}


def native_pair_worker():
    """Two ranks: bf16 Adasum's wire bytes against fp32's (the engine's
    bytes counter), 20 steps of the same 5 named averages (the response
    cache's steady state), three named sums (the timeline), a result's
    type, dtype and device, in place too, and a 32 MB Sum, whose ring
    halves (16 MB each way at once) are past the sockets' buffers."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _engine_registry
    from horovod_tpu_torch.ops import eager

    r = hvd.rank()
    eng = _engine_registry.get_engine()
    out = {}
    base = torch.from_numpy(
        np.linspace(0.1, 1.0, 2048).astype(np.float32) * (r + 1))
    b0 = eng.lib.hvdtpu_perf_bytes()
    out32 = eager.allreduce(base, hvd.Adasum, name="a32")
    b1 = eng.lib.hvdtpu_perf_bytes()
    out16 = eager.allreduce(base.bfloat16(), hvd.Adasum, name="a16")
    b2 = eng.lib.hvdtpu_perf_bytes()
    out.update(f32_bytes=b1 - b0, bf16_bytes=b2 - b1,
               out32=out32.double().numpy(), out16=out16.double().numpy())

    totals = []
    for step in range(20):
        hs = [hvd.allreduce_async(torch.full((8,), float(step + r + k)),
                                  hvd.Average, name=f"grad_{k}")
              for k in range(5)]
        totals.append(float(sum(hvd.synchronize(h).sum() for h in hs)))
    out["totals"] = totals
    out["stats"] = eng.stats

    for i in range(3):
        eager.allreduce(torch.ones(4), hvd.Sum, name=f"t{i}")

    x = torch.full((4,), float(r + 1))
    s = eager.allreduce(x, hvd.Sum)
    y = torch.full((2, 2), float(r + 1), dtype=torch.float64)
    y_out = eager.allreduce_(y, hvd.Sum)
    out.update(is_tensor=isinstance(s, torch.Tensor), device=str(s.device),
               dtype=str(s.dtype), sum=s.tolist(), inplace_is_arg=y_out is y,
               inplace=y.tolist())
    big = eager.allreduce(torch.full((1 << 23,), float(r + 1)), hvd.Sum,
                          name="big")
    out["big"] = (big.numel(), bool((big == 3.0).all()))
    return out


def native_autotune_worker():
    """``tests/test_multiprocess.py``'s autotune case on the port: steady
    traffic until rank 0's tuner moves the fusion threshold (30 s at
    most); the moved parameters as each rank's engine sees them.  The
    ranks leave the loop together, on a Max of "moved or out of time"
    (one rank leaving alone would shut the engine down under the other's
    next op)."""
    import time

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import _engine_registry
    from horovod_tpu_torch.ops import eager

    eng = _engine_registry.get_engine()
    initial = eng.lib.hvdtpu_get_fusion_bytes()
    deadline = time.monotonic() + 30.0
    i, done = 0, False
    while not done:
        eager.allreduce(torch.ones(4096), hvd.Sum, name=f"t{i % 4}")
        i += 1
        stop = eng.lib.hvdtpu_get_fusion_bytes() != initial \
            or time.monotonic() > deadline
        done = bool(eager.allreduce(torch.tensor([float(stop)]), hvd.Max,
                                    name=f"stop.{i}")[0] > 0)
    return {"initial": initial, "fusion": eng.lib.hvdtpu_get_fusion_bytes(),
            "cycle_ms": eng.lib.hvdtpu_get_cycle_ms(),
            "perf_bytes": eng.lib.hvdtpu_perf_bytes(), "iters": i}


def native_np8_worker():
    """Eight ranks, 20 rounds of a 256 KB Sum each: seven workers feed the
    rank-0 coordinator through its poll-multiplexed gather."""
    import time

    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops import eager

    r = hvd.rank()
    t0 = time.monotonic()
    for i in range(20):
        out = eager.allreduce(torch.full((65536,), float(r + 1)), hvd.Sum,
                              name=f"big{i}")
    return {"ok": bool((out == 36.0).all()),
            "elapsed": time.monotonic() - t0}


def schedule_worker(out_dir, steps, extra_on_rank):
    """gpt-nano fp32 in ``bucket`` mode for ``steps`` steps with torch's
    flight recorder on (the parent sets its environment before the world
    starts); dumps this rank's schedule to ``out_dir/rank<r>.json`` and
    returns the plan's bucket count and the entries written.  On rank
    ``extra_on_rank`` one extra ``all_reduce`` runs first, on a group of
    that rank alone: the rank-guarded collective of HVD001, made to
    complete so that its schedule can be compared."""
    import os

    import torch
    import torch.distributed as dist

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.obs.collective_schedule import (
        dump_collective_schedule)
    from horovod_tpu_torch.train import build_gpt_step

    r = hvd.rank()
    alone = dist.new_group([extra_on_rank]) if extra_on_rank is not None \
        else None
    step, state, _ = build_gpt_step("nano", "fp32", 2, 16, device="cpu",
                                    overlap_mode="bucket", grad_bucket_mb=0.25)
    if r == extra_on_rank:
        dist.all_reduce(torch.zeros(1), group=alone)
    for _ in range(steps):
        state = step(*state)[:2] + (state[2],)
    n = dump_collective_schedule(os.path.join(out_dir, f"rank{r}.json"))
    return len(state[1].layout.buckets), n
