"""A small gloo world of horovod_tpu_torch processes for the port's tests.

:func:`run_world` spawns ``world`` fresh processes (``spawn``: no JAX and
no state of the test process carried over), gives each the hvdrun
rendezvous environment, calls ``horovod_tpu_torch.init(device="cpu")``,
runs ``fn(*args)`` and returns the per-rank results in rank order.  The
worker functions below import only torch and the port.
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


def _entry(fn, rank, world, port, args, out):
    os.environ.update({
        "HVDTPU_RANK": str(rank), "HVDTPU_SIZE": str(world),
        "HVDTPU_LOCAL_RANK": str(rank), "HVDTPU_LOCAL_SIZE": str(world),
        "HVDTPU_CROSS_RANK": "0", "HVDTPU_CROSS_SIZE": "1",
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


def run_world(fn, args=(), world: int = 2, timeout: float = 60.0) -> list:
    """Run ``fn(*args)`` on every rank of a fresh gloo world; results in
    rank order.  Raises with the failing rank's traceback, or on timeout."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_entry, args=(fn, r, world, port, args, out),
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
