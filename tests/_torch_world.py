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


def collectives_worker(xs, ws, bf16_xs):
    """allreduce / grouped_allreduce / broadcast values and grads on this
    rank's inputs (``xs[rank]`` etc.), returned as numpy."""
    import torch

    import horovod_tpu_torch as hvd

    r = hvd.rank()
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
