"""Training-throughput bench of the port: the root ``bench.py``'s GPT and
conv-zoo paths (its CLI, ``bench.py:1236-1290``, and its record,
``:1551-1575``).

    python -m horovod_tpu_torch.bench --model resnet50           # one GPU
    python -m horovod_tpu_torch.bench --model gpt-small
    torchrun --nproc-per-node 4 -m horovod_tpu_torch.bench ...   # four
    python -m horovod_tpu_torch.bench --cpu --model gpt-nano     # CPU check

Builds ``train.build_step`` (conv models) or ``train.build_gpt_step``
with the flags' values, runs ``--warmup`` steps, then times ``--iters``
steps with the host clock around work that ends in a device synchronise,
and prints one JSON line (rank 0's): ``metric``, ``value`` (images/s or
tokens/s per GPU), ``unit``, ``mfu`` (model FLOPs over the card's dense
peak for the dtype; null where the device has no entry in
:data:`PEAK_FLOPS`, e.g. the CPU), ``device``, ``overlap_mode``, the
torch and CUDA versions, peak memory, and the flash kernels that launched
with their counts (``attention`` says ``kernels`` only if some did: the
CPU runs their plain versions).  Conv records also carry
``flops_per_image`` (:func:`conv_flops_per_image`) and ``vs_baseline``,
the value over Horovod's published 103.55 images/s per GPU
(``bench.py:7-14``).  Every number is this run's.

``--serve`` is the reference's open-loop serving benchmark
(``bench.py:675-1059``): a :class:`~.serve.ServeJob` fleet of
``--serve-np`` ranks serving ``--model`` (gpt-nano: the reference's own
2-layer fp32 serving model) gets ``--serve-requests`` mixed-length prompts
(``--seed``) at Poisson arrivals of ``--serve-rate`` a second, submitted
on schedule whatever the fleet's backlog, while a poller stamps each
request's first token and completion.  One JSON record: generated
tokens/s (``value``), requests/s, TTFT and TPOT percentiles on the
client's clock, the paged pool's KV waste, the front door's per-shard
counts; ``--serve-scaling`` adds the same traffic at np = w and 2w.

    python -m horovod_tpu_torch.bench --serve --model gpt-small \\
        --serve-slots 16 --serve-requests 48 --serve-rate 3

Every record carries ``anatomy`` (``obs/anatomy.py``, as the root
``bench.py:1612-1629`` and ``:1032-1045`` attach it): the step time split
into compute (MFU x step), the eager engine's collective wait and the
host gap, the roofline verdict, and (training records) the flash kernels
one step launches.  ``--campaign SPEC`` runs a resumable sweep of bench
points instead of one measurement (:mod:`.campaign`).

The run is supervised (:mod:`.supervisor`, the root ``bench.py``'s
machinery): one wall-clock budget ``--total-budget-secs`` across every
attempt, a retry in a fresh process (``--attempts``) for a transient
device or rendezvous failure, a watchdog over the phases ``init``,
``build`` (window ``--watchdog-secs``), ``warmup`` and ``measure`` that
re-execs or exits 86, a failure sidecar naming the phase, and a degraded
``BENCH_rNN.json`` when no measurement comes.  Records and sidecars land
only in a directory the environment names (``HVDTPU_BENCH_RECORD_DIR``,
``HVDTPU_RECORD_DIR``, ``HVDTPU_BENCH_SIDECAR``), never in the checkout.
Every record carries the regression sentinel's verdict against that
directory's trajectory (:func:`attach_regression`) and its backend stamp
(``provenance``); ``--num-slices N`` forces a partition of N slices
before the world starts, and the record then carries ``num_slices``.
``--cpu`` never arms the watchdog.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch

from ..obs.anatomy import attach_anatomy
from ..obs.profile import PEAK_FLOPS, peak_flops
from ..optim.overlap import MODES
from ..utils import env as envmod
from . import supervisor

__all__ = ["PEAK_FLOPS", "BASELINE_IMAGES_PER_SEC", "conv_flops_per_image",
           "model_flops_per_step", "peak_flops", "serve_spec", "serve_trace",
           "serve_main", "attach_regression", "main"]

# Horovod's published per-GPU figure the reference's ``vs_baseline`` divides
# by: tf_cnn_benchmarks ResNet-101, 1656.82 images/s over 16 Pascal GPUs
# (docs/benchmarks.rst:29-43, root bench.py:7-14)
BASELINE_IMAGES_PER_SEC = 103.55

_GPT_MODELS = ("gpt-nano", "gpt-small", "gpt-medium", "gpt-large")
_CONV_MODELS = ("resnet50", "resnet101", "resnet18", "vgg16", "vgg19",
                "inception3")


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Training FLOPs of one step, counted from the model: 6 per parameter
    of the matrix products per token (forward 2, backward 4), plus the
    attention products (forward 4 * emb per (q, k) pair alive under the
    causal mask, times 3 for forward and backward); neither the backward's
    recompute of the scores nor a remat recompute is counted.

    An MoE block (``cfg.moe_experts > 0``) counts ``moe_top_k`` times the
    dense MLP's products per token (the experts each token is routed to,
    as if none overflowed) plus its router's ``emb x experts``.  The
    one-hot dispatch and combine einsums move tokens into and out of the
    expert slots: they are layout, not model FLOPs, and are not counted,
    though on the card they take most of the MoE step's time."""
    e, L, v = cfg.emb_dim, cfg.num_layers, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    mlp = 2 * cfg.mlp_ratio * e * e
    if cfg.moe_experts > 0:
        mlp = cfg.moe_top_k * mlp + e * cfg.moe_experts
    n_mm = L * (e * (e + 2 * kv) + e * e + mlp) + e * v
    pairs = seq * (seq + 1) // 2
    return 6 * n_mm * batch * seq + 3 * L * 4 * e * pairs * batch


def conv_flops_per_image(model: str, image_size: int = 224,
                         s2d_stem: bool = False) -> int:
    """Training FLOPs per image of conv-zoo model ``model``, counted from
    its layers' shapes: 3 (forward, and the backward's two products) x 2 x
    the multiply-adds of every convolution and Dense layer, found by one
    forward of a single image on the ``meta`` device (shapes only).
    BatchNorm, pools, activations, the loss and the optimizer are left
    out.  The root ``bench.py`` takes XLA's compiled cost analysis
    instead, which counts other work, so the two records'
    ``flops_per_image`` are not to be compared."""
    from ..models.layers import Conv2d, Dense
    from ..train import conv_model

    with torch.device("meta"):
        net = conv_model(model, "fp32", image_size, s2d_stem)
    macs = []

    def count(mod, inputs, out):
        if isinstance(mod, Conv2d):
            macs.append(out.numel() * mod.weight[0].numel())
        else:
            macs.append(out.numel() * mod.in_features)

    for mod in net.modules():
        if isinstance(mod, (Conv2d, Dense)):
            mod.register_forward_hook(count)
    net.eval()(torch.empty(1, 3, image_size, image_size, device="meta"))
    return 6 * sum(macs)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m horovod_tpu_torch.bench")
    p.add_argument("--model", default="gpt-small",
                   choices=_GPT_MODELS + _CONV_MODELS)
    p.add_argument("--dtype", default="bf16", choices=["bf16", "fp32", "fp8"],
                   help="compute dtype (params and optimizer state fp32); "
                   "fp8 = bf16 compute with e4m3 activation storage (GPT, "
                   "ResNet)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="per GPU (default: 128 for conv models, 8 for GPT)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--s2d-stem", action="store_true",
                   help="ResNet's space-to-depth stem")
    p.add_argument("--seq-len", type=int, default=1024)
    p.add_argument("--attention", default="flash",
                   choices=["flash", "reference"])
    p.add_argument("--remat", action="store_true",
                   help="checkpoint every block, saving the Dense products")
    p.add_argument("--kv-heads", type=int, default=0, help="0 = MHA")
    p.add_argument("--pos-embedding", default="learned",
                   choices=["learned", "rope"])
    p.add_argument("--attention-window", type=int, default=0,
                   help="sliding window (last W keys); 0 = full causal")
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--iters", type=int, default=10, help="timed steps")
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--overlap", default=None, choices=MODES,
                   help="backward-overlap gradient plane (default: "
                   "HVDTPU_OVERLAP or off)")
    p.add_argument("--grad-bucket-mb", type=float, default=None,
                   help="bucket cap for --overlap (default: "
                   "HVDTPU_GRAD_BUCKET_MB or 16)")
    p.add_argument("--serve", action="store_true",
                   help="serving-plane benchmark: open-loop arrivals "
                   "through the continuous-batching fleet; lands ttft/tpot "
                   "percentiles and tokens/sec instead of a training step "
                   "time")
    p.add_argument("--serve-np", type=int, default=1,
                   help="serving ranks (elastic fleet size)")
    p.add_argument("--serve-slots", type=int, default=4,
                   help="decode slot pool size per rank")
    p.add_argument("--serve-requests", type=int, default=16,
                   help="requests in the open-loop arrival trace")
    p.add_argument("--serve-rate", type=float, default=4.0,
                   help="mean arrival rate, requests/sec (seeded "
                   "exponential gaps)")
    p.add_argument("--serve-width", type=int, default=0,
                   help="width-sharded fleet (0 = replicated): np//width "
                   "serving groups; above 1 each group's ranks hold one "
                   "Megatron shard each of the model")
    p.add_argument("--serve-kv-mode", default="paged",
                   choices=["paged", "contiguous"],
                   help="KV layout (paged = block tables; contiguous = "
                   "worst-case rows)")
    p.add_argument("--serve-page-size", type=int, default=8,
                   help="KV page size in token rows (paged mode)")
    p.add_argument("--serve-kv-pages", type=int, default=0,
                   help="KV page-pool size (0 = worst case)")
    p.add_argument("--serve-scaling", action="store_true",
                   help="run the same workload at np=w and np=2w (w = "
                   "--serve-width or 1) and embed the fleet-scaling "
                   "tokens/sec ratio")
    p.add_argument("--serve-scaling-attempts", type=int, default=2,
                   help="best-of-N runs per scaling leg")
    p.add_argument("--frontends", type=int, default=0,
                   dest="serve_frontends",
                   help="sharded front door: run the workload with F "
                   "frontend ingest shards; F>1 also runs an F=1 leg on "
                   "the same trace and embeds the comparison")
    p.add_argument("--seed", type=int, default=42,
                   help="seed of the serving trace (arrival gaps, prompt "
                   "lengths and tokens, budgets)")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (a check of the path; its numbers "
                   "are no device's)")
    p.add_argument("--campaign", default=None, metavar="SPEC",
                   help="run a resumable benchmark campaign from this "
                   "sweep-spec JSON instead of one measurement (each point "
                   "its own bench process; see horovod_tpu_torch.bench."
                   "campaign)")
    p.add_argument("--num-slices", type=int, default=0,
                   help="force a partition of the world into N slices "
                   "(HVDTPU_NUM_SLICES) before it starts; 0 = one slice")
    p.add_argument("--attempts", type=int, default=4,
                   help="retries (a fresh process each) on a transient "
                   "device or rendezvous failure")
    p.add_argument("--watchdog-secs", type=int, default=780,
                   help="the build phase's hang deadline (0 disables the "
                   "watchdog); init and warm-up use 300 s")
    p.add_argument("--total-budget-secs", type=int, default=1440,
                   help="hard wall-clock budget across all attempts, "
                   "backoff included")
    p.add_argument("--retry-attempt", type=int, default=0,
                   help=argparse.SUPPRESS)
    p.add_argument("--deadline-epoch", type=float, default=0.0,
                   help=argparse.SUPPRESS)
    return p


def _check_args(args) -> None:
    """Refuse, before anything is built, the combinations the port's bench
    cannot run: a width-sharded serving fleet outside paged mode (the
    width-sharded decode is the paged one, as in the reference), and
    experts on a model without blocks.  (``--campaign`` never reaches
    here: :func:`main` hands it to :mod:`.campaign` before the flags of a
    measurement are read.)"""
    if args.serve and (args.serve_width or 0) > 1 \
            and args.serve_kv_mode != "paged":
        raise ValueError(
            f"--serve-width {args.serve_width} needs --serve-kv-mode paged "
            f"(the width-sharded decode is the paged one)")
    if args.moe_experts and not args.model.startswith("gpt-"):
        raise ValueError(f"--moe-experts needs a gpt-* model, not "
                         f"{args.model!r}")


def run(args) -> dict:
    """Start the world, build, warm up and time the step, marking each
    phase for the watchdog; the record."""
    from .. import basics
    from ..obs.health import HealthConfig, StepHealth
    from ..ops import flash_attention as fa
    from ..ops import kernels
    from ..train import build_gpt_step, build_step

    touch = supervisor._touch_progress
    gpt = args.model.startswith("gpt-")
    device = "cpu" if args.cpu else None
    touch(phase="init")
    basics.init(device=device)
    # the model and the kernels' first-use build: the compile window
    touch(args.watchdog_secs, phase="build")
    if basics.device().type == "cuda":
        kernels.build_all()
    # --health (HVDTPU_HEALTH) arms the GPT step's health bundle, the
    # anomaly judge and the divergence sentinel
    health = gpt and HealthConfig.from_env().enabled
    if gpt:
        step, state, static = build_gpt_step(
            args.model[len("gpt-"):], args.dtype, args.batch_size,
            args.seq_len, attention=args.attention, remat=args.remat,
            kv_heads=args.kv_heads, pos_embedding=args.pos_embedding,
            attention_window=args.attention_window,
            moe_experts=args.moe_experts,
            overlap_mode=args.overlap, grad_bucket_mb=args.grad_bucket_mb,
            device=device, health=health)
    else:
        step, state, static = build_step(
            args.model, args.dtype, args.batch_size, args.image_size,
            args.s2d_stem, args.overlap, args.grad_bucket_mb, device=device)
    dev = basics.device()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    carry = static["carry_len"]
    monitor = (StepHealth(state[1], rank=basics.rank())
               if health else None)
    done = [0]

    def steps(n, state):
        loss = None
        for _ in range(n):
            out = step(*state)
            state = tuple(out[:carry]) + state[carry:]
            loss = out[carry]
            done[0] += 1
            if monitor is not None:
                monitor.after_step(done[0], out[carry + 1])
            touch()  # at dispatch; the sync ends each loop
        return state, loss

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    touch(phase="warmup")
    state, _ = steps(args.warmup, state)
    sync()
    touch(phase="measure")
    t0 = time.perf_counter()
    state, loss = steps(args.iters, state)
    final_loss = float(loss)  # waits for the device
    sync()
    step_s = (time.perf_counter() - t0) / args.iters
    supervisor._watchdog_disarm.set()
    if monitor is not None:
        monitor.drain()
    if final_loss != final_loss or abs(final_loss) == float("inf"):
        raise RuntimeError(f"non-finite loss {final_loss}")

    name = torch.cuda.get_device_name(dev) if cuda else "cpu"
    peak = peak_flops(name, args.dtype) if cuda else None
    launched = {k: v for k, v in fa.LAUNCHES.items() if v}
    if gpt:
        unit = "tokens/sec/gpu"
        per_gpu = args.batch_size * args.seq_len / step_s
        flops = model_flops_per_step(state[0].cfg, args.batch_size,
                                     args.seq_len)
        extra = {"model_flops_per_step": flops,
                 "attention": (args.attention if args.attention != "flash"
                               else "kernels" if launched else "plain")}
    else:
        unit = "images/sec/gpu"
        per_gpu = args.batch_size / step_s
        per_image = conv_flops_per_image(args.model, args.image_size,
                                         args.s2d_stem)
        flops = per_image * args.batch_size
        # a GPU figure: no CPU number is held against it
        extra = {"flops_per_image": per_image,
                 "vs_baseline": (round(per_gpu / BASELINE_IMAGES_PER_SEC, 4)
                                 if cuda else None),
                 "image_size": args.image_size}
    record = {
        "metric": f"{args.model}_{args.dtype}_{unit.replace('/', '_per_')}",
        "value": round(per_gpu, 2),
        "unit": unit,
        "mfu": round(flops / step_s / peak, 4) if peak else None,
        **extra,
        "device": name,
        "device_index": dev.index,
        # the rendezvous environment this process was started with (a
        # launcher's, or none)
        "rendezvous_env": {k: os.environ[k] for k in (
            envmod.RANK, envmod.SIZE, envmod.LOCAL_RANK, envmod.LOCAL_SIZE,
            envmod.COORDINATOR) if k in os.environ},
        "n_gpus": static["n_chips"],
        "batch_size": args.batch_size,
        "overlap_mode": args.overlap,
        "step_ms": step_s * 1e3,
        "final_loss": final_loss,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "flash_launches": launched,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if cuda else None),
        "provenance": supervisor.backend_provenance(probe=True),
    }
    if basics.num_slices() > 1:
        record["num_slices"] = basics.num_slices()
    layout = getattr(state[carry - 1], "layout", None)
    if layout is not None:
        record["buckets"] = len(layout.buckets)
        record["bucket_bytes"] = [b.nbytes for b in layout.buckets]
    record["health"] = health_gauges(final_loss)
    steps_run = args.warmup + args.iters
    attach_anatomy(
        record, step_ms=step_s * 1e3, mfu=record["mfu"],
        flops_per_step=flops, device_kind=name, dtype=args.dtype,
        launches={k: v / steps_run for k, v in launched.items()},
        steps_observed=steps_run)
    return record


def health_gauges(final_loss: float) -> dict:
    """The headline health gauges every record carries (the root
    ``bench.py:1583-1599``): ``health.loss`` and ``health.nonfinite`` from
    the timed loop's final loss, the divergence checks and the nonfinite
    total at their current counts (0 when ``--health`` was off), and, when
    the step carried the health bundle, the grad-norm histogram's p50 and
    the alerts fired."""
    from ..obs import get_registry

    reg = get_registry()
    reg.gauge("health.loss").set(final_loss)
    reg.gauge("health.nonfinite").set(
        0 if final_loss == final_loss and abs(final_loss) != float("inf")
        else 1)
    reg.counter("health.divergence.checks").inc(0)
    reg.counter("health.nonfinite_total").inc(0)
    out, alerts = {}, 0.0
    for m in reg.snapshot():
        name = m["name"]
        if not name.startswith("health."):
            continue
        if name == "health.alerts":
            alerts += float(m.get("value") or 0)
        elif name == "health.grad_norm_hist":
            if m.get("p50") is not None:
                out["health.grad_norm_p50"] = m["p50"]
        elif not m["tags"]:
            out[name] = m["value"]
    if alerts:
        out["health.alerts_total"] = alerts
    return out


# seconds one serving run may take, start-up included
SERVE_TIMEOUT = 900.0

# The reference's serving-bench model (root bench.py:689-692): gpt-nano
# cut to 2 layers, 4 heads, emb 64, vocab 512, fp32.
SERVE_NANO = dict(num_layers=2, num_heads=4, emb_dim=64, max_len=256,
                  vocab_size=512, attention_impl="reference",
                  dtype=torch.float32)


def serve_spec(args) -> dict:
    """The fleet's spec: ``--model`` (gpt-nano is the reference's serving
    model, ``SERVE_NANO``; the others at full width and depth in
    ``--dtype``), with the pool and page flags."""
    size = args.model[len("gpt-"):]
    if size == "nano":
        overrides = dict(SERVE_NANO)
    else:
        overrides = {"attention_impl": "reference",
                     "dtype": {"bf16": torch.bfloat16,
                               "fp32": torch.float32}[args.dtype]}
    spec = {"size": size, "overrides": overrides, "seed": 0,
            "num_slots": args.serve_slots, "idle_secs": 0.005,
            # Stream batching at 8: the first token still publishes
            # immediately (ttft is real), steady-state streaming costs
            # half the signed puts.
            "stream_every": 8,
            "kv_mode": args.serve_kv_mode,
            "page_size": args.serve_page_size}
    if args.serve_kv_pages:
        spec["kv_pages"] = args.serve_kv_pages
    if args.cpu:
        spec["device"] = "cpu"
    return spec


def serve_trace(args, vocab: int):
    """``(gaps, prompts, budgets)`` of the open-loop trace from ``--seed``:
    exponential gaps at ``--serve-rate``, prompts of 16-48 tokens, budgets
    16-32 (the reference's mix)."""
    import numpy as np

    n = args.serve_requests
    rng = np.random.RandomState(args.seed)
    gaps = rng.exponential(1.0 / args.serve_rate, n)
    prompts = [rng.randint(0, vocab, rng.randint(16, 49)).tolist()
               for _ in range(n)]
    budgets = [int(rng.randint(16, 33)) for _ in range(n)]
    return gaps, prompts, budgets


def _pct(xs, q):
    import numpy as np

    return round(float(np.percentile(xs, q)), 2) if xs else None


def _run_serve_load(args, np_: int, width: int, frontends: int = 1) -> dict:
    """One fleet under one open-loop workload (the reference's
    ``_run_serve_load``): launch ``np_`` serving ranks (``width`` >= 1:
    np_//width serving groups), submit the trace, and measure ttft, tpot,
    tokens/s and requests/s on the client clock.  Returns the raw
    measurement the record (or the scaling comparison) embeds."""
    import threading

    from ..models import GPT_CONFIGS
    from ..serve import ServeJob

    spec = serve_spec(args)
    spec["width"] = width
    spec["frontends"] = max(int(frontends), 1)
    size = spec["size"]
    vocab = spec["overrides"].get("vocab_size",
                                  GPT_CONFIGS[size].vocab_size)
    # one intra-op thread a CPU worker: the fleet's processes share the
    # host, and a scaling comparison must not measure their contention
    env = {"OMP_NUM_THREADS": "1"} if args.cpu else None
    gaps, prompts, budgets = serve_trace(args, vocab)
    n_req = args.serve_requests
    job = ServeJob(spec, np=np_, env=env, timeout=SERVE_TIMEOUT).start()
    deadline = time.monotonic() + SERVE_TIMEOUT
    # Warm-up outside the measured window: one request per prompt bucket
    # the trace hits (16/32/64), on every group.
    groups = max(np_ // width, 1) if width else 1
    warm = [job.client.submit([7] * warm_len, max_new_tokens=9)
            for warm_len in (10, 20, 40) for _ in range(groups)]
    submit_t: dict = {}
    rids: list = []
    fd_stats: dict = {}
    try:
        for rid in warm:
            job.client.result(rid, timeout=max(deadline - time.monotonic(),
                                               1.0))

        def _submitter():
            t = time.perf_counter()
            for i in range(n_req):
                t += gaps[i]
                now = time.perf_counter()
                if t > now:
                    time.sleep(t - now)
                rid = job.client.submit(prompts[i],
                                        max_new_tokens=budgets[i])
                submit_t[rid] = time.perf_counter()
                rids.append(rid)

        sub = threading.Thread(target=_submitter, daemon=True)
        t_start = time.perf_counter()
        t_start_wall = time.time()
        sub.start()
        first_t: dict = {}
        done: dict = {}
        while len(done) < n_req:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"serve bench: {len(done)}/{n_req} requests finished "
                    f"within {SERVE_TIMEOUT} s")
            for rid in list(rids):
                if rid in done:
                    continue
                doc = job.client.poll(rid)
                if doc is None:
                    continue
                if doc.get("tokens") and rid not in first_t:
                    first_t[rid] = time.perf_counter()
                if doc.get("done"):
                    done[rid] = (time.perf_counter(),
                                 len(doc.get("tokens", [])),
                                 doc.get("t_done"))
            # a sweep costs the store a signed get per pending request:
            # sweeping again at once would make this client the store's
            # biggest tenant
            time.sleep(0.01)
        sub.join(timeout=10)
        total_tokens = sum(n for _, n, _ in done.values())
        # Throughput from the leaders' completion stamps against the
        # client's submit clock (one host, one clock): the client's own
        # polling cadence would otherwise be the largest term.
        server_ends = [t for _, _, t in done.values() if t]
        if server_ends:
            elapsed = max(server_ends) - t_start_wall
        else:
            elapsed = max(t for t, _, _ in done.values()) - t_start
        # Sustained rate: tokens completed in the p20-p80 completion
        # window over its duration (ramp and drain excluded).
        sustained = None
        if len(server_ends) >= 10:
            ends = sorted((t, n) for _, n, t in done.values() if t)
            lo = ends[int(len(ends) * 0.2)][0]
            hi = ends[int(len(ends) * 0.8)][0]
            mid_tokens = sum(n for t, n in ends if lo < t <= hi)
            if hi > lo:
                sustained = mid_tokens / (hi - lo)
        ttft = [(first_t[r] - submit_t[r]) * 1000.0
                for r in rids if r in first_t]
        tpot = [(done[r][0] - first_t[r]) / max(done[r][1] - 1, 1) * 1000.0
                for r in rids if r in first_t and done[r][1] > 1]
        results, _ = job.stop(timeout=max(deadline - time.monotonic(), 30))
        fd_stats = job.front_door.stats()
    finally:
        job.shutdown()

    meas = {
        "np": np_,
        "width": width,
        "frontends": max(int(frontends), 1),
        "groups": groups,
        "slots": args.serve_slots,
        "requests": n_req,
        "arrival_rate_per_sec": args.serve_rate,
        "total_tokens": total_tokens,
        "elapsed_s": elapsed,
        "tokens_per_sec": round(total_tokens / max(elapsed, 1e-9), 2),
        "requests_per_sec": round(n_req / max(elapsed, 1e-9), 3),
        "sustained_tokens_per_sec": (round(sustained, 2)
                                     if sustained else None),
        "ttft_ms": {"p50": _pct(ttft, 50), "p90": _pct(ttft, 90),
                    "p99": _pct(ttft, 99)},
        "tpot_ms": {"p50": _pct(tpot, 50), "p90": _pct(tpot, 90),
                    "p99": _pct(tpot, 99)},
    }
    if fd_stats:
        meas["frontdoor"] = {
            "frontends": fd_stats.get("frontends"),
            "fd_epoch": fd_stats.get("fd_epoch"),
            "takeovers": fd_stats.get("takeovers"),
            "ingested_by_shard": {
                str(s): n for s, n in sorted(
                    (fd_stats.get("ingested_by_shard") or {}).items())},
        }
    ranks = sorted(results or {})
    meas["_results"] = results or {}
    if ranks:
        meas["completed_per_rank"] = {
            str(r): results[r]["completed"] for r in ranks}
        meas["admitted_while_busy"] = max(
            results[r].get("admitted_while_busy", 0) for r in ranks)
        kvs = [results[r]["kv"] for r in ranks if results[r].get("kv")]
        if kvs:
            meas["kv"] = {
                "mode": kvs[0].get("mode"),
                "waste_ratio_mean": round(max(
                    k.get("waste_ratio_mean", 0.0) for k in kvs), 4),
                "contiguous_equiv_waste_mean": round(max(
                    k.get("contiguous_equiv_waste_mean", 0.0)
                    for k in kvs), 4),
                "page_size": kvs[0].get("page_size"),
                "num_pages": kvs[0].get("num_pages"),
                "pool_bytes": kvs[0].get("pool_bytes"),
            }
    return meas


def serve_main(args) -> dict:
    """``--serve`` (the reference's ``_serve_bench``): one fleet under the
    open-loop trace, or the front-door comparison (``--frontends`` F > 1:
    the same trace through one pump and through F), or ``--serve-scaling``
    (np = w and 2w, best of ``--serve-scaling-attempts`` each).  The
    record."""
    width = int(args.serve_width or 0)
    fd = max(int(args.serve_frontends or 0), 0)
    scaling = frontdoor_scaling = None
    where = "cpu" if args.cpu else "device measurement"
    if fd > 1 and not args.serve_scaling:
        single = _run_serve_load(args, args.serve_np, width, frontends=1)
        single.pop("_results", None)
        main = _run_serve_load(args, args.serve_np, width, frontends=fd)
        results = main.pop("_results")
        frontdoor_scaling = {
            "f1": {k: v for k, v in single.items()
                   if k != "completed_per_rank"},
            f"f{fd}": {k: v for k, v in main.items()
                       if k != "completed_per_rank"},
            "tokens_per_sec_ratio": round(
                main["tokens_per_sec"] / max(single["tokens_per_sec"],
                                             1e-9), 3),
            "provenance": where,
        }
    elif args.serve_scaling:
        w = max(width, 1)
        attempts = max(int(args.serve_scaling_attempts), 1)

        def _rate(m):
            return m["sustained_tokens_per_sec"] or m["tokens_per_sec"]

        base = max((_run_serve_load(args, w, w) for _ in range(attempts)),
                   key=_rate)
        doubled = max((_run_serve_load(args, 2 * w, w)
                       for _ in range(attempts)), key=_rate)
        both = (base["sustained_tokens_per_sec"] is not None
                and doubled["sustained_tokens_per_sec"] is not None)
        main, results = doubled, doubled.pop("_results")
        base.pop("_results", None)
        scaling = {
            "np_w": {k: v for k, v in base.items()
                     if k != "completed_per_rank"},
            "np_2w": {k: v for k, v in doubled.items()
                      if k != "completed_per_rank"},
            "tokens_per_sec_ratio": round(
                _rate(doubled) / max(_rate(base), 1e-9), 3),
            "ratio_basis": ("sustained (p20-p80 completion window)"
                            if both else "makespan tokens_per_sec"),
            "best_of": attempts,
            "provenance": where,
        }
    else:
        main = _run_serve_load(args, args.serve_np, width,
                               frontends=max(fd, 1))
        results = main.pop("_results")
    size = args.model[len("gpt-"):]
    out = {
        "metric": f"serve_{size}_tokens_per_sec",
        "value": main["tokens_per_sec"],
        "unit": "tokens/sec",
        "device": ("cpu" if args.cpu
                   else torch.cuda.get_device_name(0)),
        "dtype": "fp32" if size == "nano" else args.dtype,
        "seed": args.seed,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "serve": main,
    }
    if scaling is not None:
        out["serve"]["scaling"] = scaling
    if frontdoor_scaling is not None:
        out["serve"]["frontdoor_scaling"] = frontdoor_scaling
    ranks = sorted(results or {})
    if ranks:
        mem = results[ranks[0]].get("memory")
        if mem:
            out["memory"] = mem
        sched = results[ranks[0]].get("sched_ms") or []
        out["serve"]["sched_ms_median"] = (
            _pct(sched, 50) if sched else None)
        # the leader's decode-step accounting (obs/profile.py): the
        # anatomy below splits its step into compute and host gap
        perf = results[ranks[0]].get("perf")
        if perf:
            out["perf"] = perf
    perf = out.get("perf") or {}
    attach_anatomy(out, step_ms=perf.get("step_ms"), mfu=perf.get("mfu"),
                   flops_per_step=perf.get("flops_per_step"),
                   device_kind=out["device"])
    if args.cpu:
        out["degraded"] = True
    return out


def attach_regression(out: dict, record_dir: Optional[str] = None,
                      threshold_pct: float = 5.0) -> dict:
    """The trend-aware regression sentinel over the ``BENCH_*.json``
    trajectory in ``record_dir`` (default: the supervisor's record dir;
    with none, nothing is comparable), a copy of the root
    ``bench.py:1060-1161`` on the port's ``obs/trend.py``.

    The baseline is the EWMA over the last non-degraded records of this
    run's metric and device; ``baseline_record`` names the newest such
    record and the records the EWMA folded, with the newer records it
    skipped (no comparable measurement) and the degraded ones it refused;
    ``deltas`` holds ``value`` and ``mfu`` against the EWMA (and the peak
    memory's, informational); ``regression`` flags a value drop past
    ``threshold_pct`` %, None when nothing is comparable.  ``trend`` is
    the trajectory's stamp (its degraded streak).  Best-effort: a failure
    here never sinks the measurement."""
    try:
        from ..obs import trend as _trend  # noqa: PLC0415

        d = record_dir or supervisor.bench_record_dir()
        records = _trend.load_bench_records(d) if d else []
        stamp = _trend.trend_stamp(d) if d else None
        if stamp is not None:
            out["trend"] = stamp
        key = (out.get("metric"), out.get("device"))
        newest = None  # the newest real matching record: (fname, parsed)
        skipped = 0
        degraded_skipped = 0
        for _, fname, doc in reversed(records):
            parsed = _trend.parsed_payload(doc)
            # a failed round must not reset the bar a real measurement is
            # judged against
            if _trend.classify(doc) == "degraded":
                degraded_skipped += 1
                continue
            if (isinstance(parsed, dict)
                    and _trend.scenario_key(parsed) == key):
                newest = (fname, parsed)
                break
            skipped += 1
        ewma = _trend.ewma_baseline(records, *key)
        if newest is None or ewma is None:
            out["baseline_record"] = {
                "file": None,
                "stale_records_skipped": skipped,
                "degraded_records_skipped": degraded_skipped,
            }
            out["regression"] = None  # nothing comparable to regress from
            return out
        fname, parsed = newest
        deltas = {}
        for key_name in ("value", "mfu"):
            old, new = ewma.get(key_name), out.get(key_name)
            if (isinstance(old, (int, float))
                    and isinstance(new, (int, float)) and old):
                deltas[key_name] = {
                    "baseline": old,
                    "pct": round((new - old) / old * 100.0, 2),
                }

        # the peak memory's delta is informational: more bytes is not a
        # worse measurement
        def _peak(doc):
            census = (doc.get("memory") or {}).get("census") or {}
            return (census.get("device") or {}).get("peak_bytes") or \
                census.get("total_bytes")

        old_peak, new_peak = _peak(parsed), _peak(out)
        if (isinstance(old_peak, (int, float)) and old_peak
                and isinstance(new_peak, (int, float))):
            deltas["peak_bytes"] = {
                "baseline": old_peak,
                "pct": round((new_peak - old_peak) / old_peak * 100.0, 2),
                "informational": True,
            }
        out["baseline_record"] = {
            "file": fname,
            "baseline_records": ewma["records"],
            "ewma": {"k": ewma["k"], "alpha": ewma["alpha"],
                     "count": ewma["count"]},
            "stale_records_skipped": skipped,
            "degraded_records_skipped": degraded_skipped,
            "stale": skipped > 0,
        }
        out["deltas"] = deltas
        out["regression"] = bool(
            deltas.get("value", {}).get("pct", 0.0) < -threshold_pct)
    except Exception:
        out.setdefault("regression", None)
    return out


def _fail_record(exc: BaseException, phase: str) -> None:
    supervisor._auto_record(f"{type(exc).__name__}: {exc}"[:2000], rc=1,
                            phase=phase)


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.campaign:
        # this process becomes the sweep's driver: each point runs as a
        # bench process of its own, so no supervisor runs here
        from .campaign import main as campaign_main

        return campaign_main(["--spec", args.campaign])
    if not args.deadline_epoch:
        args.deadline_epoch = time.time() + args.total_budget_secs
    if args.num_slices > 0:
        # before the world starts: the slice partition is resolved there
        os.environ[envmod.NUM_SLICES] = str(args.num_slices)
    if args.overlap is None:
        args.overlap = os.environ.get(envmod.OVERLAP, "off")
        if args.overlap not in MODES:
            raise SystemExit(f"{envmod.OVERLAP}={args.overlap!r}: choices "
                             f"are {', '.join(MODES)}")
    if args.batch_size is None:
        args.batch_size = 8 if args.model.startswith("gpt-") else 128
    _check_args(args)
    if args.serve:
        if not args.model.startswith("gpt-"):
            raise SystemExit("--serve serves a GPT model (--model gpt-*)")
        supervisor._arm_watchdog(args)
        supervisor._touch_progress(max(args.watchdog_secs, 300),
                                   phase="serve")
        try:
            if not args.cpu and not torch.cuda.is_available():
                raise RuntimeError("--serve: no CUDA device is visible; "
                                   "pass --cpu to serve on the CPU")
            out = serve_main(args)
        except Exception as exc:
            # the round still lands a record
            _fail_record(exc, "serve")
            raise
        attach_regression(out)
        supervisor._watchdog_disarm.set()
        print(json.dumps(out), flush=True)
        return 0
    from .. import basics

    supervisor._arm_watchdog(args)
    try:
        record = run(args)
        root = basics.rank() == 0
    except Exception as exc:
        if (not args.cpu and supervisor._is_unavailable(exc)
                and args.retry_attempt < args.attempts):
            supervisor._retry_exec(args, exc)  # never returns
        # out of retries, or not transient: the round still lands a record
        _fail_record(exc, supervisor._phase_name)
        raise
    finally:
        basics.shutdown()
    if root:  # one record for the job, whatever its world
        # the sentinel before the print: the record carries its verdict
        attach_regression(record)
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
