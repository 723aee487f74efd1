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
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from .optim.overlap import MODES
from .utils import env as envmod

__all__ = ["PEAK_FLOPS", "BASELINE_IMAGES_PER_SEC", "conv_flops_per_image",
           "model_flops_per_step", "peak_flops", "main"]

# Dense peak FLOP/s by device-name substring and compute dtype: NVIDIA's
# H100 SXM data sheet (bf16 tensor cores; fp32 outside them).  fp32 runs
# there only with TF32 off: PyTorch's default is off for matmuls but ON
# for cuDNN convolutions, so ``train.build_step`` turns it off for fp32.
# fp8 computes in bf16 (e4m3 is only the activations' storage).
PEAK_FLOPS = {"H100": {"bf16": 989e12, "fp32": 67e12, "fp8": 989e12}}

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
    recompute of the scores nor a remat recompute is counted."""
    e, L, v = cfg.emb_dim, cfg.num_layers, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    n_mm = L * (e * (e + 2 * kv) + e * e + 2 * cfg.mlp_ratio * e * e) + e * v
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
    from .models.layers import Conv2d, Dense
    from .train import conv_model

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


def peak_flops(device_name: str, dtype: str):
    """The dense peak for ``dtype`` on the named device, or None."""
    for key, peaks in PEAK_FLOPS.items():
        if key in device_name:
            return peaks.get(dtype)
    return None


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
    p.add_argument("--serve", action="store_true")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (a check of the path; its numbers "
                   "are no device's)")
    return p


def _check_ported(args) -> None:
    if args.serve:
        raise NotImplementedError(
            "--serve is not ported yet (ROADMAP A12b: the serving plane)")
    if args.moe_experts:
        raise NotImplementedError(
            "--moe-experts is not ported yet (ROADMAP A11)")


def run(args) -> dict:
    """Build, warm up and time the step; the record."""
    from . import basics
    from .ops import flash_attention as fa
    from .train import build_gpt_step, build_step

    gpt = args.model.startswith("gpt-")
    device = "cpu" if args.cpu else None
    if gpt:
        step, state, static = build_gpt_step(
            args.model[len("gpt-"):], args.dtype, args.batch_size,
            args.seq_len, attention=args.attention, remat=args.remat,
            kv_heads=args.kv_heads, pos_embedding=args.pos_embedding,
            attention_window=args.attention_window,
            overlap_mode=args.overlap, grad_bucket_mb=args.grad_bucket_mb,
            device=device)
    else:
        step, state, static = build_step(
            args.model, args.dtype, args.batch_size, args.image_size,
            args.s2d_stem, args.overlap, args.grad_bucket_mb, device=device)
    dev = basics.device()
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    carry = static["carry_len"]

    def steps(n, state):
        loss = None
        for _ in range(n):
            *out, loss = step(*state)
            state = tuple(out) + state[carry:]
        return state, loss

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    state, _ = steps(args.warmup, state)
    sync()
    t0 = time.perf_counter()
    state, loss = steps(args.iters, state)
    final_loss = float(loss)  # waits for the device
    sync()
    step_s = (time.perf_counter() - t0) / args.iters
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
    }
    layout = getattr(state[carry - 1], "layout", None)
    if layout is not None:
        record["buckets"] = len(layout.buckets)
        record["bucket_bytes"] = [b.nbytes for b in layout.buckets]
    return record


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.overlap is None:
        args.overlap = os.environ.get(envmod.OVERLAP, "off")
        if args.overlap not in MODES:
            raise SystemExit(f"{envmod.OVERLAP}={args.overlap!r}: choices "
                             f"are {', '.join(MODES)}")
    if args.batch_size is None:
        args.batch_size = 8 if args.model.startswith("gpt-") else 128
    _check_ported(args)
    from . import basics

    try:
        record = run(args)
        root = basics.rank() == 0
    finally:
        basics.shutdown()
    if root:  # one record for the job, whatever its world
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
