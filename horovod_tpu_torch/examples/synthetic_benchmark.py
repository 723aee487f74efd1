"""Synthetic ResNet benchmark, the reference's examples/
synthetic_benchmark.py (its pytorch_synthetic_benchmark.py CLI: model,
batch size, iteration counts, the compressed-allreduce flag) on the port:
the data-parallel SGD step of the conv zoo through ``hvd.distribute``.

    python -m horovod_tpu_torch.examples.synthetic_benchmark --model resnet50 --batch-size 64
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.synthetic_benchmark

(``python -m horovod_tpu_torch.bench`` is the one-line record version.)
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from . import _common


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--model", default="resnet50")
    p.add_argument("--batch-size", type=int, default=32,
                   help="per-GPU batch size (reference default 32)")
    p.add_argument("--num-batches-per-iter", type=int, default=10)
    p.add_argument("--num-iters", type=int, default=10)
    p.add_argument("--num-warmup-batches", type=int, default=10)
    p.add_argument("--bf16-allreduce", action="store_true",
                   help="the reference's --fp16-allreduce: bf16 gradients "
                        "on the wire")
    args = p.parse_args(argv)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.optim import P
    from horovod_tpu_torch.models.layers import from_nhwc
    from horovod_tpu_torch.train import conv_model, make_sgd

    dev = _common.init(args)
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
    model = conv_model(args.model, "bf16").to(dev).train()
    n = hvd.num_devices()
    global_batch = args.batch_size * n
    rng = np.random.RandomState(args.seed)
    images = from_nhwc(rng.randn(global_batch, 224, 224, 3).astype(
        np.float32)).to(dev, torch.bfloat16)
    labels = torch.from_numpy(np.random.RandomState(args.seed + 1).randint(
        0, 1000, (global_batch,))).to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    compression = (hvd.Compression.bf16 if args.bf16_allreduce
                   else hvd.Compression.none)
    opt = hvd.DistributedOptimizer(make_sgd(model.parameters()),
                                   compression=compression)

    def local_step(model, opt, images, labels):
        opt.zero_grad()
        loss = F.cross_entropy(model(images).float(), labels)
        loss.backward()
        opt.step()
        return model, opt, loss.detach()

    hvd.mesh("flat")
    step = hvd.distribute(
        local_step, in_specs=(P(), P(), P(hvd.DP_AXIS), P(hvd.DP_AXIS)),
        out_specs=(P(), P(), P()))
    losses = []

    def run_batches(k):
        nonlocal model, opt
        loss = None
        for _ in range(k):
            model, opt, loss = step(model, opt, images, labels)
        if loss is not None:
            losses.append(float(loss))  # waits for the device

    if hvd.rank() == 0:
        print(f"Model: {args.model}, batch size/GPU: {args.batch_size}, "
              f"GPUs: {n}", flush=True)
    run_batches(args.num_warmup_batches)

    img_secs = []
    for i in range(args.num_iters):
        t0 = time.perf_counter()
        run_batches(args.num_batches_per_iter)
        rate = global_batch * args.num_batches_per_iter / (
            time.perf_counter() - t0)
        img_secs.append(rate)
        if hvd.rank() == 0:
            print(f"Iter #{i}: {rate:.1f} img/sec total", flush=True)

    mean, conf = float(np.mean(img_secs)), float(1.96 * np.std(img_secs))
    if hvd.rank() == 0:
        print(f"Img/sec per GPU: {mean / n:.1f} +- {conf / n:.1f}")
        print(f"Total img/sec on {n} GPU(s): {mean:.1f} +- {conf:.1f}",
              flush=True)
    _common.report("synthetic_benchmark", hvd.rank(), model=args.model,
                   batch_per_gpu=args.batch_size, world=n,
                   images_per_sec_per_gpu=mean / n, images_per_sec=mean,
                   conf=conf, losses=losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
