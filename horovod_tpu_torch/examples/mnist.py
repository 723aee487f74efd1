"""Distributed MNIST training, the reference's examples/mnist.py (its
tensorflow2_mnist.py / pytorch_mnist.py four-line recipe) on the port:

    1. hvd.init()
    2. shard the data by rank: ``hvd.distribute`` hands each rank its
       block of every global batch
    3. wrap the optimizer in DistributedOptimizer
    4. broadcast the initial state from rank 0

    python -m horovod_tpu_torch.examples.mnist --smoke
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.mnist --smoke

Synthetic MNIST-shaped data from ``--seed`` (nothing is downloaded).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from . import _common


def synthetic_mnist(n: int = 4096, seed: int = 0):
    """Images ``[n, 28, 28]`` in [0, 1); label = the argmax of 10 fixed
    random projections (learnable structure)."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28).astype(np.float32)
    w = np.random.RandomState(42).randn(28 * 28, 10).astype(np.float32)
    y = (x.reshape(n, -1) @ w).argmax(axis=1)
    return torch.from_numpy(x), torch.from_numpy(y)


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--smoke", action="store_true",
                   help="tiny run for the CI matrix")
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs = 1

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import ConvNet
    from horovod_tpu_torch.optim import P

    dev = _common.init(args)
    x, y = synthetic_mnist(n=512 if args.smoke else 4096, seed=args.seed)
    model = ConvNet().to(dev)
    # Step 4: every rank starts from rank 0's weights
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)

    # Step 3: wrap the optimizer; the learning rate warms up to its
    # world-size multiple (the reference's LearningRateWarmupCallback)
    n = hvd.num_devices()
    batch = 32 * n
    steps_per_epoch = max(len(x) // batch, 1)
    base = torch.optim.Adam(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.LambdaLR(base, hvd.callbacks.warmup_schedule(
        0.001, warmup_epochs=2, steps_per_epoch=steps_per_epoch, scale=n))
    opt = hvd.DistributedOptimizer(base)

    def local_step(model, opt, xb, yb):
        opt.zero_grad()
        loss = F.cross_entropy(model(xb), yb)
        loss.backward()
        opt.step()
        sched.step()
        return model, opt, hvd.allreduce(loss.detach())

    hvd.mesh("flat")
    # Step 2: the global batch in, each rank's block of it through the step
    step = hvd.distribute(
        local_step, in_specs=(P(), P(), P(hvd.DP_AXIS), P(hvd.DP_AXIS)),
        out_specs=(P(), P(), P()))

    losses = []
    for epoch in range(args.epochs):
        t0 = time.time()
        epoch_losses = []
        for i in range(0, len(x) - batch + 1, batch):
            model, opt, loss = step(model, opt, x[i:i + batch].to(dev),
                                    y[i:i + batch].to(dev))
            epoch_losses.append(float(loss))
        losses += epoch_losses
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss={np.mean(epoch_losses):.4f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    _common.report("mnist", hvd.rank(), world=n, losses=losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
