"""MNIST through the port's ``horovod.torch``-compatible frontend
(``interop.torch``), the reference's examples/torch_mnist.py (its
pytorch_mnist.py): the same init / DistributedOptimizer /
broadcast_parameters recipe, the gradients through the eager engine.

    python -m horovod_tpu_torch.examples.torch_mnist
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.torch_mnist
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from . import _common


class Net(nn.Module):
    """The reference example's two-conv MNIST net (pytorch_mnist.py)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 10, kernel_size=5)
        self.conv2 = nn.Conv2d(10, 20, kernel_size=5)
        self.fc1 = nn.Linear(320, 50)
        self.fc2 = nn.Linear(50, 10)

    def forward(self, x):
        x = F.relu(F.max_pool2d(self.conv1(x), 2))
        x = F.relu(F.max_pool2d(self.conv2(x), 2))
        x = x.view(-1, 320)
        x = F.relu(self.fc1(x))
        return F.log_softmax(self.fc2(x), dim=1)


def synthetic_mnist(n=2048, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 1, 28, 28).astype(np.float32)
    w = np.random.RandomState(42).randn(28 * 28, 10).astype(np.float32)
    y = (x.reshape(n, -1) @ w).argmax(axis=1)
    return torch.from_numpy(x), torch.from_numpy(y)


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--epochs", type=int, default=2)
    p.add_argument("--samples", type=int, default=2048)
    args = p.parse_args(argv)

    import horovod_tpu_torch.interop.torch as hvd

    # 1. initialize
    dev = hvd.init(device=_common.device_arg(args)).device
    torch.manual_seed(args.seed)

    x, y = synthetic_mnist(args.samples, args.seed)
    # 2. shard the data by rank (the reference's DistributedSampler role)
    x = x[hvd.rank()::hvd.size()].to(dev)
    y = y[hvd.rank()::hvd.size()].to(dev)

    model = Net().to(dev)
    # 3. broadcast the initial state from rank 0
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # 4. wrap the optimizer
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.01, momentum=0.5),
        named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)

    bs = 64
    epoch_losses = []
    for epoch in range(args.epochs):
        perm = torch.randperm(len(x), device=dev)
        losses = []
        for s in range(len(x) // bs):
            idx = perm[s * bs:(s + 1) * bs]
            opt.zero_grad()
            loss = F.nll_loss(model(x[idx]), y[idx])
            loss.backward()
            opt.step()
            losses.append(float(loss))
        # the metric averaged across ranks, on the eager path
        avg = float(hvd.allreduce(torch.tensor(np.mean(losses))))
        epoch_losses.append(avg)
        if hvd.rank() == 0:
            print(f"epoch {epoch}: loss {avg:.4f}", flush=True)
    _common.report("torch_mnist", hvd.rank(), world=hvd.size(),
                   losses=epoch_losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
