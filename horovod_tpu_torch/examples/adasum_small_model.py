"""Adasum on a tiny curve-fitting model, the reference's examples/
adasum_small_model.py on the port's ``horovod.torch``-compatible surface
(``interop.torch``): each rank fits a quadratic on its own slice of the
curve, and the delta-reducing Adasum optimizer (``op=hvd.Adasum``) blends
the ranks' update directions by the VHDD projection instead of averaging
raw gradients.

    python -m horovod_tpu_torch.examples.adasum_small_model
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.adasum_small_model
"""

from __future__ import annotations

import torch

from . import _common


def curve(x: torch.Tensor) -> torch.Tensor:
    return 2.0 * x * x - 20.0 * x + 50.0


class Quadratic(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.coef = torch.nn.Parameter(torch.tensor([1.0, -1.0, 1.0]))

    def forward(self, x):
        return self.coef[0] * x * x + self.coef[1] * x + self.coef[2]


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--steps", type=int, default=200)
    args = p.parse_args(argv)

    import horovod_tpu_torch.interop.torch as hvd

    dev = hvd.init(device=_common.device_arg(args)).device
    torch.manual_seed(1234 + args.seed)

    model = Quadratic().to(dev)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    # op=Adasum selects the delta-based optimizer: the SGD step runs
    # locally and the parameter delta rides the VHDD reduction
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=1e-3),
        named_parameters=model.named_parameters(), op=hvd.Adasum)

    # disjoint slices of the curve: genuinely disagreeing gradients
    lo = -5.0 + 10.0 * hvd.rank() / hvd.size()
    xs = torch.linspace(lo, lo + 10.0 / hvd.size(), 64, device=dev)
    ys = curve(xs)

    losses = []
    for step in range(args.steps):
        opt.zero_grad()
        loss = ((model(xs) - ys) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(float(loss))
        if step % 50 == 0 and hvd.rank() == 0:
            print(f"step {step:3d} loss {float(loss):10.3f} coef "
                  f"{model.coef.detach().cpu().numpy().round(3)}", flush=True)

    final = hvd.allreduce(((model(xs) - ys) ** 2).mean().detach(),
                          name="final_loss")
    if hvd.rank() == 0:
        print(f"final mean loss across ranks: {float(final):.3f}", flush=True)
    _common.report("adasum_small_model", hvd.rank(), world=hvd.size(),
                   final_loss=float(final), losses=losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
