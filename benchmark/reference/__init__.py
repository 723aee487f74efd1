"""Plain PyTorch references of the benchmark's models, in float32 with
TF32 off.  They import nothing of the program and take nothing it made:
the benchmark hands them the same seeded weights and inputs it handed
the program, and they work the training steps out again."""

from __future__ import annotations


def fp32_highest() -> None:
    """Every float32 product in full float32: no TF32 in matmuls or in
    cuDNN's convolutions.  cuDNN picks its algorithms by its heuristics:
    the program's ``cudnn.benchmark`` would time every candidate of every
    new shape, which costs the reference tens of seconds."""
    import torch  # noqa: PLC0415

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.set_float32_matmul_precision("highest")


def sgd_momentum_(params: dict, grads: dict, state: dict, opt: dict) -> None:
    """One heavy-ball SGD step in place: ``buf = momentum * buf + g`` (the
    first step's ``buf`` is ``g``), ``p -= lr * buf``."""
    import torch  # noqa: PLC0415

    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            if k in state:
                buf = state[k].mul_(opt["momentum"]).add_(g)
            else:
                buf = state[k] = g.clone()
            p.sub_(opt["lr"] * buf)
