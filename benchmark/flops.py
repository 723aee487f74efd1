"""The yardstick's arithmetic: the card's peak, and the operations a
step must do, counted from the cell's shapes.  Copied from the program
(``horovod_tpu_torch/bench/__init__.py::conv_flops_per_image``,
``obs/profile.py::PEAK_FLOPS``) so that a change to the program cannot
move the yardstick.  A count is of the work the model needs, whatever
implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate
PEAK_BF16_FLOPS = 989e12


def conv_flops_per_image(cfg: dict) -> float:
    """Training FLOPs of one image (the program's
    ``conv_flops_per_image``): 3 (forward, and the backward's two
    products) x 2 x the multiply-adds of every convolution and of the
    head, counted from the reference model's shapes.  BatchNorm, pools,
    activations, the loss and the optimizer are left out.  24.535e9 for
    ResNet-50 at 224."""
    from .reference.resnet import conv_macs  # noqa: PLC0415

    return 6.0 * conv_macs(cfg)
