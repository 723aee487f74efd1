"""The ``resnet`` family: ``horovod_tpu_torch.train.build_step``'s step
``step(model, batch_stats, opt, images, labels)``, driven on the
benchmark's seeded images."""

from __future__ import annotations

from .. import flops
from ..common import generator
from ..reference import resnet as reference
from . import ProgramBase, leaf_norms, seeded_weights

RATE_METRIC = "images_per_s_per_gpu"

_DTYPES = {"bf16": "bfloat16", "fp32": "float32", "fp8": "bfloat16"}


def units(traffic: dict) -> int:
    """Images one GPU completes in a step."""
    return traffic["batch_per_gpu"]


def step_flops(cfg: dict, traffic: dict) -> float:
    return flops.conv_flops_per_image(cfg) * traffic["batch_per_gpu"]


def batches(cfg: dict, traffic: dict, seed: int, device, dtype: str = "bf16"):
    """The pool of batches: ``pool_batches`` entries of ``(images,
    labels)``, images N(0, 1) ``[batch_per_gpu, 3, size, size]``
    rounded to the compute dtype, in channels_last memory, and labels
    uniform over the classes, drawn on ``device``."""
    import torch  # noqa: PLC0415

    rows, size = traffic["batch_per_gpu"], cfg["image_size"]
    g = generator(seed, "images", device)
    dt = getattr(torch, _DTYPES[dtype])
    out = []
    for _ in range(traffic["pool_batches"]):
        x = torch.randn(rows, size, size, 3, generator=g, device=device)
        out.append(x.to(dt).permute(0, 3, 1, 2))
        del x
    labels = torch.randint(0, cfg["num_classes"],
                           (traffic["pool_batches"], rows),
                           generator=generator(seed, "labels", device),
                           device=device)
    return [(x, y) for x, y in zip(out, labels)]


def weights(cfg: dict, seed: int, device) -> dict:
    return seeded_weights(reference.param_specs(cfg), seed, device)


class Program(ProgramBase):
    split = staticmethod(reference.comparison_leaves)

    def __init__(self, cfg: dict, traffic: dict, seed: int, device=None,
                 dtype=None, fault=None):
        from horovod_tpu_torch.train import build_step  # noqa: PLC0415

        self.fault = fault
        dtype = dtype or cfg["dtype"]
        step, state, _ = build_step(
            cfg["program"]["model"], dtype, traffic["batch_per_gpu"],
            cfg["image_size"], overlap_mode=traffic["overlap_mode"],
            grad_bucket_mb=traffic["grad_bucket_mb"], device=device)
        self.model, self.batch_stats, self.opt = state[:3]
        dev = next(self.model.parameters()).device
        self.load(weights(cfg, seed, dev))
        self.pool = batches(cfg, traffic, seed, dev, dtype)
        self._apply_fault()

        def call(batch):
            return step(self.model, self.batch_stats, self.opt, *batch)[-1]

        self._call = call

    def leaves(self) -> dict:
        return {**dict(self.model.named_parameters()), **self.batch_stats}

    def close(self) -> None:
        self.batch_stats = None
        super().close()


def reference_readings(cfg: dict, traffic: dict, seed: int, device,
                       steps: int) -> dict:
    """The float32 reference over the first ``steps`` batches of the pool
    (the images the program saw, in float32): its losses, each
    parameter's gradient norm at the first step and each leaf's change,
    running statistics included, after the last."""
    import torch  # noqa: PLC0415

    w0 = weights(cfg, seed, device)
    pool = batches(cfg, traffic, seed, device, cfg["dtype"])[:steps]
    out: dict = {}

    def on_step(t, leaves, grads):
        if t == 1:
            out["grad_norms"] = leaf_norms(grads, reference.comparison_leaves)
        if grads is None:
            with torch.no_grad():
                out["change_norms"] = leaf_norms(
                    {k: leaves[k] - w0[k] for k in leaves},
                    reference.comparison_leaves)

    out["losses"] = reference.train(w0, pool, cfg, on_step)
    return out
