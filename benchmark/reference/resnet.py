"""Plain ResNet v1.5 (float32): the reference of the ``resnet`` family.

Bottleneck blocks (1x1, 3x3 carrying the stride, 1x1 at 4x width) with a
projection shortcut where the shape changes; a 7x7 stride-2 stem and a
3x3 stride-2 max pool; global average pool and a Dense head.  Padding is
XLA's ``"SAME"`` (a stride-2 3x3 convolution on an even input pads
(0, 1), where torchvision pads (1, 1): the configuration lists it),
but the stem's, which pads 3 on every side.
BatchNorm in training mode normalises by the batch's biased variance and
updates its running statistics as ``r = m * r + (1 - m) * batch`` with
the biased variance, ``m`` the configuration's ``bn_momentum``.
Parameter and statistic names are the program's, so one seeded weight
dict serves both.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import fp32_highest, sgd_momentum_

STATS = ("running_mean", "running_var")


def same_pads(size: int, kernel: int, stride: int) -> tuple:
    """XLA's SAME pads (lo, hi) of one spatial dimension."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def blocks(cfg: dict):
    """``(name, in_ch, width, stride, project)`` of every block."""
    ch = cfg["width"]
    for i, count in enumerate(cfg["stage_sizes"]):
        width = cfg["width"] * 2 ** i
        for j in range(count):
            stride = 2 if i > 0 and j == 0 else 1
            out = width * cfg["expansion"]
            yield (f"stage{i + 1}_block{j + 1}", ch, width, stride,
                   ch != out or stride != 1)
            ch = out


def _bn_specs(name: str, ch: int, scale: float = 1.0) -> list:
    return [(f"{name}.weight", (ch,), ("fill", scale)),
            (f"{name}.bias", (ch,), ("fill", 0.0)),
            (f"{name}.running_mean", (ch,), ("fill", 0.0)),
            (f"{name}.running_var", (ch,), ("fill", 1.0))]


def param_specs(cfg: dict) -> list:
    """``[(name, shape, init)]`` of every parameter and running
    statistic: convolution and head weights N(0, 1/fan_in), BatchNorm
    scales 1 but the last of each block's, ``residual_bn_scale``, biases
    and means 0, variances 1."""
    def conv(name, cin, cout, k):
        return [(f"{name}.weight", (cout, cin, k, k),
                 ("normal", (cin * k * k) ** -0.5))]

    w = cfg["width"]
    out = conv("conv_init", 3, w, 7) + _bn_specs("bn_init", w)
    for name, cin, width, _, project in blocks(cfg):
        cout = width * cfg["expansion"]
        out += (conv(f"{name}.conv1", cin, width, 1)
                + _bn_specs(f"{name}.bn1", width)
                + conv(f"{name}.conv2", width, width, 3)
                + _bn_specs(f"{name}.bn2", width)
                + conv(f"{name}.conv3", width, cout, 1)
                + _bn_specs(f"{name}.bn3", cout, cfg["residual_bn_scale"]))
        if project:
            out += (conv(f"{name}.proj_conv", cin, cout, 1)
                    + _bn_specs(f"{name}.proj_bn", cout))
    feats = w * 2 ** (len(cfg["stage_sizes"]) - 1) * cfg["expansion"]
    out += [("head.weight", (cfg["num_classes"], feats),
             ("normal", feats ** -0.5)),
            ("head.bias", (cfg["num_classes"],), ("fill", 0.0))]
    return out


def comparison_leaves(name: str, t: torch.Tensor) -> list:
    return [(name, t)]


def conv_macs(cfg: dict) -> int:
    """Multiply-adds of every convolution and of the head for one image,
    from the shapes alone."""
    size = cfg["image_size"]
    h = -(-size // 2)  # the stem's stride 2
    macs = h * h * cfg["width"] * 3 * 7 * 7
    h = -(-h // 2)  # the max pool
    for _, cin, width, stride, project in blocks(cfg):
        cout = width * cfg["expansion"]
        ho = -(-h // stride)
        macs += h * h * width * cin + ho * ho * width * width * 9 \
            + ho * ho * cout * width
        if project:
            macs += ho * ho * cout * cin
        h = ho
    feats = cfg["width"] * 2 ** (len(cfg["stage_sizes"]) - 1) \
        * cfg["expansion"]
    return macs + feats * cfg["num_classes"]


def _conv(x, w, stride, pads=None):
    k = w.shape[-1]
    if pads is not None:
        return F.conv2d(x, w, stride=stride, padding=pads)
    (lh, hh), (lw, hw) = (same_pads(x.shape[-2], k, stride),
                          same_pads(x.shape[-1], k, stride))
    if lh != hh or lw != hw:
        x = F.pad(x, (lw, hw, lh, hh))
        return F.conv2d(x, w, stride=stride)
    return F.conv2d(x, w, stride=stride, padding=(lh, lw))


def _bn(x, w: dict, name: str, cfg: dict, stats: dict):
    """Training-mode BatchNorm; the batch's mean and biased variance go
    to ``stats[name]``."""
    y = F.batch_norm(x, None, None, w[f"{name}.weight"], w[f"{name}.bias"],
                     True, 0.0, cfg["bn_eps"])
    with torch.no_grad():
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
    stats[name] = (mean, var)
    return y


def logits(w: dict, x: torch.Tensor, cfg: dict, stats: dict):
    """Logits of images ``x`` ``[n, 3, h, w]`` in training mode."""
    # the stem pads 3 on every side (not SAME)
    y = F.relu(_bn(_conv(x, w["conv_init.weight"], 2, (3, 3)), w, "bn_init",
                   cfg, stats))
    y = F.max_pool2d(F.pad(y, (1, 1, 1, 1), value=float("-inf")), 3, 2)
    for name, _, _, stride, project in blocks(cfg):
        r = F.relu(_bn(_conv(y, w[f"{name}.conv1.weight"], 1), w,
                       f"{name}.bn1", cfg, stats))
        r = F.relu(_bn(_conv(r, w[f"{name}.conv2.weight"], stride), w,
                       f"{name}.bn2", cfg, stats))
        r = _bn(_conv(r, w[f"{name}.conv3.weight"], 1), w, f"{name}.bn3",
                cfg, stats)
        if project:
            y = _bn(_conv(y, w[f"{name}.proj_conv.weight"], stride), w,
                    f"{name}.proj_bn", cfg, stats)
        y = F.relu(y + r)
    feats = y.mean(dim=(2, 3))
    return feats @ w["head.weight"].T + w["head.bias"]


def train(weights: dict, batches: list, cfg: dict, on_step=None) -> list:
    """Float32 SGD-with-momentum steps from ``weights`` (parameters and
    running statistics) over ``batches`` of ``(images, labels)``, each the
    whole global batch at once (BatchNorm's statistics are the batch's).
    ``on_step(t, leaves, grads)`` is called after each step's backward and
    before its update, and once more at the end with ``grads`` None;
    returns the losses."""
    fp32_highest()
    params = {k: v.detach().float().clone().requires_grad_(True)
              for k, v in weights.items()
              if not k.endswith(STATS)}
    running = {k: v.detach().float().clone() for k, v in weights.items()
               if k.endswith(STATS)}
    m = cfg["bn_momentum"]
    state: dict = {}
    losses = []
    for t, (images, labels) in enumerate(batches, 1):
        stats: dict = {}
        out = logits(params, images.float().contiguous(), cfg, stats)
        step_loss = F.cross_entropy(out, labels)
        step_loss.backward()
        losses.append(step_loss.item())
        with torch.no_grad():
            for name, (mean, var) in stats.items():
                running[f"{name}.running_mean"].mul_(m).add_(
                    mean, alpha=1 - m)
                running[f"{name}.running_var"].mul_(m).add_(var, alpha=1 - m)
        grads = {k: p.grad for k, p in params.items()}
        if on_step is not None:
            on_step(t, {**params, **running}, grads)
        sgd_momentum_(params, grads, state, cfg["optimizer"])
        for p in params.values():
            p.grad = None
        del out, step_loss, stats
    if on_step is not None:
        on_step(len(batches) + 1, {**params, **running}, None)
    return losses
