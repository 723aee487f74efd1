"""The data-parallel training steps (counterparts of the root
``bench.py::build_gpt_step`` and ``build_step``).

One process per GPU: each rank holds a replica of the model, takes its
slice of the global batch, and the gradients are averaged before the
update (AdamW for GPT, SGD with momentum for the conv zoo), so the
replicas stay identical.  ``overlap_mode`` picks how: ``"off"`` is
:class:`DistributedOptimizer` (one fused reduce in ``step()``),
``"bucket"`` and ``"bucket+zero1"`` the backward-overlap plane of
``optim/overlap.py`` (per-bucket collectives issued during the backward;
ZeRO-1 also shards the optimizer state).

``dtype`` is ``"bf16"``, ``"fp32"`` or ``"fp8"``: bf16 compute with the
activations stored through e4m3 (the GPT, and ResNet of the conv zoo).

A step is ``step(*state) -> carry + (loss,)``: the first
``static["carry_len"]`` entries of ``state`` come back updated, the rest
(the batch) stay.

Its phases are spans (``obs/trace.py``'s :class:`~.obs.trace.phase`,
under ``torch.profiler`` or ``HVDTPU_TRACE``): ``step`` holds
``forward`` (``zero_grad``, the model and the loss), ``backward``, the
optimizer's ``grad_reduce`` and ``optimizer``, and ``loss_reduce`` (the
loss's mean over the world).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import basics
from .obs.trace import phase
from .models import (VGG16, VGG19, InceptionV3, ResNet18, ResNet50,
                     ResNet101, gpt)
from .models.layers import from_nhwc
from .optim import DistributedOptimizer, broadcast_parameters
from .optim.overlap import MODES, OverlapPlan
from .ops.collectives import allreduce

__all__ = ["build_gpt_step", "build_step", "conv_model", "lm_loss", "lm_loss_fn",
           "make_adamw", "make_sgd", "CONV_MODELS"]

# the compute dtype of each --dtype, and the activation storage dtype of
# those that store through another
_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
           "fp8": torch.bfloat16}
_ACT_STORE = {"fp8": torch.float8_e4m3fn}


def _check_dtype(dtype: str) -> None:
    if dtype not in _DTYPES:
        raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got "
                         f"{dtype!r}")


# the weight of the MoE blocks' aux losses in the training loss (the
# reference bench's 0.01 x their sum)
MOE_AUX_WEIGHT = 0.01


def lm_loss(model, toks: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy on fp32 logits (the reference's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``), plus
    ``MOE_AUX_WEIGHT`` times the sum of the MoE blocks' aux losses when
    the model has experts."""
    losses: list = []
    logits = model(toks[:, :-1], losses=losses)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           toks[:, 1:].reshape(-1))
    if losses:
        loss = loss + MOE_AUX_WEIGHT * torch.stack(losses).sum()
    return loss


def lm_loss_fn(model):
    """:func:`lm_loss` as a function of the parameters: ``loss_fn(params,
    toks)``, ``params`` a dict of ``model``'s named parameters that the
    forward runs on (``torch.func.functional_call``) — the form
    ``sync_gradients`` differentiates."""
    from torch.func import functional_call  # noqa: PLC0415

    def loss_fn(params, toks):
        return lm_loss(
            lambda x, **kw: functional_call(model, params, (x,), kw), toks)

    return loss_fn


def make_adamw(params) -> torch.optim.AdamW:
    """``optax.adamw(1e-4)``'s equivalent: lr 1e-4, betas (0.9, 0.999),
    eps 1e-8 and weight decay 1e-4 on every parameter."""
    return torch.optim.AdamW(params, lr=1e-4, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def build_gpt_step(size: str, dtype: str, batch_size: int, seq_len: int,
                   attention: str = "flash", remat: bool = False,
                   flash_block_q: int = 512, flash_block_k: int = 256,
                   kv_heads: int = 0, pos_embedding: str = "learned",
                   moe_experts: int = 0, attention_window: int = 0,
                   overlap_mode: str = "off", grad_bucket_mb=None, *,
                   device=None, health: bool = False):
    """GPT causal-LM training step, with the reference's keywords and
    defaults.  Returns ``(step, state, static)`` like the reference:
    ``step(*state) -> (model, optimizer, loss)`` with ``state = (model,
    optimizer, tokens)``, where ``tokens`` is this rank's slice of the
    global batch and ``loss`` is the mean over the world.  ``batch_size``
    is per GPU; ``device=None`` is this process's GPU.

    ``optimizer`` is a :class:`DistributedOptimizer` around
    :func:`make_adamw` (``overlap_mode="off"``), or an
    :class:`~horovod_tpu_torch.optim.overlap.OverlapPlan` of that mode
    with buckets of ``grad_bucket_mb`` (None: ``HVDTPU_GRAD_BUCKET_MB`` or
    16).

    ``moe_experts > 0`` gives every block a mixture of experts (top 2,
    capacity factor 2, routing groups of 4096: the reference model's
    defaults), and the loss adds ``MOE_AUX_WEIGHT`` times the blocks' aux
    losses, as the reference's step does.

    ``health=True`` builds the optimizer as an ``OverlapPlan(health=True)``
    (of mode ``overlap_mode``, ``off`` included) and ``step`` returns
    ``(model, optimizer, loss, bundle)``: the step's training-health
    bundle (``obs/health.py``), a device tensor that nothing reads on the
    host.  The losses are those of ``health=False``, bit for bit.
    """
    _check_dtype(dtype)
    if overlap_mode not in MODES:
        raise ValueError(
            f"overlap_mode must be one of {MODES}, got {overlap_mode!r}")
    topo = basics.init(device=device)
    dev = topo.device
    n_gpus = topo.process_count
    model = gpt(size, device=dev, dtype=_DTYPES[dtype], max_len=seq_len,
                attention_impl=attention, remat=remat,
                flash_block_q=flash_block_q, flash_block_k=flash_block_k,
                num_kv_heads=kv_heads or None, pos_embedding=pos_embedding,
                moe_experts=moe_experts,
                act_store_dtype=_ACT_STORE.get(dtype),
                attention_window=attention_window or None)
    vocab = model.cfg.vocab_size

    global_batch = batch_size * n_gpus
    tokens = np.random.RandomState(0).randint(
        0, vocab, size=(global_batch, seq_len + 1))
    r = topo.process_rank
    local = torch.from_numpy(
        tokens[r * batch_size:(r + 1) * batch_size]).to(dev)
    broadcast_parameters(model.state_dict(), root_rank=0)

    if overlap_mode == "off" and not health:
        opt = DistributedOptimizer(make_adamw(model.parameters()))
    else:
        opt = OverlapPlan(model.parameters(), make_adamw, mode=overlap_mode,
                          bucket_mb=grad_bucket_mb, health=health)

    steps = [0]

    def step(model, opt, toks):
        steps[0] += 1
        # host clock: the phases cover the step's issue, and wait for
        # nothing on the device
        with phase("step", step=steps[0]):
            with phase("forward"):
                opt.zero_grad()
                loss = lm_loss(model, toks)
            with phase("backward"):
                loss.backward()
            if health:
                opt.step(loss=loss.detach())
            else:
                opt.step()
            with phase("loss_reduce"):
                # the mean over the world, so a non-finite loss on any
                # rank shows
                mean = allreduce(loss.detach())
        return (model, opt, mean, opt.bundle) if health else \
            (model, opt, mean)

    state = (model, opt, local)
    return step, state, {"n_chips": n_gpus, "global_batch": global_batch,
                         "carry_len": 2}


CONV_MODELS = {"resnet50": ResNet50, "resnet101": ResNet101,
               "resnet18": ResNet18, "vgg16": VGG16, "vgg19": VGG19,
               "inception3": InceptionV3}


def conv_model(name: str, dtype: str = "bf16", image_size: int = 224,
               s2d_stem: bool = False):
    """The conv-zoo model ``name`` (a key of :data:`CONV_MODELS`), 1000
    classes, in the compute dtype ``dtype``, seeded weights on the CPU.
    ``image_size`` sizes VGG's classifier; ``s2d_stem`` is ResNet's (the
    others ignore it, as the reference does).  ``"fp8"`` is ResNet's only
    (its stored ReLU outputs), as in the reference."""
    if name not in CONV_MODELS:
        raise ValueError(f"model must be one of {sorted(CONV_MODELS)}, got "
                         f"{name!r}")
    _check_dtype(dtype)
    kw = {"num_classes": 1000, "compute_dtype": _DTYPES[dtype]}
    if name.startswith("resnet"):
        kw["s2d_stem"] = s2d_stem
        kw["act_store_dtype"] = _ACT_STORE.get(dtype)
    elif dtype in _ACT_STORE:
        raise ValueError(
            f"--dtype {dtype} is resnet-only (e4m3 activation storage); "
            f"{name!r} takes bf16 or fp32")
    if name.startswith("vgg"):
        kw["image_size"] = image_size
    return CONV_MODELS[name](**kw)


def make_sgd(params) -> torch.optim.SGD:
    """``optax.sgd(0.01, momentum=0.9)``'s equivalent: no dampening, no
    Nesterov (the first step's momentum buffer is the gradient, as
    optax's trace)."""
    return torch.optim.SGD(params, lr=0.01, momentum=0.9)


def build_step(model_name: str, dtype: str, batch_size: int,
               image_size: int = 224, s2d_stem: bool = False,
               overlap_mode: str = "off", grad_bucket_mb=None, *,
               device=None):
    """Conv-zoo training step (``model_name`` in :data:`CONV_MODELS`),
    with the reference's keywords and defaults: SGD with momentum, mean
    cross entropy on fp32 logits, 1000 classes.  Returns ``(step, state,
    static)``: ``state = (model, batch_stats, optimizer, images,
    labels)``, ``step(*state) -> (model, batch_stats, optimizer, loss)``
    (``carry_len`` 3).  ``batch_stats`` names the BatchNorm running
    statistics (buffers of ``model``, updated in place by the step; empty
    for VGG); they stay per rank, as in the reference.  ``images`` are
    this rank's slice of ``RandomState(0).randn(global_batch, H, W, 3)``
    in the compute dtype, NCHW in channels_last memory; ``labels`` of
    ``RandomState(1).randint(0, 1000)``; ``loss`` is the mean over the
    world.  ``batch_size`` is per GPU; ``device=None`` is this process's
    GPU.

    On CUDA it turns on ``cudnn.benchmark`` (the counterpart of XLA's conv
    autotuning) and, for ``dtype="fp32"``, turns off cuDNN's TF32, which
    PyTorch enables by default for convolutions.
    """
    if overlap_mode not in MODES:
        raise ValueError(
            f"overlap_mode must be one of {MODES}, got {overlap_mode!r}")
    model = conv_model(model_name, dtype, image_size, s2d_stem)
    topo = basics.init(device=device)
    dev = topo.device
    if dev.type == "cuda":
        torch.backends.cudnn.benchmark = True
        if dtype == "fp32":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
    model = model.to(dev).train()

    n_gpus, r = topo.process_count, topo.process_rank
    global_batch = batch_size * n_gpus
    mine = slice(r * batch_size, (r + 1) * batch_size)
    images = np.random.RandomState(0).randn(
        global_batch, image_size, image_size, 3).astype(np.float32)
    labels = np.random.RandomState(1).randint(0, 1000, size=(global_batch,))
    images = from_nhwc(images[mine]).to(dev, _DTYPES[dtype])
    labels = torch.from_numpy(labels[mine]).to(dev)
    broadcast_parameters(model.state_dict(), root_rank=0)
    batch_stats = dict(model.named_buffers())

    if overlap_mode == "off":
        opt = DistributedOptimizer(make_sgd(model.parameters()))
    else:
        opt = OverlapPlan(model.parameters(), make_sgd, mode=overlap_mode,
                          bucket_mb=grad_bucket_mb)

    steps = [0]

    def step(model, batch_stats, opt, images, labels):
        steps[0] += 1
        with phase("step", step=steps[0]):
            with phase("forward"):
                opt.zero_grad()
                loss = F.cross_entropy(model(images), labels)
            with phase("backward"):
                loss.backward()
            opt.step()
            with phase("loss_reduce"):
                mean = allreduce(loss.detach())
        return model, batch_stats, opt, mean

    state = (model, batch_stats, opt, images, labels)
    return step, state, {"n_chips": n_gpus, "global_batch": global_batch,
                         "carry_len": 3}
