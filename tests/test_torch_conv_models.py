"""The port's conv zoo (``horovod_tpu_torch.models``: ``layers``,
``resnet``, ``vgg``, ``inception``, ``simple``, ``convert``) held against
the JAX package's models on the same weights (flax's init, converted by
``variables_from_jax``) and the same numpy inputs.

Each case runs one forward and backward of a mean cross-entropy loss and
compares the logits, the loss, every gradient (by port name; the two
trees must name the same parameters) and, in training mode, the updated
BatchNorm running statistics.  Tolerances, |port - jax| <= atol + rtol *
|jax| elementwise:

* fp32: atol 2e-5, rtol 1e-4 (sums in other orders; measured at most
  4e-6 on logits and 1e-5 normwise on gradients);
* ResNet-18 in bf16 compute with fp32 parameters: logits and loss 5e-2
  of JAX's bf16 step (both round every conv and BatchNorm output to bf16,
  8 bits of mantissa, after sums in other orders; measured 1.3e-2, and
  JAX's own bf16 logits are 1.0e-2 from its fp32 ones), running
  statistics 1e-2 (measured 1.0e-3).  At batch 2 the bf16 gradients are
  dominated by rounding (JAX's own are 13% from its fp32 ones, all
  gradients taken as one vector), so the port's bf16 gradients are held
  to be no farther from JAX's fp32 gradients than 1.5x JAX's bf16
  gradients are (measured 14.5% against 12.8%);
* Inception V3 in training mode at init is ill-conditioned in fp32 at any
  size (on the CPU the port's own fp32 and fp64 gradients differ by
  3-5% normwise, and at 96x96 its last blocks normalise 1x1 maps over 2
  values), so it is held at the fp32 bound in eval mode (BatchNorm on the
  running statistics, eps 1e-3), where the JAX and port steps agree to
  1e-6, and in training mode at batch 8 within measured bounds: logits
  1e-2 (measured 3.8e-3), gradients 0.15 of their norm (7.1%), running
  statistics 1e-3 (8.4e-5).

``test_torch_defaults_fail`` shows that the two flax-vs-torch defaults
these tests guard would fail them: torch's BatchNorm running update
(unbiased variance) and an NCHW flatten in VGG.
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from horovod_tpu import models as jmodels
from horovod_tpu_torch.bench import conv_flops_per_image
from horovod_tpu_torch.models import (MLP, VGG, ConvNet, InceptionV3,
                                      ResNet18, ResNet50, VGG16, layers,
                                      variables_from_jax)
from horovod_tpu_torch.models.resnet import space_to_depth

FP32 = {"atol": 2e-5, "rtol": 1e-4}
BF16 = {"logits": 5e-2, "stats": 1e-2, "grads_vs_jax_bf16": 1.5}
INCEPTION_TRAIN = {"logits": 1e-2, "grad_norm": 0.15, "stats": 1e-3}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(batch, size, classes=1000, channels=3):
    x = np.random.RandomState(0).randn(batch, size, size,
                                       channels).astype(np.float32)
    y = np.random.RandomState(1).randint(0, classes, (batch,))
    return x, y


def _jax_init(model, x, has_train=True):
    kw = {"train": True} if has_train else {}
    return jax.jit(lambda k, a: model.init(k, a, **kw))(
        jax.random.PRNGKey(0), x[:1])


def _jax_run(model, variables, x, y, train=True, has_train=True):
    """One JAX forward/backward: logits, loss, grads and updated
    batch_stats, by port name."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    kw = {"train": train} if has_train else {}

    def loss_fn(p):
        v = {"params": p, **({"batch_stats": stats} if stats else {})}
        if train and stats:
            logits, mut = model.apply(v, x, mutable=["batch_stats"], **kw)
            new = mut["batch_stats"]
        else:
            logits, new = model.apply(v, x, **kw), stats
        logits = logits.astype(jnp.float32)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        return loss, (logits, new)

    (loss, (logits, new)), g = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"logits": np.asarray(logits), "loss": float(loss),
            "grads": variables_from_jax(_np(g)),
            "stats": variables_from_jax({}, _np(new))}


def _port_run(model, variables, x, y, train=True):
    model.load_state_dict(variables_from_jax(
        _np(variables["params"]), _np(variables.get("batch_stats", {}))),
        strict=True)
    model.train(train)
    xt = layers.from_nhwc(x) if x.ndim == 4 else torch.from_numpy(x)
    logits = model(xt).float()
    loss = F.cross_entropy(logits, torch.from_numpy(y))
    loss.backward()
    return {"logits": logits.detach().numpy(), "loss": loss.item(),
            "grads": {n: p.grad.float().numpy()
                      for n, p in model.named_parameters()},
            "stats": {n: b.numpy() for n, b in model.named_buffers()}}


def _close(got, want, atol, rtol, what):
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                               err_msg=what)


def _assert_fp32(got, want, train=True):
    _close(got["logits"], want["logits"], **FP32, what="logits")
    _close(np.float32(got["loss"]), want["loss"], **FP32, what="loss")
    assert set(got["grads"]) == set(want["grads"])
    for name, g in got["grads"].items():
        _close(g, want["grads"][name].numpy(), **FP32, what=name)
    if train:
        assert set(got["stats"]) == set(want["stats"])
        for name, s in got["stats"].items():
            _close(s, want["stats"][name].numpy(), **FP32, what=name)


def _assert_normwise(got, want, bound, what):
    want = np.asarray(want, np.float64)
    err = np.linalg.norm(np.asarray(got, np.float64) - want)
    assert err <= bound * np.linalg.norm(want) + 1e-6, (what, err)


def _assert_loose(got, want, tol):
    _close(got["logits"], want["logits"], tol["logits"], tol["logits"],
           "logits")
    _close(np.float32(got["loss"]), want["loss"], tol["logits"],
           tol["logits"], "loss")
    assert set(got["grads"]) == set(want["grads"])
    for name, g in got["grads"].items():
        _assert_normwise(g, want["grads"][name].numpy(), tol["grad_norm"],
                         name)
    for name, s in got["stats"].items():
        _close(s, want["stats"][name].numpy(), tol["stats"], tol["stats"],
               name)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

# (size, kernel, stride, padding): SAME at stride 1 and 2 on even and odd
# sizes, even kernels, and the ResNet stems' explicit pairs
PAD_CASES = [
    (8, 3, 1, "SAME"), (8, 3, 2, "SAME"), (7, 3, 2, "SAME"),
    (9, 3, 2, "SAME"), (8, 1, 2, "SAME"), (10, 5, 2, "SAME"),
    (8, 4, 1, "SAME"), (9, 2, 2, "SAME"), (11, 3, 2, "VALID"),
    (16, 7, 2, [(3, 3), (3, 3)]), (8, 4, 1, [(1, 2), (1, 2)]),
]


@pytest.mark.parametrize("size,kernel,stride,padding", PAD_CASES)
def test_conv_padding_matches_flax(size, kernel, stride, padding):
    x = np.random.RandomState(2).randn(2, size, size, 3).astype(np.float32)
    conv = fnn.Conv(4, (kernel, kernel), (stride, stride), padding=padding)
    params = conv.init(jax.random.PRNGKey(1), x)
    want = np.asarray(conv.apply(params, x))
    port = layers.Conv2d(3, 4, kernel, stride, padding)
    port.load_state_dict(variables_from_jax(_np(params)))
    got = port(layers.from_nhwc(x)).detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_same_pads_put_the_odd_pad_at_the_end():
    assert layers.same_pads(8, 3, 2) == (0, 1)     # torch's padding=1: (1, 1)
    assert layers.same_pads(7, 3, 2) == (1, 1)
    assert layers.same_pads(8, 3, 1) == (1, 1)
    assert layers.same_pads(8, 4, 1) == (1, 2)
    assert layers.same_pads(8, 1, 2) == (0, 0)


@pytest.mark.parametrize("kind", ["max", "avg"])
def test_pools_match_flax(kind):
    x = np.random.RandomState(3).randn(2, 9, 9, 5).astype(np.float32)
    xt = layers.from_nhwc(x)
    if kind == "max":   # ResNet's padded max pool and Inception's VALID one
        cases = [(fnn.max_pool(x, (3, 3), (2, 2), ((1, 1), (1, 1))),
                  layers.max_pool(xt, 3, 2, [(1, 1), (1, 1)])),
                 (fnn.max_pool(x, (3, 3), (2, 2)), layers.max_pool(xt, 3, 2))]
    else:               # Inception's SAME average pool counts the pads
        cases = [(fnn.avg_pool(x, (3, 3), (1, 1), padding="SAME"),
                  layers.avg_pool(xt, 3, 1, "SAME"))]
    for want, got in cases:
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1e-6, rtol=1e-6)


def test_space_to_depth_matches_jax():
    x = np.random.RandomState(4).randn(2, 8, 6, 3).astype(np.float32)
    want = np.asarray(jmodels.resnet.space_to_depth(jnp.asarray(x), 2))
    got = space_to_depth(layers.from_nhwc(x), 2)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,train", [
    ("resnet18", True), ("resnet18", False), ("resnet50", True),
    ("resnet50", False), ("resnet18_s2d", True),
])
def test_resnet_matches_flax(name, train):
    """64x64, batch 2, fp32, 1000 classes: logits, loss, every gradient
    and (training mode) the updated running statistics."""
    s2d = name.endswith("_s2d")
    jcls, tcls = ((jmodels.ResNet50, ResNet50) if name == "resnet50"
                  else (jmodels.ResNet18, ResNet18))
    x, y = _inputs(2, 64)
    jm = jcls(compute_dtype=jnp.float32, s2d_stem=s2d)
    variables = _jax_init(jm, x)
    want = _jax_run(jm, variables, x, y, train)
    got = _port_run(tcls(compute_dtype=torch.float32, s2d_stem=s2d),
                    variables, x, y, train)
    _assert_fp32(got, want, train)


def _global_rel(grads, ref) -> float:
    """|grads - ref| / |ref|, every gradient taken as one vector."""
    keys = sorted(ref)
    a, b = (np.concatenate([np.asarray(g[k], np.float64).ravel()
                            for k in keys]) for g in (grads, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_resnet18_bf16_matches_flax():
    x, y = _inputs(2, 64)
    jm = jmodels.ResNet18(compute_dtype=jnp.bfloat16)
    variables = _jax_init(jm, x)
    want = _jax_run(jm, variables, x, y)
    want32 = _jax_run(jmodels.ResNet18(compute_dtype=jnp.float32), variables,
                      x, y)
    got = _port_run(ResNet18(compute_dtype=torch.bfloat16), variables, x, y)
    tol = BF16["logits"]
    _close(got["logits"], want["logits"], tol, tol, "logits")
    _close(np.float32(got["loss"]), want["loss"], tol, tol, "loss")
    assert set(got["stats"]) == set(want["stats"])
    for name, s in got["stats"].items():
        _close(s, want["stats"][name].numpy(), BF16["stats"], BF16["stats"],
               name)
    assert set(got["grads"]) == set(want["grads"])
    ref = {k: v.numpy() for k, v in want32["grads"].items()}
    jax_bf16 = _global_rel({k: v.numpy() for k, v in want["grads"].items()},
                           ref)
    assert _global_rel(got["grads"], ref) <= \
        BF16["grads_vs_jax_bf16"] * jax_bf16


def test_vgg16_matches_flax_at_64():
    """At 64x64 VGG-16 flattens 2x2x512: the first Dense's rows line up
    with flax's only in (h, w, c) order."""
    x, y = _inputs(2, 64)
    jm = jmodels.VGG16(compute_dtype=jnp.float32)
    variables = _jax_init(jm, x)
    want = _jax_run(jm, variables, x, y)
    got = _port_run(VGG16(compute_dtype=torch.float32, image_size=64),
                    variables, x, y)
    _assert_fp32(got, want, train=False)


@pytest.mark.parametrize("train", [False, True])
def test_inception_v3_matches_flax_at_96(train):
    x, y = _inputs(8 if train else 2, 96)
    jm = jmodels.InceptionV3(compute_dtype=jnp.float32)
    variables = _jax_init(jm, x)
    want = _jax_run(jm, variables, x, y, train)
    got = _port_run(InceptionV3(compute_dtype=torch.float32), variables, x,
                    y, train)
    if train:
        _assert_loose(got, want, INCEPTION_TRAIN)
    else:
        _assert_fp32(got, want, train=False)


@pytest.mark.parametrize("name", ["mlp", "convnet"])
def test_simple_models_match_flax(name):
    x, y = _inputs(4, 28, classes=10, channels=1)
    x = x[..., 0]  # [N, 28, 28], as the MNIST examples feed them
    if name == "mlp":
        jm, port = jmodels.MLP(), MLP(28 * 28)
    else:
        jm, port = jmodels.ConvNet(), ConvNet(image_size=28)
    variables = _jax_init(jm, x, has_train=False)
    want = _jax_run(jm, variables, x, y, train=False, has_train=False)
    got = _port_run(port, variables, x, y, train=False)
    _assert_fp32(got, want, train=False)


class _NCHWFlattenVGG(VGG):
    """VGG with torch's habitual flatten of an NCHW map (c, h, w)."""

    def forward(self, x):
        k = 0
        for spec in self.cfg:
            if spec == "M":
                x = layers.max_pool(x, 2, 2)
            else:
                x = F.relu(getattr(self, f"Conv_{k}")(x))
                k += 1
        x = F.relu(self.Dense_0(x.flatten(1)))
        return self.Dense_2(F.relu(self.Dense_1(x))).float()


def _torch_batch_norm(self, x):
    """torch's BatchNorm update (momentum 1 - 0.9, unbiased variance)."""
    return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                        self.bias, self.training, 1 - self.momentum, self.eps)


@pytest.mark.parametrize("default", ["unbiased_running_var", "nchw_flatten"])
def test_torch_defaults_fail(default, monkeypatch):
    """The parity tests above catch each torch default they guard."""
    x, y = _inputs(2, 64)
    if default == "unbiased_running_var":
        monkeypatch.setattr(layers.BatchNorm, "forward", _torch_batch_norm)
        jm, port = (jmodels.ResNet18(compute_dtype=jnp.float32),
                    ResNet18(compute_dtype=torch.float32))
    else:
        jm = jmodels.VGG16(compute_dtype=jnp.float32)
        port = _NCHWFlattenVGG(compute_dtype=torch.float32, image_size=64)
    variables = _jax_init(jm, x)
    want = _jax_run(jm, variables, x, y)
    got = _port_run(port, variables, x, y)
    with pytest.raises(AssertionError):
        _assert_fp32(got, want, train=default == "unbiased_running_var")


def test_resnet50_at_224_has_flax_parameters():
    """Parameter count and every parameter and statistic shape equal to
    flax's ResNet-50 at 224 (flax's from ``eval_shape``, the port's on
    the ``meta`` device)."""
    jm = jmodels.ResNet50()
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 224, 224, 3)), train=True))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    want = {k: tuple(v.shape) for k, v in variables_from_jax(
        zeros["params"], zeros["batch_stats"]).items()}
    with torch.device("meta"):
        port = ResNet50()
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == want
    n = sum(p.numel() for p in port.parameters())
    assert n == sum(np.prod(s.shape) for s in
                    jax.tree_util.tree_leaves(shapes["params"])) == 25557032


def _vgg16_macs(side, classes=1000):
    """VGG-16's multiply-adds per image, layer by layer."""
    macs, c = 0, 3
    for stage, (width, convs) in enumerate([(64, 2), (128, 2), (256, 3),
                                            (512, 3), (512, 3)]):
        s = side >> stage
        for _ in range(convs):
            macs += s * s * width * 9 * c
            c = width
    flat = (side >> 5) ** 2 * 512
    return macs + flat * 4096 + 4096 * 4096 + 4096 * classes


def _resnet50_macs(side=224, classes=1000):
    """ResNet-50's multiply-adds per image: the 7x7/2 stem, then per
    bottleneck 1x1 -> 3x3(stride) -> 1x1 and a projection in each stage's
    first block, then the head."""
    s = side // 2
    macs = s * s * 64 * 49 * 3
    s //= 2          # max pool
    c = 64
    for stage, blocks in enumerate([3, 4, 6, 3]):
        f = 64 << stage
        for j in range(blocks):
            stride = 2 if stage > 0 and j == 0 else 1
            out = s // stride
            macs += s * s * f * c             # conv1 at the input size
            macs += out * out * f * 9 * f     # conv2 (the stride)
            macs += out * out * 4 * f * f     # conv3
            if j == 0:
                macs += out * out * 4 * f * c  # projection
            s, c = out, 4 * f
    return macs + c * classes


@pytest.mark.parametrize("model,size,macs", [
    ("vgg16", 64, _vgg16_macs(64)), ("vgg16", 224, _vgg16_macs(224)),
    ("resnet50", 224, _resnet50_macs()),
])
def test_conv_flops_per_image_is_the_hand_count(model, size, macs):
    assert conv_flops_per_image(model, size) == 6 * macs
    if model == "resnet50":  # 4.09 G multiply-adds, the published count
        assert 4.08e9 < macs < 4.12e9
    if model == "vgg16" and size == 224:  # 15.47 G
        assert 15.4e9 < macs < 15.5e9
