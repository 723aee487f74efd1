"""The port's fp8 activation storage (``models.layers.act_store``, the
GPT's and ResNet's ``act_store_dtype``, ``--dtype fp8``) held against the
JAX package's.

* ``act_store`` equals JAX's e4m3 round trip (``convert_element_type`` to
  ``float8_e4m3fn`` and back) element for element, NaN where JAX gives NaN,
  on ``chip_smoke.act_store_grid``: every bf16 value of magnitude up to
  1024 and, in fp32 and fp16, every e4m3 rounding boundary and its
  neighbours, with +-inf and nan.  torch's own cast saturates out of range
  (500 -> 448 where XLA gives NaN), so this fails for a plain ``.to()``.
  The gradient, the cotangent rounded the same way, equals ``jax.vjp``'s.
* gpt-nano and ResNet-18 (64x64) with e4m3 storage of their activations,
  fp32 compute, on flax's weights: logits, loss and gradients at the bounds
  of the models' own parity tests (GPT: 2e-4 logits and loss, 5e-4
  gradients; ResNet-18: atol 2e-5, rtol 1e-4), with fp32 compute so that
  both sides round the same values to e4m3.  e4m3 rounding is a step
  function (one step is 6-12% of the value), so an fp32 difference of
  1e-6 between the frameworks can move an activation that sits on a
  rounding boundary by one step; these cases have none, measured (with
  flips, at ResNet-18 batch 4 in training mode: logits 1.1e-2 apart and
  gradients 4.4% normwise).  Each is also shown to differ from the same
  model without fp8 storage, so the knob is live.
* The reference's ``test_fp8.py`` contract on the port's entry points in
  bf16 compute: ``build_gpt_step("nano", "fp8", 2, 64)`` and
  ``build_step("resnet18", "fp8", 16, 32)`` against their bf16 runs: the
  first loss within 2%, every later one within 15% + 0.05, both runs
  decreasing.  The reference runs its ResNet on the 8-device mesh, 2
  images a device: its loss is the mean over a global batch of 16, which
  the port's world of one takes on one rank.  (At 2 images on one rank the
  first losses of the port's own seeded weights are 3.9% apart, at 4 0.56%,
  at 16 0.18%; on flax's weights the port's bf16 and fp8 losses at 2
  images are JAX's to 1e-6.)  VGG refuses fp8, as the reference's bench
  does.
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_world
from horovod_tpu import models as jmodels
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu_torch.models import ResNet18, gpt, params_from_jax
from horovod_tpu_torch.models import layers
from horovod_tpu_torch.models.layers import act_store
from horovod_tpu_torch.train import lm_loss

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the grid the card is held on too)

E4M3 = torch.float8_e4m3fn
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16),
          "fp32": (torch.float32, jnp.float32)}
GPT_TOL = {"logits": 2e-4, "grads": 5e-4}
CONV_FP32 = {"atol": 2e-5, "rtol": 1e-4}
STEPS = 6
CONV_BATCH = 16  # the reference's global batch: 8 devices x 2


def _same(got, want):
    """Equal element for element, NaN where NaN."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])


def _jax_round_trip(x, jdt):
    return jnp.asarray(jnp.asarray(x, jnp.float8_e4m3fn), jdt)


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_act_store_gives_xlas_values(name):
    tdt, jdt = DTYPES[name]
    x = chip_smoke.act_store_grid(tdt)
    assert x.dtype == tdt and x.numel() > 400
    got = act_store(x, E4M3, tdt)
    want = _jax_round_trip(jnp.asarray(x.float().numpy(), jdt), jdt)
    _same(got.float().numpy(), np.asarray(want, np.float32))
    # out of range XLA gives NaN where torch's own cast saturates
    over = x.float().abs() > layers.E4M3_NAN_ABOVE
    assert bool(over.any()) and bool(torch.isnan(got[over]).all())
    sat = x.to(E4M3).to(tdt)
    assert not bool(torch.isnan(sat[over & torch.isfinite(x)]).any())


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_act_store_gradient_matches_jax_vjp(name):
    """The cotangent is rounded through e4m3 as the transpose of JAX's
    conversion pair rounds it, NaN rule included."""
    tdt, jdt = DTYPES[name]
    g = chip_smoke.act_store_grid(tdt)
    y = torch.linspace(-3, 3, g.numel()).to(tdt).requires_grad_()
    act_store(y, E4M3, tdt).backward(g)
    _, vjp = jax.vjp(lambda v: _jax_round_trip(v, jdt),
                     jnp.asarray(y.detach().float().numpy(), jdt))
    (want,) = vjp(jnp.asarray(g.float().numpy(), jdt))
    _same(y.grad.float().numpy(), np.asarray(want, np.float32))


def test_act_store_off_is_the_identity():
    x = torch.randn(5)
    assert act_store(x, None, torch.float32) is x
    with pytest.raises(ValueError, match="float8_e4m3fn"):
        act_store(x, torch.float8_e5m2, torch.float32)


def _gpt_pair(fp8):
    kw = dict(attention_impl="flash", flash_block_q=16, flash_block_k=16)
    jm = jax_gpt("nano", dtype=jnp.float32,
                 act_store_dtype=jnp.float8_e4m3fn if fp8 else None, **kw)
    jparams = jax.tree_util.tree_map(np.asarray, jm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32)))
    tm = gpt("nano", device="cpu", dtype=torch.float32,
             act_store_dtype=E4M3 if fp8 else None, **kw)
    tm.load_state_dict(params_from_jax(jparams), strict=True)
    return jm, jparams, tm


def _gpt_run(fp8):
    """(port logits, loss, grads), (flax logits, loss, grads by name)."""
    jm, jparams, tm = _gpt_pair(fp8)
    toks = np.random.RandomState(1).randint(0, 1024, (2, 33))

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(toks[:, :-1]))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(toks[:, 1:])).mean(), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, jparams))
    ttoks = torch.from_numpy(toks)
    tlogits = tm(ttoks[:, :-1]).detach().numpy()
    tl = lm_loss(tm, ttoks)
    tl.backward()
    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    return ((tlogits, tl.item(),
             {n: p.grad.numpy() for n, p in tm.named_parameters()}),
            (np.asarray(jlogits), float(jl),
             {n: t.numpy() for n, t in want.items()}))


def test_gpt_with_e4m3_storage_matches_flax():
    (logits, loss, grads), (jlogits, jl, jgrads) = _gpt_run(fp8=True)
    tol = GPT_TOL["logits"]
    np.testing.assert_allclose(logits, jlogits, atol=tol, rtol=tol)
    np.testing.assert_allclose(loss, jl, atol=tol, rtol=tol)
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g, jgrads[name], atol=GPT_TOL["grads"],
                                   rtol=GPT_TOL["grads"], err_msg=name)
    plain = _gpt_run(fp8=False)[0][0]
    assert np.abs(logits - plain).max() > 10 * tol  # the knob is live


def _resnet_run(fp8, batch, train):
    from test_torch_conv_models import _inputs, _jax_init, _jax_run, \
        _port_run

    x, y = _inputs(batch, 64)
    jm = jmodels.ResNet18(num_classes=1000, compute_dtype=jnp.float32,
                          act_store_dtype=jnp.float8_e4m3fn if fp8 else None)
    variables = _jax_init(jm, x)
    want = _jax_run(jm, variables, x, y, train=train)
    got = _port_run(ResNet18(compute_dtype=torch.float32,
                             act_store_dtype=E4M3 if fp8 else None),
                    variables, x, y, train=train)
    return got, want


@pytest.mark.parametrize("batch,train", [(2, True), (4, False)])
def test_resnet18_with_e4m3_storage_matches_flax(batch, train):
    got, want = _resnet_run(True, batch, train)
    np.testing.assert_allclose(got["logits"], want["logits"], **CONV_FP32)
    np.testing.assert_allclose(got["loss"], want["loss"], **CONV_FP32)
    assert set(got["grads"]) == set(want["grads"])
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, want["grads"][name].numpy(),
                                   **CONV_FP32, err_msg=name)
    if train:
        for name, s in got["stats"].items():
            np.testing.assert_allclose(s, want["stats"][name].numpy(),
                                       **CONV_FP32, err_msg=name)
    plain, _ = _resnet_run(False, batch, train)
    assert np.abs(got["logits"] - plain["logits"]).max() > 1e-3


@pytest.fixture(scope="module")
def contract():
    return _torch_world.run_world(_torch_world.fp8_contract_worker,
                                  (STEPS, CONV_BATCH), world=1,
                                  timeout=240)[0]


@pytest.mark.parametrize("model", ["gpt", "resnet"])
def test_fp8_tracks_bf16_loss(contract, model):
    bf16, fp8 = contract[f"{model}_bf16"], contract[f"{model}_fp8"]
    assert len(fp8) == STEPS and np.isfinite(fp8).all()
    assert bf16[-1] < bf16[0] and fp8[-1] < fp8[0]
    assert abs(fp8[0] - bf16[0]) <= 0.02 * abs(bf16[0]), (fp8, bf16)
    for b, f in zip(bf16[1:], fp8[1:]):
        assert abs(f - b) <= 0.15 * abs(b) + 0.05, (fp8, bf16)
    assert fp8 != bf16  # the storage is live


def test_fp8_is_resnet_only_in_the_conv_zoo(contract):
    assert "resnet-only" in contract["vgg"]


def test_fp8_compute_dtype_is_bf16():
    m = gpt("nano", device="cpu", act_store_dtype=E4M3)
    x = torch.zeros((1, 8), dtype=torch.long)
    assert m(x).dtype == torch.float32  # fp32 logits, as the reference
    from horovod_tpu_torch.train import _ACT_STORE, _DTYPES

    assert _DTYPES["fp8"] == torch.bfloat16 and _ACT_STORE["fp8"] == E4M3


@pytest.mark.parametrize("model,args", [
    ("gpt-nano", ["--seq-len", "32", "--batch-size", "2"]),
    ("resnet18", ["--image-size", "32", "--batch-size", "2"]),
])
def test_bench_cli_runs_fp8(model, args):
    """``python -m horovod_tpu_torch.bench --dtype fp8`` runs the GPT and
    ResNet (one record, finite loss; on the CPU no device's numbers)."""
    import json
    import subprocess

    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--cpu",
         "--model", model, "--dtype", "fp8", "--iters", "1", "--warmup",
         "1", *args],
        capture_output=True, text=True, timeout=120,
        cwd=str(Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    (line,) = out.stdout.strip().splitlines()
    rec = json.loads(line)
    assert rec["metric"].startswith(f"{model}_fp8_")
    assert rec["device"] == "cpu" and rec["mfu"] is None
    assert np.isfinite(rec["final_loss"])
