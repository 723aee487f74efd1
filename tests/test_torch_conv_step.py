"""The port's conv training step and cross-replica BatchNorm held against
the JAX package's.

* ``SyncBatchNorm`` (``horovod_tpu_torch.parallel``) on a 2-process gloo
  world against the JAX ``SyncBatchNorm`` under shard_map on a 2-device
  mesh, training mode, loss ``sum(y * w)``: outputs, the gradients of x,
  scale and bias, and the running statistics, atol and rtol 1e-5 (fp32
  sums in other orders).  Uneven local batches (3 rows and 1) must give
  the statistics of the whole batch: they are held against the JAX module
  on one device over the 4 rows (the per-rank scale and bias gradients
  summed).  At world 1 ``SyncBatchNorm`` equals ``layers.BatchNorm``.
* ``train.build_step("resnet18", "fp32", 4, 32)``: three SGD-momentum
  steps on a 2-process gloo world against the root
  ``bench.build_step("resnet18", "fp32", 4, 32)`` on a 2-device mesh (the
  first two devices of the 8-device CPU mesh: BatchNorm statistics are
  per replica, so each JAX replica must hold what each rank holds), both
  from the port's seeded initial weights.  Losses (the port's step
  returns the mean over the world; the reference's, device 0's, so the
  test takes the mean of both blocks' losses) within 1e-4, the
  parameters within 1e-4 + 1e-3 relative, rank 0's running statistics
  within 1e-4 + 1e-3 relative (fp32 sums in other orders through three
  steps; measured 1.5e-5 on the losses, 3.2e-6 on the parameters, 2.2e-6
  on the statistics).  Within the port, ``off``, ``bucket`` and
  ``bucket+zero1`` agree bit for bit: at 2 ranks a sum is order-free, a
  reduce-scatter shard is the matching slice of the allreduce, and SGD
  is elementwise.
* The CLI prints one images/s record, and what is not ported raises.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_world
import bench as root_bench
import horovod_tpu as jhvd
from horovod_tpu import models as jmodels
from horovod_tpu.ops.collectives import shard_map_compat
from horovod_tpu.parallel.sync_batch_norm import (
    SyncBatchNorm as JSyncBatchNorm,
)
from horovod_tpu_torch.models import ResNet18, variables_from_jax
from horovod_tpu_torch.train import build_step, conv_model

REPO = Path(__file__).resolve().parent.parent
BN_TOL = 1e-5
STEPS, BATCH, SIZE = 3, 4, 32
LOSS_TOL = 1e-4
PARAM_TOL = {"atol": 1e-4, "rtol": 1e-3}
MODES = ("off", "bucket", "bucket+zero1")

# ---------------------------------------------------------------------------
# SyncBatchNorm
# ---------------------------------------------------------------------------

C = 6


def _bn_data(rows):
    rng = np.random.RandomState(5)
    xs = [rng.randn(n, 3, 3, C).astype(np.float32) * 2 + 1 for n in rows]
    ws = [rng.randn(n, 3, 3, C).astype(np.float32) for n in rows]
    scale = rng.rand(C).astype(np.float32) + 0.5
    bias = rng.randn(C).astype(np.float32)
    return xs, ws, scale, bias


def _jax_sync_bn(xs, ws, scale, bias, momentum, devices):
    """JAX SyncBatchNorm under shard_map over ``devices``, one block of
    ``xs`` per device: per device (y, dx, dscale, dbias) and the running
    statistics."""
    mesh = Mesh(np.asarray(devices), (jhvd.DP_AXIS,))
    bn = JSyncBatchNorm(axis_name=jhvd.DP_AXIS, momentum=momentum)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    stats = {"mean": jnp.zeros(C), "var": jnp.ones(C)}

    def local(p, x, w):
        def f(p, x):
            y, mut = bn.apply({"params": p, "batch_stats": stats}, x,
                              use_running_average=False,
                              mutable=["batch_stats"])
            return (y * w).sum(), (y, mut["batch_stats"])

        (_, (y, new)), (gp, gx) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(p, x)
        return y, gx, gp["scale"][None], gp["bias"][None], new

    fn = jax.jit(shard_map_compat(
        local, mesh=mesh, in_specs=(P(), P(jhvd.DP_AXIS), P(jhvd.DP_AXIS)),
        out_specs=(P(jhvd.DP_AXIS),) * 4 + (P(),)))
    y, dx, ds, db, new = fn(params, jnp.concatenate(xs),
                            jnp.concatenate(ws))
    return (np.asarray(y), np.asarray(dx), np.asarray(ds), np.asarray(db),
            {k: np.asarray(v) for k, v in new.items()})


def _close(got, want, what):
    np.testing.assert_allclose(got, want, atol=BN_TOL, rtol=BN_TOL,
                               err_msg=what)


@pytest.mark.parametrize("rows", [(2, 2), (3, 1)], ids=["equal", "uneven"])
def test_sync_batch_norm_matches_jax(rows):
    momentum = 0.9
    xs, ws, scale, bias = _bn_data(rows)
    port = _torch_world.run_world(_torch_world.sync_bn_worker,
                                  (xs, ws, scale, bias, momentum))
    even = rows[0] == rows[1]
    # equal blocks: one per device of a 2-device mesh; uneven: the whole
    # batch on one device (the statistics a world must agree on)
    devices = jax.devices()[:2] if even else jax.devices()[:1]
    y, dx, ds, db, stats = _jax_sync_bn(xs, ws, scale, bias, momentum,
                                        devices)
    starts = np.cumsum((0,) + rows)
    for r, res in enumerate(port):
        got = res["sync"]
        rows_r = slice(starts[r], starts[r + 1])
        _close(got["y"], y[rows_r], f"rank {r} y")
        _close(got["dx"], dx[rows_r], f"rank {r} dx")
        _close(got["mean"], stats["mean"], f"rank {r} running mean")
        _close(got["var"], stats["var"], f"rank {r} running var")
        if even:
            _close(got["dscale"], ds[r], f"rank {r} dscale")
            _close(got["dbias"], db[r], f"rank {r} dbias")
    if not even:  # the ranks' parameter gradients sum to the whole batch's
        _close(sum(res["sync"]["dscale"] for res in port), ds[0], "dscale")
        _close(sum(res["sync"]["dbias"] for res in port), db[0], "dbias")


def test_sync_batch_norm_at_world_1_is_batch_norm():
    xs, ws, scale, bias = _bn_data((4,))
    (res,) = _torch_world.run_world(_torch_world.sync_bn_worker,
                                    (xs, ws, scale, bias, 0.99), world=1)
    for key, want in res["local"].items():
        _close(res["sync"][key], want, key)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------


def _to_flax(template, sd):
    """``template``'s flax tree holding the port state_dict ``sd`` (the
    inverse of ``variables_from_jax``)."""
    names = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
             "var": "running_var"}
    out = {}
    for key, sub in template.items():
        if isinstance(sub, dict):
            out[key] = _to_flax(sub, {k[len(key) + 1:]: v for k, v in
                                      sd.items() if k.startswith(key + ".")})
            continue
        t = sd[names.get(key, key)].detach().numpy()
        if key == "kernel":
            t = t.transpose(2, 3, 1, 0) if t.ndim == 4 else t.T
        out[key] = jnp.asarray(t)
    return out


@pytest.fixture(scope="module")
def reference(monkeypatch_module):
    """The root bench's step on the first 2 devices, from the port's
    seeded weights: losses, final params and batch_stats by port name."""
    devices = jax.devices()[:2]
    monkeypatch_module.setattr(jhvd, "num_devices", lambda: 2)
    monkeypatch_module.setattr(
        jhvd, "mesh", lambda shape="flat": Mesh(np.asarray(devices),
                                                (jhvd.DP_AXIS,)))
    step, state, static = root_bench.build_step("resnet18", "fp32", BATCH,
                                                SIZE)
    assert static["global_batch"] == 2 * BATCH and static["carry_len"] == 3
    params, stats, opt_state, images, labels = state
    sd = conv_model("resnet18", "fp32", SIZE).state_dict()
    flax_params = _to_flax(jax.tree_util.tree_map(np.asarray, params), sd)
    flax_stats = _to_flax(jax.tree_util.tree_map(np.asarray, stats), sd)
    state = (flax_params, flax_stats, opt_state, images, labels)
    model = jmodels.ResNet18(num_classes=1000, compute_dtype=jnp.float32)

    @jax.jit
    def world_loss(params, stats):
        # the reference step returns device 0's loss; the port's, the mean
        # over the world: the mean of the two blocks' losses (in training
        # mode the running statistics do not enter the forward)
        def block(x, y):
            logits, _ = model.apply({"params": params, "batch_stats": stats},
                                    x, train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean()

        return (block(images[:BATCH], labels[:BATCH])
                + block(images[BATCH:], labels[BATCH:])) / 2

    losses = []
    for _ in range(STEPS):
        losses.append(float(world_loss(state[0], state[1])))
        *carry, _ = step(*state)
        state = tuple(carry) + state[3:]
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"losses": losses, "images": np.asarray(images),
            "labels": np.asarray(labels),
            "params": variables_from_jax(np_tree(state[0])),
            "stats": variables_from_jax({}, np_tree(state[1]))}


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


@pytest.fixture(scope="module")
def port():
    return _torch_world.run_world(_torch_world.conv_step_worker,
                                  (STEPS, BATCH, SIZE, MODES), timeout=300)


def test_build_step_matches_the_root_bench(reference, port):
    for r, res in enumerate(port):
        off = res["off"]
        assert off["static"] == {"n_chips": 2, "global_batch": 2 * BATCH,
                                 "carry_len": 3}
        assert off["channels_last"]
        mine = slice(r * BATCH, (r + 1) * BATCH)
        np.testing.assert_array_equal(off["images"],
                                      reference["images"][mine])
        np.testing.assert_array_equal(off["labels"],
                                      reference["labels"][mine])
        np.testing.assert_allclose(off["losses"], reference["losses"],
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        for name, want in reference["params"].items():
            np.testing.assert_allclose(off["params"][name], want.numpy(),
                                       **PARAM_TOL, err_msg=name)
    assert set(port[0]["off"]["params"]) == set(reference["params"])
    # BatchNorm statistics stay per replica: rank 0 holds device 0's
    for name, want in reference["stats"].items():
        np.testing.assert_allclose(port[0]["off"]["stats"][name],
                                   want.numpy(), **PARAM_TOL, err_msg=name)


@pytest.mark.parametrize("mode", MODES[1:])
def test_overlap_modes_are_bitwise_off(port, mode):
    for res in port:
        assert res[mode]["bitwise_equal_to_first"]
        assert res[mode]["losses"] == res["off"]["losses"]
    assert port[0][mode]["digest"] == port[1][mode]["digest"]


def test_replicas_stay_identical(port):
    assert port[0]["off"]["digest"] == port[1]["off"]["digest"]
    assert all(np.isfinite(port[0]["off"]["losses"]))


def test_bench_cli_prints_an_images_record():
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--cpu",
         "--model", "resnet18", "--image-size", "32", "--batch-size", "2",
         "--iters", "1", "--warmup", "1"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO),
        env=_torch_world.bench_env())
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "resnet18_bf16_images_per_sec_per_gpu"
    assert rec["unit"] == "images/sec/gpu" and rec["value"] > 0
    # a CPU run is held against no device's peak or GPU baseline
    assert rec["device"] == "cpu" and rec["mfu"] is None
    assert rec["vs_baseline"] is None
    from horovod_tpu_torch.bench import conv_flops_per_image

    assert rec["flops_per_image"] == conv_flops_per_image("resnet18", 32)
    assert rec["overlap_mode"] == "off" and rec["flash_launches"] == {}
    assert rec["batch_size"] == 2 and np.isfinite(rec["final_loss"])


def test_what_is_not_ported_raises():
    """fp8 is ResNet's only (VGG and Inception refuse it, as the reference's
    bench does); the bench refuses the width-sharded fleet outside paged
    mode and experts on a conv model."""
    for name in ("vgg16", "inception3"):
        with pytest.raises(ValueError, match="resnet-only"):
            build_step(name, "fp8", 2, 32, device="cpu")
    assert ResNet18(act_store_dtype=torch.float8_e4m3fn).act \
        is not torch.nn.functional.relu
    from horovod_tpu_torch.bench import _check_args, _parser

    # the width-sharded fleet is ported (A11); what the bench still
    # refuses is a width-sharded fleet outside paged mode and experts on
    # a conv model
    with pytest.raises(ValueError, match="paged"):
        _check_args(_parser().parse_args(["--model", "gpt-small",
                                            "--serve", "--serve-width",
                                            "2", "--serve-kv-mode",
                                            "contiguous"]))
    with pytest.raises(ValueError, match="gpt-"):
        _check_args(_parser().parse_args(["--model", "resnet50",
                                            "--moe-experts", "8"]))
    _check_args(_parser().parse_args(["--model", "gpt-small", "--serve",
                                        "--serve-width", "2"]))
    for name in ("resnet50", "resnet101", "resnet18", "vgg16", "vgg19",
                 "inception3"):
        for dtype in ("bf16", "fp32", "fp8"):
            _check_args(_parser().parse_args(["--model", name,
                                                "--dtype", dtype]))
