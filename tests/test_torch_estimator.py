"""The port's Estimator / Model (``horovod_tpu_torch/estimator.py``) held
against the reference's (``horovod_tpu/estimator.py``): the six cases of
``tests/test_estimator.py`` on the port, one fit of the same MLP from the
same initial weights through both packages, and one ``launcher`` fit in a
2-process gloo world.

Tolerance of the parity case (fp32; the same batches in the same order,
Adam with the same hyper-parameters; the reference averages the gradients
of its 8 CPU devices' shards, the port takes the whole batch in a world of
one, so sums run in another order): every epoch's loss within 1e-5, and
every output of the fitted model within 1e-5 + 1e-5 x its magnitude (the
logits reach ~6 after 40 Adam steps; measured 2.8e-5 absolute, 8.3e-6
relative).  The 2-process fit is held to the local fit at 1e-5: two
ranks of 16 rows each average to the 32-row mean.
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import optax
import pytest
import torch

import horovod_tpu as jhvd
from horovod_tpu.estimator import Estimator as JEstimator
from horovod_tpu.models.simple import MLP as JMLP
from horovod_tpu_torch import basics
from horovod_tpu_torch.checkpoint import LocalStore, latest_checkpoint_step
from horovod_tpu_torch.estimator import Estimator, Model
from horovod_tpu_torch.models import MLP, variables_from_jax

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def hvd1():
    import horovod_tpu_torch as hvd

    jhvd.init()
    hvd.init(device="cpu")
    yield hvd
    hvd.shutdown()


def _blobs(n=256, seed=0):
    """Two linearly separable 2-D blobs (the reference test's)."""
    rng = np.random.RandomState(seed)
    half = n // 2
    x = np.concatenate([
        rng.randn(half, 2).astype(np.float32) + 2.0,
        rng.randn(n - half, 2).astype(np.float32) - 2.0,
    ])
    y = np.concatenate([np.zeros(half, np.int64), np.ones(n - half, np.int64)])
    return {"features": x, "label": y}


def _adam(lr):
    return functools.partial(torch.optim.Adam, lr=lr)


def _sgd(lr):
    return functools.partial(torch.optim.SGD, lr=lr)


def test_fit_local_learns_and_transforms(tmp_path):
    data = _blobs()
    est = Estimator(MLP(2, (16,), 2), _adam(1e-2), batch_size=32, epochs=5,
                    store=LocalStore(str(tmp_path)), run_id="blobs",
                    use_cpu=True)
    model = est.fit(data)
    assert len(model.history) == 5
    assert model.history[-1]["loss"] < model.history[0]["loss"]
    out = model.transform(data)
    assert (out["prediction"] == data["label"]).mean() > 0.95
    meta = LocalStore(str(tmp_path)).read_metadata("blobs")
    assert meta["model"] == "MLP"
    assert len(meta["history"]) == 5


def test_model_save_load_roundtrip(tmp_path):
    data = _blobs(n=128)
    store = LocalStore(str(tmp_path))
    est = Estimator(MLP(2, (8,), 2), _adam(1e-2), batch_size=32, epochs=2,
                    store=store, run_id="r1", use_cpu=True)
    model = est.fit(data)
    preds = model.transform(data)
    loaded = Model.load(MLP(2, (8,), 2), store, "r1", device="cpu")
    again = loaded.transform(data)
    np.testing.assert_array_equal(preds["prediction"], again["prediction"])
    np.testing.assert_array_equal(preds["prediction_logits"],
                                  again["prediction_logits"])
    assert loaded.history == model.history
    # save() lands a newer step that loads back the same
    model.save()
    assert latest_checkpoint_step(store.checkpoint_dir("r1")) == 3
    np.testing.assert_array_equal(
        Model.load(MLP(2, (8,), 2), store, "r1", device="cpu")
        .predict(data["features"]), model.predict(data["features"]))


def test_final_epoch_always_checkpointed(tmp_path):
    """epochs not a multiple of the cadence: the last epoch is still saved,
    so Model.load matches the fitted Model."""
    store = LocalStore(str(tmp_path))
    est = Estimator(MLP(2, (4,), 2), _sgd(0.1), batch_size=32, epochs=3,
                    checkpoint_every_epochs=5, store=store, run_id="cad",
                    use_cpu=True)
    est.fit(_blobs(n=64))
    assert latest_checkpoint_step(store.checkpoint_dir("cad")) == 3


def test_bad_batch_size_raises(monkeypatch):
    """31 rows a step over a world of 8 (the reference's 8 CPU devices):
    refused before any collective."""
    monkeypatch.setattr(basics, "size", lambda: 8)
    est = Estimator(MLP(2, (8,), 2), _sgd(0.1), batch_size=31, epochs=1,
                    use_cpu=True)
    with pytest.raises(ValueError, match="not divisible"):
        est.fit(_blobs(n=64))


def test_mismatched_lengths_raise():
    est = Estimator(MLP(2), _sgd(0.1), use_cpu=True)
    with pytest.raises(ValueError, match="length mismatch"):
        est.fit({"features": np.zeros((4, 2), np.float32),
                 "label": np.zeros(3, np.int64)})


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="unknown backend"):
        Estimator(MLP(2), _sgd(0.1), backend="spark")


def _jax_init(features):
    return JMLP(features=features, num_classes=2).init(
        jax.random.PRNGKey(0), np.zeros((1, 2), np.float32))


def _port_mlp_from(params, features):
    model = MLP(2, features, 2)
    model.load_state_dict(variables_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"])))
    return model


def test_fit_matches_the_reference(tmp_path):
    """The same MLP from the same initial weights (the reference's seed-0
    init, carried across by the port's converter), the same blobs and
    shuffles, Adam 1e-2, batch 32, 5 epochs: epoch losses within 1e-5,
    the fitted model's outputs within 1e-5 + 1e-5 x their magnitude."""
    data = _blobs()
    ref = JEstimator(JMLP(features=(16,), num_classes=2), optax.adam(1e-2),
                     batch_size=32, epochs=5).fit(
        {"features": data["features"],
         "label": data["label"].astype(np.int32)})
    port = Estimator(_port_mlp_from(_jax_init((16,)), (16,)), _adam(1e-2),
                     batch_size=32, epochs=5, use_cpu=True).fit(data)
    np.testing.assert_allclose([h["loss"] for h in port.history],
                               [h["loss"] for h in ref.history],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(port.predict(data["features"]),
                               ref.predict(data["features"]),
                               rtol=TOL, atol=TOL)


def test_launcher_fit_in_a_two_process_world(tmp_path):
    """``backend="launcher"`` with two gloo workers: each takes 16 rows of
    every 32-row batch and DistributedOptimizer averages their gradients,
    so the fit equals the local one; the store holds the final epoch."""
    data = _blobs(n=128)
    init = _port_mlp_from(_jax_init((8,)), (8,))
    store = LocalStore(str(tmp_path))
    kw = dict(batch_size=32, epochs=2, use_cpu=True)
    local = Estimator(init, _adam(1e-2), **kw).fit(data)
    multi = Estimator(init, _adam(1e-2), backend="launcher", np_workers=2,
                      store=store, run_id="two", timeout=120, **kw).fit(data)
    np.testing.assert_allclose([h["loss"] for h in multi.history],
                               [h["loss"] for h in local.history],
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(multi.predict(data["features"]),
                               local.predict(data["features"]),
                               rtol=0, atol=TOL)
    assert latest_checkpoint_step(store.checkpoint_dir("two")) == 2
    # fit trains a copy: the caller's model keeps its initial weights
    for k, v in init.state_dict().items():
        np.testing.assert_array_equal(
            v.numpy(), _port_mlp_from(_jax_init((8,)), (8,))
            .state_dict()[k].numpy())
