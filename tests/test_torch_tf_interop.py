"""The port's TensorFlow and Keras frontends
(``horovod_tpu_torch/interop/{tf,tf_keras,keras}.py``) held against the
reference's (``horovod_tpu/interop/{tf,tf_keras}.py``): the 22 cases of
``tests/test_tf_interop.py``, each run through both frontends on the same
inputs (Keras models built from the same seed), with the port's values
equal to the reference's (exactly for the collectives, which are
identities in a world of one; 1e-6 for the Keras fits and updates, which
run the same TensorFlow arithmetic) and the reference test's own
assertions on the port's.

Both frontends run in this process: the reference's on the JAX package's
world, the port's on a gloo world of one on the CPU (its ``init``'s
default: TF tensors live on the host).
"""

import numpy as np
import pytest

tf = pytest.importorskip("tensorflow")

import horovod_tpu as jhvd  # noqa: E402
import horovod_tpu.interop.tf as jtf  # noqa: E402
import horovod_tpu.interop.tf_keras as jtfk  # noqa: E402
import horovod_tpu_torch.interop.keras as pkeras  # noqa: E402
import horovod_tpu_torch.interop.tf as ptf  # noqa: E402
import horovod_tpu_torch.interop.tf_keras as ptfk  # noqa: E402

TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _init():
    jhvd.init()
    ptf.init()
    yield
    ptf.shutdown()


def _same(fn):
    """``fn(frontend)`` through the port's and the reference's frontends:
    the values must agree; returns the port's."""
    got, want = fn(ptf), fn(jtf)
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    for g, w in pairs:
        np.testing.assert_array_equal(np.asarray(g, np.float64),
                                      np.asarray(w, np.float64))
    return got


def test_allreduce_identity_single_process():
    x = tf.reshape(tf.range(6, dtype=tf.float32), (2, 3))
    out = ptf.allreduce(x)
    assert isinstance(out, tf.Tensor)
    np.testing.assert_array_equal(out.numpy(), jtf.allreduce(x).numpy())
    np.testing.assert_allclose(out.numpy(), x.numpy())


def test_allreduce_sum_bf16_roundtrip():
    x = tf.ones((8,), dtype=tf.bfloat16)
    out = ptf.allreduce(x, op=ptf.Sum)
    assert out.dtype == tf.bfloat16
    got = tf.cast(out, tf.float32).numpy()
    np.testing.assert_array_equal(
        got, tf.cast(jtf.allreduce(x, op=jtf.Sum), tf.float32).numpy())
    np.testing.assert_allclose(got, np.ones(8))


def test_allreduce_inside_tf_function():
    def run(hvd):
        @tf.function
        def fn(x):
            return hvd.allreduce(x, op=hvd.Sum)

        return fn(tf.constant([1.0, 2.0])).numpy()

    np.testing.assert_allclose(_same(run), [1.0, 2.0])


def test_allreduce_indexed_slices_allgathers():
    def run(hvd):
        slices = tf.IndexedSlices(
            values=tf.constant([[1.0, 2.0], [3.0, 4.0]]),
            indices=tf.constant([0, 3], dtype=tf.int64),
            dense_shape=tf.constant([5, 2], dtype=tf.int64),
        )
        out = hvd.allreduce(slices, op=hvd.Average)
        assert isinstance(out, tf.IndexedSlices)
        return out.values.numpy(), out.indices.numpy()

    values, indices = _same(run)
    np.testing.assert_allclose(values, [[1.0, 2.0], [3.0, 4.0]])
    np.testing.assert_array_equal(indices, [0, 3])


def test_allreduce_grad_is_allreduced():
    def run(hvd):
        x = tf.Variable([1.0, 2.0, 3.0])
        with tf.GradientTape() as tape:
            y = tf.reduce_sum(hvd._allreduce(x, op=hvd.Sum))
        return tape.gradient(y, x).numpy()

    np.testing.assert_allclose(_same(run), np.ones(3))


def test_allgather_and_grad():
    value = np.random.RandomState(0).randn(2, 3).astype(np.float32)

    def run(hvd):
        x = tf.Variable(value)
        with tf.GradientTape() as tape:
            g = hvd.allgather(x)
            loss = tf.reduce_sum(g)
        assert g.shape == (2, 3)
        return g.numpy(), tape.gradient(loss, x).numpy()

    gathered, grad = _same(run)
    np.testing.assert_array_equal(gathered, value)
    np.testing.assert_allclose(grad, np.ones((2, 3)))


def test_broadcast_grad_root():
    value = np.random.RandomState(1).randn(4).astype(np.float32)

    def run(hvd):
        x = tf.Variable(value)
        with tf.GradientTape() as tape:
            y = tf.reduce_sum(hvd.broadcast(x, root_rank=0))
        return tape.gradient(y, x).numpy()

    np.testing.assert_allclose(_same(run), np.ones(4))


def test_broadcast_variables_assigns():
    def run(hvd):
        v = tf.Variable([5.0, 6.0])
        hvd.broadcast_variables([v], root_rank=0)
        return v.numpy()

    np.testing.assert_allclose(_same(run), [5.0, 6.0])


def test_distributed_gradient_tape():
    def run(hvd):
        x = tf.Variable(3.0)
        with hvd.DistributedGradientTape(tf.GradientTape()) as tape:
            y = x * x
        return float(tape.gradient(y, x))

    assert _same(run) == 6.0


def test_distributed_keras_optimizer_applies():
    def run(hvd):
        dopt = hvd.DistributedOptimizer(
            tf.keras.optimizers.SGD(learning_rate=0.5))
        assert type(dopt).__name__ == "DistributedSGD"
        v = tf.Variable(2.0)
        dopt.apply_gradients([(tf.constant(1.0), v)])
        return float(v)

    assert _same(run) == 1.5


def test_distributed_legacy_optimizer_wrap():
    try:
        base = tf.compat.v1.train.GradientDescentOptimizer(0.1)
    except AttributeError:
        pytest.skip("tf.compat.v1 unavailable")
    got = ptf.DistributedOptimizer(base)
    want = jtf.DistributedOptimizer(base)
    assert type(got).__name__ == type(want).__name__
    assert got.get_slot_names() == base.get_slot_names() \
        == want.get_slot_names()


def test_adasum_optimizer_single_process_delta_step():
    """op=Adasum diverts to the delta-reducing Keras subclass; world 1
    applies the local update."""
    def run(hvd):
        v = tf.Variable([1.0, 2.0])
        opt = hvd.DistributedOptimizer(
            tf.keras.optimizers.SGD(learning_rate=0.1), op=hvd.Adasum)
        assert type(opt).__name__ == "AdasumSGD"
        assert isinstance(opt, tf.keras.optimizers.SGD)
        opt.apply_gradients([(tf.constant([1.0, 2.0]), v)])
        assert len(opt._hvd_starts) == 1
        return v.numpy()

    np.testing.assert_allclose(_same(run), [0.9, 1.8], rtol=1e-6)


def _fit_history(hvd, build, x, y, **fit_kw):
    tf.keras.utils.set_random_seed(0)
    model = build(hvd)
    return model, model.fit(x, y, verbose=0, **fit_kw).history


def _dense_model(hvd, opt, **compile_kw):
    model = tf.keras.Sequential(
        [tf.keras.Input(shape=(2,)),
         tf.keras.layers.Dense(1, use_bias=False)])
    model.compile(optimizer=opt, loss="mse", **compile_kw)
    return model


def test_adasum_keras_optimizer_works_in_model_compile():
    x = np.ones((8, 2), np.float32)
    y = np.zeros((8, 1), np.float32)
    hists = [_fit_history(
        h, lambda h: _dense_model(h, h.DistributedOptimizer(
            tf.keras.optimizers.SGD(learning_rate=0.1), op=h.Adasum)),
        x, y, epochs=1, batch_size=4)[1] for h in (ptf, jtf)]
    assert np.isfinite(hists[0]["loss"][0])
    np.testing.assert_allclose(hists[0]["loss"], hists[1]["loss"],
                               rtol=TOL)


@pytest.mark.parametrize("dt", ["float32", "float64", "float16", "bfloat16",
                                "int32", "int64"])
def test_allreduce_dtype_dims_grid(dt):
    """allreduce across dtype x rank keeps dtype, shape and values (world
    1 identities), as the reference's."""
    dt = getattr(tf, dt)
    for dim in (1, 2, 3):
        shape = (2,) * dim
        x = tf.cast(tf.reshape(tf.range(2 ** dim) % 3, shape), dt)
        for hvd in (ptf, jtf):
            op = hvd.Sum if not dt.is_floating else hvd.Average
            out = hvd.allreduce(x, op=op)
            assert out.dtype == dt, (dt, dim)
            assert tuple(out.shape) == shape, (dt, dim)
            np.testing.assert_array_equal(
                tf.cast(out, tf.float64).numpy(),
                tf.cast(x, tf.float64).numpy())


def test_compression_fp16_roundtrip():
    x = tf.constant([1.0, 2.0, 3.0])
    for hvd in (ptf, jtf):
        c, ctx = hvd.Compression.fp16.compress(x)
        assert c.dtype == tf.float16
        out = hvd.Compression.fp16.decompress(c, ctx)
        assert out.dtype == tf.float32
        np.testing.assert_allclose(out.numpy(), x.numpy())


def test_alltoall_single_process_identity():
    x = tf.constant(np.arange(4, dtype=np.float32))
    np.testing.assert_allclose(_same(lambda h: h.alltoall(x).numpy()),
                               x.numpy())


def test_feature_probes_answer():
    assert ptf.size() == 1 == jtf.size()
    for probe in ("gloo_built", "mpi_built", "nccl_built"):
        assert isinstance(getattr(ptf, probe)(), bool)
    assert ptf.gloo_built() is True


# ---------------------------------------------------------------------------
# Keras frontend
# ---------------------------------------------------------------------------


def _tiny_model(hvk, lr=0.1):
    return _dense_model(hvk, hvk.DistributedOptimizer(
        tf.keras.optimizers.SGD(learning_rate=lr)))


def test_keras_fit_with_callbacks_single_process():
    x = np.random.RandomState(0).randn(32, 2).astype(np.float32)
    y = (x @ np.asarray([[1.0], [2.0]], np.float32)).astype(np.float32)
    out = {}
    for hvk in (ptfk, jtfk):
        model, hist = _fit_history(
            hvk, _tiny_model, x, y, epochs=2, batch_size=8,
            callbacks=[
                hvk.callbacks.BroadcastGlobalVariablesCallback(0),
                hvk.callbacks.MetricAverageCallback(),
                hvk.callbacks.LearningRateWarmupCallback(
                    initial_lr=0.1, warmup_epochs=2),
            ])
        out[hvk] = (hist, hvk._lr_value(model.optimizer))
    hist, lr = out[ptfk]
    assert hist["loss"][-1] < hist["loss"][0]
    assert abs(lr - 0.1) < 1e-6
    np.testing.assert_allclose(hist["loss"], out[jtfk][0]["loss"], rtol=TOL)


def test_keras_lr_schedule_staircase():
    x = np.zeros((8, 2), np.float32)
    y = np.zeros((8, 1), np.float32)
    hists = [_fit_history(
        hvk, lambda h: _tiny_model(h, lr=1.0), x, y, epochs=3,
        batch_size=8, callbacks=[hvk.callbacks.LearningRateScheduleCallback(
            initial_lr=1.0, multiplier=lambda epoch: 0.5 ** epoch)])[1]
        for hvk in (ptfk, jtfk)]
    assert hists[0]["lr"] == [1.0, 0.5, 0.25] == hists[1]["lr"]


def _save_and_load(hvk, build, x, y, path):
    tf.keras.utils.set_random_seed(0)
    model = build(hvk)
    model.fit(x, y, epochs=1, batch_size=8, verbose=0)
    model.save(path)
    restored = hvk.load_model(path)
    hist = restored.fit(x, y, epochs=1, batch_size=8, verbose=0).history
    return restored, hist


def test_keras_load_model_rewraps_optimizer(tmp_path):
    x = np.random.RandomState(0).randn(16, 2).astype(np.float32)
    y = np.zeros((16, 1), np.float32)
    out = [_save_and_load(hvk, _tiny_model, x, y,
                          str(tmp_path / f"{i}.keras"))
           for i, hvk in enumerate((ptfk, pkeras, jtfk))]
    for restored, _ in out:
        assert getattr(restored.optimizer, "_hvd_wrapped", False)
    np.testing.assert_allclose(out[0][1]["loss"], out[2][1]["loss"],
                               rtol=TOL)


def test_keras_load_model_restores_adasum_wrap(tmp_path):
    x = np.random.RandomState(0).randn(16, 2).astype(np.float32)
    y = np.zeros((16, 1), np.float32)

    def build(hvk):
        hvd = ptf if hvk is ptfk else jtf
        return _dense_model(hvk, hvd.DistributedOptimizer(
            tf.keras.optimizers.SGD(learning_rate=0.1), op=hvd.Adasum))

    out = [_save_and_load(hvk, build, x, y, str(tmp_path / f"{i}.keras"))
           for i, hvk in enumerate((ptfk, jtfk))]
    for restored, _ in out:
        assert type(restored.optimizer).__name__ == "AdasumSGD"
        assert getattr(restored.optimizer, "_hvd_wrapped", False)
    np.testing.assert_allclose(out[0][1]["loss"], out[1][1]["loss"],
                               rtol=TOL)


def test_keras_warmup_momentum_correction_restores():
    x = np.zeros((16, 2), np.float32)
    y = np.zeros((16, 1), np.float32)
    for hvk in (ptfk, jtfk):
        model, _ = _fit_history(
            hvk, lambda h: _dense_model(h, h.DistributedOptimizer(
                tf.keras.optimizers.SGD(learning_rate=0.1, momentum=0.9))),
            x, y, epochs=2, batch_size=8,
            callbacks=[hvk.callbacks.LearningRateWarmupCallback(
                initial_lr=0.1, warmup_epochs=2)])
        # per-batch LR changes rescale momentum (Goyal et al.) and must
        # restore it after every batch
        assert abs(float(model.optimizer.momentum) - 0.9) < 1e-9
