"""Distributed Keras MNIST through the port's Keras frontend
(``interop.tf_keras``), the reference's examples/keras_mnist.py (its
keras_mnist_advanced.py recipe):

    1. hvd.init()
    2. wrap the optimizer:  model.compile(optimizer=hvd.DistributedOptimizer(...))
    3. model.fit(callbacks=[BroadcastGlobalVariablesCallback(0),
                            MetricAverageCallback(),
                            LearningRateWarmupCallback(...)])

    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.keras_mnist --smoke

Needs TensorFlow; without it ``main`` raises ``ImportError`` naming it.
Keras tensors live on the host, so the world is on the CPU (gloo) with or
without ``--cpu``.
"""

from __future__ import annotations

import numpy as np

from . import _common


def synthetic_mnist(n: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 28, 28, 1).astype(np.float32)
    w = np.random.RandomState(42).randn(28 * 28, 10).astype(np.float32)
    y = (x.reshape(n, -1) @ w).argmax(axis=1).astype(np.int32)
    return x, y


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--epochs", type=int, default=4)
    args = p.parse_args(argv)
    if args.smoke:
        args.epochs = 1
    tf, hvd = _common.import_tensorflow("keras_mnist", "tf_keras")

    hvd.init()
    x, y = synthetic_mnist(512 if args.smoke else 4096,
                           seed=args.seed + hvd.rank())
    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(16, 3, activation="relu",
                               input_shape=(28, 28, 1)),
        tf.keras.layers.MaxPooling2D(),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(10),
    ])
    # the learning rate scaled by the world size and warmed up over the
    # first epochs (the reference's keras_mnist_advanced.py recipe)
    model.compile(
        optimizer=hvd.DistributedOptimizer(tf.keras.optimizers.SGD(
            learning_rate=0.01 * hvd.size(), momentum=0.9)),
        loss=tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True),
        metrics=["accuracy"])
    hist = model.fit(
        x, y, batch_size=32, epochs=args.epochs,
        verbose=2 if hvd.rank() == 0 else 0,
        callbacks=[
            hvd.callbacks.BroadcastGlobalVariablesCallback(0),
            hvd.callbacks.MetricAverageCallback(),
            hvd.callbacks.LearningRateWarmupCallback(
                initial_lr=0.01 * hvd.size(), warmup_epochs=2),
        ])
    if hvd.rank() == 0:
        print(f"final loss {hist.history['loss'][-1]:.4f} "
              f"acc {hist.history['accuracy'][-1]:.3f}", flush=True)
    _common.report("keras_mnist", hvd.rank(), world=hvd.size(),
                   losses=[float(v) for v in hist.history["loss"]])
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
