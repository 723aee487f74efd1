"""TF2 eager MNIST with ``DistributedGradientTape`` through the port's
TensorFlow frontend (``interop.tf``), the reference's examples/
tf2_mnist.py (its tensorflow2_mnist.py): the tape wraps the gradient
computation, the gradients are averaged across ranks by the eager
engine, and the variables are broadcast from rank 0 after the first
batch.

    python -m horovod_tpu_torch.examples.tf2_mnist
    python -m horovod_tpu_torch.run -np 2 python -m horovod_tpu_torch.examples.tf2_mnist

Needs TensorFlow; without it ``main`` raises ``ImportError`` naming it.
TF tensors live on the host, so the world is on the CPU (gloo) with or
without ``--cpu``.
"""

from __future__ import annotations

import numpy as np

from . import _common


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--steps", type=int, default=16)
    args = p.parse_args(argv)
    tf, hvd = _common.import_tensorflow("tf2_mnist", "tf")

    hvd.init()
    tf.keras.utils.set_random_seed(42 + args.seed + hvd.rank())
    # synthetic MNIST-shaped data, one shard per rank as the reference
    # example's tf.data shard() gives
    rng = np.random.RandomState(args.seed + hvd.rank())
    images = rng.rand(512, 28, 28, 1).astype(np.float32)
    labels = rng.randint(0, 10, size=(512,)).astype(np.int64)

    model = tf.keras.Sequential([
        tf.keras.layers.Conv2D(16, 3, activation="relu",
                               input_shape=(28, 28, 1)),
        tf.keras.layers.MaxPooling2D(),
        tf.keras.layers.Flatten(),
        tf.keras.layers.Dense(10),
    ])
    loss_fn = tf.keras.losses.SparseCategoricalCrossentropy(from_logits=True)
    # the learning rate scaled by the world size: the gradient averaged
    # over N ranks stands for an N times larger batch
    opt = tf.keras.optimizers.SGD(0.001 * hvd.size())

    batch, losses = 32, []
    for step in range(args.steps):
        i = (step * batch) % len(images)
        x, y = images[i:i + batch], labels[i:i + batch]
        with hvd.DistributedGradientTape(tf.GradientTape()) as tape:
            logits = model(x, training=True)
            loss = loss_fn(y, logits)
        grads = tape.gradient(loss, model.trainable_variables)
        opt.apply_gradients(zip(grads, model.trainable_variables))
        if step == 0:
            # the first-batch broadcast: every rank runs step 0, so the
            # branch cannot diverge across ranks
            hvd.broadcast_variables(  # hvdtpu: disable=HVD003
                model.variables, root_rank=0)
            opt_vars = opt.variables  # a property in modern Keras,
            if callable(opt_vars):    # a method on legacy optimizers
                opt_vars = opt_vars()
            hvd.broadcast_variables(  # hvdtpu: disable=HVD003
                opt_vars, root_rank=0)
        losses.append(float(loss))
        if step % 5 == 0 and hvd.rank() == 0:
            print(f"step {step:2d} loss {float(loss):.4f}", flush=True)

    avg = float(hvd.allreduce(loss))
    if hvd.rank() == 0:
        print(f"final loss (rank-averaged): {avg:.4f}", flush=True)
    _common.report("tf2_mnist", hvd.rank(), world=hvd.size(),
                   final_loss=avg, losses=losses)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
