"""The Estimator API, the reference's examples/estimator_train.py (its
Spark estimator examples) on the port: configure a model, an optimizer
and a store, fit on a data dict, get a Model transformer back.  The
Store's directory is ``--store-dir`` (default: one under the temporary
directory).

    python -m horovod_tpu_torch.examples.estimator_train
"""

from __future__ import annotations

import functools
import os
import tempfile

import numpy as np
import torch

from . import _common


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--samples", type=int, default=2048)
    p.add_argument("--store-dir", default=os.path.join(
        tempfile.gettempdir(), "hvdtpu_estimator_demo"))
    args = p.parse_args(argv)

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import MLP

    dev = _common.init(args)
    rng = np.random.RandomState(args.seed)
    n = args.samples
    x = np.concatenate([rng.randn(n // 2, 16).astype(np.float32) + 1.5,
                        rng.randn(n // 2, 16).astype(np.float32) - 1.5])
    y = np.concatenate([np.zeros(n // 2, np.int64), np.ones(n // 2, np.int64)])

    store = hvd.LocalStore(args.store_dir)
    est = hvd.Estimator(
        MLP(16, features=(64,), num_classes=2).to(dev),
        functools.partial(torch.optim.Adam, lr=1e-3),
        batch_size=64, epochs=args.epochs, store=store, run_id="demo",
        use_cpu=dev.type == "cpu", verbose=True)
    model = est.fit({"features": x, "label": y})

    out = model.transform({"features": x, "label": y})
    acc = float((out["prediction"] == y).mean())
    history = store.read_metadata("demo")["history"]
    print(f"train accuracy: {acc:.3f}")
    print(f"metadata: {history[-1]}", flush=True)
    _common.report("estimator_train", hvd.rank(), accuracy=acc,
                   history=history)
    hvd.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
