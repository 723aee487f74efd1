"""Estimator API: train on a dataset, get a fitted transformer back
(counterpart of ``horovod_tpu/estimator.py``; reference: the Spark
estimators, horovod/spark/{keras,torch}/estimator.py and
horovod/spark/common/{estimator,params,store}.py).

An :class:`Estimator` is configured with a model, an optimizer factory, a
loss and a :class:`~horovod_tpu_torch.checkpoint.Store`; ``fit(data)``
runs data-parallel training and returns a :class:`Model` whose
``transform`` / ``predict`` run batched inference.  Backends:

* ``"local"`` — in this process, on this process's GPU (``cuda``) unless
  ``use_cpu``; a process not yet in a world opens a world of one.
* ``"launcher"`` — ``np_workers`` worker processes through
  :func:`horovod_tpu_torch.run.run`, one GPU each (``use_cpu``: gloo on
  the CPU).
* a callable — an executor of :mod:`horovod_tpu_torch.cluster`
  (``local_executor``, ``spark_executor`` or an adapter), as the
  reference's estimators train inside Spark tasks.

Every backend runs one loop (:func:`_train_rank_sharded`): each rank takes
its slice of every global batch, and the gradients are averaged across
ranks by :class:`~horovod_tpu_torch.optim.DistributedOptimizer` over
``torch.distributed`` (the reference reduces under ``shard_map`` on its
local path and through the eager engine on its launcher path).

Where the port differs from the reference: ``model`` is an
``nn.Module`` (its own parameters are the initial weights, broadcast from
rank 0; ``fit`` trains a copy and leaves it as it was), and ``optimizer``
is a factory ``params -> torch.optim.Optimizer`` (for example
``functools.partial(torch.optim.Adam, lr=1e-2)``) in place of an optax
transformation.  The default loss is ``F.cross_entropy`` on integer
labels.  Checkpoints and run metadata go through the Store, so
:meth:`Model.load` rehydrates a trained transformer from the store alone.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .checkpoint import (
    Store,
    latest_checkpoint_step,
    restore_checkpoint,
    save_checkpoint,
)

__all__ = ["Estimator", "Model"]


def _default_loss(logits, labels):
    """Softmax cross-entropy on integer labels (the reference estimators
    default to categorical cross-entropy for classifiers)."""
    return F.cross_entropy(logits.float(), labels.long())


def _state_np(model: torch.nn.Module) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy()
            for k, v in model.state_dict().items()}


def _state_tensors(params: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in params.items()}


class Estimator:
    """Distributed training estimator (reference: the KerasEstimator /
    TorchEstimator parameters, horovod/spark/common/params.py).

    * ``model`` — an ``nn.Module`` holding the initial weights.
    * ``optimizer`` — ``params -> torch.optim.Optimizer``, wrapped in
      :class:`~horovod_tpu_torch.optim.DistributedOptimizer`.
    * ``loss`` — ``loss(outputs, labels) -> scalar``; default softmax
      cross-entropy with integer labels.
    * ``feature_col`` / ``label_col`` — keys into the ``fit`` data dict.
    * ``batch_size`` (global, split over the ranks), ``epochs``,
      ``shuffle`` (a ``RandomState(seed + epoch)`` permutation).
    * ``store`` / ``run_id`` — where checkpoints and metadata land.
    * ``backend`` — ``"local"``, ``"launcher"`` or a cluster executor.
    * ``np_workers`` — world size of the launcher and cluster backends
      (default 2).
    * ``use_cpu`` — train on the CPU (gloo) instead of the GPUs.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        optimizer: Callable,
        *,
        loss: Optional[Callable] = None,
        feature_col: str = "features",
        label_col: str = "label",
        batch_size: int = 32,
        epochs: int = 1,
        shuffle: bool = True,
        seed: int = 0,
        store: Optional[Store] = None,
        run_id: str = "default",
        backend="local",
        np_workers: Optional[int] = None,
        use_cpu: bool = False,
        timeout: Optional[float] = 600.0,
        checkpoint_every_epochs: int = 1,
        verbose: bool = False,
    ):
        if backend not in ("local", "launcher") and not callable(backend):
            raise ValueError(
                f"unknown backend {backend!r}: expected 'local', 'launcher' "
                "or a horovod_tpu_torch.cluster executor"
            )
        self.model = model
        self.optimizer = optimizer
        self.loss = loss or _default_loss
        self.feature_col = feature_col
        self.label_col = label_col
        self.batch_size = batch_size
        self.epochs = epochs
        self.shuffle = shuffle
        self.seed = seed
        self.store = store
        self.run_id = run_id
        self.backend = backend
        self.np_workers = np_workers
        self.use_cpu = use_cpu
        self.timeout = timeout
        self.checkpoint_every_epochs = checkpoint_every_epochs
        self.verbose = verbose

    def fit(self, data: Dict[str, np.ndarray]) -> "Model":
        """Train on ``data`` (a dict of equally long arrays) and return the
        fitted :class:`Model` (reference: Estimator.fit(df) -> Model)."""
        x = np.asarray(data[self.feature_col])
        y = np.asarray(data[self.label_col])
        if len(x) != len(y):
            raise ValueError(
                f"feature/label length mismatch: {len(x)} vs {len(y)}"
            )
        if self.backend == "local":
            params, history = _train_local(self._config(), x, y)
        elif callable(self.backend):
            params, history = _train_cluster(self._config(), x, y)
        else:
            params, history = _train_launcher(self._config(), x, y)
        if self.store is not None:
            self.store.write_metadata({
                "run_id": self.run_id,
                "epochs": self.epochs,
                "batch_size": self.batch_size,
                "history": history,
                "model": type(self.model).__name__,
            }, self.run_id)
        return Model(
            self.model,
            params,
            feature_col=self.feature_col,
            history=history,
            store=self.store,
            run_id=self.run_id,
            device="cpu" if self.use_cpu else None,
        )

    def _config(self) -> dict:
        return {
            "model": self.model,
            "optimizer": self.optimizer,
            "loss": self.loss,
            "batch_size": self.batch_size,
            "epochs": self.epochs,
            "shuffle": self.shuffle,
            "seed": self.seed,
            # resolved through the (possibly subclassed) Store here, so
            # the training loops and Model.load agree on the layout
            "ckpt_dir": (self.store.checkpoint_dir(self.run_id)
                         if self.store is not None else None),
            "run_id": self.run_id,
            "np_workers": self.np_workers,
            "backend_executor": (self.backend if callable(self.backend)
                                 else None),
            "use_cpu": self.use_cpu,
            "timeout": self.timeout,
            "checkpoint_every_epochs": self.checkpoint_every_epochs,
            "verbose": self.verbose,
        }


# ---------------------------------------------------------------------------
# training loops
# ---------------------------------------------------------------------------


def _epoch_order(n, epoch, seed, shuffle):
    if not shuffle:
        return np.arange(n)
    return np.random.RandomState(seed + epoch).permutation(n)


def _should_checkpoint(epoch: int, cfg: dict) -> bool:
    """Cadence epochs plus always the final epoch, so the store's latest
    checkpoint matches the params ``fit`` returns."""
    last = epoch + 1 == cfg["epochs"]
    return last or (epoch + 1) % cfg["checkpoint_every_epochs"] == 0


def _train_local(cfg: dict, x: np.ndarray, y: np.ndarray):
    """In this process: joins (or opens, as a world of one) the
    ``torch.distributed`` world on the GPU, or the CPU with ``use_cpu``."""
    from . import basics  # noqa: PLC0415

    want = "cpu" if cfg["use_cpu"] else "cuda"
    if not basics.is_initialized():
        basics.init(device="cpu" if cfg["use_cpu"] else None)
    if basics.device().type != want:
        raise ValueError(
            f"Estimator(use_cpu={cfg['use_cpu']}) in a process whose world "
            f"is on {basics.device()}")
    return _train_rank_sharded(cfg, x, y)


def _train_rank_sharded(cfg: dict, x: np.ndarray, y: np.ndarray):
    """One rank's data-parallel loop: rank r takes rows
    ``[r * b, (r + 1) * b)`` of every global batch (b = batch_size /
    world), and ``DistributedOptimizer`` averages the gradients.  Returns
    ``(state_dict as numpy, history)``; the history's losses are the
    world's mean per step, averaged over each epoch."""
    from . import basics  # noqa: PLC0415
    from .ops.collectives import Average, allreduce  # noqa: PLC0415
    from .optim import DistributedOptimizer, broadcast_parameters  # noqa: PLC0415

    rank, size = basics.rank(), basics.size()
    bs = cfg["batch_size"]
    if bs % size:
        raise ValueError(f"batch_size {bs} not divisible by {size} workers")
    per_rank = bs // size
    n = len(x)
    steps_per_epoch = n // bs
    if steps_per_epoch == 0:
        raise ValueError(f"dataset of {n} rows < batch_size {bs}")
    dev = basics.device()
    model = copy.deepcopy(cfg["model"]).to(dev)
    model.train()
    if size > 1:
        broadcast_parameters(model.state_dict(), root_rank=0)
    opt = DistributedOptimizer(cfg["optimizer"](model.parameters()))
    loss_fn = cfg["loss"]
    history = []
    for epoch in range(cfg["epochs"]):
        order = _epoch_order(n, epoch, cfg["seed"], cfg["shuffle"])
        losses = []
        for s in range(steps_per_epoch):
            base = s * bs + rank * per_rank
            idx = order[base:base + per_rank]
            xb = torch.as_tensor(x[idx], device=dev)
            yb = torch.as_tensor(y[idx], device=dev)
            opt.zero_grad()
            loss = loss_fn(model(xb), yb)
            loss.backward()
            opt.step()
            loss = loss.detach().float()
            if size > 1:
                loss = allreduce(loss, Average)
            losses.append(loss)
        history.append({"epoch": epoch,
                        "loss": float(torch.stack(losses).mean())})
        if cfg["verbose"] and rank == 0:
            print(f"[estimator] epoch {epoch}: loss "
                  f"{history[-1]['loss']:.4f}", flush=True)
        if cfg["ckpt_dir"] and _should_checkpoint(epoch, cfg):
            save_checkpoint(cfg["ckpt_dir"],
                            {"params": _state_tensors(_state_np(model))},
                            step=epoch + 1)
    return _state_np(model), history


def _launcher_worker(cfg: dict, x: np.ndarray, y: np.ndarray):
    """Each launcher or cluster process: join the job's world (gloo on the
    CPU with ``use_cpu``), train, leave."""
    from . import basics  # noqa: PLC0415

    basics.init(device="cpu" if cfg["use_cpu"] else None)
    try:
        return _train_rank_sharded(cfg, x, y)
    finally:
        basics.shutdown()


def _train_launcher(cfg: dict, x: np.ndarray, y: np.ndarray):
    from .run import run  # noqa: PLC0415

    results = run(_launcher_worker, (cfg, x, y), np=cfg["np_workers"] or 2,
                  use_cpu=cfg["use_cpu"], timeout=cfg["timeout"])
    return results[0]


def _train_cluster(cfg: dict, x: np.ndarray, y: np.ndarray):
    """Train inside cluster task slots (reference: the Spark estimators
    over horovod.spark.run)."""
    from .cluster import run_on_cluster  # noqa: PLC0415

    # the executor may close over unpicklable scheduler handles (a
    # SparkContext); the workers never need it
    worker_cfg = {k: v for k, v in cfg.items() if k != "backend_executor"}
    env = {"CUDA_VISIBLE_DEVICES": ""} if cfg["use_cpu"] else {}
    results = run_on_cluster(
        _launcher_worker, (worker_cfg, x, y),
        num_proc=cfg["np_workers"] or 2, executor=cfg["backend_executor"],
        job_timeout=cfg["timeout"], env=env,
    )
    return results[0]


# ---------------------------------------------------------------------------
# Model transformer
# ---------------------------------------------------------------------------


class Model:
    """A fitted model transformer (reference: KerasModel / TorchModel,
    Spark Transformers applying the trained net to a DataFrame).

    ``params`` is the trained state dict (numpy arrays, as ``fit`` returns
    it); the transformer runs a copy of ``model`` holding it, on
    ``device`` (the GPU unless ``"cpu"``).  ``transform(data)`` adds a
    prediction column; ``predict(batch)`` returns the raw outputs;
    ``save`` / ``load`` persist through the Store.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        params: Dict[str, np.ndarray],
        *,
        feature_col: str = "features",
        output_col: str = "prediction",
        history: Optional[list] = None,
        store: Optional[Store] = None,
        run_id: str = "default",
        batch_size: int = 1024,
        device=None,
    ):
        self.params = {k: np.asarray(v) for k, v in params.items()}
        self.feature_col = feature_col
        self.output_col = output_col
        self.history = history or []
        self.store = store
        self.run_id = run_id
        self.batch_size = batch_size
        self.device = torch.device("cuda" if device is None else device)
        self.model = copy.deepcopy(model)
        self.model.load_state_dict(_state_tensors(self.params))
        self.model.to(self.device).eval()

    def predict(self, batch: np.ndarray) -> np.ndarray:
        """Raw model outputs for one feature batch."""
        with torch.no_grad():
            out = self.model(torch.as_tensor(np.asarray(batch),
                                             device=self.device))
        return out.float().cpu().numpy()

    def transform(self, data: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Batched inference over a data dict: adds ``output_col`` with the
        argmax class (the reference transformers' classifier convention)
        and ``output_col + "_logits"`` with the outputs."""
        x = np.asarray(data[self.feature_col])
        outs = [self.predict(x[s:s + self.batch_size])
                for s in range(0, len(x), self.batch_size)]
        logits = np.concatenate(outs) if outs else np.zeros((0,))
        out = dict(data)
        out[self.output_col] = (logits.argmax(-1) if logits.ndim > 1
                                else logits)
        out[self.output_col + "_logits"] = logits
        return out

    def save(self) -> None:
        if self.store is None:
            raise ValueError("Model has no store; pass store= to Estimator")
        ckpt_dir = self.store.checkpoint_dir(self.run_id)
        step = (latest_checkpoint_step(ckpt_dir) or 0) + 1
        save_checkpoint(ckpt_dir, {"params": _state_tensors(self.params)},
                        step=step)
        self.store.write_metadata(
            {"run_id": self.run_id, "history": self.history,
             "model": type(self.model).__name__},
            self.run_id,
        )

    @classmethod
    def load(
        cls,
        model: torch.nn.Module,
        store: Store,
        run_id: str = "default",
        *,
        template_params=None,
        feature_col: str = "features",
        device=None,
    ) -> "Model":
        """Rehydrate from the store's latest checkpoint (reference:
        Model.load).  ``template_params`` (a state dict with the
        checkpoint's structure and dtypes) defaults to ``model``'s own."""
        ckpt_dir = store.checkpoint_dir(run_id)
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        if template_params is None:
            template_params = {k: v.detach().cpu()
                               for k, v in model.state_dict().items()}
        state = restore_checkpoint(
            ckpt_dir, {"params": _state_tensors(
                {k: np.asarray(v) for k, v in template_params.items()})},
            step=step, broadcast=False,
        )
        meta = store.read_metadata(run_id) or {}
        return cls(
            model,
            {k: v.numpy() for k, v in state["params"].items()},
            feature_col=feature_col,
            history=meta.get("history", []),
            store=store,
            run_id=run_id,
            device=device,
        )
