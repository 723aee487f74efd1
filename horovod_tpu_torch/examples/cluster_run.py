"""Run a job inside cluster task slots, the reference's examples/
cluster_run.py (horovod.spark.run's topology) on the port.  With Spark::

    import horovod_tpu_torch.cluster as cluster
    results = cluster.run_on_cluster(
        train_fn, num_proc=sc.defaultParallelism,
        executor=cluster.spark_executor(sc))

This example uses the local subprocess executor, so it runs anywhere:

    python -m horovod_tpu_torch.examples.cluster_run --cpu
"""

from __future__ import annotations

from . import _common


def train_fn(steps: int, device):
    """One rank's job: ``steps`` averaged allreduces of a per-rank vector."""
    import torch

    import horovod_tpu_torch as hvd

    hvd.init(device=device)
    r = hvd.rank()
    total = 0.0
    for step in range(steps):
        g = torch.full((8,), float(r + 1 + step), device=hvd.device())
        total += float(hvd.allreduce(g, op=hvd.Average).sum())
    hvd.shutdown()
    return {"rank": r, "metric": total}


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--np", type=int, default=2, dest="num_proc")
    p.add_argument("--steps", type=int, default=5)
    args = p.parse_args(argv)

    from horovod_tpu_torch.cluster import local_executor, run_on_cluster
    # the slots unpickle train_fn by its module's name, not as __main__'s
    from horovod_tpu_torch.examples import cluster_run

    results = run_on_cluster(
        cluster_run.train_fn, (args.steps, _common.device_arg(args)),
        num_proc=args.num_proc, executor=local_executor())
    for res in results:
        print(f"rank {res['rank']}: metric {res['metric']:.1f}", flush=True)
    _common.report("cluster_run", metrics=[res["metric"] for res in results])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
