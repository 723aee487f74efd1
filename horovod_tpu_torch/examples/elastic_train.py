"""Elastic fault-tolerant training, the reference's examples/
elastic_train.py on the port: a small data-parallel SGD loop under
``elastic.launch``; with ``--fault`` a rank is killed mid-training by the
fault-injection registry (``HVDTPU_FAULT_SPEC``) and the job finishes
with the committed state a run without the fault reaches.

    # clean run
    python -m horovod_tpu_torch.examples.elastic_train --np 3

    # rank 1 killed at its 4th step, respawned; rollback + re-rendezvous
    python -m horovod_tpu_torch.examples.elastic_train --np 3 --fault worker_exit:step=4:rank=1

    # no respawn allowed: the world shrinks to 2
    python -m horovod_tpu_torch.examples.elastic_train --np 3 --fault worker_exit:step=4:rank=1 --max-retries 0 --min-workers 2

The workers' collectives ride the launcher's KV store on the host, so
``--cpu`` changes nothing here; it is accepted as every example takes it.
"""

from __future__ import annotations

from . import _common


def train(steps, seed):
    """One worker: ``steps`` committed SGD steps on a deterministic
    per-(step, rank) gradient, so a recovered run reproduces a clean
    one."""
    import numpy as np

    import horovod_tpu_torch.elastic as elastic

    ctx = elastic.context()
    state = elastic.State(w=np.full(8, float(seed)), step=0)

    @elastic.run
    def loop(state):
        while state.step < steps:
            grad = np.full(8, float(state.step + 1) * (ctx.rank + 1))
            state.w = state.w - 0.01 * ctx.allreduce(
                grad, name=f"grad{state.step}")
            state.step += 1
            state.commit()
        return float(state.w[0]), state.step

    return loop(state)


def main(argv=None) -> int:
    p = _common.parser(__doc__)
    p.add_argument("--np", type=int, default=3, dest="num_proc")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--fault", default="",
                   help="HVDTPU_FAULT_SPEC for the workers, e.g. "
                        "worker_exit:step=4:rank=1")
    p.add_argument("--max-retries", type=int, default=3)
    p.add_argument("--min-workers", type=int, default=None)
    p.add_argument("--progress-timeout", type=float, default=300.0,
                   help="the progress-beat budget (s): a rank whose "
                        "training thread hangs is killed and respawned "
                        "after this long without a completed collective")
    args = p.parse_args(argv)

    import horovod_tpu_torch.elastic as elastic
    # the workers unpickle train by its module's name, not as __main__'s
    from horovod_tpu_torch.examples import elastic_train

    env = {}
    if args.fault:
        env["HVDTPU_FAULT_SPEC"] = args.fault
        # a hang is found by the progress beat only: peer timeouts must
        # not be the rescue path
        if "action=hang" in args.fault:
            env["HVDTPU_ELASTIC_TIMEOUT"] = "600"
    results, job = elastic.launch(
        elastic_train.train, args=(args.steps, args.seed),
        np=args.num_proc, env=env, max_retries=args.max_retries,
        min_workers=args.min_workers,
        progress_timeout=args.progress_timeout, timeout=300)
    print(f"final world: {job.world} (epoch {job.epoch})")
    for event in job.trace:
        print(f"  trace: {event}")
    w0 = {r: results[r][0] for r in sorted(results)}
    print(f"w[0] per rank: {w0}", flush=True)
    assert len(set(w0.values())) == 1, "ranks disagree on final state"
    respawned = any(e[0] == "respawn" for e in job.trace)
    if args.fault and args.max_retries > 0:
        assert respawned, "fault spec set but no respawn happened"
        print("recovered: rollback + respawn verified", flush=True)
    _common.report("elastic_train", world=job.world, epoch=job.epoch,
                   w0=sorted(set(w0.values())), respawned=respawned)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
