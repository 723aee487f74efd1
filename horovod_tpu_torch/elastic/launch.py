"""Python launch API for elastic jobs: ``elastic.launch(fn, np=4)`` (a
port of ``horovod_tpu/elastic/launch.py``).

Pickles the function into the launcher's rendezvous store, drives
``run/runner.py:launch_elastic_job`` (failure detection, blacklist,
respawn, epoch minting), and collects per-rank results from the ranks
that survived to the final world.

Returns ``(results, job)`` where ``results`` maps rank -> value for
every rank of the final world (a shrunken job returns fewer entries)
and ``job`` is the :class:`~..run.runner.ElasticJobResult` whose
``trace`` is the deterministic recovery event list chaos tests compare
across runs.  The function travels as ``run/api.py``'s ``_pickle_func``
ships it (cloudpickle only where a function must travel by value).
"""

from __future__ import annotations

import pickle
import sys
from typing import Any, Dict, Optional, Tuple

from ..run.api import _pickle_func
from ..run.rendezvous import KVStoreClient, KVStoreServer
from ..run.runner import ElasticJobResult, launch_elastic_job

_SCOPE = "elastic"

__all__ = ["launch"]


def launch(
    fn,
    args: tuple = (),
    kwargs: Optional[dict] = None,
    *,
    np: int = 1,
    hosts: Optional[str] = None,
    hostfile: Optional[str] = None,
    env: Optional[Dict[str, str]] = None,
    min_workers: Optional[int] = None,
    max_retries: int = 3,
    heartbeat_timeout: float = 60.0,
    progress_timeout: float = 300.0,
    progress_grace: float = 0.0,
    blacklist_cooldown: float = 10.0,
    dump_grace_secs: float = 5.0,
    timeout: Optional[float] = None,
    live_stats_secs: Optional[float] = None,
    live_history: Optional[str] = None,
) -> Tuple[Dict[int, Any], ElasticJobResult]:
    """Run ``fn(*args, **kwargs)`` on ``np`` elastic workers.

    ``fn`` runs under the ambient elastic context
    (``horovod_tpu_torch.elastic.context()``); wrap its training loop
    with ``elastic.run`` and keep its state in an ``elastic.State`` to
    get rollback-and-resume on worker failure.  ``dump_grace_secs``: a
    rank declared dead gets SIGUSR1 + SIGTERM and this long to dump its
    flight recorder before SIGKILL.  ``live_stats_secs`` /
    ``live_history``: the live telemetry plane
    (:func:`~..run.runner.launch_elastic_job`).
    """
    from ..run.allocate import is_local_host  # noqa: PLC0415
    from ..run.runner import _resolve_host_slots  # noqa: PLC0415

    host_slots = (_resolve_host_slots(hosts, hostfile, "localhost")
                  if hosts or hostfile else [])
    all_local = all(is_local_host(h.hostname) for h in host_slots)
    server = KVStoreServer(bind_all=not all_local)
    server.start()
    kv = KVStoreClient(f"127.0.0.1:{server.port}", server.secret)
    kv.put(_SCOPE, "func", _pickle_func(fn, args, kwargs or {}))
    try:
        job = launch_elastic_job(
            [sys.executable, "-m", "horovod_tpu_torch.elastic.worker"],
            np,
            hosts=hosts,
            hostfile=hostfile,
            env=env,
            min_workers=min_workers,
            max_retries=max_retries,
            heartbeat_timeout=heartbeat_timeout,
            progress_timeout=progress_timeout,
            progress_grace=progress_grace,
            blacklist_cooldown=blacklist_cooldown,
            dump_grace_secs=dump_grace_secs,
            job_timeout=timeout,
            kv_server=server,
            live_stats_secs=live_stats_secs,
            live_history=live_history,
        )
        results: Dict[int, Any] = {}
        for rank in job.world:
            blob = kv.wait(_SCOPE, f"result_{rank}", timeout=30)
            ok, value = pickle.loads(blob)
            if not ok:  # pragma: no cover - monitor aborts first
                raise RuntimeError(f"rank {rank} raised:\n{value}")
            results[rank] = value
        return results, job
    finally:
        server.stop()
