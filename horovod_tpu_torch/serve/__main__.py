"""Serving worker CLI: one rank of a continuous-batching fleet (a port
of ``horovod_tpu/serve/__main__.py``).

Spawned by ``hvdrun --elastic --serve`` (which also arms the ingest
front door on its rendezvous store)::

    python -m horovod_tpu_torch.run --elastic --serve -np 2 -- \\
        python -m horovod_tpu_torch.serve --size small --slots 16

Mirrors ``elastic/worker.py``'s lifecycle (heartbeat immediately,
epoch-qualified error publishing) with the function baked in instead of
fetched: the serving loop :func:`~.service.serve_worker`.  Model geometry
comes from flags, each falling back to the HVDTPU_SERVE_* env the
launcher forwards — so one ``--serve`` invocation configures the whole
fleet.  Each rank serves on its GPU (``cuda:local_rank``); ``--cpu``
serves on the CPU.  The drain summary is printed as one JSON line,
``{"serve_summary": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
import traceback

from ..utils import env as envmod


def parse_spec(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.serve",
        description="One serving rank (run under hvdrun --elastic --serve).",
    )
    p.add_argument("--size", default=None,
                   help="gpt() model family entry (default nano)")
    p.add_argument("--slots", type=int, default=None,
                   help="decode slot pool size (default 4)")
    p.add_argument("--max-len", type=int, default=None,
                   help="slot cache length (default: the model's max_len)")
    p.add_argument("--seed", type=int, default=None,
                   help="params init seed + sampling root, identical "
                        "on every rank")
    p.add_argument("--kv-mode", default=None,
                   choices=["paged", "contiguous"],
                   help="KV cache layout (default paged: block-table "
                        "pages, admission judged in free pages)")
    p.add_argument("--page-size", type=int, default=None,
                   help="KV page size in token rows (default 16)")
    p.add_argument("--kv-pages", type=int, default=None,
                   help="KV page-pool size (default: worst case)")
    p.add_argument("--width", type=int, default=None,
                   help="width-sharded fleet: np//width serving groups "
                        "(default 0 = replicated); above 1 the ranks of a "
                        "group each hold a Megatron shard of the model")
    p.add_argument("--attention", default="reference",
                   choices=["reference", "flash"],
                   help="attention implementation of the served model's "
                        "forward (default reference; decode and prefill "
                        "attend with their own einsums either way)")
    p.add_argument("--cpu", action="store_true",
                   help="serve on the CPU instead of this rank's GPU")
    p.add_argument("--weights-dir", default=None,
                   help="weight hot-swap source: sharded-checkpoint "
                        "directory a training job publishes versions "
                        "into (default: HVDTPU_SERVE_WEIGHTS_DIR, "
                        "unset = hot-swap off)")
    p.add_argument("--swap-poll-steps", type=int, default=None,
                   help="serving steps between hot-swap manifest "
                        "polls (default 16)")
    p.add_argument("--slo-ttft-ms", type=float, default=None,
                   help="time-to-first-token objective ceiling in ms "
                        "for --slo-class requests (unset = no ttft "
                        "objective)")
    p.add_argument("--slo-tpot-ms", type=float, default=None,
                   help="per-output-token objective ceiling in ms for "
                        "--slo-class requests (unset = no tpot "
                        "objective)")
    p.add_argument("--slo-objective", type=float, default=None,
                   help="fraction of requests that must meet the "
                        "ceilings (default 0.99: a 1%% error budget "
                        "the burn-rate alerts spend against)")
    p.add_argument("--slo-class", default=None,
                   help="which SLO class the ceilings apply to "
                        "(default interactive)")
    args = p.parse_args(argv)

    import os  # noqa: PLC0415

    def pick(flag, env_name, cast, default):
        if flag is not None:
            return flag
        raw = os.environ.get(env_name)
        return cast(raw) if raw not in (None, "") else default

    spec = {
        "size": pick(args.size, envmod.SERVE_MODEL, str, "nano"),
        "num_slots": pick(args.slots, envmod.SERVE_SLOTS, int, 4),
        "seed": pick(args.seed, envmod.SERVE_SEED, int, 0),
        "kv_mode": pick(args.kv_mode, envmod.SERVE_KV_MODE, str,
                        "paged"),
        "page_size": pick(args.page_size, envmod.SERVE_PAGE_SIZE, int,
                          16),
        "width": pick(args.width, envmod.SERVE_WIDTH, int, 0),
        "overrides": {"attention_impl": args.attention},
    }
    if args.cpu:
        spec["device"] = "cpu"
    kv_pages = pick(args.kv_pages, envmod.SERVE_KV_PAGES, int, 0)
    if kv_pages:
        spec["kv_pages"] = kv_pages
    max_len = pick(args.max_len, envmod.SERVE_MAX_LEN, int, 0)
    if max_len:
        spec["max_len"] = max_len
    weights_dir = pick(args.weights_dir, envmod.SERVE_WEIGHTS_DIR,
                       str, None)
    if weights_dir:
        spec["weights_dir"] = weights_dir
        spec["swap_poll_steps"] = pick(
            args.swap_poll_steps, envmod.SERVE_SWAP_POLL_STEPS, int, 16
        )
    # Tenant-aware admission: fleet-wide (every rank must build the
    # identical TenantQoS), so it travels the launcher-forwarded env
    # like the model geometry does.
    tenant_budget = pick(None, envmod.SERVE_TENANT_BUDGET, int, 0)
    if tenant_budget:
        spec["tenants"] = {"budget_tokens": tenant_budget}
    # SLO objectives (obs/slo.py): fleet-wide like the QoS policy —
    # every rank must judge the identical targets, so they ride the
    # launcher-forwarded env with flag overrides.  Classes without a
    # target never alert (untagged traffic trips nothing).
    slo_ttft = pick(args.slo_ttft_ms, envmod.SERVE_SLO_TTFT_MS,
                    float, 0.0)
    slo_tpot = pick(args.slo_tpot_ms, envmod.SERVE_SLO_TPOT_MS,
                    float, 0.0)
    if slo_ttft or slo_tpot:
        target = {
            "objective": pick(args.slo_objective,
                              envmod.SERVE_SLO_OBJECTIVE, float, 0.99),
        }
        if slo_ttft:
            target["ttft_ms"] = slo_ttft
        if slo_tpot:
            target["tpot_ms"] = slo_tpot
        cls = pick(args.slo_class, envmod.SERVE_SLO_CLASS, str,
                   "interactive")
        spec["slo"] = {cls: target}
    return spec


def main(argv=None) -> int:
    spec = parse_spec(argv)

    from ..elastic.context import ElasticContext, context  # noqa: PLC0415
    from ..elastic.exceptions import HorovodShutdownError  # noqa: PLC0415
    from .service import serve_worker  # noqa: PLC0415

    ctx = context()
    if not isinstance(ctx, ElasticContext):
        print(
            "python -m horovod_tpu_torch.serve must be spawned by the elastic "
            "launcher (hvdrun --elastic --serve); HVDTPU_ELASTIC_KV is "
            "unset", file=sys.stderr,
        )
        return 2
    ctx.start_heartbeat()
    try:
        summary = serve_worker(spec)
        print(json.dumps({"serve_summary": summary}), flush=True)
        return 0
    except HorovodShutdownError:
        # Outlived the retry budget / dropped from the world: exit like
        # a crash so the launcher's monitor decides, not this rank.
        return 1
    except BaseException:
        # Epoch-qualified, a plain string: the launcher reads it with
        # pickle and aborts the job with it.
        try:
            ctx.kv.put(
                "elastic", f"error_{ctx.rank}_{ctx.epoch}",
                pickle.dumps(traceback.format_exc()),
            )
        except Exception:
            pass
        return 1
    finally:
        ctx.stop_heartbeat()


if __name__ == "__main__":
    sys.exit(main())
