"""What every example shares: the ``--cpu`` / ``--seed`` flags, ``init``
on the chosen device, and the closing JSON line."""

from __future__ import annotations

import argparse
import json
import sys


def parser(doc: str) -> argparse.ArgumentParser:
    """An argument parser with the flags every example takes."""
    p = argparse.ArgumentParser(description=doc.splitlines()[0])
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (gloo) instead of this process's GPU")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the synthetic data")
    return p


def device_arg(args):
    """``init``'s ``device``: the GPU unless ``--cpu``."""
    return "cpu" if args.cpu else None


def init(args):
    """``horovod_tpu_torch.init`` on the example's device; returns it."""
    import horovod_tpu_torch as hvd  # noqa: PLC0415

    return hvd.init(device=device_arg(args)).device


def report(name: str, rank: int = 0, **fields) -> dict:
    """Print the example's figures as one JSON line (rank 0 only)."""
    doc = {"example": name, **fields}
    if rank == 0:
        print(json.dumps(doc), flush=True)
        sys.stdout.flush()
    return doc


def import_tensorflow(example: str, frontend: str):
    """``tensorflow`` and the port's frontend module ``frontend`` (under
    ``horovod_tpu_torch.interop``), or an ``ImportError`` that names what
    ``example`` needs."""
    import importlib  # noqa: PLC0415

    try:
        tf = importlib.import_module("tensorflow")
    except ImportError as exc:
        raise ImportError(
            f"{example} needs TensorFlow for the port's interop.{frontend} "
            f"frontend, and it is not installed: {exc}") from exc
    return tf, importlib.import_module(f"horovod_tpu_torch.interop.{frontend}")
