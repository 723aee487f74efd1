"""What every part of the benchmark shares: where its files are, how a
cell is found by name, and how the seed becomes generators.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything
that belongs to one configuration, one traffic mix, one cell or one
per-layer metric is a file of its own, found by name:

* ``configs/<config>.json``: the model's sizes, its source and its
  departures from it (``family`` names ``families/<family>.py``);
* ``traffic/<traffic>.json``: the batch, the pool of inputs and the
  training plane's mode;
* ``limits/<workload>.json``: the limits of the comparison that decides
  ``correct``;
* ``metrics/<base>.py`` (and its data file ``<base>.json``, if any, with
  any ``<base>.kernels-<tag>.json`` beside it): the reader of the
  per-layer metrics whose name up to its first dot is ``<base>``
  (``mfu.resnet`` and a later ``mfu.gpt`` share ``metrics/mfu.py``).

No torch import at module scope: the tests import this on any machine.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = ROOT / "BENCHMARK.json"

# top-level module names the benchmark's processes may never hold
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "horovod_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return load_json(SPEC)


class Cell:
    """One workload of ``BENCHMARK.json`` with its files read: ``config``,
    ``traffic`` and ``limits`` (dicts), and the metrics it reports."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = spec() if bench is None else bench
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                           f"{[w['name'] for w in bench['workloads']]}")
        self.entry = found[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg_entry = [c for c in bench["configs"]
                     if c["name"] == self.entry["config"]][0]
        self.config = load_json(ROOT / cfg_entry["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = load_json(HERE / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])]


def make_cell(name: str, chips: int, config: dict, traffic: dict,
              limits: dict, end_to_end: list, per_layer: list) -> Cell:
    """A cell from its parts, not from the files (the tests' tiny
    cells)."""
    cell = Cell.__new__(Cell)
    cell.name, cell.chips, cell.entry = name, chips, {}
    cell.config, cell.traffic, cell.limits = config, traffic, limits
    cell.end_to_end, cell.per_layer = end_to_end, per_layer
    return cell


def sub_seed(seed: int, what: str) -> int:
    """A 63-bit seed for the stream ``what`` of run seed ``seed``: any
    whole number, however large, gives the same value on every machine."""
    h = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def generator(seed: int, what: str, device):
    """A ``torch.Generator`` on ``device`` seeded for stream ``what``."""
    import torch  # noqa: PLC0415

    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, what))
    return g


def family(name: str):
    """The module ``families/<name>.py``."""
    import importlib  # noqa: PLC0415

    return importlib.import_module(f"benchmark.families.{name}")


def forbidden_modules() -> list:
    """Modules in this process whose top-level name is forbidden, compared
    whole (``horovod_tpu_torch`` is not ``horovod_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN_MODULES)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)
