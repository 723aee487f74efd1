"""hvdtpu-lint for horovod_tpu_torch: SPMD-correctness and concurrency
static analyzer.

Run it (with no paths it lints ``horovod_tpu_torch/`` and
``chip_smoke.py`` against ``horovod_tpu_torch/analysis/baseline.json``)::

    python -m horovod_tpu_torch.analysis
    python -m horovod_tpu_torch.analysis --changed        # fast local loop
    python -m horovod_tpu_torch.analysis --list-rules

The rules, their ids, severities, the finding schema
(``hvdtpu-lint-v1``), the flags and the exit codes are the JAX
package's ``horovod_tpu.analysis``; the vocabulary also knows
``torch.distributed``: ``dist.all_reduce`` and its siblings are
collectives, ``dist.get_rank()`` and the ``RANK`` / ``LOCAL_RANK``
environment are rank reads, and ``group=group_of_axis(A)`` scopes a
collective to axis A.

Two rule families (catalog: ``--list-rules`` / docs/analysis.md):

* ``HVD0xx`` — SPMD schedule correctness: rank-guarded collectives,
  unordered-container iteration, unnamed collectives in conditionals,
  missing initial-state broadcast, import-time topology reads,
  collectives in except handlers, rank-dependent names — and the
  mesh-aware family: interprocedural axis-scoped rank
  taint guarding subgroup collectives (HVD010), runtime-selected
  collective axis sets (HVD011), impurity inside determinism
  contracts (HVD012), rank-tainted trace decisions (HVD013).
* ``HVDC1xx`` — concurrency discipline: lock-order inversions,
  blocking calls under locks, and the signal-path rules (non-reentrant
  locks, logging, blocking calls, unbounded growth reachable from
  death hooks), plus swallowed shutdown exceptions — and the
  RacerD-style data-race family (:mod:`horovod_tpu_torch.analysis.racer`):
  per-field guarded-by inference over thread-escaped lock-owning
  classes, reporting unguarded writes (HVDC108), unguarded reads
  against a disciplined write side (HVDC109), and lock-split
  check-then-act pairs (HVDC110).

The runtime side lives in :mod:`horovod_tpu_torch.analysis.schedule`
(``python -m horovod_tpu_torch.analysis.schedule``): read the
collective sequences torch's flight recorder kept on each rank and
assert every rank issued the identical sequence.

Suppress one finding inline with ``# hvdtpu: disable=HVD001`` (same
line or the line above); acknowledge known false positives in
``analysis/baseline.json`` — every entry needs a ``reason``
(``--prune-baseline`` / ``--strict-baseline`` keep the file honest).

This package is stdlib-only (no torch import), so it runs in bare CI
images and pre-commit hooks.
"""

from .cli import analyze_paths, main  # noqa: F401
from .core import SCHEMA, Finding, Rule  # noqa: F401
from .registry import all_rules  # noqa: F401

__all__ = [
    "analyze_paths",
    "main",
    "all_rules",
    "Finding",
    "Rule",
    "SCHEMA",
]
