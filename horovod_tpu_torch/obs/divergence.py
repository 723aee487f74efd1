"""Cross-rank divergence sentinel: bitwise replication, verified at run
time (counterpart of ``horovod_tpu/obs/divergence.py``).

Every data-parallel rank must hold bitwise-identical parameters.  Data
skew, a nondeterministic kernel or silent data corruption (a bit flip that
survives the allreduce) can break that invisibly for thousands of steps.
This module watches the running job:

* **Digest algebra** (:func:`bit_words`, :func:`digest_words`) — tensors
  are bit-reinterpreted into a uint32 word stream (one zero-extended word
  per element; 8-byte elements split into lo/hi words) and folded through
  two position-mixed multiply-XOR lanes, word for word the reference's, so
  the port's digests equal the reference's on the same bits.  ``+0.0`` vs
  ``-0.0`` and NaN payloads digest differently.
* **On-device digest** (:func:`device_digest`, the counterpart of
  ``jit_digest``) — the same algebra in torch ops on the parameters'
  device, bit-exact with the host path: the host fetches 8 bytes per
  bucket instead of the parameters.  Words ride in int64 and every product
  is taken mod 2^32 through 16-bit halves (two 32-bit factors would
  overflow int64); the XOR reduction, which torch lacks, is a fold in
  log2(n) halving steps of ``bitwise_xor``.
* **Per-bucket digest vector** (:func:`tree_digest_vector`) over the
  overlap plan's :class:`~..optim.overlap.BucketLayout`, plus one digest
  each for the optimizer state and the PRNG key.
* :class:`DivergenceSentinel` — every ``--health-check-steps`` N,
  allgathers the digest vector, names the minority ranks, then descends to
  the first divergent leaf with a second exchange.  Every rank reaches the
  same verdict and the same ``--divergence-action``.  The exchange is the
  eager engine's allgather of int32 bit patterns, or, under the elastic
  launcher, the elastic context's allreduce (each rank's row of a zero
  matrix, summed exactly in int64): the collectives the elastic worker's
  training rides.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.logging import get_logger

LOG = get_logger("obs.divergence")

__all__ = [
    "bit_words",
    "digest_words",
    "digest_array",
    "digest_leaves",
    "blob_digest",
    "tree_digest_vector",
    "leaf_digest_matrix",
    "device_digest",
    "page_state_digest",
    "serve_state_digest",
    "DivergenceReport",
    "DivergenceHalt",
    "DivergenceSentinel",
    "ACTIONS",
]

ACTIONS = ("warn", "dump", "halt")

# Two independent mix lanes: (index stride, odd multiplier, seed).
# Odd multipliers are bijections mod 2^32, so a word that differs at one
# position always changes that lane's XOR fold; two lanes make a
# cross-position cancellation require a simultaneous collision in both.
_LANES = (
    (np.uint32(0x9E3779B9), np.uint32(0x85EBCA6B), np.uint32(0x02E1B213)),
    (np.uint32(0xC2B2AE35), np.uint32(0x27D4EB2F), np.uint32(0x165667B1)),
)
DIGEST_WIDTH = len(_LANES)  # uint32 words per digest


class DivergenceHalt(RuntimeError):
    """Raised on every rank when ``--divergence-action halt`` fires."""


def bit_words(arr) -> np.ndarray:
    """The canonical uint32 word stream of an array's BIT PATTERN: one
    zero-extended word per element for itemsize <= 4, two (lo, hi) words
    per element for itemsize 8.  Per-element (not a raw byte stream) so
    the identical stream is cheap to produce in-graph, where
    ``bitcast_convert_type`` yields one integer per element."""
    a = np.ascontiguousarray(_host(arr))
    size = a.dtype.itemsize
    if size == 1:
        return a.view(np.uint8).ravel().astype(np.uint32)
    if size == 2:
        return a.view(np.uint16).ravel().astype(np.uint32)
    if size == 4:
        return a.view(np.uint32).ravel().copy()
    if size == 8:
        w = a.view(np.uint64).ravel()
        out = np.empty(w.size * 2, dtype=np.uint32)
        out[0::2] = (w & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        out[1::2] = (w >> np.uint64(32)).astype(np.uint32)
        return out
    raise TypeError(f"no bit_words rule for itemsize {size} ({a.dtype})")


def digest_words(words: np.ndarray) -> np.ndarray:
    """Fold a uint32 word stream into the ``(DIGEST_WIDTH,)`` digest.
    Length is mixed in, so a zero-padded stream never digests equal to
    its unpadded prefix."""
    w = np.asarray(words, dtype=np.uint32)
    n = np.uint32(w.size)
    idx = np.arange(w.size, dtype=np.uint32)
    out = np.empty(DIGEST_WIDTH, dtype=np.uint32)
    for lane, (c, m, seed) in enumerate(_LANES):
        if w.size:
            mixed = np.multiply(
                np.bitwise_xor(w, np.multiply(idx, c, dtype=np.uint32)
                               + seed),
                m, dtype=np.uint32,
            )
            acc = np.bitwise_xor.reduce(mixed)
        else:
            acc = np.uint32(0)
        length_mix = np.uint32((int(n) * int(m) + int(c)) & 0xFFFFFFFF)
        out[lane] = np.bitwise_xor(acc, length_mix)
    return out


def _host(t) -> np.ndarray:
    """A tensor's bits as a numpy array (bf16 as its int16 bit pattern:
    numpy has no bfloat16, and the digest reads bits only)."""
    if hasattr(t, "detach"):
        import torch  # noqa: PLC0415

        t = t.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.cpu().numpy()
    return np.asarray(t)


def digest_array(arr) -> np.ndarray:
    """Digest of one array's bit pattern (host side)."""
    return digest_words(bit_words(arr))


def digest_leaves(leaves: Sequence) -> np.ndarray:
    """Digest of several arrays' concatenated word streams — the
    per-bucket digest is over the bucket's leaves in bucket order, the
    same concatenation order ``_bucket_concat`` fuses gradients in."""
    if not leaves:
        return digest_words(np.empty(0, dtype=np.uint32))
    return digest_words(np.concatenate([bit_words(_host(l))
                                        for l in leaves]))


def blob_digest(raw: bytes) -> np.ndarray:
    """Digest of an opaque byte payload (zero-padded to whole words) —
    the serving twin's schedule-doc digest."""
    buf = np.frombuffer(raw, dtype=np.uint8)
    pad = (-buf.size) % 4
    if pad:
        buf = np.concatenate([buf, np.zeros(pad, dtype=np.uint8)])
    return digest_words(buf.view(np.uint32))


# ---------------------------------------------------------------------------
# pytree / bucket digests
# ---------------------------------------------------------------------------


def tree_digest_vector(leaves: Sequence, layout,
                       extras: Sequence[Tuple[str, Sequence]] = (),
                       bucket_digests=None
                       ) -> Tuple[np.ndarray, List[str]]:
    """The exchange vector: per-bucket digests of ``leaves`` (flattened
    params, in ``layout``'s flatten order) followed by one digest per
    named extra component (optimizer state, PRNG key, ...).  Returns
    ``(uint32 vector, component names)`` where component ``i`` owns
    words ``[i*DIGEST_WIDTH, (i+1)*DIGEST_WIDTH)`` — the first
    mismatching word indexes straight into a component."""
    parts: List[np.ndarray] = []
    names: List[str] = []
    for b in layout.buckets:
        if bucket_digests is not None:
            parts.append(np.asarray(bucket_digests[b.index],
                                    dtype=np.uint32))
        else:
            parts.append(digest_leaves([_host(leaves[i])
                                        for i in b.leaf_indices]))
        names.append(f"bucket{b.index}")
    for name, arrs in extras:
        parts.append(digest_leaves([_host(a) for a in arrs]))
        names.append(name)
    return np.concatenate(parts), names


def leaf_digest_matrix(leaves: Sequence, bucket) -> np.ndarray:
    """Per-leaf digests of one bucket, shape ``(n_leaves,
    DIGEST_WIDTH)`` — the descent exchange that turns "bucket 3
    diverged" into "leaf mlp/kernel diverged"."""
    return np.stack([digest_array(_host(leaves[i]))
                     for i in bucket.leaf_indices])


_M32 = 0xFFFFFFFF


def _mulmod32(a, b: int):
    """``(a * b) mod 2^32`` for an int64 tensor ``a`` in [0, 2^32) and a
    constant ``b`` < 2^32, without leaving int64: the product is taken in
    16-bit halves of ``b`` (each partial product < 2^48)."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _device_words(leaf):
    """:func:`bit_words` of one tensor, on its device, as int64 words."""
    import torch  # noqa: PLC0415

    t = leaf.detach().contiguous().reshape(-1)
    size = t.element_size()
    if size == 1:
        return t.view(torch.uint8).to(torch.int64)
    if size == 2:
        return t.view(torch.int16).to(torch.int64) & 0xFFFF
    if size == 4:
        return t.view(torch.int32).to(torch.int64) & _M32
    if size == 8:
        w = t.view(torch.int64)
        return torch.stack([w & _M32, (w >> 32) & _M32], dim=1).reshape(-1)
    raise TypeError(f"no bit_words rule for itemsize {size} ({t.dtype})")


def _xor_fold(rows):
    """XOR-reduce each row of a 2-D int64 tensor whose width is a power
    of two: log2(width) halving steps of ``bitwise_xor``."""
    import torch  # noqa: PLC0415

    while rows.shape[1] > 1:
        h = rows.shape[1] // 2
        rows = torch.bitwise_xor(rows[:, :h], rows[:, h:])
    return rows[:, 0]


def _digest_device_words(w):
    """:func:`digest_words` of an int64 word tensor, on its device: a
    ``(DIGEST_WIDTH,)`` int64 tensor of uint32 values."""
    import torch  # noqa: PLC0415

    n = w.numel()
    lanes = []
    if n:
        idx = torch.arange(n, dtype=torch.int64, device=w.device)
        width = 1 << (n - 1).bit_length()
        mixed = torch.zeros((DIGEST_WIDTH, width), dtype=torch.int64,
                            device=w.device)
        for lane, (c, m, seed) in enumerate(_LANES):
            pos = (_mulmod32(idx, int(c)) + int(seed)) & _M32
            mixed[lane, :n] = _mulmod32(torch.bitwise_xor(w, pos), int(m))
        acc = _xor_fold(mixed)
    else:
        acc = torch.zeros(DIGEST_WIDTH, dtype=torch.int64, device=w.device)
    for lane, (c, m, _) in enumerate(_LANES):
        lanes.append((n * int(m) + int(c)) & _M32)
    mix = torch.tensor(lanes, dtype=torch.int64, device=w.device)
    return torch.bitwise_xor(acc, mix)


def device_digest(layout):
    """The on-device digest (the counterpart of the reference's
    ``jit_digest``): a function mapping the parameters' flat leaves
    (``layout``'s leaf order, any device) to the ``(n_buckets,
    DIGEST_WIDTH)`` digest matrix as an int64 tensor of uint32 values on
    that device, bit-exact with :func:`tree_digest_vector`'s bucket
    prefix.  Unlike the reference's, 8-byte leaves digest here too.
    ``.cpu().numpy().astype(np.uint32)`` fetches it."""
    def digests(*leaves):
        import torch  # noqa: PLC0415

        rows = []
        for b in layout.buckets:
            words = [_device_words(leaves[i]) for i in b.leaf_indices]
            w = torch.cat(words) if words else torch.zeros(
                0, dtype=torch.int64)
            rows.append(_digest_device_words(w))
        return torch.stack(rows)

    return digests


def digest_matrix_host(mat) -> np.ndarray:
    """A :func:`device_digest` result as a uint32 numpy matrix."""
    return mat.detach().cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# the sentinel
# ---------------------------------------------------------------------------


@dataclass
class DivergenceReport:
    """One confirmed divergence, fully localized."""

    step: int
    component: str               # "bucket<i>" | "opt_state" | "prng"
    bucket: Optional[int]        # set when the component is a bucket
    leaf_index: Optional[int]    # flatten-order leaf position
    leaf_name: Optional[str]
    minority_ranks: Tuple[int, ...] = ()
    majority_ranks: Tuple[int, ...] = ()
    detail: str = field(default="", compare=False)

    def describe(self) -> str:
        where = self.component
        if self.leaf_name is not None:
            where += f" (leaf {self.leaf_name})"
        ranks = ",".join(str(r) for r in self.minority_ranks)
        return (f"rank(s) {ranks} diverged from the majority at step "
                f"{self.step} in {where}")


def _default_exchange(vec: np.ndarray, name: str) -> np.ndarray:
    """Allgather the digest words.  Under the elastic launcher: the
    elastic context's allreduce (the collectives its training rides), of
    this rank's row of a zero matrix, summed exactly in int64.
    Otherwise the eager engine's allgather, with the words as int32 bit
    patterns (its dtype table has no uint32): a pure reinterpretation."""
    import os  # noqa: PLC0415

    import torch  # noqa: PLC0415

    if os.environ.get("HVDTPU_ELASTIC_KV"):
        from ..elastic.context import context  # noqa: PLC0415

        ctx = context()
        rows = np.zeros((len(ctx.world), vec.size), dtype=np.int64)
        rows[list(ctx.world).index(ctx.rank)] = vec.astype(np.int64)
        total = ctx.allreduce(rows, name=name, average=False)
        return np.asarray(total).astype(np.uint32).ravel()
    from ..ops import eager  # noqa: PLC0415

    wire = torch.from_numpy(
        np.ascontiguousarray(vec, dtype=np.uint32).view(np.int32))
    out = eager.allgather(wire, name=name)
    return out.numpy().view(np.uint32)


class DivergenceSentinel:
    """Periodic cross-rank digest compare over a bucket layout.

    ``exchange(vec, name) -> (world * len(vec),)`` is injectable so the
    decision logic is testable without an engine; the default is the
    eager ``hvd.allgather``.  Every rank must call :meth:`maybe_check`
    at the same steps with the same component set — the check is itself
    a collective, which every rank must issue alike.
    """

    def __init__(
        self,
        layout,
        *,
        rank: int,
        check_steps: int = 100,
        action: str = "warn",
        exchange: Optional[Callable[[np.ndarray, str], np.ndarray]] = None,
        leaf_names: Optional[Sequence[str]] = None,
        registry=None,
    ):
        if action not in ACTIONS:
            raise ValueError(
                f"divergence action must be one of {ACTIONS}, got "
                f"{action!r}"
            )
        if check_steps < 1:
            raise ValueError(f"check_steps must be >= 1, got {check_steps}")
        self.layout = layout
        self.rank = int(rank)
        self.check_steps = int(check_steps)
        self.action = action
        self.exchange = exchange or _default_exchange
        self.leaf_names = list(leaf_names) if leaf_names else None
        if registry is None:
            from .registry import get_registry  # noqa: PLC0415

            registry = get_registry()
        self._reg = registry
        self.checks = 0
        self.detections = 0

    # ----------------------------------------------------------- checks

    def maybe_check(self, step: int, leaves: Sequence, *,
                    opt_leaves: Optional[Sequence] = None,
                    prng_key=None,
                    bucket_digests=None) -> Optional[DivergenceReport]:
        """Run :meth:`check` when ``step`` lands on the cadence.  All
        ranks share the cadence arithmetic, so either every rank
        exchanges or none does."""
        if step % self.check_steps != 0:
            return None
        return self.check(step, leaves, opt_leaves=opt_leaves,
                          prng_key=prng_key, bucket_digests=bucket_digests)

    def check(self, step: int, leaves: Sequence, *,
              opt_leaves: Optional[Sequence] = None,
              prng_key=None,
              bucket_digests=None) -> Optional[DivergenceReport]:
        """One exchange and compare.  ``bucket_digests``: the buckets'
        digest matrix when the caller already has it (the on-device
        :func:`device_digest`, fetched), so the parameters never leave
        the device unless a divergence needs the per-leaf descent."""
        extras: List[Tuple[str, Sequence]] = []
        if opt_leaves is not None:
            extras.append(("opt_state", list(opt_leaves)))
        if prng_key is not None:
            extras.append(("prng", [prng_key]))
        vec, components = tree_digest_vector(leaves, self.layout,
                                             extras=extras,
                                             bucket_digests=bucket_digests)
        mat = self._gather(vec, f"health.digest.s{step}")
        self.checks += 1
        self._reg.counter("health.divergence.checks").inc()
        self._reg.gauge("health.divergence.last_check_step").set(step)
        if bool((mat == mat[0]).all()):
            self._reg.gauge("health.divergence.alert").set(0)
            return None
        report = self._localize(step, mat, components, leaves)
        self._record(report)
        self._act(report)
        return report

    def _gather(self, vec: np.ndarray, name: str) -> np.ndarray:
        flat = np.asarray(self.exchange(vec, name), dtype=np.uint32)
        world = flat.size // vec.size
        if world * vec.size != flat.size:
            raise ValueError(
                f"digest exchange returned {flat.size} words for a "
                f"{vec.size}-word vector — ragged gather?"
            )
        return flat.reshape(world, vec.size)

    # ------------------------------------------------------ localization

    def _localize(self, step: int, mat: np.ndarray,
                  components: List[str],
                  leaves: Sequence) -> DivergenceReport:
        minority, majority = _partition(mat)
        bad_cols = np.nonzero((mat != mat[majority[0]]).any(axis=0))[0]
        comp_index = int(bad_cols[0]) // DIGEST_WIDTH
        component = components[comp_index]
        bucket = leaf_index = None
        leaf_name = None
        if component.startswith("bucket"):
            bucket = int(component[len("bucket"):])
            leaf_index, leaf_name = self._descend(step, bucket, leaves)
        return DivergenceReport(
            step=int(step),
            component=component,
            bucket=bucket,
            leaf_index=leaf_index,
            leaf_name=leaf_name,
            minority_ranks=tuple(minority),
            majority_ranks=tuple(majority),
        )

    def _descend(self, step: int, bucket_index: int, leaves: Sequence):
        """Second-phase exchange: the divergent bucket's per-leaf
        digests.  Deterministic on every rank (all ranks saw the same
        gathered matrix, so all reach this call or none do)."""
        bucket = self.layout.buckets[bucket_index]
        local = leaf_digest_matrix(leaves, bucket).ravel()
        mat = self._gather(local,
                           f"health.digest.b{bucket_index}.s{step}")
        _, majority = _partition(mat)
        bad = np.nonzero((mat != mat[majority[0]]).any(axis=0))[0]
        if not bad.size:  # raced a repair; keep the bucket verdict
            return None, None
        pos = int(bad[0]) // DIGEST_WIDTH
        leaf_index = bucket.leaf_indices[pos]
        name = (self.leaf_names[leaf_index]
                if self.leaf_names and leaf_index < len(self.leaf_names)
                else f"leaf{leaf_index}")
        return leaf_index, name

    # ----------------------------------------------------------- verdict

    def _record(self, report: DivergenceReport) -> None:
        self.detections += 1
        minority = ",".join(str(r) for r in report.minority_ranks)
        detail = (f"step={report.step} minority={minority} "
                  f"component={report.component}")
        if report.bucket is not None:
            detail += f" bucket={report.bucket}"
        if report.leaf_name is not None:
            detail += f" leaf={report.leaf_name}"
        report.detail = detail
        tags = {"component": report.component}
        if report.leaf_name is not None:
            tags["leaf"] = report.leaf_name
        self._reg.counter("health.divergence.detected", **tags).inc()
        self._reg.gauge("health.divergence.alert").set(1)
        from . import flightrec  # noqa: PLC0415

        flightrec.record("health.divergence", name=report.component,
                         cycle=report.step, detail=detail)
        LOG.error("replication violated: %s", report.describe())

    def _act(self, report: DivergenceReport) -> None:
        if self.action == "warn":
            return
        if self.action == "dump":
            # Leave the evidence NOW: the poisoned state may kill the
            # job (or worse, checkpoint) before any death-path dump.
            from . import flightrec  # noqa: PLC0415
            from .registry import dump_metrics  # noqa: PLC0415

            try:
                flightrec.dump_flight_recorder(trigger="health.divergence")
            except Exception:  # pragma: no cover - defensive
                pass
            try:
                dump_metrics()
            except Exception:  # pragma: no cover - defensive
                pass
            return
        raise DivergenceHalt(
            f"divergence sentinel: {report.describe()} "
            f"(--divergence-action halt)"
        )


def _partition(mat: np.ndarray) -> Tuple[List[int], List[int]]:
    """Split ranks into (minority, majority) by digest-row pattern.
    Majority = the most common row; ties break toward the pattern of
    the lowest rank holding it, so every rank (and every rerun) names
    the same culprit."""
    rows = [tuple(int(x) for x in mat[r]) for r in range(mat.shape[0])]
    counts: dict = {}
    for row in rows:
        counts[row] = counts.get(row, 0) + 1
    best = max(counts.items(),
               key=lambda kv: (kv[1], -rows.index(kv[0])))[0]
    majority = [r for r, row in enumerate(rows) if row == best]
    minority = [r for r, row in enumerate(rows) if row != best]
    return minority, majority


# ---------------------------------------------------------------------------
# serving twin
# ---------------------------------------------------------------------------


def page_state_digest(paged) -> np.ndarray:
    """Digest of a :class:`~..serve.paged.PagedKV` pool's observable
    state: every slot's block-table row + position, plus the free list
    (sorted — the heap's internal order is arrival-dependent, the SET
    of free pages is the invariant)."""
    if paged is None:
        return digest_words(np.empty(0, dtype=np.uint32))
    rows: List[List[int]] = [list(paged.table(s)) + [paged.position(s)]
                             for s in range(paged.num_slots)]
    flat = [x for row in rows for x in row] + sorted(paged._free)
    return digest_array(np.asarray(flat, dtype=np.int32))


def serve_state_digest(sdoc_raw: bytes, paged) -> np.ndarray:
    """The serving twin's per-check digest: broadcast schedule doc
    bytes + page-table state, concatenated.  Replicated ranks of a
    width group must produce identical values every step — the serving
    form of bitwise replication."""
    return np.concatenate([blob_digest(sdoc_raw),
                           page_state_digest(paged)])
