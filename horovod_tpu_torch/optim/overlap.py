"""Backward-overlap gradient plane (counterpart of
``horovod_tpu/optim/overlap.py``).

Horovod's core idea is to reduce each gradient while the rest of the
backward pass still runs (Sergeev & Del Balso 2018, §3).  The
:class:`~horovod_tpu_torch.optim.DistributedOptimizer` does the opposite:
it reduces every gradient in ``step()``, after the whole backward.  This
module brings the overlap back the way PyTorch DDP does it:

* :func:`build_layout` assigns the parameters to size-bounded, single-dtype
  *buckets* in reverse order (``--grad-bucket-mb``, default 16 MB);
* mode ``"bucket"``: every parameter's ``.grad`` is a view into its
  bucket's flat buffer, and a post-accumulate-grad hook counts the
  gradients a bucket still waits for; when its last one lands, one
  ``all_reduce(..., async_op=True)`` of the whole buffer is issued, with
  the rest of the backward still ahead of it.  ``step()`` waits on the
  handles in bucket order, divides (Average) and steps the optimizer;
* mode ``"bucket+zero1"`` (ZeRO-1): each bucket's parameters live in one
  flat buffer that the model's parameters view, and each rank owns a
  1/world shard of it as an ``nn.Parameter``.  The wrapped optimizer is
  built over those shards only, so its state is sharded.  The hook issues
  the bucket's reduce-scatter into the shard's gradient; ``step()``
  updates the shards and all-gathers every bucket back into its buffer;
* mode ``"off"`` is :class:`~horovod_tpu_torch.optim.DistributedOptimizer`
  itself.

The modes compute the same update: a sum is elementwise, so regrouping the
gradients into buckets regroups independent reductions, and a
reduce-scatter shard is the matching slice of the full allreduce.  The
ZeRO path needs an elementwise optimizer (SGD, momentum, Adam, AdamW with
its weight decay); one that couples elements across tensors (global-norm
clipping) would need its norms reduced across the shards.

Order.  :func:`build_layout` buckets the parameters in the reverse of the
order it is given.  The plan hands it ``model.parameters()``, registration
order, so the first bucket holds the last layer, whose gradients the
backward produces first.

Not ported (each raises ``NotImplementedError``): ``hierarchical_axes`` and
``dcn_compression`` (ROADMAP A10: they need A1's local/cross subgroups),
``health=True`` and the metrics gauges (A13), and ``inspect_schedule`` /
``donated_params`` / ``audit_donation``, which read XLA's HLO and have no
PyTorch counterpart (the on-card proof of the overlap is the issue order,
``OverlapPlan.on_issue``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..basics import global_topology
from ..ops.collectives import (
    Average,
    ReduceOp,
    Sum,
    _all_gather_single,
    _reduce_scatter_single,
)
from ..runtime.autotune import resolve_grad_bucket_bytes

__all__ = [
    "MODES",
    "Bucket",
    "BucketLayout",
    "build_layout",
    "OverlapPlan",
]

MODES = ("off", "bucket", "bucket+zero1")


# ---------------------------------------------------------------------------
# bucket layout
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Bucket:
    """One fused gradient bucket: a run of parameter leaves in reverse
    order, of one dtype, concatenated flat."""

    index: int
    leaf_indices: Tuple[int, ...]   # positions in the order build_layout got
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]
    dtype: torch.dtype
    pad: int                        # zeros appended so shard_ways divides
    # leaves laid out channels_last (NHWC memory): their bucket slices are
    # in that order, so views of the bucket keep the leaf's strides
    channels_last: Tuple[bool, ...]

    @property
    def size(self) -> int:
        return sum(self.sizes)

    @property
    def padded_size(self) -> int:
        return self.size + self.pad

    @property
    def nbytes(self) -> int:
        return self.size * _itemsize(self.dtype)


@dataclass(frozen=True)
class BucketLayout:
    """The bucket assignment of a parameter list: derived from shapes and
    dtypes only, so every rank computes the same one."""

    buckets: Tuple[Bucket, ...]
    num_leaves: int
    bucket_bytes: int
    shard_ways: int

    @property
    def total_bytes(self) -> int:
        return sum(b.nbytes for b in self.buckets)


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def build_layout(params: Sequence[torch.Tensor], bucket_bytes: int, *,
                 shard_ways: int = 1) -> BucketLayout:
    """Assign the tensors of ``params`` to buckets, walking them in reverse.

    A bucket closes when the next tensor would take it past
    ``bucket_bytes`` or has another dtype; a tensor larger than the cap
    gets a bucket of its own (one tensor is never split).  ``shard_ways``
    > 1 (ZeRO-1) pads each bucket with zeros to a multiple of it.
    Non-float tensors are rejected.
    """
    leaves = list(params)
    if not leaves:
        raise ValueError("cannot build a bucket layout over no parameters")
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    for i, leaf in enumerate(leaves):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            raise ValueError(
                f"parameter leaf {i} has non-float dtype {leaf.dtype}; the "
                f"overlap plane reduces a gradient for every leaf, so "
                f"params must be all-float")
    shapes = [tuple(leaf.shape) for leaf in leaves]
    sizes = [leaf.numel() for leaf in leaves]
    dtypes = [leaf.dtype for leaf in leaves]
    nhwc = [_is_channels_last(leaf) for leaf in leaves]

    buckets: List[Bucket] = []

    def close(run: List[int]) -> None:
        if not run:
            return
        total = sum(sizes[i] for i in run)
        buckets.append(Bucket(
            index=len(buckets),
            leaf_indices=tuple(run),
            shapes=tuple(shapes[i] for i in run),
            sizes=tuple(sizes[i] for i in run),
            dtype=dtypes[run[0]],
            pad=(-total) % shard_ways,
            channels_last=tuple(nhwc[i] for i in run),
        ))

    run: List[int] = []
    run_bytes = 0
    for i in reversed(range(len(leaves))):
        nbytes = sizes[i] * _itemsize(dtypes[i])
        if run and (dtypes[i] != dtypes[run[0]]
                    or run_bytes + nbytes > bucket_bytes):
            close(run)
            run, run_bytes = [], 0
        run.append(i)
        run_bytes += nbytes
    close(run)
    return BucketLayout(buckets=tuple(buckets), num_leaves=len(leaves),
                        bucket_bytes=int(bucket_bytes),
                        shard_ways=int(shard_ways))


def _is_channels_last(t: torch.Tensor) -> bool:
    return (t.dim() == 4 and not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last))


def _bucket_concat(pieces: Sequence[torch.Tensor],
                   bucket: Bucket) -> torch.Tensor:
    """Flatten and concatenate a bucket's leaves (bucket order; a
    channels_last leaf in its NHWC memory order), zero padded: a new
    buffer."""
    flat = torch.cat([(p.permute(0, 2, 3, 1) if cl else p).reshape(-1)
                      for p, cl in zip(pieces, bucket.channels_last)])
    if bucket.pad:
        flat = torch.cat([flat, flat.new_zeros(bucket.pad)])
    return flat


def _bucket_split(flat: torch.Tensor, bucket: Bucket) -> List[torch.Tensor]:
    """Inverse of :func:`_bucket_concat`: views of ``flat``, one per leaf,
    with the leaf's layout."""
    out, off = [], 0
    for shape, size, cl in zip(bucket.shapes, bucket.sizes,
                               bucket.channels_last):
        piece = flat[off:off + size]
        if cl:
            n, c, h, w = shape
            out.append(piece.view(n, h, w, c).permute(0, 3, 1, 2))
        else:
            out.append(piece.view(shape))
        off += size
    return out


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


class OverlapPlan:
    """A configured overlap plane over ``params``, used like an optimizer:
    ``zero_grad()``, ``loss.backward()``, ``step()``.

    ``make_optimizer`` builds the wrapped ``torch.optim.Optimizer`` from a
    list of parameters: the model's (``off``, ``bucket``) or the plan's
    flat shards (``bucket+zero1``); it must be elementwise for the latter.
    Build the plan after the parameters hold their final initial values
    (after ``broadcast_parameters``): ZeRO-1 copies them into its buffers
    and shards.

    The plan keeps each gradient as a view into its bucket, so
    ``zero_grad()`` zeroes the buckets instead of dropping the gradients;
    a gradient the backward allocated anew (after ``p.grad = None``) is
    copied into its bucket by the hook.  One backward per ``step()``.
    ``on_issue``, when set, is called on the host with each bucket's index
    right after its collective is issued (measurement only).
    """

    def __init__(
        self,
        params,
        make_optimizer: Callable[[list], torch.optim.Optimizer],
        *,
        mode: str = "bucket",
        op: ReduceOp = Average,
        bucket_mb: Optional[float] = None,
        hierarchical_axes=None,
        dcn_compression=None,
        health: bool = False,
    ):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if op not in (Average, Sum):
            raise ValueError(f"OverlapPlan supports Average/Sum, got {op!r}")
        if hierarchical_axes is not None or dcn_compression is not None:
            raise NotImplementedError(
                "hierarchical_axes / dcn_compression are not ported yet "
                "(ROADMAP A10; they need A1's local/cross subgroups)")
        if health:
            raise NotImplementedError(
                "health=True is not ported yet (ROADMAP A13)")
        self.mode = mode
        self.op = op
        self.params: List[nn.Parameter] = list(params)
        topo = global_topology()
        self.world, self.rank = topo.process_count, topo.process_rank
        zero1 = mode == "bucket+zero1"
        self.layout = build_layout(
            self.params, resolve_grad_bucket_bytes(bucket_mb),
            shard_ways=self.world if zero1 else 1)
        self.on_issue: Optional[Callable[[int], None]] = None
        self._hooks: list = []
        if mode == "off":
            from . import DistributedOptimizer  # noqa: PLC0415

            self.optimizer = DistributedOptimizer(
                make_optimizer(self.params), op=op)
            return
        devices = {p.device for p in self.params}
        if len(devices) != 1:
            raise ValueError(f"parameters on several devices: {devices}")
        buckets = self.layout.buckets
        with torch.no_grad():
            self._grads = [self.params[b.leaf_indices[0]].new_zeros(
                b.padded_size) for b in buckets]
            self.shards: List[nn.Parameter] = []
            if zero1:
                self._flat = [_bucket_concat(
                    [self.params[i].detach() for i in b.leaf_indices], b)
                    for b in buckets]
                for b, flat in zip(buckets, self._flat):
                    for i, view in zip(b.leaf_indices, _bucket_split(flat, b)):
                        self.params[i].data = view
                    chunk = b.padded_size // self.world
                    shard = nn.Parameter(
                        flat[self.rank * chunk:(self.rank + 1) * chunk]
                        .clone())
                    shard.grad = torch.zeros_like(shard)
                    self.shards.append(shard)
        for b, grad in zip(buckets, self._grads):
            for i, view in zip(b.leaf_indices, _bucket_split(grad, b)):
                self.params[i].grad = view
                self._hooks.append(self.params[i]
                                   .register_post_accumulate_grad_hook(
                                       self._hook(b.index, view)))
        self._pending = [len(b.leaf_indices) for b in buckets]
        self._work: list = [None] * len(buckets)
        self.optimizer = make_optimizer(self.shards if zero1 else self.params)

    # ------------------------------------------------------------ optimizer

    @property
    def sharded_state(self) -> bool:
        """Whether each rank's optimizer state is its own shard (ZeRO-1),
        which ``broadcast_optimizer_state`` must leave alone."""
        return self.mode == "bucket+zero1"

    @property
    def param_groups(self):
        return self.optimizer.param_groups

    @property
    def state(self):
        return self.optimizer.state

    def state_dict(self):
        return self.optimizer.state_dict()

    def load_state_dict(self, state_dict):
        self.optimizer.load_state_dict(state_dict)

    def zero_grad(self, set_to_none: bool = True) -> None:
        """Zero the gradients: the buckets' buffers (the parameters' grads
        stay views of them; ``set_to_none`` applies to mode ``off``
        only)."""
        if self.mode == "off":
            self.optimizer.zero_grad(set_to_none=set_to_none)
            return
        for grad in self._grads:
            grad.zero_()

    # ------------------------------------------------------------ backward

    def _hook(self, index: int, view: torch.Tensor):
        # The parameter holds its hook from C++, where the garbage collector
        # cannot see it: a strong reference to the plan would keep a dropped
        # plan, its buffers and its optimizer state alive for good.
        plan_ref = weakref.ref(self)

        def hook(param: nn.Parameter) -> None:
            plan = plan_ref()
            if plan is None:
                return
            if param.grad.data_ptr() != view.data_ptr():
                # a gradient autograd allocated anew: into the bucket
                with torch.no_grad():
                    view.copy_(param.grad)
                param.grad = view
            plan._pending[index] -= 1
            if plan._pending[index] == 0:
                plan._issue(index)
            elif plan._pending[index] < 0:
                raise RuntimeError(
                    "OverlapPlan: a second backward before step(); the plan "
                    "reduces each bucket once per step")
        return hook

    def _issue(self, index: int) -> None:
        grad = self._grads[index]
        if self.mode == "bucket+zero1":
            work = _reduce_scatter_single(self.shards[index].grad, grad,
                                          async_op=True)
        else:
            work = dist.all_reduce(grad, async_op=True)
        self._work[index] = work
        if self.on_issue is not None:
            self.on_issue(index)

    # ---------------------------------------------------------------- step

    @torch.no_grad()
    def step(self, closure=None):
        if self.mode == "off":
            return self.optimizer.step(closure)
        # buckets a parameter without a gradient kept from firing
        for index, work in enumerate(self._work):
            if work is None:
                self._issue(index)
        # what each bucket's collective wrote: the shard's gradient under
        # ZeRO-1, the bucket's buffer otherwise
        reduced = ([s.grad for s in self.shards]
                   if self.mode == "bucket+zero1" else self._grads)
        for index, work in enumerate(self._work):
            work.wait()
            if self.op == Average and self.world > 1:
                reduced[index].div_(self.world)
        self._work = [None] * len(self._work)
        self._pending = [len(b.leaf_indices) for b in self.layout.buckets]
        loss = self.optimizer.step(closure)
        if self.mode == "bucket+zero1":
            works = [_all_gather_single(flat, shard.detach(), async_op=True)
                     for flat, shard in zip(self._flat, self.shards)]
            for work in works:
                work.wait()
        return loss

    # ------------------------------------------------------ state transfer

    def materialize(self) -> List[torch.Tensor]:
        """The full parameters, in the order the plan was given them
        (copies; after ``step()`` every rank holds them whole)."""
        return [p.detach().clone() for p in self.params]

    def close(self) -> None:
        """Remove the plan's gradient hooks."""
        for h in self._hooks:
            h.remove()
        self._hooks = []

    def rebucket(self, new_plan: "OverlapPlan") -> "OverlapPlan":
        """Carry ZeRO-1 optimizer state into ``new_plan``, a
        ``bucket+zero1`` plan built since over the same parameters with
        another bucket size (the parameters themselves it took over when
        it was built).  Each state field that parallels the shards is
        gathered, split per parameter and re-sharded in the new layout;
        scalar fields (Adam's step) carry over.  State of another shape
        raises rather than be guessed.  Closes this plan; returns
        ``new_plan``."""
        if self.mode != "bucket+zero1" or new_plan.mode != "bucket+zero1":
            raise ValueError("rebucket is only meaningful between "
                             "bucket+zero1 plans")
        if [id(p) for p in new_plan.params] != [id(p) for p in self.params]:
            raise ValueError("rebucket requires the same parameters")
        self.close()
        old_states = [self.optimizer.state.get(s, {}) for s in self.shards]
        fields = set(old_states[0])
        if any(set(st) != fields for st in old_states):
            raise ValueError("optimizer state differs between buckets")
        new_states = [new_plan.optimizer.state[s] for s in new_plan.shards]
        for key in sorted(fields):
            vals = [st[key] for st in old_states]
            if all(torch.is_tensor(v) and v.dim() == 0 for v in vals) or \
                    not any(torch.is_tensor(v) for v in vals):
                if any(not _same_value(v, vals[0]) for v in vals):
                    raise ValueError(
                        f"optimizer state {key!r} differs between buckets")
                for st in new_states:
                    st[key] = vals[0].clone() if torch.is_tensor(vals[0]) \
                        else vals[0]
                continue
            if any(not torch.is_tensor(v) or v.shape != s.shape
                   for v, s in zip(vals, self.shards)):
                raise ValueError(
                    "optimizer state does not parallel the bucket list; "
                    "re-initialize it for the new layout instead")
            for st, shard in zip(new_states,
                                 self._regroup(vals, new_plan)):
                st[key] = shard
        return new_plan

    def _regroup(self, shards: Sequence[torch.Tensor],
                 new_plan: "OverlapPlan") -> List[torch.Tensor]:
        """One state field: gather each old bucket, split per parameter,
        concatenate per new bucket, keep this rank's chunk."""
        leaves: List[torch.Tensor] = [None] * self.layout.num_leaves
        for b, shard in zip(self.layout.buckets, shards):
            full = shard.new_empty(b.padded_size)
            _all_gather_single(full, shard.contiguous())
            for i, piece in zip(b.leaf_indices, _bucket_split(full, b)):
                leaves[i] = piece
        out = []
        for b in new_plan.layout.buckets:
            flat = _bucket_concat([leaves[i] for i in b.leaf_indices], b)
            chunk = b.padded_size // new_plan.world
            out.append(flat[new_plan.rank * chunk:
                            (new_plan.rank + 1) * chunk].clone())
        return out


def _same_value(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b
