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
  itself;
* :func:`sync_gradients` is the reference's bucketed ``value_and_grad``: a
  ``bucket`` plan over detached copies of the parameters, whose hooks
  issue each bucket's reduce inside the backward, and no optimizer.

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

Two-level schedule.  ``hierarchical_axes=(LOCAL_AXIS, CROSS_AXIS)`` reduces
each bucket by ``parallel/hierarchical.py`` (``bucket``:
``hierarchical_allreduce``; ``bucket+zero1``: ``hierarchical_reduce_scatter``
and ``hierarchical_all_gather``, rank (c, l) owning shard
``l x cross_size + c`` of every bucket, as in the reference), with
``dcn_compression`` on the cross leg.  Its collectives chain on one
another; on CUDA the hook issues them on the plan's side stream, which
waits for the bucket's gradients and which ``step()`` waits for, so the
backward is not held up behind them.

Health.  ``health=True`` makes ``step()`` also compute the training-health
bundle (``obs/health.py``, :func:`~..obs.health.bundle_names` order: loss,
global grad norm, max update/param ratio, nonfinite count, per-bucket grad
norms) from the reduced gradients and the update it applies, into
:attr:`OverlapPlan.bundle`, as the reference's ``local_step(health=True)``
does.  It reads the plan's flat buffers with multi-tensor reductions
(``torch._foreach_norm``): per bucket one fp32 norm, one nonfinite count
over the whole gradient store (the buckets' gradients are views of one
buffer per dtype), and the ratio as a max per leaf (per shard
under ZeRO-1, whose sums and max are then reduced over the world, as the
reference's ``psum``/``pmax``).  The update is ``new - old`` of a snapshot
taken before the optimizer steps.  Nothing reads the bundle on the host:
the parameters and the losses are those of ``health=False``, bit for bit.

Not ported (each raises ``NotImplementedError``): the metrics gauges, and
``inspect_schedule`` / ``donated_params`` /
``audit_donation``, which read XLA's HLO and have no PyTorch counterpart
(the on-card proof of the overlap is the issue order,
``OverlapPlan.on_issue``).
"""

from __future__ import annotations

import time
import weakref
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.utils._pytree as pytree
from torch import nn

from ..basics import DP_AXIS, global_topology, group_of_axis
from ..obs import trace as obs_trace
from ..parallel.hierarchical import (
    _resolve_compressor,
    hierarchical_all_gather,
    hierarchical_allreduce,
    hierarchical_reduce_scatter,
    hierarchical_shard_index,
)
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
    "sync_gradients",
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
    Its spans (``obs/trace.py``): each collective's issue in ``phase
    ("bucket", bucket=i)``, :meth:`reduce` in ``grad_reduce``, the
    optimizer's step (and ZeRO-1's all-gather) in ``optimizer``; with
    ``HVDTPU_TRACE``, one ring span ``overlap/bucket{i}`` a bucket and
    step, from its first leaf's hook to its collective's issue (the
    bucket's fill), with its ``bytes``, ``leaves`` and ``mode``.
    ``axis_name`` names the ranks the gradients are reduced over (the
    world by default).  ``hierarchical_axes`` / ``dcn_compression``: the
    two-level schedule (module docstring).  ``layout``: a prebuilt
    :func:`build_layout` of ``params`` in place of one from ``bucket_mb``.
    ``make_optimizer=None`` (mode ``bucket`` only) builds no optimizer:
    :meth:`reduce` then ends the step.
    """

    def __init__(
        self,
        params,
        make_optimizer: Callable[[list], torch.optim.Optimizer],
        *,
        mode: str = "bucket",
        op: ReduceOp = Average,
        axis_name: str = DP_AXIS,
        bucket_mb: Optional[float] = None,
        hierarchical_axes=None,
        dcn_compression=None,
        health: bool = False,
        layout: Optional["BucketLayout"] = None,
    ):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        if op not in (Average, Sum):
            raise ValueError(f"OverlapPlan supports Average/Sum, got {op!r}")
        if make_optimizer is None and mode != "bucket":
            raise ValueError(f"mode {mode!r} needs make_optimizer")
        if hierarchical_axes is not None and len(hierarchical_axes) != 2:
            raise ValueError(
                "hierarchical_axes must be (local_axis, cross_axis), got "
                f"{hierarchical_axes!r}")
        self.health = bool(health)
        self.bundle: Optional[torch.Tensor] = None
        self._steps = 0
        self.mode = mode
        self.op = op
        self.hierarchical_axes = (tuple(hierarchical_axes)
                                  if hierarchical_axes else None)
        self.dcn_compression = dcn_compression
        _resolve_compressor(dcn_compression)  # an unknown name fails here
        self.params: List[nn.Parameter] = list(params)
        topo = global_topology()
        group = group_of_axis(axis_name)
        # the reduce's process group (None: the default one)
        self.group = None if group is dist.group.WORLD else group
        self.world, self.rank = dist.get_world_size(group), topo.process_rank
        # the shard of every bucket this rank owns under ZeRO-1
        self.shard_index = (dist.get_rank(group)
                            if self.hierarchical_axes is None else
                            hierarchical_shard_index(topo.local_rank,
                                                     topo.cross_rank,
                                                     topo.cross_size))
        zero1 = mode == "bucket+zero1"
        self.layout = layout if layout is not None else build_layout(
            self.params, resolve_grad_bucket_bytes(bucket_mb),
            shard_ways=self.world if zero1 else 1)
        self.on_issue: Optional[Callable[[int], None]] = None
        self._hooks: list = []
        self._old: List[torch.Tensor] = []
        if mode == "off":
            from . import DistributedOptimizer  # noqa: PLC0415

            self.optimizer = DistributedOptimizer(
                make_optimizer(self.params), op=op, axis_name=axis_name,
                hierarchical_axes=self.hierarchical_axes,
                dcn_compression=dcn_compression)
            if self.health:
                self._old = [torch.empty_like(p) for p in self.params]
            return
        devices = {p.device for p in self.params}
        if len(devices) != 1:
            raise ValueError(f"parameters on several devices: {devices}")
        buckets = self.layout.buckets
        like = self.params[0]
        with torch.no_grad():
            self._grad_store, self._grads = _stored(
                like, [(b.padded_size, b.dtype) for b in buckets])
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
                        flat[self.shard_index * chunk:
                             (self.shard_index + 1) * chunk].clone())
                    self.shards.append(shard)
                self._shard_store, views = _stored(
                    like, [(s.numel(), s.dtype) for s in self.shards])
                for shard, view in zip(self.shards, views):
                    shard.grad = view
        for b, grad in zip(buckets, self._grads):
            for i, view in zip(b.leaf_indices, _bucket_split(grad, b)):
                self.params[i].grad = view
                self._hooks.append(self.params[i]
                                   .register_post_accumulate_grad_hook(
                                       self._hook(b.index, view)))
        # each bucket's leaves, and those whose hook has yet to fire
        self._leaves = [len(b.leaf_indices) for b in buckets]
        self._pending = list(self._leaves)
        self._work: list = [None] * len(buckets)
        # each bucket's first hook of the step (wall clock), with
        # HVDTPU_TRACE
        self._filling: list = [None] * len(buckets)
        if self.health:
            self._old = [torch.empty_like(t)
                         for t in (self.shards if zero1 else self.params)]
        cuda = next(iter(devices)).type == "cuda"
        self._side = (torch.cuda.Stream() if cuda and self.hierarchical_axes
                      else None)
        self.optimizer = (None if make_optimizer is None else
                          make_optimizer(self.shards if zero1 else
                                         self.params))

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
        for flat in self._grad_store:
            flat.zero_()

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
            if plan._pending[index] == plan._leaves[index] \
                    and obs_trace.enabled():
                plan._filling[index] = time.time()
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
        t0, self._filling[index] = self._filling[index], None
        if t0 is not None:
            b = self.layout.buckets[index]
            obs_trace.add_span("overlap", f"bucket{index}", t0, time.time(),
                               bucket=index, bytes=b.nbytes,
                               leaves=len(b.sizes), mode=self.mode)
        grad = self._grads[index]
        zero1 = self.mode == "bucket+zero1"
        with obs_trace.phase("bucket", bucket=index):
            if self.hierarchical_axes is not None:
                out = self.shards[index].grad if zero1 else grad
                work = self._issue_two_level(grad, out)
            elif zero1:
                work = _reduce_scatter_single(
                    self.shards[index].grad, grad, group=self.group,
                    async_op=True)
            else:
                work = dist.all_reduce(grad, group=self.group,
                                       async_op=True)
        self._work[index] = work
        if self.on_issue is not None:
            self.on_issue(index)

    @torch.no_grad()
    def _reduce_two_level(self, grad: torch.Tensor,
                          out: torch.Tensor) -> None:
        """The sum of a bucket's gradients over both groups into ``out``:
        the whole bucket (``bucket``) or this rank's shard of it (ZeRO-1).
        ``step()`` divides for Average."""
        local_ax, cross_ax = self.hierarchical_axes
        fn = (hierarchical_reduce_scatter if self.mode == "bucket+zero1"
              else hierarchical_allreduce)
        out.copy_(fn(grad, Sum, local_axis=local_ax, cross_axis=cross_ax,
                     compression=self.dcn_compression))

    def _issue_two_level(self, grad: torch.Tensor, out: torch.Tensor):
        """:meth:`_reduce_two_level`, whose collectives chain on one
        another: on CUDA on the plan's side stream, after the work queued so
        far on the current one, with a handle whose ``wait()`` makes the
        current stream wait for it; on the CPU it runs to its end here."""
        if self._side is None:
            self._reduce_two_level(grad, out)
            return _Done()
        self._side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(self._side):
            self._reduce_two_level(grad, out)
            done = torch.cuda.Event()
            done.record()
        return _StreamDone(done)

    def _gather_shard(self, shard: torch.Tensor, out: torch.Tensor) -> None:
        """Every rank's shard of a bucket, in shard order, into ``out``."""
        if self.hierarchical_axes is None:
            _all_gather_single(out, shard.contiguous(), group=self.group)
            return
        local_ax, cross_ax = self.hierarchical_axes
        out.copy_(hierarchical_all_gather(shard.detach(), local_axis=local_ax,
                                          cross_axis=cross_ax))

    # ---------------------------------------------------------------- step

    @torch.no_grad()
    def step(self, closure=None, *, loss: Optional[torch.Tensor] = None):
        """Wait for the buckets' collectives, average, step the optimizer
        (ZeRO-1: and all-gather the shards).  Under ``health=True`` also
        leaves the step's health bundle, with ``loss`` (this rank's loss;
        the closure's when None) as its first entry, in :attr:`bundle`."""
        if self.mode == "off":
            if not self.health:
                return self.optimizer.step(closure)
            torch._foreach_copy_(self._old, self.params)
            out = self.optimizer.step(closure)
            self._leaf_bundle(out if loss is None else loss)
            return out
        reduced = self.reduce()
        with obs_trace.phase("optimizer"):
            if self.health:
                stepped = self.shards if self.mode == "bucket+zero1" \
                    else self.params
                torch._foreach_copy_(self._old, stepped)
            out = self.optimizer.step(closure)
            if self.health:
                self._flat_bundle(out if loss is None else loss, reduced)
            if self.mode == "bucket+zero1" and \
                    self.hierarchical_axes is not None:
                for flat, shard in zip(self._flat, self.shards):
                    self._gather_shard(shard, flat)
            elif self.mode == "bucket+zero1":
                works = [_all_gather_single(flat, shard.detach(),
                                            group=self.group, async_op=True)
                         for flat, shard in zip(self._flat, self.shards)]
                for work in works:
                    work.wait()
        return out

    @torch.no_grad()
    def reduce(self) -> List[torch.Tensor]:
        """The backward's end (modes ``bucket`` / ``bucket+zero1``): issue
        the buckets a parameter without a gradient kept from firing, wait
        for every bucket's collective and average.  Returns what each
        bucket's collective wrote: the shard's gradient under ZeRO-1, the
        bucket's buffer otherwise (the parameters' ``.grad`` are views of
        it).  :meth:`step` calls it before the optimizer steps."""
        with obs_trace.phase("grad_reduce"):
            for index, work in enumerate(self._work):
                if work is None:
                    self._issue(index)
            reduced = ([s.grad for s in self.shards]
                       if self.mode == "bucket+zero1" else self._grads)
            for index, work in enumerate(self._work):
                work.wait()
                if self.op == Average and self.world > 1:
                    reduced[index].div_(self.world)
            self._work = [None] * len(self._work)
            self._pending = list(self._leaves)
            self._grad_ready_fault(reduced)
        return reduced

    # -------------------------------------------------------------- health

    def _grad_ready_fault(self, reduced: List[torch.Tensor]) -> None:
        """The ``grad_ready`` fault point (testing/faults.py), after the
        reduction: a fired ``flip_bits`` / ``nan_inject`` damages one
        element of this rank's copy of bucket ``name=bucket<i>``'s reduced
        gradient, the silent corruption the divergence sentinel exists to
        catch.  ``step`` is the plan's step count, from 1.  A host check
        only, unless a fault spec is loaded."""
        from ..testing import faults  # noqa: PLC0415

        self._steps += 1
        if not faults.active():
            return
        for index, grad in enumerate(reduced):
            name = f"bucket{index}"
            action = faults.maybe_fail("grad_ready", rank=self.rank,
                                       step=self._steps, name=name)
            if action in ("flip_bits", "nan_inject"):
                host = grad.detach().cpu()
                if host.dtype == torch.bfloat16:
                    host = host.view(torch.int16)
                bad = faults.corrupt_grad(host.numpy(), action,
                                          rank=self.rank, step=self._steps,
                                          name=name)
                grad.copy_(torch.from_numpy(bad).to(grad.device)
                           .view(grad.dtype))

    def _leaf_bundle(self, loss) -> None:
        """Mode ``off``: the bundle from the parameters' own gradients."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norms = _f32(torch._foreach_norm(grads, 2))
        sq = norms * norms
        bucket_sq = torch.stack([sq[list(b.leaf_indices)].sum()
                                 for b in self.layout.buckets])
        nonfinite = (~torch.isfinite(torch.cat(
            [g.reshape(-1) for g in grads]))).sum()
        self.bundle = self._assemble(loss, bucket_sq, nonfinite,
                                     self._update_ratio(self.params))

    def _flat_bundle(self, loss, reduced: List[torch.Tensor]) -> None:
        """Modes ``bucket`` / ``bucket+zero1``: the bundle from the reduced
        flat buffers (ZeRO-1: this rank's shards, summed over the world)."""
        norms = _f32(torch._foreach_norm(reduced, 2))
        store = (self._shard_store if self.mode == "bucket+zero1"
                 else self._grad_store)
        nonfinite = sum((~torch.isfinite(flat)).sum() for flat in store)
        stepped = self.shards if self.mode == "bucket+zero1" else self.params
        ratio = self._update_ratio(stepped)
        sums = torch.cat([norms * norms,
                          nonfinite.to(torch.float32).reshape(1)])
        if self.mode == "bucket+zero1" and self.world > 1:
            dist.all_reduce(sums, group=self.group)
            dist.all_reduce(ratio, op=dist.ReduceOp.MAX, group=self.group)
        self.bundle = self._assemble(loss, sums[:-1], sums[-1], ratio)

    def _update_ratio(self, stepped: List[torch.Tensor]) -> torch.Tensor:
        """Max over the stepped tensors of ``max|new - old| / (max|old| +
        1e-12)`` (the reference's eps); leaves the snapshot holding
        ``old - new``."""
        pmax = _f32(torch._foreach_norm(self._old, float("inf")))
        torch._foreach_sub_(self._old, stepped)
        umax = _f32(torch._foreach_norm(self._old, float("inf")))
        return (umax / (pmax + 1e-12)).max()

    @staticmethod
    def _assemble(loss, bucket_sq, nonfinite, ratio) -> torch.Tensor:
        f32 = torch.float32
        loss = torch.as_tensor(loss).detach().to(device=bucket_sq.device,
                                                 dtype=f32).reshape(1)
        return torch.cat([loss, torch.sqrt(bucket_sq.sum()).reshape(1),
                          ratio.to(f32).reshape(1),
                          torch.as_tensor(nonfinite).to(f32).reshape(1),
                          torch.sqrt(bucket_sq)])

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
            self._gather_shard(shard, full)
            for i, piece in zip(b.leaf_indices, _bucket_split(full, b)):
                leaves[i] = piece
        out = []
        for b in new_plan.layout.buckets:
            flat = _bucket_concat([leaves[i] for i in b.leaf_indices], b)
            chunk = b.padded_size // new_plan.world
            first = new_plan.shard_index * chunk
            out.append(flat[first:first + chunk].clone())
        return out


# Measurement only: when set, called on the host with each bucket's index
# as sync_gradients issues its reduce (OverlapPlan.on_issue of its plan).
on_sync_issue: Optional[Callable[[int], None]] = None


def sync_gradients(
    loss_fn: Callable,
    params,
    *args,
    op: ReduceOp = Average,
    axis_name: str = DP_AXIS,
    bucket_mb: Optional[float] = None,
    layout: Optional[BucketLayout] = None,
    has_aux: bool = False,
    hierarchical_axes=None,
    dcn_compression=None,
):
    """``value_and_grad(loss_fn)(params, *args)`` with the gradients
    reduced across ``axis_name`` inside the backward (reference
    ``hvd.sync_gradients``, horovod_tpu/optim/overlap.py:338-377).

    ``params`` is a pytree (dicts, lists, tuples) of float tensors that
    ``loss_fn(params, *args)`` computes its loss from (a module's through
    ``torch.func.functional_call``).  Returns ``(loss, grads)``, or
    ``((loss, aux), grads)`` with ``has_aux``: ``grads`` has the structure of
    ``params`` and is already reduced, with one fused reduce per bucket of
    ``build_layout(leaves, bucket_mb)`` (``--grad-bucket-mb``,
    ``HVDTPU_GRAD_BUCKET_MB``, 16 MB) — or of a prebuilt ``layout`` —
    issued from the bucket's last gradient hook while the rest of the
    backward still runs.  It is a ``bucket`` :class:`OverlapPlan` over
    detached copies of the leaves, whose ``.grad`` its hooks fill (a
    post-accumulate hook fires under ``backward()``, not under
    ``torch.autograd.grad``).  ``op`` is Average or Sum;
    ``hierarchical_axes`` / ``dcn_compression`` run the two-level schedule.
    """
    if op not in (Average, Sum):
        raise ValueError(f"sync_gradients supports Average/Sum, got {op!r}")
    leaves, spec = pytree.tree_flatten(params)
    work = [p.detach().requires_grad_() for p in leaves]
    plan = OverlapPlan(work, None, mode="bucket", op=op, axis_name=axis_name,
                       bucket_mb=bucket_mb, layout=layout,
                       hierarchical_axes=hierarchical_axes,
                       dcn_compression=dcn_compression)
    plan.on_issue = on_sync_issue
    try:
        out = loss_fn(pytree.tree_unflatten(work, spec), *args)
        loss = out[0] if has_aux else out
        loss.backward()
        plan.reduce()
    finally:
        plan.close()
    grads = pytree.tree_unflatten([w.grad for w in work], spec)
    if has_aux:
        aux = pytree.tree_map(
            lambda x: x.detach() if torch.is_tensor(x) else x, out[1])
        return (loss.detach(), aux), grads
    return loss.detach(), grads


class _Done:
    """The handle of collectives that ran to their end when issued."""

    @staticmethod
    def wait() -> None:
        pass


class _StreamDone:
    """The handle of collectives queued on a side stream: ``wait()`` makes
    the current stream wait for them."""

    def __init__(self, event):
        self.event = event

    def wait(self) -> None:
        torch.cuda.current_stream().wait_event(self.event)


def _f32(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack(tensors).to(torch.float32)


# The bucket gradients (and ZeRO-1's shard gradients) are views of one
# buffer per dtype, each starting on a 256-byte boundary: zero_grad is one
# launch a dtype, and the health bundle's nonfinite count one pass.
_ALIGN_BYTES = 256


def _stored(like: torch.Tensor, sizes: Sequence[Tuple[int, torch.dtype]]):
    """Zeroed views of ``(numel, dtype)`` each, carved from one zeroed
    buffer per dtype on ``like``'s device: ``(buffers, views)``."""
    offsets, ends = [], {}
    for numel, dtype in sizes:
        align = max(_ALIGN_BYTES // _itemsize(dtype), 1)
        start = -(-ends.get(dtype, 0) // align) * align
        offsets.append(start)
        ends[dtype] = start + numel
    store = {dtype: like.new_zeros(end, dtype=dtype)
             for dtype, end in ends.items()}
    views = [store[dtype][off:off + numel]
             for (numel, dtype), off in zip(sizes, offsets)]
    return list(store.values()), views


def _same_value(a, b) -> bool:
    if torch.is_tensor(a):
        return torch.equal(a, b)
    return a == b
