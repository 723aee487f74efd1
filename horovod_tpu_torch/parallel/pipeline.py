"""GPipe and circular pipeline parallelism for the GPT family (counterpart
of ``horovod_tpu/parallel/pipeline.py``).

The block stack splits into P stages over a pipeline axis (a name of
``basics.init_axes`` or a process group), one process per stage.
Microbatches stream through ``M + P - 1`` ticks (circular: ``circles * M
+ P - 1``); each tick every stage runs its layers on what it holds and
hands the result to the next stage with ``ops.collectives.ring_shift``
(the reference's ``ppermute``).  Embeddings and the LM head are
replicated; each stage holds its ``num_layers / P`` blocks.

* :func:`pp_gpt_apply`: GPipe forward, full logits on every rank;
* :func:`pp_gpt_loss`: training; the head and token loss run per
  microbatch inside the tick on the last stage, the rejoin is one scalar
  all-reduce, and ``remat`` checkpoints each tick's stage
  (``torch.utils.checkpoint``);
* :func:`pp_gpt_loss_circular`: each stage holds ``circles``
  non-contiguous layer groups and the stream wraps the ring, banked in an
  M-slot queue on stage 0;
* :func:`pp_tp_gpt_loss`: stages whose blocks are tensor-parallel
  (``parallel/tensor_parallel.py``) over a second axis.

Every rank runs the same program, as the reference's SPMD schedule does:
each tick every stage computes (bubble ticks on clamped inputs), every
stage runs the head on its output, and the stage's identity selects what
counts (``torch.where``).  That is load-bearing here: the backward of a
ring shift is a shift the other way, which its neighbours' backward must
meet, and the backward of the replicated weights' ``pvary`` is an
all-reduce; building the same graph on every rank makes autograd issue
those in one order everywhere.  The gradients are the reference's under
replication tracking: staged weights get their layers' gradients, the
replicated weights (embeddings, final LN, head) the unsharded model's on
every rank.

Trees are as in ``parallel/tensor_parallel.py`` (the port's layouts);
every staged leaf has a leading ``pp`` dim, and rank r passes
``local_shard(staged, r)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.collectives import _axis, psum, pvary, ring_shift
from .tensor_parallel import (_gpt_embed, _gpt_head, _map, _tp_block,
                              param_tree, raw_dense, raw_layer_norm,
                              stack_tp_params, unstack_tp_params)

__all__ = ["stack_pp_params", "stack_pp_params_circular",
           "stack_tp_pp_params", "unstack_pp_params",
           "unstack_pp_params_circular", "unstack_tp_pp_params",
           "pp_gpt_apply", "pp_gpt_loss", "pp_gpt_loss_circular",
           "pp_tp_gpt_loss"]


def _stack(trees):
    """Leaf-wise ``torch.stack`` of trees of one structure."""
    first = trees[0]
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in first.items()}


def stack_pp_params(params, cfg, pp: int):
    """Split a GPT's parameters into ``(staged, replicated)``: ``staged``
    the block trees stacked with leading dims ``[pp, layers_per_stage]``,
    ``replicated`` the embeddings, final LN and head."""
    if cfg.num_layers % pp:
        raise ValueError(f"pp={pp} must divide num_layers={cfg.num_layers}")
    p = param_tree(params)
    blocks = [p[f"block{i}"] for i in range(cfg.num_layers)]
    if any("fc1" not in b for b in blocks):
        raise ValueError(
            "stack_pp_params supports dense blocks only (MoE blocks shard "
            "over the ep axis)")
    per = cfg.num_layers // pp
    staged = _map(lambda a: a.reshape((pp, per) + a.shape[1:]).contiguous(),
                  _stack(blocks))
    replicated = {k: v for k, v in p.items() if not k.startswith("block")}
    return staged, replicated


def stack_pp_params_circular(params, cfg, pp: int, circles: int):
    """Restack for the circular schedule: stage ``s`` holds layer groups
    ``{s, s + pp, ...}``; leaves ``[pp, circles, layers_per_group, ...]``
    with layer ``(v * pp + s) * per_group + j`` at ``[s, v, j]``."""
    if circles < 1:
        raise ValueError(f"circles={circles} must be >= 1")
    if cfg.num_layers % (pp * circles):
        raise ValueError(
            f"pp*circles={pp}*{circles} must divide "
            f"num_layers={cfg.num_layers}")
    staged, replicated = stack_pp_params(params, cfg, pp)
    per_group = cfg.num_layers // (pp * circles)

    def restack(leaf):
        flat = leaf.reshape((cfg.num_layers,) + leaf.shape[2:])
        grouped = flat.reshape((circles, pp, per_group) + leaf.shape[2:])
        return grouped.transpose(0, 1).contiguous()

    return _map(restack, staged), replicated


def _check_lead(staged, want: tuple, what: str):
    leaf = staged
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    got = tuple(leaf.shape[:len(want)])
    if got != want:
        raise ValueError(
            f"staged leaves have leading dims {got}, expected {want} "
            f"({what}): unstacking with different factors than the tree "
            "was stacked with")


def unstack_pp_params(staged, replicated, cfg, pp: int) -> dict:
    """Inverse of :func:`stack_pp_params`: the GPT's parameter tree."""
    per = cfg.num_layers // pp
    _check_lead(staged, (pp, per), "pp, layers_per_stage")
    out = dict(replicated)
    for i in range(cfg.num_layers):
        s, j = divmod(i, per)
        out[f"block{i}"] = _map(lambda a: a[s, j], staged)
    return out


def unstack_pp_params_circular(staged, replicated, cfg, pp: int,
                               circles: int) -> dict:
    """Inverse of :func:`stack_pp_params_circular`."""
    per_group = cfg.num_layers // (pp * circles)
    _check_lead(staged, (pp, circles, per_group),
                "pp, circles, layers_per_group")
    out = dict(replicated)
    for i in range(cfg.num_layers):
        g, j = divmod(i, per_group)
        v, s = divmod(g, pp)
        out[f"block{i}"] = _map(lambda a: a[s, v, j], staged)
    return out


def stack_tp_pp_params(params, cfg, pp: int, tp: int):
    """Restack for tensor parallelism inside pipeline stages:
    ``(staged_sharded [pp, tp, layers_per_stage, ...], staged_replicated
    [pp, layers_per_stage, ...], replicated)``."""
    if cfg.num_layers % pp:
        raise ValueError(f"pp={pp} must divide num_layers={cfg.num_layers}")
    sharded, replicated = stack_tp_params(params, cfg, tp)
    per = cfg.num_layers // pp

    def stage_stack(tree_of_blocks, tp_leading):
        stacked = _stack([tree_of_blocks[f"block{i}"]
                          for i in range(cfg.num_layers)])

        def leaf(a):
            a = a.reshape((pp, per) + a.shape[1:])
            return (a.transpose(1, 2) if tp_leading else a).contiguous()
        return _map(leaf, stacked)

    staged_sharded = stage_stack(sharded, True)
    staged_replicated = stage_stack(
        {k: v for k, v in replicated.items() if k.startswith("block")},
        False)
    true_replicated = {k: v for k, v in replicated.items()
                       if not k.startswith("block")}
    return staged_sharded, staged_replicated, true_replicated


def unstack_tp_pp_params(staged_sharded, staged_replicated, replicated,
                         cfg, pp: int, tp: int) -> dict:
    """Inverse of :func:`stack_tp_pp_params`."""
    per = cfg.num_layers // pp
    _check_lead(staged_sharded, (pp, tp, per), "pp, tp, layers_per_stage")
    _check_lead(staged_replicated, (pp, per), "pp, layers_per_stage")
    sharded, rep = {}, dict(replicated)
    for i in range(cfg.num_layers):
        s, j = divmod(i, per)
        sharded[f"block{i}"] = _map(lambda a: a[s, :, j], staged_sharded)
        rep[f"block{i}"] = _map(lambda a: a[s, j], staged_replicated)
    return unstack_tp_params(sharded, rep, cfg, tp)


def _dense_block(cfg, p, x, rope_tabs):
    """One dense block from a raw block tree: ``block_math`` with plain
    Dense closures (the reference's ``raw_block_forward``)."""
    from ..models.layers import act_store  # noqa: PLC0415
    from ..models.transformer import block_math  # noqa: PLC0415

    dt = cfg.dtype

    def mlp(h):
        m = F.gelu(raw_dense(p["fc1"], dt)(h), approximate="tanh")
        return raw_dense(p["fc2"], dt)(act_store(m, cfg.act_store_dtype, dt))

    return block_math(
        cfg, x, rope_tabs,
        ln1=lambda h: raw_layer_norm(h, p["ln1"]),
        qkv=raw_dense(p["qkv"], dt), proj=raw_dense(p["proj"], dt),
        ln2=lambda h: raw_layer_norm(h, p["ln2"]), mlp=mlp)


def _head_loss(head, cfg, y, tgt):
    """Mean token loss of one microbatch's final activation."""
    logits = _gpt_head(head, cfg, y)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tgt.reshape(-1))


def _flag(value: bool, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, device=like.device)


def _layers(local) -> int:
    leaf = local
    while isinstance(leaf, (dict, tuple)):
        leaf = (leaf[0] if isinstance(leaf, tuple)
                else next(iter(leaf.values())))
    return leaf.shape[0]


class _Schedule:
    """What the GPipe tick loops share: the embedded microbatch stream
    (through ``pvary``: it enters stage 0's computation on every rank),
    the stage body (checkpointed under ``remat``), and the tick's stage
    input / output / hand-off."""

    def __init__(self, local, replicated, cfg, tokens, pp_axis,
                 microbatches, pos_offset, positions, remat,
                 contiguous=True, layer_fn=None):
        _, self.pp, self.stage = _axis(pp_axis)
        self.pp_axis, self.cfg = pp_axis, cfg
        b, s = tokens.shape
        if b % microbatches:
            raise ValueError(
                f"batch {b} must divide into microbatches={microbatches}")
        x, _, self.rope_tabs = _gpt_embed(replicated, cfg, tokens,
                                          pos_offset, positions)
        x = pvary(x, pp_axis)
        self.b, self.s = b, s
        self.mb = b // microbatches
        self.microbatches = microbatches
        self.mbs = x.reshape(microbatches, self.mb, s, cfg.emb_dim)
        self.local = local
        n_layers = _layers(local)
        per_stage = cfg.num_layers // self.pp
        if contiguous:
            # a tree stacked for the circular schedule or for another pp
            # would run and give a finite, wrong loss
            if n_layers != per_stage or (
                    layer_fn is None and local["qkv"]["weight"].dim() != 3):
                raise ValueError(
                    f"staged params carry {n_layers} layers/stage with qkv "
                    f"weight {tuple(_first_qkv(local).shape)}, expected "
                    f"[{per_stage}, qkv_dim, emb] (num_layers/pp contiguous "
                    "layers per device): params stacked with "
                    "stack_pp_params_circular go through "
                    "pp_gpt_loss_circular, and params stacked for a "
                    "different pp than this axis do not fit")
        if layer_fn is None:
            def layer_fn(p_j, x):
                return _dense_block(cfg, p_j, x, self.rope_tabs)
        self.layer_fn = layer_fn

        def run_stage(x):
            for j in range(n_layers):
                x = layer_fn(_index(local, j), x)
            return x

        self.run_stage = _maybe_remat(run_stage, remat)
        self.n_ticks = microbatches + self.pp - 1
        self.first = _flag(self.stage == 0, x)
        self.last = _flag(self.stage == self.pp - 1, x)

    def zeros(self):
        return torch.zeros((self.mb, self.s, self.cfg.emb_dim),
                           dtype=self.cfg.dtype, device=self.mbs.device)

    def stage_io(self, incoming, t):
        """Stage 0 takes microbatch ``t`` (clamped), the others what was
        handed over; returns the stage output and its hand-off (None on
        the last tick, whose hand-off no stage reads)."""
        fresh = self.mbs[min(max(t, 0), self.microbatches - 1)]
        y = self.run_stage(torch.where(self.first, fresh, incoming))
        handoff = (ring_shift(y, self.pp_axis)
                   if t + 1 < self.n_ticks else None)
        return y, handoff


def _first_qkv(local):
    return (local[0] if isinstance(local, tuple) else local)["qkv"]["weight"]


def _index(tree, j):
    if isinstance(tree, tuple):
        return tuple(_index(t, j) for t in tree)
    return _map(lambda a: a[j], tree)


def _maybe_remat(fn, remat: bool):
    if not remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _head_of(replicated, pp_axis):
    """The final LN and head, through ``pvary``: every stage uses them,
    and their gradient is the sum of the stages'."""
    return {k: _map(lambda a: pvary(a, pp_axis), replicated[k])
            for k in ("lnf", "head")}


def pp_gpt_apply(staged_params, replicated_params, cfg, tokens, pp_axis, *,
                 microbatches: int, pos_offset=0, positions=None,
                 remat: bool = False):
    """``GPT.forward`` with the block stack pipelined over ``pp_axis``:
    ``staged_params`` this rank's stage (leading dim 1), ``tokens [b, s]``
    the same on every rank with ``b % microbatches == 0``.  The last
    stage's outputs are summed over the axis (an all-reduce of a masked
    buffer) so every rank returns the full fp32 logits: for evaluation and
    the equivalence tests; train through :func:`pp_gpt_loss`."""
    local = _map(lambda a: a[0], staged_params)
    sched = _Schedule(local, replicated_params, cfg, tokens, pp_axis,
                      microbatches, pos_offset, positions, remat)
    pp = sched.pp
    incoming = sched.zeros()
    outputs = [sched.zeros() for _ in range(microbatches)]
    for t in range(sched.n_ticks):
        y, handoff = sched.stage_io(incoming, t)
        if t >= pp - 1:  # the last stage finished microbatch t - (pp - 1)
            i = t - (pp - 1)
            outputs[i] = torch.where(sched.last, y, outputs[i])
        incoming = handoff
    stacked = torch.stack(outputs)
    stacked = psum(torch.where(sched.last, stacked, stacked.new_zeros(())),
                   pp_axis)
    x = stacked.reshape(sched.b, sched.s, cfg.emb_dim)
    return _gpt_head(replicated_params, cfg, x)


def pp_gpt_loss(staged_params, replicated_params, cfg, tokens, targets,
                pp_axis, *, microbatches: int, pos_offset=0,
                positions=None, remat: bool = True):
    """Pipelined causal-LM loss with a stage-local head: the GPipe ticks
    of :func:`pp_gpt_apply`, with the head and the token loss of each
    finished microbatch computed in its tick on the last stage and one
    scalar all-reduce as the rejoin.  ``targets [b, s]`` are the next
    tokens.  Returns the mean token loss, the same on every rank."""
    local = _map(lambda a: a[0], staged_params)
    sched = _Schedule(local, replicated_params, cfg, tokens, pp_axis,
                      microbatches, pos_offset, positions, remat)
    return _gpipe_loss(sched, replicated_params, cfg, targets, remat)


def _gpipe_loss(sched, replicated_params, cfg, targets, remat):
    pp, M = sched.pp, sched.microbatches
    tgt_mbs = targets.reshape(M, sched.mb, sched.s)
    head = _head_of(replicated_params, sched.pp_axis)
    head_loss = _maybe_remat(
        lambda y, tgt: _head_loss(head, cfg, y, tgt), remat)
    incoming = sched.zeros()
    loss_sum = sched.mbs.new_zeros((), dtype=torch.float32)
    for t in range(sched.n_ticks):
        y, handoff = sched.stage_io(incoming, t)
        i = min(max(t - (pp - 1), 0), M - 1)
        take = sched.last & _flag(t >= pp - 1, y)
        loss_sum = loss_sum + torch.where(take, head_loss(y, tgt_mbs[i]),
                                          loss_sum.new_zeros(()))
        incoming = handoff
    # equal microbatches: the mean of their means is the token mean
    return psum(loss_sum, sched.pp_axis) / M


def pp_gpt_loss_circular(staged_params, replicated_params, cfg, tokens,
                         targets, pp_axis, *, microbatches: int,
                         circles: int, pos_offset=0, positions=None,
                         remat: bool = True):
    """:func:`pp_gpt_loss` on the circular schedule (trees from
    :func:`stack_pp_params_circular`).  Stage ``s`` at tick ``t`` works
    stream position ``k = t - s``: circle ``k // M``, microbatch ``k %
    M``, one group forward a tick.  Stage P-1's output of an inner circle
    returns to stage 0 through an M-slot queue (slot ``h % M`` written at
    tick ``h + P``, read at tick ``h + M``), which needs ``microbatches >=
    pp``.  The loss is taken on the last circle's outputs."""
    local = _map(lambda a: a[0], staged_params)
    sched = _Schedule(local, replicated_params, cfg, tokens, pp_axis,
                      microbatches, pos_offset, positions, remat=False,
                      contiguous=False)
    pp, stage, M = sched.pp, sched.stage, microbatches
    if M < pp:
        raise ValueError(
            f"circular schedule needs microbatches >= pp ({M} < {pp}): "
            "the ring buffer re-feeds device 0 M-P+1 ticks after arrival")
    if _layers(local) != circles:
        raise ValueError(
            f"staged params carry {_layers(local)} groups/device, expected "
            f"circles={circles}: restack with "
            "stack_pp_params_circular(params, cfg, pp, circles)")
    per_group = local["qkv"]["weight"].shape[1]
    tgt_mbs = targets.reshape(M, sched.mb, sched.s)

    def run_group(v, x):
        group = _index(local, v)
        for j in range(per_group):
            x = _dense_block(cfg, _index(group, j), x, sched.rope_tabs)
        return x

    head = _head_of(replicated_params, pp_axis)
    run_group = _maybe_remat(run_group, remat)
    head_loss = _maybe_remat(
        lambda y, tgt: _head_loss(head, cfg, y, tgt), remat)
    n_ticks = circles * M + pp - 1
    incoming = sched.zeros()
    queue = [sched.zeros() for _ in range(M)]
    loss_sum = sched.mbs.new_zeros((), dtype=torch.float32)
    for t in range(n_ticks):
        # bank the arrival first (stage 0's incoming is stream position
        # t - pp), so the M == pp edge reads what it just wrote
        h = t - pp
        if h >= 0:
            queue[h % M] = incoming
        k = min(max(t - stage, 0), circles * M - 1)
        k_valid = 0 <= t - stage < circles * M
        v, m = divmod(k, M)
        x0 = torch.where(_flag(v == 0, incoming), sched.mbs[m], queue[m])
        y = run_group(v, torch.where(sched.first, x0, incoming))
        take = sched.last & _flag(v == circles - 1 and k_valid, y)
        loss_sum = loss_sum + torch.where(take, head_loss(y, tgt_mbs[m]),
                                          loss_sum.new_zeros(()))
        incoming = ring_shift(y, pp_axis) if t + 1 < n_ticks else None
    return psum(loss_sum, pp_axis) / M


def pp_tp_gpt_loss(staged_sharded, staged_replicated, replicated_params,
                   cfg, tokens, targets, pp_axis, tp_axis, *,
                   microbatches: int, pos_offset=0, positions=None,
                   remat: bool = True):
    """:func:`pp_gpt_loss` with each stage's blocks tensor-parallel over
    ``tp_axis`` (trees from :func:`stack_tp_pp_params`; this rank passes
    its ``[1, 1, ...]`` shard of ``staged_sharded`` and its ``[1, ...]``
    stage of ``staged_replicated``).  The loss comes out identical on
    every rank of the tp axis (its activations are all-reduced), so it is
    returned as it stands: the reference's ``pmean`` over tp of a
    replicated value is the identity, value and gradient."""
    _, tp, _ = _axis(tp_axis)
    local = (_map(lambda a: a[0][0], staged_sharded),
             _map(lambda a: a[0], staged_replicated))

    def layer_fn(p_j, x):
        sh_j, rep_j = p_j
        return _tp_block(cfg, sh_j, rep_j, x, sched.rope_tabs, tp_axis, tp)

    sched = _Schedule(local, replicated_params, cfg, tokens, pp_axis,
                      microbatches, pos_offset, positions, remat,
                      layer_fn=layer_fn)
    return _gpipe_loss(sched, replicated_params, cfg, targets, remat)
