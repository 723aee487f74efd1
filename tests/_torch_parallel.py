"""Workers of the port's parallel-schedule tests (``test_torch_ring_
attention.py``, ``test_torch_tensor_parallel.py``, ``test_torch_pipeline.
py``, ``test_torch_moe.py``, ``test_torch_composed.py``,
``test_torch_longctx.py``, ``test_torch_width_serving.py``).

Each runs inside a gloo world of ``tests/_torch_world.py``, registers the
axes it needs with ``basics.init_axes``, runs every case of its test file
on numpy inputs and the reference's weights (flax trees as numpy, carried
across with ``models.convert``), and returns numpy results keyed by case.
They import only torch and the port.
"""

from __future__ import annotations

import numpy as np


def _t(x):
    import torch

    return torch.from_numpy(np.array(x, copy=True))


def _np(tree):
    """A tree of tensors (or tensor grads) as numpy."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_np(v) for v in tree)
    return tree.detach().float().numpy() if tree is not None else None


def _leaves(tree):
    """A copy of a tree whose leaves require grad."""
    if isinstance(tree, dict):
        return {k: _leaves(v) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_()


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.numpy()


def _model(state, **cfg):
    """The port's GPT with ``cfg`` on the CPU, loaded from a flax tree."""
    import torch

    from horovod_tpu_torch.models import gpt, params_from_jax

    model = gpt("nano", device="cpu", dtype=torch.float32, **cfg)
    model.load_state_dict(params_from_jax(state))
    return model


def _nll(logits, targets):
    import torch.nn.functional as F

    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           targets.reshape(-1))


def _raises(fn, exc=Exception):
    try:
        fn()
    except exc as e:  # noqa: BLE001 - the message is the result
        return str(e)
    return None


# ---------------------------------------------------------------------------
# sequence parallelism
# ---------------------------------------------------------------------------


def sp_worker(q, k, v, w, kv_gqa, gpt_state, gpt_cfg, tokens):
    """Ring, zigzag and Ulysses attention and the GPT on them, on this
    rank's shard of the sequence (``sp`` = the world)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.parallel import (
        ring_attention, ring_attention_zigzag, ulysses_attention,
        zigzag_positions, zigzag_shard)

    n, r = basics.size(), basics.rank()
    basics.init_axes({"sp": n})
    sl = q.shape[1] // n

    def mine(x):
        return _t(x)[:, r * sl:(r + 1) * sl]

    def zmine(x):
        return zigzag_shard(_t(x), n, axis=1)[:, r * sl:(r + 1) * sl]

    ring = lambda *a, causal=True: ring_attention(*a, "sp", causal=causal)
    uly = lambda *a, causal=True: ulysses_attention(*a, "sp", causal=causal)
    res = {}
    for causal in (False, True):
        res[f"ring_{causal}"] = ring(mine(q), mine(k), mine(v),
                                     causal=causal).numpy()
        res[f"ulysses_{causal}"] = uly(mine(q), mine(k), mine(v),
                                       causal=causal).numpy()
    for name, fn in (("ring", ring), ("ulysses", uly)):
        qkv = [mine(x).requires_grad_() for x in (q, k, v)]
        (fn(*qkv) ** 2).sum().backward()
        res[f"{name}_grads"] = [t.grad.numpy() for t in qkv]
    bf = ring(*(mine(x).to(torch.bfloat16) for x in (q, k, v)))
    res["ring_bf16"] = (str(bf.dtype), bf.float().numpy())
    res["ring_gqa"] = ring(mine(q), mine(kv_gqa[0]), mine(kv_gqa[1])).numpy()
    zq = [zmine(x).requires_grad_() for x in (q, k, v)]
    out = ring_attention_zigzag(*zq, "sp")
    res["zigzag"] = out.detach().numpy()
    (out * zmine(w)).sum().backward()
    res["zigzag_grads"] = [t.grad.numpy() for t in zq]
    res["ulysses_heads_error"] = _raises(
        lambda: uly(*(torch.zeros(1, 2, n + 1, 4),) * 3), ValueError)
    res["zigzag_odd_error"] = _raises(
        lambda: ring_attention_zigzag(*(torch.zeros(1, 1, 2, 4),) * 3, "sp"),
        ValueError)

    # the GPT on each schedule: logits of this rank's shard and the
    # parameter gradients of the global mean token loss (each rank's
    # share summed over the axis)
    toks = _t(tokens)
    tgt = torch.roll(toks, -1, dims=1)
    s_tok = toks.shape[1] // n
    for impl in ("ring", "zigzag", "ulysses"):
        model = _model(gpt_state, **gpt_cfg, attention_impl=impl,
                       sp_axis="sp")
        if impl == "zigzag":
            pos = zigzag_positions(r, n, s_tok)
            tk = zigzag_shard(toks, n, axis=1)[:, r * s_tok:(r + 1) * s_tok]
            tg = zigzag_shard(tgt, n, axis=1)[:, r * s_tok:(r + 1) * s_tok]
            logits = model(tk, positions=pos)
        else:
            tk = toks[:, r * s_tok:(r + 1) * s_tok]
            tg = tgt[:, r * s_tok:(r + 1) * s_tok]
            logits = model(tk, pos_offset=r * s_tok)
        res[f"gpt_{impl}"] = logits.detach().numpy()
        (_nll(logits, tg) / n).backward()
        grads = {}
        for name in ("wte.weight", "block0.qkv.weight", "block1.fc2.weight",
                     "head.weight"):
            g = dict(model.named_parameters())[name].grad.clone()
            dist.all_reduce(g)
            grads[name] = g.numpy()
        res[f"gpt_{impl}_grads"] = grads
    return res


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------


def tp_worker(cases, grad_case, tokens, targets, stacking):
    """``tp_gpt_apply`` logits per case, the sharded and replicated
    gradients of ``grad_case``, and the replicated-stacking artifact
    (``stacking``: W, H, x) through ``pvary`` and ``psum``."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops.collectives import psum, pvary
    from horovod_tpu_torch.parallel import (local_shard, stack_tp_params,
                                            tp_gpt_apply)

    n, r = basics.size(), basics.rank()
    basics.init_axes({"tp": n})
    toks, tgt = _t(tokens), _t(targets)
    res = {}
    for name, (state, cfg) in cases.items():
        model = _model(state, **cfg)
        sh, rep = stack_tp_params(model, model.cfg, n)
        res[name] = tp_gpt_apply(local_shard(sh, r), rep, model.cfg, toks,
                                 "tp").detach().numpy()
    state, cfg = cases[grad_case]
    model = _model(state, **cfg)
    sh, rep = stack_tp_params(model, model.cfg, n)
    shl, repl = _leaves(local_shard(sh, r)), _leaves(rep)
    _nll(tp_gpt_apply(shl, repl, model.cfg, toks, "tp"), tgt).backward()
    res["grads"] = (_grads(shl), _grads(repl))

    W, H, x = (_t(a) for a in stacking)
    for name, mark in (("stacked", True), ("replicated", False)):
        wr = W[r].clone().requires_grad_()
        y = psum(x @ wr, "tp")
        if mark:  # H stacked per rank: y meets rank-varying weights
            y = pvary(y, "tp")
        ((y @ H) ** 2).sum().backward()
        res[f"stacking_{name}"] = wr.grad.numpy()
    return res


# ---------------------------------------------------------------------------
# pipeline parallelism
# ---------------------------------------------------------------------------


def pp_worker(cases):
    """Every pipeline case of ``cases`` whose pp is this world's size:
    ``name -> (kind, state, cfg, tokens, kwargs)``."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.parallel import (
        local_shard, pp_gpt_apply, pp_gpt_loss, pp_gpt_loss_circular,
        stack_pp_params, stack_pp_params_circular)

    n, r = basics.size(), basics.rank()
    basics.init_axes({"pp": n})
    res = {}
    for name, (kind, state, cfg, tokens, kw) in cases.items():
        model = _model(state, **cfg)
        toks = _t(tokens)
        tgt = torch.roll(toks, -1, dims=1)
        circles = kw.pop("circles", None)
        grads = kw.pop("grads", False)
        if circles:
            st, rep = stack_pp_params_circular(model, model.cfg, n, circles)
        else:
            st, rep = stack_pp_params(model, model.cfg, n)
        st, rep = local_shard(st, r), rep
        if grads:
            st, rep = _leaves(st), _leaves(rep)
        if kind.startswith("error_"):
            fn = (pp_gpt_loss if kind == "error_loss"
                  else pp_gpt_loss_circular)
            extra = {} if kind == "error_loss" else {"circles": circles}
            res[name] = _raises(lambda: fn(st, rep, model.cfg, toks, tgt,
                                           "pp", **kw, **extra))
            continue
        if kind == "apply":
            out = pp_gpt_apply(st, rep, model.cfg, toks, "pp", **kw)
            loss = _nll(out, tgt)
        elif kind == "loss":
            out = loss = pp_gpt_loss(st, rep, model.cfg, toks, tgt, "pp",
                                     **kw)
        else:
            out = loss = pp_gpt_loss_circular(st, rep, model.cfg, toks, tgt,
                                              "pp", circles=circles, **kw)
        if grads:
            loss.backward()
            res[name] = (_np(out), _grads(st), _grads(rep))
        else:
            res[name] = _np(out)
    st, rep = stack_pp_params(model, model.cfg, n)
    res["indivisible_batch"] = _raises(lambda: pp_gpt_apply(
        local_shard(st, r), rep, model.cfg, toks[:3], "pp",
        microbatches=2), ValueError)
    return res


# ---------------------------------------------------------------------------
# expert parallelism
# ---------------------------------------------------------------------------


def ep_worker(sets, recipe):
    """``moe_mlp_ep`` on this rank's token rows and experts: ``(y, aux)``
    for each set ``name -> (x, params, kwargs)``, and for ``recipe`` (a
    set's name) the gradients of the reference's recipe: the router's
    averaged over the axis, the experts' divided by its size."""
    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops.collectives import pmean
    from horovod_tpu_torch.parallel import MoEParams, moe_mlp_ep

    n, r = basics.size(), basics.rank()
    basics.init_axes({"ep": n})

    def local(x, params, grad=False):
        per = x.shape[0] // n
        e_loc = params["w1"].shape[0] // n
        sl = slice(r * e_loc, (r + 1) * e_loc)
        parts = {k: (_t(v) if k == "router" else _t(v[sl]))
                 for k, v in params.items()}
        if grad:
            parts = {k: t.requires_grad_() for k, t in parts.items()}
        return _t(x[r * per:(r + 1) * per]), MoEParams(**parts)

    res = {}
    for name, (x, params, kw) in sets.items():
        y, aux = moe_mlp_ep(*local(x, params), "ep", **kw)
        res[name] = (y.detach().numpy(), float(aux))
    x, params, kw = sets[recipe]
    xr, lp = local(x, params, grad=True)
    y, aux = moe_mlp_ep(xr, lp, "ep", **kw)
    ((y ** 2).mean() + 0.01 * aux).backward()
    res["recipe"] = {
        "router": pmean(lp.router.grad, "ep").numpy(),
        **{k: getattr(lp, k).grad.numpy() / n
           for k in ("w1", "b1", "w2", "b2")}}
    return res


# ---------------------------------------------------------------------------
# composed meshes
# ---------------------------------------------------------------------------


def composed_worker(state, cfg, tokens, lr, momentum):
    """One SGD-with-momentum step of each composition over a 4-rank
    world: dp x tp, dp x pp and pp x tp; the loss and this rank's updated
    trees (the gradients averaged over dp, as the reference's recipe)."""
    import torch
    import torch.distributed as dist

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.ops.collectives import _axis
    from horovod_tpu_torch.parallel import (
        local_shard, pp_gpt_apply, pp_tp_gpt_loss, stack_pp_params,
        stack_tp_params, stack_tp_pp_params, tp_gpt_apply)

    r = basics.rank()
    toks = _t(tokens)
    tgt = torch.roll(toks, -1, dims=1)

    def sgd(trees, loss, dp_axis):
        """Average the gradients over dp, one SGD step; updated trees."""
        loss.backward()
        group, dp, idx = _axis(dp_axis) if dp_axis else (None, 1, 0)
        flat = []

        def walk(t):
            for v in t.values():
                walk(v) if isinstance(v, dict) else flat.append(v)
        for t in trees:
            walk(t)
        opt = torch.optim.SGD(flat, lr=lr, momentum=momentum)
        for p in flat:
            if dp > 1:
                dist.all_reduce(p.grad, group=group)
                p.grad /= dp
        opt.step()
        lv = loss.detach().clone()
        if dp > 1:
            dist.all_reduce(lv, group=group)
            lv /= dp
        return [_np(t) for t in trees], float(lv)

    def batch(dp_axis):
        _, dp, idx = _axis(dp_axis)
        per = toks.shape[0] // dp
        return toks[idx * per:(idx + 1) * per], tgt[idx * per:(idx + 1) * per]

    res = {}
    model = _model(state, **cfg)
    coords = basics.init_axes({"dp": 2, "tp": 2})
    sh, rep = stack_tp_params(model, model.cfg, 2)
    sh, rep = _leaves(local_shard(sh, coords["tp"])), _leaves(rep)
    tk, tg = batch("dp")
    res["dp_tp"] = sgd((sh, rep), _nll(
        tp_gpt_apply(sh, rep, model.cfg, tk, "tp"), tg), "dp")

    coords = basics.init_axes({"dp": 2, "pp": 2})
    st, rep = stack_pp_params(model, model.cfg, 2)
    st, rep = _leaves(local_shard(st, coords["pp"])), _leaves(rep)
    tk, tg = batch("dp")
    res["dp_pp"] = sgd((st, rep), _nll(pp_gpt_apply(
        st, rep, model.cfg, tk, "pp", microbatches=2), tg), "dp")

    coords = basics.init_axes({"pp": 2, "tp": 2})
    a, b, c = stack_tp_pp_params(model, model.cfg, 2, 2)
    a = _leaves(_index2(a, coords))
    b, c = _leaves(local_shard(b, coords["pp"])), _leaves(c)
    res["pp_tp"] = sgd((a, b, c), pp_tp_gpt_loss(
        a, b, c, model.cfg, toks, tgt, "pp", "tp", microbatches=2), None)

    a4, b4, c4 = stack_tp_pp_params(model, model.cfg, 4, 2)
    res["pp_tp_mismatch"] = _raises(lambda: pp_tp_gpt_loss(
        _index2(a4, coords), local_shard(b4, coords["pp"]), c4, model.cfg,
        toks, tgt, "pp", "tp", microbatches=2))
    res["coords"] = coords
    res["rank"] = r
    return res


def _index2(tree, coords):
    """Rank (pp, tp)'s ``[1, 1, ...]`` block of a ``[pp, tp, ...]`` tree."""
    from horovod_tpu_torch.parallel.tensor_parallel import _map

    p, t = coords["pp"], coords["tp"]
    return _map(lambda a: a[p:p + 1, t:t + 1], tree)


# ---------------------------------------------------------------------------
# long-context serving
# ---------------------------------------------------------------------------


def longctx_worker(cfg_kw, q, k, v, pos, pq, pk, pv):
    """``sharded_decode_attention`` on this rank's chunk of the cache
    (plus the deeply negative case) and ``ulysses_prefill_attention`` on
    this rank's shard of the prompt."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models.transformer import TransformerConfig
    from horovod_tpu_torch.serve.longctx import (sharded_decode_attention,
                                                 ulysses_prefill_attention)

    n, r = basics.size(), basics.rank()
    basics.init_axes({"seq": n})
    cfg = TransformerConfig(dtype=torch.float32, **cfg_kw)
    sl = k.shape[1] // n

    def mine(x):
        return _t(x)[:, r * sl:(r + 1) * sl]

    res = {}
    with torch.inference_mode():
        res["decode"] = sharded_decode_attention(
            cfg, _t(q), mine(k), mine(v), _t(pos), "seq").numpy()
        res["decode_neg"] = sharded_decode_attention(
            cfg, _t(q) - 40.0, mine(k) + 40.0, mine(v), _t(pos),
            "seq").numpy()
    pl = pq.shape[1] // n
    res["prefill"] = ulysses_prefill_attention(
        *(_t(x)[:, r * pl:(r + 1) * pl] for x in (pq, pk, pv)),
        "seq").numpy()
    return res


# ---------------------------------------------------------------------------
# width-sharded serving
# ---------------------------------------------------------------------------


def width_worker(cases, steps, engine_case):
    """Width-sharded paged decode (``WidthShard`` over a ``width`` group
    of the world) against the replicated decode on the same weights, per
    case ``name -> (state, cfg, prompts)``; and a width-sharded
    ``SlotEngine``'s greedy tokens for ``engine_case``."""
    import torch

    from horovod_tpu_torch import basics
    from horovod_tpu_torch.models import decode
    from horovod_tpu_torch.parallel import local_shard, stack_tp_params
    from horovod_tpu_torch.serve import SlotEngine
    from horovod_tpu_torch.serve.engine import WIDTH_AXIS

    n, r = basics.size(), basics.rank()
    basics.init_axes({WIDTH_AXIS: n})
    res = {}
    for name, (state, cfg, prompts) in cases.items():
        model = _model(state, **cfg)
        sh, rep = stack_tp_params(model, model.cfg, n)
        shard = decode.WidthShard(model.cfg, local_shard(sh, r), rep,
                                  WIDTH_AXIS)
        out = {}
        for tag, runner in (("width", shard), ("replicated", model)):
            slots, ps = len(prompts), 8
            pool = decode.init_paged_pool(runner, 16, ps, slots)
            tables = torch.full((slots, 4), 16, dtype=torch.int64)
            for s in range(slots):
                tables[s, :2] = torch.tensor([2 * s, 2 * s + 1])
            lasts, logits = [], []
            for s, p in enumerate(prompts):
                pool, last = decode.assign_slot_paged(
                    runner, pool, tables, s, _t(np.asarray(p, np.int64)))
                lasts.append(last)
            tok = torch.stack(lasts).argmax(-1)
            for _ in range(steps):
                lg, pool = decode.decode_step_paged(runner, pool, tables,
                                                    tok)
                logits.append(lg)
                tok = lg.argmax(-1)
            out[tag] = (torch.stack(lasts).numpy(),
                        torch.stack(logits).numpy(),
                        tuple(pool["k"].shape))
        res[name] = out
    state, cfg, prompts = cases[engine_case]
    model = _model(state, **cfg)
    eng = SlotEngine(model, len(prompts), kv_mode="paged", page_size=8,
                     width=n)
    toks = {s: [eng.admit(s, p)] for s, p in enumerate(prompts)}
    for _ in range(steps):
        for s, t in eng.step(list(toks)).items():
            toks[s].append(t)
    res["engine"] = [toks[s] for s in range(len(prompts))]
    res["engine_pool_heads"] = int(eng.cache["k"].shape[3])
    return res
