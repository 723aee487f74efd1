"""Worker functions of ``tests/test_torch_spmd.py``: the reference's SPMD
surface (``mesh``, ``distribute``, ``DistributedGradientTransform``,
``sync_gradients``) on every input of its own tests, inside a gloo world
of ``tests/_torch_world.py``.  They import only torch and the port."""

from __future__ import annotations


def _np(t):
    return t.detach().float().numpy()


def _raises(fn, exc=ValueError):
    try:
        fn()
    except exc as e:  # noqa: PERF203
        return str(e)
    return None


def spmd_worker(inp):
    """Every case of ``inp`` on this rank: row ``rank`` of each stacked
    input is this rank's.  Returns numpy results by case."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.ops.collectives import axis_rank, axis_size
    from horovod_tpu_torch.ops.sparse import IndexedSlices, to_dense
    from horovod_tpu_torch.optim import P
    from horovod_tpu_torch.optim import overlap as ov

    r, n = hvd.rank(), hvd.size()
    t = torch.from_numpy
    res = {"world": n, "axis": (axis_rank(), axis_size())}

    # -- DistributedGradientTransform (tests/test_optimizer.py) --
    tx = hvd.DistributedGradientTransform(hvd.Average)
    res["average"] = _np(tx.update({"w": t(inp["average"][r])},
                                   tx.init(None))[0]["w"])
    tx = hvd.DistributedGradientTransform(hvd.Average,
                                          gradient_predivide_factor=2.0)
    res["predivide"] = _np(tx.update((t(inp["predivide"][r]),),
                                     tx.init(None))[0][0])
    tx = hvd.DistributedGradientTransform(hvd.Average,
                                          compression=hvd.Compression.bf16)
    out = tx.update((t(inp["bf16"][r]),), tx.init(None))[0][0]
    res["bf16"], res["bf16_dtype"] = _np(out), str(out.dtype)

    # -- sparse leaves (tests/test_sparse.py) --
    tx = hvd.DistributedGradientTransform(op=hvd.Adasum,
                                          sparse_as_dense=False)
    leaf = IndexedSlices(torch.ones(1, 1), torch.tensor([0]), (4, 1))
    res["adasum_sparse"] = _raises(lambda: tx.update({"emb": leaf}, None))
    coo = torch.sparse_coo_tensor(torch.tensor([[0]]), torch.ones(1, 1),
                                  (4, 1))
    res["adasum_coo"] = _raises(lambda: tx.update({"emb": coo}, None))
    values, indices = inp["sparse_values"][r], inp["sparse_indices"][r]
    tx = hvd.DistributedGradientTransform()
    out, _ = tx.update({"emb": IndexedSlices(t(values), t(indices),
                                             (8, 2)),
                        "w": torch.ones(2) * float(indices[0])},
                       tx.init(None))
    res["sparse_as_dense"] = (_np(out["emb"]), _np(out["w"]))
    tx = hvd.DistributedGradientTransform(sparse_as_dense=False)
    kv, ki = inp["kept_values"][r], inp["kept_indices"][r]
    out, _ = tx.update({"emb": IndexedSlices(t(kv), t(ki), (6, 2))}, None)
    s = out["emb"]
    res["kept"] = (isinstance(s, IndexedSlices), tuple(s.values.shape),
                   _np(to_dense(s)))
    coo = torch.sparse_coo_tensor(t(ki).long()[None], t(kv), (6, 2))
    out, _ = tx.update([coo], None)
    res["kept_coo"] = (out[0].is_sparse, _np(out[0].to_dense()))

    # -- distribute (tests/test_train_slice.py) --
    X, y = t(inp["linreg_X"]), t(inp["linreg_y"])
    w = torch.zeros(5, 1, requires_grad=True)
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.2))

    def lin_step(w, opt, xb, yb):
        opt.zero_grad()
        loss = ((xb @ w - yb) ** 2).mean()
        loss.backward()
        opt.step()
        return w, opt, hvd.allreduce(loss.detach())

    step = hvd.distribute(lin_step,
                          in_specs=(P(), P(), P(hvd.DP_AXIS),
                                    P(hvd.DP_AXIS)),
                          out_specs=(P(), P(), P()))
    losses = []
    for _ in range(60):
        w, opt, loss = step(w, opt, X, y)
        losses.append(float(loss))
    res["linreg"] = (losses, _np(w))

    p = torch.zeros(3, requires_grad=True)
    target = torch.tensor([1.0, 2.0, 3.0])
    opt = hvd.DistributedOptimizer(torch.optim.SGD([p], lr=0.5))

    def helper_step(p, opt, batch):
        opt.zero_grad()
        ((batch @ p[None].T - batch @ target[None].T) ** 2).mean().backward()
        opt.step()
        return p, opt

    step = hvd.distribute(helper_step)
    batch = t(inp["helper_batch"])
    for _ in range(100):
        p, opt = step(p, opt, batch)
    res["helper"] = _np(p)
    # outputs split on an axis come back whole; a batch the axis does not
    # divide raises
    echo = hvd.distribute(lambda b: (b * 2, b.shape[0]),
                          out_specs=(P(hvd.DP_AXIS), P()))
    got, rows = echo(batch)
    res["gathered"] = (_np(got), rows)
    res["indivisible"] = _raises(lambda: echo(batch[:n * 8 - 1]))
    inner = hvd.distribute(lambda b: b, in_specs=(P(None, hvd.DP_AXIS),),
                           out_specs=P(None, hvd.DP_AXIS))
    res["dim1"] = _np(inner(batch[:, :2]))

    # -- sync_gradients (tests/test_overlap.py) --
    params = [{k: t(v) for k, v in layer.items()} for layer in inp["mlp"]]
    x, y = t(inp["mlp_x"]), t(inp["mlp_y"])
    rows = x.shape[0] // n
    xb, yb = x[r * rows:(r + 1) * rows], y[r * rows:(r + 1) * rows]
    seen = []
    ov.on_sync_issue = seen.append
    try:
        loss, grads = hvd.sync_gradients(_mlp_loss, params, xb, yb,
                                         bucket_mb=8 / 1024.0)
    finally:
        ov.on_sync_issue = None
    res["sync"] = (float(loss), [[_np(g) for g in (d["w"], d["b"])]
                                 for d in grads])
    res["sync_issued"] = seen
    res["sync_buckets"] = len(ov.build_layout(
        torch.utils._pytree.tree_leaves(params), 8 * 1024).buckets)
    # the same reduction taken the plain way: autograd, then an average
    leaves = [d[k].detach().requires_grad_() for d in params
              for k in ("w", "b")]
    it = iter(leaves)
    again = [{k: next(it) for k in ("w", "b")} for _ in params]
    plain = torch.autograd.grad(_mlp_loss(again, xb, yb), leaves)
    res["plain"] = [_np(hvd.allreduce(g)) for g in plain]

    def with_aux(p, xb, yb):
        return _mlp_loss(p, xb, yb), {"n": torch.tensor(1.0)}

    (loss, aux), grads = hvd.sync_gradients(with_aux, params, xb, yb,
                                            has_aux=True,
                                            bucket_mb=8 / 1024.0)
    res["aux"] = (float(aux["n"]), float(loss),
                  [sorted(d) for d in grads])
    res["bad_op"] = _raises(
        lambda: hvd.sync_gradients(_mlp_loss, params, xb, yb, op=hvd.Adasum))
    res["gpt"] = _gpt_steps(inp["gpt_state"], inp["gpt_tokens"],
                            inp["gpt_steps"])
    tx = hvd.DistributedGradientTransform(
        gradient_predivide_factor=2.0,
        hierarchical_axes=(hvd.LOCAL_AXIS, hvd.CROSS_AXIS))
    res["predivide_hierarchy"] = _raises(
        lambda: tx.update({"w": torch.ones(3)}, tx.init(None)))
    res["slice_error"] = _raises(lambda: hvd.mesh("slice"))
    res["unknown_error"] = _raises(lambda: hvd.mesh("torus"))
    return res


def _mlp_loss(params, x, y):
    """The reference test's MLP loss (tests/test_overlap.py::_loss_fn)."""
    import torch

    h = x
    for i, layer in enumerate(params):
        h = h @ layer["w"].float() + layer["b"].float()
        if i < 3:
            h = torch.relu(h)
    return ((h - y) ** 2).mean()


def _gpt_steps(state_np, tokens, steps):
    """gpt-nano (fp32) built the SPMD way: ``distribute`` over a step that
    takes its gradients from ``sync_gradients`` and passes them through
    ``DistributedGradientTransform`` into AdamW."""
    import torch

    import horovod_tpu_torch as hvd
    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.train import lm_loss_fn, make_adamw

    model = gpt("nano", device="cpu", dtype=torch.float32,
                flash_block_q=16, flash_block_k=16)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in state_np.items()})
    params = dict(model.named_parameters())
    opt = make_adamw(params.values())
    tx = hvd.DistributedGradientTransform()
    tx_state = tx.init(params)
    loss_fn = lm_loss_fn(model)

    def local_step(model, opt, toks):
        loss, grads = hvd.sync_gradients(loss_fn, params, toks,
                                         bucket_mb=0.25)
        grads, _ = tx.update(grads, tx_state)
        for name, p in params.items():
            p.grad = grads[name]
        opt.step()
        return model, opt, hvd.allreduce(loss)

    step = hvd.distribute(local_step)
    toks = torch.from_numpy(tokens)
    losses = []
    for _ in range(steps):
        model, opt, loss = step(model, opt, toks)
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: v.detach().numpy()
                       for k, v in model.state_dict().items()}}


def mesh_worker():
    """Every mesh shape of this world (4 ranks, 2 hosts of 2) with 2
    forced slices: shape, names, rank grid, each dimension's group's ranks and
    whether it is ``group_of_axis``'s; and the uneven-hosts error."""
    import dataclasses

    import torch.distributed as dist

    from horovod_tpu_torch import basics

    # two forced slices (what HVDTPU_NUM_SLICES=2 gives at init)
    topo = basics._topology
    basics._topology = dataclasses.replace(
        topo, num_slices=2, slice_id=topo.process_rank // 2)
    out = {}
    for shape in ("flat", "hierarchical", "slice"):
        m = basics.mesh(shape)
        out[shape] = {
            "shape": tuple(m.shape), "names": m.mesh_dim_names,
            "grid": m.mesh.tolist(),
            "ranks": [dist.get_process_group_ranks(m.get_group(a))
                      for a in m.mesh_dim_names],
            "own": [m.get_group(a) is basics.group_of_axis(a)
                    for a in m.mesh_dim_names],
            "cached": basics.mesh(shape) is m,
        }
    sliced = basics._topology
    basics._topology = dataclasses.replace(sliced, cross_size=3)
    basics._mesh_cache.pop("hierarchical")
    out["uneven"] = _raises(lambda: basics.mesh("hierarchical"))
    basics._topology = topo
    return out
