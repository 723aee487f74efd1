"""The port's ``horovod.torch`` surface (``interop/torch.py``) on its eager
engine, against the JAX package's (``horovod_tpu/interop/torch.py``; the
file ``tests/test_torch_interop.py`` tests that one and stays as it is).

World of one, in process: ``tests/test_torch_interop.py``'s cases on the
port, each also run through the JAX package's module on the same inputs
where both take them (the JAX module takes host tensors only; the port
takes CUDA ones too, so the GPU-rejection case inverts: only devices that
are neither CUDA nor CPU are refused).

A 2-rank gloo world (one spawn): the hook ``DistributedOptimizer`` on
gpt-nano (fp32, 3 AdamW steps of four rows per rank, as
``tests/test_torch_optim.py``) held
* against the JAX reference transform (``DistributedOptimizer(optax.
  adamw)`` on the 8-device mesh) within ``test_torch_optim``'s bounds,
* against the port's flat ``optim.DistributedOptimizer`` bit for bit (a
  mean over 2 ranks is exact), with 1 and 2 backward passes a step and in
  the synchronize / clip / ``skip_synchronize`` pattern;
``broadcast_parameters`` / ``broadcast_optimizer_state`` through the
engine; the Adasum delta optimizer against ``_numpy_adasum_rows`` of the
ranks' SGD deltas (1e-6); ``SyncBatchNorm`` against ``BatchNorm`` on the
world's concatenated batch (1e-5: fp32 sums in another order).
"""

from __future__ import annotations

import concurrent.futures
import warnings

import jax
import numpy as np
import pytest
import torch

import _torch_world
import horovod_tpu.interop.torch as jht
import horovod_tpu_torch.interop.torch as hvd
from horovod_tpu.ops.adasum import _numpy_adasum_rows
from horovod_tpu_torch.models import params_from_jax
from test_torch_optim import (  # noqa: F401  (the module's JAX fixture)
    LOSS_TOL,
    STEPS,
    _assert_params_match,
    _setup,
    reference,
)


@pytest.fixture(scope="module")
def world_of_one():
    hvd.init(device="cpu")
    yield
    hvd.shutdown()


def both(fn):
    """``fn`` through the port's module and the JAX package's."""
    return fn(hvd), fn(jht)


def test_allreduce_identity_single_process(world_of_one):
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    mine, ref = both(lambda m: m.allreduce(x))
    assert torch.equal(mine, x) and torch.equal(mine, ref)


def test_allreduce_inplace_writes_back(world_of_one):
    x = torch.ones(4)
    assert hvd.allreduce_(x, op=hvd.Sum) is x
    assert torch.equal(x, torch.ones(4))


def test_allreduce_bf16_roundtrip(world_of_one):
    x = torch.ones(8, dtype=torch.bfloat16)
    mine, ref = both(lambda m: m.allreduce(x, op=m.Sum))
    assert mine.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(mine, ref)


def test_cuda_tensors_accepted_other_devices_refused(world_of_one):
    """The JAX module refuses every non-CPU tensor; the port takes CUDA
    (tests/test_torch_kernels_gpu.py runs it on the card) and refuses
    only what is neither."""
    fake = torch.ones(2).to("meta")
    with pytest.raises(ValueError, match="host \\(CPU\\) tensors"):
        jht.allreduce(fake)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        hvd.allreduce(fake)


def test_allreduce_grad_is_allreduced(world_of_one):
    x = torch.randn(3, requires_grad=True)
    hvd.allreduce(x, op=hvd.Sum).sum().backward()
    assert torch.equal(x.grad, torch.ones(3))


def test_allgather_and_grad(world_of_one):
    x = torch.randn(2, 3, requires_grad=True)
    g = hvd.allgather(x)
    assert g.shape == (2, 3)
    g.sum().backward()
    assert torch.equal(x.grad, torch.ones(2, 3))


def test_broadcast_grad_root(world_of_one):
    x = torch.randn(4, requires_grad=True)
    hvd.broadcast(x, root_rank=0).sum().backward()
    assert torch.equal(x.grad, torch.ones(4))


def test_poll_synchronize(world_of_one):
    h = hvd.allreduce_async(torch.ones(2))
    out = hvd.synchronize(h)
    assert hvd.poll(h)
    assert torch.equal(out, torch.ones(2))


def _linear_step(m):
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    opt = m.DistributedOptimizer(torch.optim.SGD(model.parameters(), lr=0.1),
                                 named_parameters=model.named_parameters())
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    opt.zero_grad()
    return model.weight.detach()


def test_distributed_optimizer_step(world_of_one):
    mine, ref = both(_linear_step)
    torch.manual_seed(0)
    assert not torch.equal(mine, torch.nn.Linear(3, 2).weight.detach())
    assert torch.equal(mine, ref)


def test_zero_grad_with_inflight_raises(world_of_one):
    model = torch.nn.Linear(2, 1)
    opt = hvd.DistributedOptimizer(
        torch.optim.SGD(model.parameters(), lr=0.1),
        named_parameters=model.named_parameters())
    model(torch.ones(1, 2)).sum().backward()
    with pytest.raises(AssertionError, match="in flight"):
        opt.zero_grad()
    opt.synchronize()
    opt.zero_grad()


def test_duplicate_parameter_names_rejected(world_of_one):
    params = list(torch.nn.Linear(2, 1).parameters())
    with pytest.raises(ValueError, match="unique"):
        hvd.DistributedOptimizer(
            torch.optim.SGD(params, lr=0.1),
            named_parameters=[("p", params[0]), ("p", params[1])])


def test_broadcast_parameters_state_dict(world_of_one):
    model = torch.nn.Linear(3, 2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k])


def test_broadcast_optimizer_state(world_of_one):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    hvd.broadcast_optimizer_state(opt, root_rank=0)  # no-op world of 1
    assert opt.state_dict()["state"]


def test_sync_batch_norm_single_process_matches_local_bn(world_of_one):
    torch.manual_seed(0)
    x = torch.randn(8, 4, 5, 5, requires_grad=True)
    x2 = x.detach().clone().requires_grad_(True)
    sbn = hvd.SyncBatchNorm(4)
    bn = torch.nn.BatchNorm2d(4)
    bn.load_state_dict(sbn.state_dict())
    out_s, out_b = sbn(x), bn(x2)
    assert torch.allclose(out_s, out_b, atol=1e-6)
    out_s.sum().backward()
    out_b.sum().backward()
    assert torch.allclose(x.grad, x2.grad, atol=1e-6)


def test_sync_batch_norm_fn_matches_the_reference(world_of_one):
    """The custom Function (statistics through engine allreduces) against
    the JAX module's on the same fp64 inputs and cotangent, forward and
    backward, and both against plain batch norm."""
    torch.manual_seed(1)
    x = torch.randn(6, 3, dtype=torch.float64)
    g = torch.randn(6, 3, dtype=torch.float64)
    outs = []
    for fn in (hvd._SyncBatchNormFn, jht._SyncBatchNormFn):
        xs = x.clone().requires_grad_(True)
        w = torch.ones(3, dtype=torch.float64, requires_grad=True)
        b = torch.zeros(3, dtype=torch.float64, requires_grad=True)
        out, _, _ = fn.apply(xs, w, b, 1e-5)
        out.backward(g)
        outs.append((out.detach(), xs.grad, w.grad, b.grad))
    ref = torch.nn.functional.batch_norm(
        x, None, None, torch.ones(3, dtype=torch.float64),
        torch.zeros(3, dtype=torch.float64), training=True, eps=1e-5)
    assert torch.allclose(outs[0][0], ref, atol=1e-8)
    for a, b in zip(*outs):
        assert torch.allclose(a, b, atol=1e-12)


def _adasum_step(m):
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    opt = m.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                 named_parameters=[("w", w)], op=m.Adasum)
    assert type(opt).__name__ == "_DistributedAdasumOptimizer"
    (w * torch.tensor([1.0, 2.0])).sum().backward()
    opt.step()
    opt.zero_grad()
    return w.detach()


def test_adasum_optimizer_single_process_delta_step(world_of_one):
    """World 1: Adasum of one delta is the delta itself."""
    mine, ref = both(_adasum_step)
    assert torch.allclose(mine, torch.tensor([0.9, 1.8]), atol=1e-6)
    assert torch.equal(mine, ref)


def test_adasum_optimizer_zero_grad_race_guard(world_of_one):
    w = torch.nn.Parameter(torch.ones(2))
    opt = hvd.DistributedOptimizer(torch.optim.SGD([w], lr=0.1),
                                   named_parameters=[("w", w)], op=hvd.Adasum)
    w.sum().backward()
    with pytest.raises(AssertionError, match="in flight"):
        opt.zero_grad()
    opt.step()


@pytest.mark.parametrize("dt", [torch.float32, torch.float64, torch.float16,
                                torch.bfloat16, torch.int32, torch.int64,
                                torch.uint8])
def test_allreduce_dtype_dims_grid(world_of_one, dt):
    """dtype, shape and values kept across dims 1-3 (world 1: identity)."""
    for dim in (1, 2, 3):
        shape = (2,) * dim
        x = (torch.arange(2 ** dim) % 3).reshape(shape).to(dt)
        op = hvd.Sum if not dt.is_floating_point else hvd.Average
        out = hvd.allreduce(x, op=op, name=f"grid.{dt}.{dim}")
        assert out.dtype == dt and out.shape == shape
        assert torch.equal(out, x)


def test_allgather_ragged_dim0_grid(world_of_one):
    for dim in (1, 2, 3):
        x = torch.ones((3,) + (2,) * (dim - 1))
        assert torch.equal(hvd.allgather(x, name=f"ag.{dim}"), x)


def _clip_pattern(m):
    w = torch.nn.Parameter(torch.tensor([3.0, 4.0]))
    opt = m.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                 named_parameters=[("w", w)])
    (w * torch.tensor([30.0, 40.0])).sum().backward()
    opt.synchronize()
    torch.nn.utils.clip_grad_norm_([w], max_norm=5.0)
    with opt.skip_synchronize():
        opt.step()
    after = w.detach().clone()
    opt.zero_grad()
    w.sum().backward()
    opt.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        opt.step()
    return after, any("skip_synchronize" in str(x.message) for x in rec)


def test_skip_synchronize_clip_pattern(world_of_one):
    """synchronize -> clip -> step without a second synchronize (reference
    torch/__init__.py:184-202), and the warning for a step after a bare
    synchronize; the Adasum optimizer refuses the context."""
    (mine, warned), (ref, ref_warned) = both(_clip_pattern)
    # clipped grad = [30,40]/50*5 = [3,4]; w = [3,4] - 1.0*[3,4] = 0
    assert torch.allclose(mine, torch.zeros(2), atol=1e-6)
    assert torch.equal(mine, ref) and warned and ref_warned
    w2 = torch.nn.Parameter(torch.ones(2))
    aopt = hvd.DistributedOptimizer(torch.optim.SGD([w2], lr=0.1),
                                    named_parameters=[("w2", w2)],
                                    op=hvd.Adasum)
    with pytest.raises(AssertionError, match="not supported"):
        with aopt.skip_synchronize():
            pass


def test_allreduce_average_spelling_compat(world_of_one):
    x = torch.ones(4)
    assert torch.equal(hvd.allreduce(x, True), x)  # positional average
    assert torch.equal(hvd.allreduce(x, average=False), x)
    y = torch.ones(3)
    hvd.synchronize(hvd.allreduce_async(y, average=False))
    hvd.allreduce_(y, average=True)
    hvd.synchronize(hvd.allreduce_async_(y, average=False))
    with pytest.raises(ValueError, match="op parameter supersedes"):
        hvd.allreduce(x, average=True, op=hvd.Sum)
    with pytest.raises(TypeError, match="must be a bool"):
        hvd.allreduce(x, hvd.Sum)


def test_allreduce_compression_kwarg(world_of_one):
    x = torch.full((8,), 3.0)
    out = hvd.allreduce(x, op=hvd.Sum, compression=hvd.Compression.fp16)
    assert out.dtype == torch.float32
    assert torch.equal(out, x)


def test_compression_fp16_roundtrip(world_of_one):
    t = torch.randn(8)
    wire, ctx = hvd.Compression.fp16.compress(t)
    assert wire.dtype == torch.float16
    out = hvd.Compression.fp16.decompress(wire, ctx)
    assert out.dtype == torch.float32
    assert torch.allclose(out, t, atol=1e-3)


# ------------------------------------------------------- 2-rank gloo world


@pytest.fixture(scope="module")
def world():
    """The 2-rank world, started in the background: its ranks run while the
    JAX reference (the ``reference`` fixture) compiles.  Yields the future
    of its results and the SyncBatchNorm inputs."""
    _, tokens, params = _setup()
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    rng = np.random.RandomState(5)
    bn_xs = rng.randn(2, 6, 4, 3).astype(np.float32)
    bn_ws = rng.randn(2, 6, 4, 3).astype(np.float32)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(
            _torch_world.run_world, _torch_world.interop_worker,
            (init, tokens, STEPS, bn_xs, bn_ws, {"HVDTPU_CYCLE_TIME": "2"}),
            timeout=120), bn_xs, bn_ws


def test_hook_optimizer_matches_jax(world, reference):
    results = world[0].result()
    for res in results:
        losses, params = res["hook"]
        np.testing.assert_allclose(losses, reference[0], atol=LOSS_TOL,
                                   rtol=LOSS_TOL)
        _assert_params_match(params, reference[1])


@pytest.mark.parametrize("hook,flat", [("hook", "flat"),
                                       ("hook_k2", "flat_k2"),
                                       ("hook_clip", "flat_clip")])
def test_hook_optimizer_equals_the_flat_one_bit_for_bit(world, hook, flat):
    results = world[0].result()
    for res in results:
        (hl, hp), (fl, fp) = res[hook], res[flat]
        assert hl == fl
        for name in fp:
            np.testing.assert_array_equal(hp[name], fp[name], err_msg=name)
    for name, p0 in results[0][hook][1].items():  # replicas identical
        np.testing.assert_array_equal(p0, results[1][hook][1][name])


def test_broadcast_optimizer_state_through_the_engine(world):
    results = world[0].result()
    assert results[0]["state_digest"] == results[1]["state_digest"]


def test_adasum_delta_optimizer_on_two_ranks(world):
    results = world[0].result()
    for name in results[0]["adasum"]:
        start = results[0]["adasum"][name][0]
        deltas = np.stack([-0.1 * res["adasum"][name][1].astype(np.float64)
                           for res in results]).reshape(2, -1)
        want = start + _numpy_adasum_rows(deltas).reshape(start.shape)
        for res in results:
            np.testing.assert_allclose(res["adasum"][name][2], want,
                                       rtol=1e-6, atol=1e-6, err_msg=name)


def test_sync_batch_norm_uses_the_worlds_batch(world):
    results, xs, ws = world[0].result(), world[1], world[2]
    x = torch.from_numpy(np.concatenate(xs)).requires_grad_()
    bn = torch.nn.BatchNorm1d(xs.shape[2])
    y = bn(x)
    (y * torch.from_numpy(np.concatenate(ws))).sum().backward()
    rows = xs.shape[1]
    for r, res in enumerate(results):
        out, grad, mean, var = res["sync_bn"]
        sl = slice(r * rows, (r + 1) * rows)
        np.testing.assert_allclose(out, y.detach().numpy()[sl], atol=1e-5)
        np.testing.assert_allclose(grad, x.grad.numpy()[sl], atol=1e-5)
        np.testing.assert_allclose(mean, bn.running_mean.numpy(), atol=1e-5)
        np.testing.assert_allclose(var, bn.running_var.numpy(), atol=1e-5)


@pytest.mark.parametrize("op", ["Average", "Adasum"])
def test_a_dropped_optimizer_is_freed(world_of_one, op):
    """The hooks live on the parameters (in C++, out of gc's sight) and hold
    the optimizer weakly: dropping it frees it and its state while the
    model lives on, and the model's backward then reduces nothing."""
    import gc
    import weakref

    model = torch.nn.Linear(3, 2)
    opt = hvd.DistributedOptimizer(
        torch.optim.Adam(model.parameters()),
        named_parameters=model.named_parameters(), op=getattr(hvd, op))
    model(torch.ones(1, 3)).sum().backward()
    opt.step()
    gone = weakref.ref(opt)
    del opt
    gc.collect()
    assert gone() is None
    model(torch.ones(1, 3)).sum().backward()  # the hooks find no optimizer
