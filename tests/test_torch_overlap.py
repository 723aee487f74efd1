"""The port's backward-overlap plane (``horovod_tpu_torch.optim.overlap``)
held against the JAX package's (``horovod_tpu.optim.overlap``).

Layouts: the port's ``build_layout`` on the JAX flatten order gives the
JAX buckets, field for field.

Training: three AdamW steps of gpt-nano (fp32, flash attention) in each of
``off``, ``bucket`` and ``bucket+zero1``: JAX ``OverlapPlan`` on a 2-device
mesh, the port on a 2-process gloo world, four rows of the same global
batch per device / rank and the same initial weights.  Bounds as
``test_torch_optim.py``: losses 2e-4; parameters 1e-4, and 1e-6 on all but
0.1% of the elements (Adam normalises each element by its own RMS, so an
element whose gradient is at fp32 rounding moves by up to one lr).  Within
the port the three modes agree bit for bit: at 2 ranks a sum is
order-free, a reduce-scatter shard is the matching slice of the allreduce,
and AdamW is elementwise.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import _torch_world
import horovod_tpu as jhvd
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.ops.collectives import shard_map_compat
from horovod_tpu.optim import overlap as joverlap
from horovod_tpu.runtime.autotune import (
    resolve_grad_bucket_bytes as jax_resolve,
)
from horovod_tpu_torch.models import gpt, params_from_jax
from horovod_tpu_torch.optim import overlap
from horovod_tpu_torch.runtime.autotune import resolve_grad_bucket_bytes

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
SEQ = 16
WORLD = 2
BUCKET_MB = 0.25      # gpt-nano (fp32) in 19 buckets
REBUCKET_MB = 1.0     # ... and in fewer
LOSS_TOL = 2e-4
PARAM_TOL = 1e-4
CLOSE_TOL, CLOSE_SHARE = 1e-6, 1e-3
MODES = ("off", "bucket", "bucket+zero1")


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------


def _mlp_params(dtype_mix=False):
    """The JAX test's 4-layer MLP: odd leaves (37, 41) straddle buckets."""
    rng = np.random.RandomState(0)
    sizes = [32, 64, 37, 41, 10]
    out = []
    for i in range(4):
        dt = jnp.bfloat16 if dtype_mix and i % 2 else jnp.float32
        out.append({"w": jnp.asarray(rng.randn(sizes[i], sizes[i + 1]), dt),
                    "b": jnp.zeros(sizes[i + 1], dt)})
    return out


def _torch_leaf(leaf):
    t = torch.from_numpy(np.array(leaf, np.float32))
    return t.to(torch.bfloat16) if leaf.dtype == jnp.bfloat16 else t


def _nano_leaves():
    """flax gpt-nano's leaves in JAX flatten order, and the port's
    parameters in that same order (names mapped through params_from_jax:
    each leaf is filled with its index before the conversion)."""
    jm = jax_gpt("nano", dtype=jnp.float32)
    jparams = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    leaves, treedef = jax.tree_util.tree_flatten(jparams)
    marked = jax.tree_util.tree_unflatten(
        treedef, [np.full(l.shape, i, np.float32)
                  for i, l in enumerate(leaves)])
    name_of = {int(t.reshape(-1)[0]): name
               for name, t in params_from_jax(marked).items()}
    tm = dict(gpt("nano", device="cpu", dtype=torch.float32)
              .named_parameters())
    assert sorted(name_of) == list(range(len(leaves)))
    return jparams, [tm[name_of[i]] for i in range(len(leaves))]


def _assert_same_layout(jl, tl, transposed_ok=False):
    assert (tl.num_leaves, tl.bucket_bytes, tl.shard_ways, tl.total_bytes) \
        == (jl.num_leaves, jl.bucket_bytes, jl.shard_ways, jl.total_bytes)
    assert len(tl.buckets) == len(jl.buckets)
    for jb, tb in zip(jl.buckets, tl.buckets):
        assert (tb.index, tb.leaf_indices, tb.sizes, tb.pad, tb.nbytes) == \
            (jb.index, jb.leaf_indices, jb.sizes, jb.pad, jb.nbytes)
        assert str(tb.dtype) == f"torch.{jnp.dtype(jb.dtype)}"
        for js, ts in zip(jb.shapes, tb.shapes):
            # Dense kernels [in, out] are Linear weights [out, in]
            assert ts == js or (transposed_ok and ts == js[::-1]), (js, ts)


@pytest.mark.parametrize("case", [
    "size_bound", "dtype_split", "shard_pad", "gpt_nano_names",
    "non_float", "knob_resolution",
])
def test_layout_matches_jax(case, monkeypatch):
    kb = 1024
    if case == "non_float":
        with pytest.raises(ValueError, match="non-float"):
            joverlap.build_layout(
                {"w": jnp.ones(4), "step": jnp.zeros((), jnp.int32)}, 1 << 20)
        with pytest.raises(ValueError, match="non-float"):
            overlap.build_layout([torch.ones(4), torch.zeros((), dtype=torch
                                                            .int32)], 1 << 20)
        return
    if case == "knob_resolution":
        monkeypatch.delenv("HVDTPU_GRAD_BUCKET_MB", raising=False)
        assert resolve_grad_bucket_bytes() == jax_resolve() == 16 << 20
        assert resolve_grad_bucket_bytes(4) == jax_resolve(4) == 4 << 20
        monkeypatch.setenv("HVDTPU_GRAD_BUCKET_MB", "2")
        assert resolve_grad_bucket_bytes() == jax_resolve() == 2 << 20
        assert resolve_grad_bucket_bytes(0.5) == 1 << 19
        for bad in (0, -1):
            with pytest.raises(ValueError, match="positive"):
                resolve_grad_bucket_bytes(bad)
        return
    if case == "gpt_nano_names":
        jparams, tleaves = _nano_leaves()
        args = dict(bucket_bytes=64 * kb, shard_ways=WORLD)
        _assert_same_layout(joverlap.build_layout(jparams, **args),
                            overlap.build_layout(tleaves, **args),
                            transposed_ok=True)
        return
    params = _mlp_params(dtype_mix=case == "dtype_split")
    args = {"size_bound": dict(bucket_bytes=8 * kb),
            "dtype_split": dict(bucket_bytes=1 << 20),
            "shard_pad": dict(bucket_bytes=8 * kb, shard_ways=8)}[case]
    tleaves = [_torch_leaf(l) for l in jax.tree_util.tree_leaves(params)]
    jl = joverlap.build_layout(params, **args)
    tl = overlap.build_layout(tleaves, **args)
    _assert_same_layout(jl, tl)
    if case == "size_bound":
        # reverse order, size-bounded unless one oversized leaf
        covered = [i for b in tl.buckets for i in b.leaf_indices]
        assert covered == list(reversed(range(len(tleaves))))
        assert all(b.nbytes <= 8 * kb or len(b.sizes) == 1
                   for b in tl.buckets)
    if case == "dtype_split":
        assert len({b.dtype for b in tl.buckets}) == 2
        assert all(len({tleaves[i].dtype for i in b.leaf_indices}) == 1
                   for b in tl.buckets)
    if case == "shard_pad":
        assert all(b.padded_size % 8 == 0 and 0 <= b.pad < 8
                   for b in tl.buckets)


def test_bucket_concat_and_split_round_trip():
    leaves = [torch.arange(6.0).reshape(2, 3), torch.arange(5.0)]
    layout = overlap.build_layout(leaves, 1 << 20, shard_ways=4)
    (b,) = layout.buckets
    flat = overlap._bucket_concat([leaves[i] for i in b.leaf_indices], b)
    assert flat.shape == (b.padded_size,) and b.pad == 1
    assert flat[-1] == 0
    for i, piece in zip(b.leaf_indices, overlap._bucket_split(flat, b)):
        assert torch.equal(piece, leaves[i])


# ---------------------------------------------------------------------------
# training: the port on a gloo world against JAX OverlapPlan
# ---------------------------------------------------------------------------


def _setup():
    model = jax_gpt("nano", dtype=jnp.float32, flash_block_q=16,
                    flash_block_k=16)
    tokens = np.random.RandomState(0).randint(0, 1024, (8, SEQ + 1))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:2, :-1]))
    return model, tokens, params


@pytest.fixture(scope="module")
def reference():
    """JAX: STEPS AdamW steps through OverlapPlan in each mode on a
    2-device mesh; mode -> (losses, final params by port name)."""
    model, tokens, params = _setup()
    mesh = Mesh(np.asarray(jax.devices()[:WORLD]), (jhvd.DP_AXIS,))
    out = {}
    for mode in MODES:
        plan = joverlap.OverlapPlan(params, optax.adamw(1e-4), mode=mode,
                                    bucket_mb=BUCKET_MB, mesh=mesh,
                                    publish_metrics=False)
        spec = plan.state_spec()

        def local_step(ostate, toks, plan=plan):
            def loss_fn(p):
                logits = model.apply(p, toks[:, :-1])
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, toks[:, 1:]).mean()

            ostate, loss = plan.local_step(loss_fn)(ostate)
            return ostate, jax.lax.pmean(loss, jhvd.DP_AXIS)

        step = jax.jit(shard_map_compat(
            local_step, mesh=mesh, in_specs=(spec, P(jhvd.DP_AXIS)),
            out_specs=(spec, P())))
        state, losses = plan.init(params), []
        toks = jnp.asarray(tokens, jnp.int32)
        for _ in range(STEPS):
            state, loss = step(state, toks)
            losses.append(float(loss))
        out[mode] = (losses, params_from_jax(jax.tree_util.tree_map(
            np.asarray, plan.materialize(state))))
    return out


@pytest.fixture(scope="module")
def port():
    _, tokens, params = _setup()
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    return _torch_world.run_world(
        _torch_world.overlap_worker,
        (init, tokens, STEPS, BUCKET_MB, REBUCKET_MB), world=WORLD,
        timeout=240)


def _assert_params_match(got_params, want):
    assert set(got_params) == set(want)
    far = total = 0
    for name, got in got_params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(got, ref, atol=PARAM_TOL, rtol=0,
                                   err_msg=name)
        far += int((np.abs(got - ref) > CLOSE_TOL).sum())
        total += got.size
    assert far <= CLOSE_SHARE * total, (far, total)


@pytest.mark.parametrize("mode", MODES)
def test_adamw_steps_match_jax_overlap_plan(reference, port, mode):
    losses, params = reference[mode]
    for res in port:
        np.testing.assert_allclose(res[mode]["losses"], losses,
                                   atol=LOSS_TOL, rtol=LOSS_TOL)
        _assert_params_match(res[mode]["params"], params)
    # replicas identical
    for name, p0 in port[0][mode]["params"].items():
        np.testing.assert_array_equal(p0, port[1][mode]["params"][name])


@pytest.mark.parametrize("mode", ["bucket", "bucket+zero1",
                                  "bucket_set_to_none"])
def test_modes_are_bitwise_off(port, mode):
    """``bucket`` and ``bucket+zero1`` give ``off``'s losses and parameters
    bit for bit; so does ``bucket`` when ``model.zero_grad()`` dropped the
    gradient views between steps (the hook copies the fresh gradient into
    its bucket: step 2 reduces step 2's gradients, not stale zeros)."""
    for res in port:
        assert res[mode]["losses"] == res["off"]["losses"]
        for name, want in res["off"]["params"].items():
            np.testing.assert_array_equal(res[mode]["params"][name], want,
                                          err_msg=name)


def test_zero1_shards_the_buckets(port):
    n = port[0]["bucket+zero1"]["buckets"]
    assert n == port[0]["bucket"]["buckets"] > 2
    for res in port:
        sizes = res["bucket+zero1"]["shard_sizes"]
        assert len(sizes) == n
        # materialize() gives the full parameters on every rank
        assert res["bucket+zero1"]["materialized"]
    # each rank holds half of every (padded) bucket
    assert port[0]["bucket+zero1"]["shard_sizes"] == \
        port[1]["bucket+zero1"]["shard_sizes"]


def test_rebucket_n_to_m_matches_the_unbroken_run(port):
    for res in port:
        n_old, n_new = res["rebucket"]["buckets"]
        assert n_old != n_new
        assert res["rebucket"]["losses"] == res["zero1_4_steps"]["losses"]
        for name, want in res["zero1_4_steps"]["params"].items():
            np.testing.assert_array_equal(res["rebucket"]["params"][name],
                                          want, err_msg=name)
        assert "bucket+zero1" in res["rebucket_refusal"]


def test_buckets_are_issued_during_the_backward(port):
    """At least *expected* bucket reductions are issued on the host before
    block 0's attention backward (the last flash backward of the step):
    every bucket holding none of block0.qkv, block0.ln1, wpe and wte, the
    parameters whose gradients come only after it."""
    for res in port:
        issue = res["issue"]
        names = issue["names"]
        late = {i for i, n in enumerate(names)
                if n.startswith(("block0.qkv.", "block0.ln1.", "wpe",
                                 "wte."))}
        assert len(late) == 6
        expected = sum(1 for b in issue["buckets"] if not late & set(b))
        events = issue["events"]
        last_attn = max(i for i, (kind, _) in enumerate(events)
                        if kind == "attention_backward")
        early = sum(1 for kind, _ in events[:last_attn] if kind == "bucket")
        # wte, wpe and block 0's qkv / ln1 hold up at most 4 buckets
        assert expected >= len(issue["buckets"]) - 4
        assert early >= expected, (early, expected)
        # every bucket issued once, during the backward (none by step())
        issued = [i for kind, i in events if kind == "bucket"]
        assert sorted(issued) == list(range(len(issue["buckets"])))


@pytest.mark.parametrize("mode", ["bucket", "bucket+zero1"])
def test_a_dropped_plan_is_freed(mode):
    """The gradient hooks hold their plan weakly: a plan dropped with its
    model, or before it, frees its buffers and optimizer state."""
    out = _torch_world.run_world(_torch_world.dropped_plan_worker, (mode,),
                                 world=1)
    assert out == [{"plan_freed": True, "plan_freed_model_kept": True,
                    "steps_after": True}]


def test_plan_refuses_what_is_not_ported():
    """A bad mode, hierarchical axes that are not a pair and an unknown
    cross-leg wire are refused.  (``health=True`` is ported: its bundles
    are ``test_torch_health.py``'s; the two-level schedule is
    ``test_torch_hierarchical.py``'s.)"""
    params = [torch.nn.Parameter(torch.ones(3))]
    for kw, match in (({"mode": "zero3"}, "mode"),
                      ({"hierarchical_axes": ("a",)}, "local_axis"),
                      ({"dcn_compression": "ef_bf16"},
                       "unknown dcn compression")):
        with pytest.raises(ValueError, match=match):
            overlap.OverlapPlan(params, torch.optim.SGD, **kw)


@pytest.mark.parametrize("mode", MODES)
def test_bench_cli_prints_its_record(mode):
    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.bench", "--cpu",
         "--model", "gpt-nano", "--overlap", mode, "--iters", "2",
         "--warmup", "1", "--seq-len", "32", "--batch-size", "2",
         "--pos-embedding", "rope", "--remat"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "gpt-nano_bf16_tokens_per_sec_per_gpu"
    assert rec["unit"] == "tokens/sec/gpu" and rec["value"] > 0
    assert rec["device"] == "cpu" and rec["mfu"] is None
    assert rec["overlap_mode"] == mode
    assert rec["torch"] == torch.__version__
    # the CPU runs the kernels' plain versions: no launch, and it says so
    assert rec["attention"] == "plain" and rec["flash_launches"] == {}
    assert np.isfinite(rec["final_loss"])
    assert ("buckets" in rec) == (mode != "off")
