"""The port's two-level schedules (``horovod_tpu_torch.parallel.
hierarchical`` and ``OverlapPlan(hierarchical_axes=...)``) held against the
JAX package's on the same numpy inputs.

The port runs a 4-rank gloo world laid out as 2 hosts of 2 ranks (rank =
cross_rank x 2 + local_rank); JAX an explicit 2 x 2 mesh (``CROSS_AXIS``,
``LOCAL_AXIS``) of the first 4 CPU devices, device (c, l) holding the rows
of rank c x 2 + l, as ``test_hierarchical.py`` builds it.  Bounds:

* fp32 values and gradients 1e-5 (sums of 4 in other orders);
* the bf16 / fp16 cross wire: one rounding of a 2-term partial sum to the
  wire type, 2^-8 / 2^-11 of the largest partial sum, then fp32;
* gpt-nano AdamW steps through the plan in ``bucket`` and
  ``bucket+zero1`` (and ``bucket`` with a bf16 cross leg), against the
  reference plan: ``test_torch_overlap.py``'s bounds (losses 2e-4;
  parameters 1e-4, and 1e-6 on all but 0.1% of the elements), not bit for
  bit, as the reference's own bitwise plan tests drift on this jax
  (ROADMAP C0).  Two kinds of element are held at 2 x STEPS x lr, the most
  AdamW can move an element whose gradient's sign rounding decides (about
  lr a step each way): the key third of each qkv bias, whose gradient is
  exactly zero (softmax ignores a constant added to every key), and, with
  the bf16 cross leg, every element, since there the gradient is rounded
  to bf16 (an element near a bf16 rounding boundary takes the other
  neighbour when the fp32 partial sums differ in their last bit).  The
  0.1% share still holds.  The port's two-level plans are held to its flat
  plans at the same bounds.

Rank (c, l) keeps shard ``l x cross_size + c`` of a reduce-scattered
buffer, as the reference's two-level scatter leaves it, and ZeRO-1 owns
that shard of every bucket.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import _torch_world
import horovod_tpu as jhvd
from horovod_tpu.models.transformer import gpt as jax_gpt
from horovod_tpu.ops.collectives import shard_map_compat
from horovod_tpu.optim import overlap as joverlap
from horovod_tpu.parallel import hierarchical as jhier
from horovod_tpu_torch.models import params_from_jax

CROSS, LOCAL = 2, 2
WORLD = CROSS * LOCAL
AXES = (jhvd.CROSS_AXIS, jhvd.LOCAL_AXIS)
TOL = 1e-5
WIRE_EPS = {"bf16": 2.0 ** -8, "fp16": 2.0 ** -11}
STEPS = 3
SEQ = 16
BUCKET_MB = 0.25
LOSS_TOL = 2e-4
PARAM_TOL = 1e-4
CLOSE_TOL, CLOSE_SHARE = 1e-6, 1e-3
LR = 1e-4
NOISE_TOL = 2 * STEPS * LR  # see the module docstring
EMB = 128                   # gpt-nano's width: qkv bias = [q | k | v]
SHAPES = {"uneven": (5,), "matrix": (3, 7), "even": (8,)}
FLAT = 8  # a buffer of 8 in 4 shards of 2


def _mesh():
    devices = np.asarray(jax.devices()[:WORLD], dtype=object)
    return Mesh(devices.reshape(CROSS, LOCAL), AXES)


def _per_rank(fn, *xs):
    """``fn`` on every device of the 2 x 2 mesh, rank r's block of each
    input; per-rank outputs stacked."""
    spec = P(AXES)
    out = jax.jit(shard_map_compat(
        lambda *a: fn(*(v[0] for v in a))[None], mesh=_mesh(),
        in_specs=tuple(spec for _ in xs), out_specs=spec))(
            *(jnp.asarray(x) for x in xs))
    return np.asarray(out)


def _inputs():
    rng = np.random.RandomState(11)
    xs = {name: rng.randn(WORLD, *shape).astype(np.float32)
          for name, shape in SHAPES.items()}
    wire = (rng.randn(WORLD, 9) * 3).astype(np.float32)
    flat = np.arange(WORLD * FLAT, dtype=np.float32).reshape(WORLD, FLAT)
    return xs, wire, flat


def _setup():
    model = jax_gpt("nano", dtype=jnp.float32, flash_block_q=16,
                    flash_block_k=16)
    tokens = np.random.RandomState(0).randint(0, 1024, (8, SEQ + 1))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens[:2, :-1]))
    return model, tokens, params


@pytest.fixture(scope="module")
def port():
    xs, wire, flat = _inputs()
    _, tokens, params = _setup()
    init = {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)).items()}
    return _torch_world.run_world(
        _torch_world.hierarchical_worker,
        (xs, wire, flat, init, tokens, STEPS, BUCKET_MB), world=WORLD,
        local_size=LOCAL, timeout=240)


def test_world_is_two_hosts_of_two(port):
    """The layout, and the topology API of a single-slice world: one GPU
    per process, one slice of every rank."""
    for r, res in enumerate(port):
        assert res["layout"] == (r % LOCAL, r // LOCAL)
        assert res["topology"] == (WORLD, r, 1, 0, WORLD, 0)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("op", ["sum", "average"])
def test_hierarchical_allreduce_matches_jax(port, shape, op):
    """Values, and the gradient of ``sum(y)`` (the same reduce of the
    cotangent), including a length the local size does not divide."""
    xs, _, _ = _inputs()
    jop = jhvd.Sum if op == "sum" else jhvd.Average
    x = xs[shape]
    want = _per_rank(lambda v: jhier.hierarchical_allreduce(v, jop), x)
    grad = _per_rank(jax.grad(lambda v: jnp.sum(
        jhier.hierarchical_allreduce(v, jop))), x)
    flat_sum = x.sum(0) / (WORLD if op == "average" else 1)
    for r, res in enumerate(port):
        y, g = res[f"allreduce_{shape}_{op}"]
        np.testing.assert_allclose(y, want[r], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(y, flat_sum, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(g, grad[r], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_hierarchical_adasum_matches_jax(port, shape):
    xs, _, _ = _inputs()
    want = _per_rank(jhier.hierarchical_adasum, xs[shape])
    for r, res in enumerate(port):
        np.testing.assert_allclose(res[f"adasum_{shape}"], want[r],
                                   atol=TOL, rtol=TOL)


@pytest.mark.parametrize("wire", ["bf16", "fp16"])
def test_compressed_cross_leg_matches_jax(port, wire):
    _, x, _ = _inputs()
    want = _per_rank(lambda v: jhier.hierarchical_allreduce(
        v, jhvd.Average, compression=wire), x)
    # one rounding of a partial sum of 2 to the wire type, then / 4
    partial = np.abs(x.reshape(CROSS, LOCAL, -1).sum(1)).max()
    atol = WIRE_EPS[wire] * partial / WORLD
    for r, res in enumerate(port):
        got = res[f"wire_{wire}"]
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want[r], atol=atol, rtol=0)
        np.testing.assert_allclose(got, x.mean(0), atol=2 * atol, rtol=0)


def test_reduce_scatter_keeps_shard_local_times_cross_plus_cross(port):
    """Rank (c, l) keeps shard ``l x 2 + c`` of the sum, as JAX's
    two-level scatter leaves it; the all-gather puts the shards back in
    order, and a bf16 cross leg scatters alike."""
    _, _, flat = _inputs()
    total = flat.sum(0)
    want = _per_rank(jhier.hierarchical_reduce_scatter, flat)
    want_bf16 = _per_rank(lambda v: jhier.hierarchical_reduce_scatter(
        v, jhvd.Average, compression="bf16"), flat)
    shard = FLAT // WORLD
    for r, res in enumerate(port):
        c, l = divmod(r, LOCAL)
        index = l * CROSS + c
        np.testing.assert_array_equal(
            res["scatter"], total[index * shard:(index + 1) * shard])
        np.testing.assert_array_equal(res["scatter"], want[r])
        np.testing.assert_allclose(res["scatter_bf16"], want_bf16[r],
                                   rtol=2.0 ** -8)
        np.testing.assert_array_equal(res["gather"], total)


def test_unknown_or_stateful_wire_is_refused(port):
    for res in port:
        assert all("unknown dcn compression" in e and "choices: none, bf16, "
                   "fp16" in e for e in res["refused"])
    with pytest.raises(ValueError, match="unknown dcn compression"):
        jhier._resolve_compressor("ef_bf16")


def test_predivide_with_hierarchical_raises_at_the_step(port):
    """Constructing the optimizer succeeds; its first step refuses, as the
    reference's transform does at its first update."""
    for res in port:
        assert "gradient_predivide_factor" in res["predivide"]


# ---------------------------------------------------------------------------
# the overlap plane on the two-level schedule
# ---------------------------------------------------------------------------

REF_MODES = {"bucket": ("bucket", None), "bucket+zero1": ("bucket+zero1",
                                                          None),
             "bucket_bf16": ("bucket", "bf16")}


@pytest.fixture(scope="module")
def reference():
    """JAX OverlapPlan on the 2 x 2 mesh with ``hierarchical_axes``: per
    case (losses, final params by port name)."""
    model, tokens, params = _setup()
    mesh = _mesh()
    out = {}
    for case, (mode, wire) in REF_MODES.items():
        plan = joverlap.OverlapPlan(
            params, optax.adamw(1e-4), mode=mode, bucket_mb=BUCKET_MB,
            hierarchical_axes=(jhvd.LOCAL_AXIS, jhvd.CROSS_AXIS),
            dcn_compression=wire, mesh=mesh, publish_metrics=False)
        spec = plan.state_spec()

        def local_step(ostate, toks, plan=plan):
            def loss_fn(p):
                logits = model.apply(p, toks[:, :-1])
                return optax.softmax_cross_entropy_with_integer_labels(
                    logits, toks[:, 1:]).mean()

            ostate, loss = plan.local_step(loss_fn)(ostate)
            return ostate, jax.lax.pmean(loss, AXES)

        step = jax.jit(shard_map_compat(
            local_step, mesh=mesh, in_specs=(spec, P(AXES)),
            out_specs=(spec, P())))
        state, losses = plan.init(params), []
        toks = jnp.asarray(tokens, jnp.int32)
        for _ in range(STEPS):
            state, loss = step(state, toks)
            losses.append(float(loss))
        out[case] = (losses, {k: v.numpy() for k, v in params_from_jax(
            jax.tree_util.tree_map(np.asarray,
                                   plan.materialize(state))).items()})
    return out


def _assert_run_close(got, losses, params, wire=False):
    np.testing.assert_allclose(got["losses"], losses, atol=LOSS_TOL,
                               rtol=LOSS_TOL)
    assert set(got["params"]) == set(params)
    far = total = 0
    for name, p in got["params"].items():
        want = params[name]
        atol = np.full(p.shape, NOISE_TOL if wire else PARAM_TOL)
        if name.endswith(".qkv.bias"):
            atol[EMB:2 * EMB] = NOISE_TOL
        assert (np.abs(p - want) <= atol).all(), (
            name, np.abs(p - want).max())
        far += int((np.abs(p - want) > CLOSE_TOL).sum())
        total += p.size
    assert far <= CLOSE_SHARE * total, (far, total)


@pytest.mark.parametrize("case", sorted(REF_MODES))
def test_overlap_plan_matches_jax(reference, port, case):
    key = {"bucket": "bucket_hier", "bucket+zero1": "bucket+zero1_hier",
           "bucket_bf16": "bucket_bf16"}[case]
    losses, params = reference[case]
    for res in port:
        _assert_run_close(res[key], losses, params,
                          wire=case == "bucket_bf16")
    for res in port[1:]:
        for name, p in res[key]["params"].items():
            np.testing.assert_array_equal(p, port[0][key]["params"][name],
                                          err_msg=name)


@pytest.mark.parametrize("mode", ["bucket", "bucket+zero1"])
def test_two_level_plan_matches_the_flat_plan(port, mode):
    for res in port:
        flat = res[f"{mode}_flat"]
        _assert_run_close(res[f"{mode}_hier"], flat["losses"],
                          flat["params"])


def test_zero1_owns_shard_local_times_cross_plus_cross(port):
    for r, res in enumerate(port):
        c, l = divmod(r, LOCAL)
        hier = res["bucket+zero1_hier"]
        assert hier["shard_index"] == l * CROSS + c
        assert res["bucket+zero1_flat"]["shard_index"] == r
        assert hier["shard_is_own"] and res["bucket+zero1_flat"][
            "shard_is_own"]


def test_world_check_runs_on_a_cpu_world():
    """``python -m horovod_tpu_torch.world_check``, the multi-GPU check of
    the reductions, on a 4-process gloo world: every check passes (the
    same script runs on four GPUs over NCCL)."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    out = subprocess.run(
        [sys.executable, "-m", "horovod_tpu_torch.world_check", "--cpu",
         "--world", "4", "--local-size", "2"],
        capture_output=True, text=True, timeout=300,
        cwd=str(Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr[-3000:]
    checks, train, verdict = (json.loads(line)
                              for line in out.stdout.strip().splitlines())
    assert verdict == {"ok": True, "failures": []}
    assert [checks["checks"][r]["hierarchical_scatter_gather"]["shard_index"]
            for r in "0123"] == [0, 2, 1, 3]
    assert set(train["train"]) >= {"off", "two_level_bucket+zero1",
                                   "adasum"}
