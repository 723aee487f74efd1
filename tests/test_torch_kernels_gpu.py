"""The port's CUDA flash-attention kernels against their plain PyTorch
versions, on an NVIDIA GPU.  Without one every test skips: a CUDA kernel
has no CPU mode.

Run on the machine with the card (the file imports no JAX; the
``--noconftest`` flag skips the JAX CPU-mesh set-up in tests/conftest.py):

    python -m pytest tests/test_torch_kernels_gpu.py --noconftest -q

Tolerance, |kernel - plain| <= atol + rtol * |plain|: fp32 1e-4 (sums in
another order), bf16 1e-2 (outputs rounded to bf16 after those sums; the
tensor-core kernels also round P and dS to bf16 before their second
product).  bf16 at head_dim 64 runs the tensor-core forward, dK/dV and dQ
(``fa.kernel_for``); fp32 and head_dims 16/32 the scalar kernels.

The next tests drive gpt-nano at head_dim 64 (2 heads, bf16) through the
training path on the card, in a one-GPU NCCL world: the overlap plane's
``bucket`` and ``bucket+zero1`` steps against ``off`` (losses within
``chip_smoke.OVERLAP_LOSS_RTOL``, exact launch counts, the buckets issued
during the backward), and remat, whose recompute launches the forward
kernel a second time per layer.

Then the conv zoo's CUDA path (cuDNN, channels_last, the BatchNorm
statistics) against its CPU path, which the CPU tests hold against JAX: one
fp32 SGD step of ResNet-18 with TF32 off within ``chip_smoke.CONV_TOL``,
and a bf16 step whose profile has no cuDNN layout-conversion kernel in any
overlap mode.  Then fp8 storage's ``act_store`` card against CPU and the
sparse embedding path's SGD steps on the card.  Last, the eager engine:
every eager op keeps CUDA tensors on the card in their dtype, and the
engine's data plane orders its NCCL reduce after the payloads' ready
events and the caller's stream after the result.  And the serving path,
which runs no kernel of this repo: the threefry sampler card against CPU,
and a small engine's paged streams bit for bit its contiguous ones, its
fp32 logits within ``chip_smoke.SERVE_LOGIT_RTOL`` of the CPU's.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from horovod_tpu_torch.models import GPT_CONFIGS, gpt
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.optim.overlap import OverlapPlan
from horovod_tpu_torch.train import lm_loss, make_adamw

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repo root's on-card smoke run)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}

# b, s, h, hkv, d, dtype, causal, window
CASES = [
    (2, 128, 4, 4, 64, torch.float32, False, None),
    (2, 128, 4, 4, 64, torch.float32, True, None),
    (1, 200, 8, 2, 64, torch.float32, True, 37),     # ragged S, GQA, band
    (2, 97, 4, 1, 32, torch.float32, True, None),    # MQA, ragged
    (1, 70, 2, 2, 16, torch.float32, False, None),
    (2, 256, 4, 2, 64, torch.bfloat16, True, None),  # tensor cores, GQA
    (1, 130, 4, 4, 32, torch.bfloat16, True, 64),
    (1, 33, 4, 4, 16, torch.bfloat16, False, None),
    # the tensor-core kernels: bf16, head_dim 64
    (2, 128, 4, 4, 64, torch.bfloat16, False, None),
    (2, 192, 4, 4, 64, torch.bfloat16, True, None),
    (2, 300, 8, 2, 64, torch.bfloat16, True, 100),   # ragged S, GQA, band
    (2, 97, 4, 1, 64, torch.bfloat16, True, None),   # MQA, ragged
]
# a GQA case per route, for the run-to-run check (the bf16 ones run the
# tensor-core dQ)
GQA_CASES = [CASES[2], CASES[5], CASES[10]]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    fa.kernels.build_all()
    return torch.device("cuda")


def _inputs(case, device, seed=0):
    b, s, h, hkv, d, dtype, causal, window = case
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda heads: torch.randn(b * heads, s, d, device=device,
                                   generator=g).to(dtype)
    args = (causal, d ** -0.5, fa._pick_block(s, 512),
            fa._pick_block(s, 256), h, hkv, window)
    return mk(h), mk(hkv), mk(hkv), mk(h), args


def _close(got, want, dtype, name):
    tol = TOL[dtype]
    got, want = got.float(), want.float()
    bad = (got - want).abs() > tol + tol * want.abs()
    assert torch.isfinite(got).all() and not bad.any(), (
        f"{name}: max abs err {(got - want).abs().max().item()}")


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_plain(cuda, case):
    q, k, v, _, args = _inputs(case, cuda)
    o, lse = fa.flash_fwd(q, k, v, *args)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, *args)
    _close(o, o_p, q.dtype, "o")
    _close(lse, lse_p, torch.float32, "lse")


@pytest.mark.parametrize("case", CASES)
def test_backward_matches_plain(cuda, case):
    q, k, v, do, args = _inputs(case, cuda)
    causal, scale, _, bk, h, hkv, window = args
    o, lse = fa.flash_fwd_plain(q, k, v, *args)
    got = fa.flash_bwd(q, k, v, o, lse, do, *args)
    want = fa.flash_bwd_plain(q, k, v, o, lse, do, causal, scale, bk, h,
                              hkv, window)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape
        _close(a, b, q.dtype, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_batch_of_one_from_a_fused_projection(cuda, dtype):
    """``flash_attention`` on q/k/v sliced out of one fused projection at
    batch 1, as a teacher-forced forward of one request gives them: the
    fold of a batch of one is a strided view the kernels refuse unless it
    is made contiguous.  Output against the reference attention."""
    from horovod_tpu_torch.parallel.ring_attention import local_attention

    s, h, d = 200, 4, 64
    g = torch.Generator(device=cuda).manual_seed(3)
    fused = torch.randn(1, s, 3 * h * d, device=cuda, generator=g).to(dtype)
    q, k, v = (fused[..., i * h * d:(i + 1) * h * d].reshape(1, s, h, d)
               for i in range(3))
    got = fa.flash_attention(q, k, v, causal=True)
    _close(got, local_attention(q, k, v, causal=True), dtype, "o")


@pytest.mark.parametrize("case", GQA_CASES)
def test_backward_is_deterministic(cuda, case):
    """No atomics: two runs give the same bits (GQA folds in one block),
    on the scalar and on the tensor-core route."""
    q, k, v, do, args = _inputs(case, cuda)
    o, lse = fa.flash_fwd(q, k, v, *args)
    first = fa.flash_bwd(q, k, v, o, lse, do, *args)
    second = fa.flash_bwd(q, k, v, o, lse, do, *args)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_masked_tiles_are_skipped(cuda):
    """The kernels' own copy of the tile predicate skips tiles, not just
    masks them: at S=1024 each kernel runs causal in under 0.7x its
    unmasked time and with a 64-key window in under 0.5x its causal time
    (``chip_smoke.tile_skip`` raises otherwise)."""
    _, ratios, _ = chip_smoke.tile_skip(fa)
    assert set(ratios) == set(fa.LAUNCHES)


@pytest.mark.parametrize("dtype,launched", [
    (torch.float32, ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")),
    (torch.bfloat16, ("flash_fwd_tc", "flash_bwd_dkdv_tc",
                      "flash_bwd_dq_tc")),
])
def test_autograd_launches_each_kernel_once(cuda, dtype, launched):
    b, s, h, d = 2, 128, 4, 64
    q, k, v = (torch.randn(b, s, h, d, device=cuda, dtype=dtype,
                           requires_grad=True) for _ in range(3))
    fa.reset_launch_counts()
    fa.flash_attention(q, k, v, causal=True).square().sum().backward()
    assert fa.LAUNCHES == {n: int(n in launched) for n in fa.LAUNCHES}
    assert q.grad.shape == q.shape and torch.isfinite(q.grad).all()


def test_tc_dq_needs_the_pairs_dkdv_filled(cuda):
    """flash_bwd_dq_tc reads (lse, delta) from the dK/dV pre-pass's scratch:
    without one its launch helper refuses; with the one that
    launch_dkdv_for_dq fills (through flash_bwd_dkdv_tc) it gives the
    plain dq."""
    case = (2, 300, 8, 2, 64, torch.bfloat16, True, 100)
    q, k, v, do, args = _inputs(case, cuda)
    causal, scale, _, bk, h, hkv, window = args
    cfg = (causal, scale, h, hkv, window)
    o, lse = fa.flash_fwd_plain(q, k, v, *args)
    dq = torch.empty_like(q)
    with pytest.raises(ValueError, match="lse, delta"):
        fa.launch_dq(q, k, v, o, lse, do, dq, *cfg, kernel="flash_bwd_dq_tc")
    fa.reset_launch_counts()
    pairs = fa.launch_dkdv_for_dq("flash_bwd_dq_tc", q, k, v, o, lse, do,
                                  torch.empty_like(k), torch.empty_like(v),
                                  *cfg)
    assert fa.LAUNCHES["flash_bwd_dkdv_tc"] == 1
    fa.launch_dq(q, k, v, o, lse, do, dq, *cfg, kernel="flash_bwd_dq_tc",
                 pairs=pairs)
    want, _, _ = fa.flash_bwd_plain(q, k, v, o, lse, do, causal, scale, bk,
                                    h, hkv, window)
    _close(dq, want, q.dtype, "dq")


def test_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    q = torch.zeros(4, 16, 48, device=cuda)  # head_dim 48
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(q, q, q, True, 0.1, 16, 16, 4, 4, None)
    q = torch.zeros(4, 16, 64, device=cuda, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.flash_fwd(q, q, q, True, 0.1, 16, 16, 4, 4, None)
    # k/v must hold the kv rows of q's batch: 4 q rows of 4 heads -> 2
    q = torch.zeros(4, 16, 64, device=cuda)
    with pytest.raises(ValueError, match=r"expected \(2, 16, 64\)"):
        fa.flash_fwd(q, q, q, True, 0.1, 16, 16, 4, 2, None)
    with pytest.raises(ValueError, match="kv_heads"):
        fa.flash_fwd(q, q, q, True, 0.1, 16, 16, 3, 3, None)
    # a contiguous view 2 bytes into its storage: TMA cannot start there
    q = torch.zeros(4 * 16 * 64 + 1, device=cuda,
                    dtype=torch.bfloat16)[1:].view(4, 16, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.flash_fwd(q, q, q, True, 0.1, 16, 16, 4, 4, None)


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    import horovod_tpu_torch as hvd

    fa.kernels.build_all()
    hvd.init()
    yield hvd
    hvd.shutdown()


def _nano_tc(**overrides):
    """gpt-nano with 2 heads: head_dim 64 in bf16, the tensor-core route;
    the same seeded weights on every call."""
    return gpt("nano", num_heads=2, dtype=torch.bfloat16, **overrides)


def _tokens():
    return torch.from_numpy(
        np.random.RandomState(0).randint(0, 1024, (2, 129))).cuda()


def _overlap_steps(mode, steps=3):
    model = _nano_tc()
    plan = OverlapPlan(model.parameters(), make_adamw, mode=mode,
                       bucket_mb=0.25)
    names = [n for n, _ in model.named_parameters()]
    seen, expected = chip_smoke.issue_order(fa, plan, names)
    toks = _tokens()
    fa.reset_launch_counts()
    losses = []
    for _ in range(steps):
        plan.zero_grad()
        loss = lm_loss(model, toks)
        loss.backward()
        plan.step()
        losses.append(float(loss.detach()))
    early = (chip_smoke.early_issues(seen, len(plan.layout.buckets),
                                     model.cfg.num_layers)
             if mode != "off" else None)
    return losses, dict(fa.LAUNCHES), early, expected


@pytest.mark.parametrize("mode", ["bucket", "bucket+zero1"])
def test_overlap_step_on_the_card(world, mode):
    off, _, _, _ = _overlap_steps("off")
    losses, launches, early, expected = _overlap_steps(mode)
    layers = GPT_CONFIGS["nano"].num_layers
    assert launches == {n: 3 * layers if n in chip_smoke.MAIN_PATH else 0
                        for n in fa.LAUNCHES}
    assert chip_smoke.max_rel(losses, off) <= chip_smoke.OVERLAP_LOSS_RTOL
    assert all(n >= expected > 0 for n in early), (early, expected)


def test_remat_recomputes_the_forward_kernel(world):
    """One remat backward launches ``flash_fwd_tc`` twice per layer and
    the backward kernels once; the gradients are the plain backward's."""
    toks = _tokens()
    grads = {}
    for remat in (True, False):
        model = _nano_tc(remat=remat, pos_embedding="rope")
        fa.reset_launch_counts()
        lm_loss(model, toks).backward()
        grads[remat] = {n: p.grad for n, p in model.named_parameters()}
        if remat:
            layers = model.cfg.num_layers
            assert fa.LAUNCHES == {
                n: (2 * layers if n == "flash_fwd_tc" else layers)
                if n in chip_smoke.MAIN_PATH else 0 for n in fa.LAUNCHES}
    for name, g in grads[True].items():
        _close(g, grads[False][name], torch.bfloat16, name)


@pytest.mark.parametrize("pool", ["avg_same", "max_padded", "max_valid"])
def test_conv_pools_match_the_cpu(cuda, pool):
    """The pools' forward and backward on channels_last input, card
    against CPU: ``layers.avg_pool`` pads its zeros itself because
    torch's CUDA ``avg_pool2d`` backward with ``padding`` > 0 on a
    channels_last input disagrees with the CPU (see its docstring)."""
    from horovod_tpu_torch.models import layers

    fn = {"avg_same": lambda x: layers.avg_pool(x, 3, 1, "SAME"),
          "max_padded": lambda x: layers.max_pool(x, 3, 2, [(1, 1), (1, 1)]),
          "max_valid": lambda x: layers.max_pool(x, 3, 2)}[pool]
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 64, 9, 9, generator=g).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(fn(x).shape, generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        xd = x.detach().to(dev).requires_grad_()
        y = fn(xd)
        (y * w.to(dev)).sum().backward()
        out[dev] = (y.detach().cpu(), xd.grad.cpu())
    for got, want in zip(out["cuda"], out["cpu"]):
        _close(got, want, torch.float32, pool)


def test_conv_step_on_the_card_matches_the_cpu(world):
    """Logits, loss, every gradient, the updated parameters and running
    statistics (``card_vs_cpu`` raises outside ``CONV_TOL``)."""
    errs, failures = chip_smoke.card_vs_cpu("resnet18", 4, 64)
    assert not failures, failures
    assert set(errs) == {"logits", "loss", "grad", "param", "stat"}


@pytest.mark.parametrize("mode", ["off", "bucket", "bucket+zero1"])
def test_conv_step_stays_channels_last(world, mode):
    """No NCHW <-> NHWC conversion on the card: the images, activations
    and weights stay channels_last through the step, ZeRO-1's re-pointed
    weights included."""
    from horovod_tpu_torch.train import build_step

    step, state, static = build_step("resnet18", "bf16", 8, 64,
                                     overlap_mode=mode, grad_bucket_mb=4)
    state, losses = chip_smoke.run_carry(step, state, static["carry_len"], 2)
    prof = chip_smoke.profile_step(state, step, step_ms=1.0)
    assert prof["layout_conversion_ms"] == 0, prof["top"]
    assert all(np.isfinite(float(x)) for x in losses)


def test_act_store_on_the_card_equals_the_cpu(world):
    """fp8 storage: the card's e4m3 round trip (values and the rounded
    cotangent) equals the CPU's on ``act_store_grid`` in bf16, fp16 and
    fp32, NaN where NaN; the CPU's is held against JAX by the CPU tests."""
    res = chip_smoke.act_store_check()
    assert all(r["card_equals_cpu"] and r["nans"] > 0 for r in res.values())


def test_sparse_embedding_sgd_on_the_card(world):
    """``nn.Embedding(sparse=True)`` trained by SGD through
    ``DistributedOptimizer``: the sparse gradient kept sparse (an
    uncoalesced COO that SGD scatter-adds) and densified give the same
    weights, and the weights moved."""
    dense, kinds_dense = chip_smoke.sparse_sgd(True)
    sparse, kinds_sparse = chip_smoke.sparse_sgd(False)
    assert kinds_dense == ["dense"] * chip_smoke.SPARSE_STEPS
    assert kinds_sparse == ["sparse"] * chip_smoke.SPARSE_STEPS
    assert torch.equal(dense, sparse)
    assert dense.abs().sum() > 0


def test_eager_ops_keep_cuda_tensors_on_the_card(world):
    """Every eager op on CUDA tensors (world of one): the result on the
    card with the input's dtype, equal to the input, scales applied."""
    ops = chip_smoke.eager_ops_check()
    assert all(dev.startswith("cuda") for dev, _ in ops.values())


def test_eager_data_plane_orders_the_streams(world):
    """The engine's fused allreduce on a 1-rank NCCL group: the engine's
    stream waits on the payloads' ready events (they are written late, on
    the caller's stream), ``synchronize`` returns while the caller's stream
    is still busy, and the results, read on the caller's stream right after
    it (before the card drains), equal the plain version bit for bit."""
    rec = chip_smoke.eager_plane_check(shapes=((256, 64), (64,), (1000,)))
    for dtype in ("float32", "bfloat16"):
        assert rec[dtype]["max_abs_err"] == 0.0
        assert rec[dtype]["on_card"]
        assert rec[dtype]["synchronize_left_stream_busy"]


def test_sampler_on_the_card_equals_the_cpu(cuda):
    """The threefry keys, folds, splits and bits on the card equal the
    CPU's (which the CPU tests hold to ``jax.random``), the Gumbel noise
    within 2 ulp, and ``sample_token`` picks the CPU's tokens."""
    rec = chip_smoke.sampler_check()
    assert rec["gumbel_max_ulps"] <= chip_smoke.GUMBEL_ULPS
    assert rec["key_checks"] > 0 and rec["sampled_rows"] > 0


def test_paged_serving_on_the_card_equals_contiguous(cuda):
    """A bf16 head_dim-64 engine on the card, paged (virtual length = the
    contiguous cache) and contiguous, over churning greedy and sampled
    requests: the same tokens bit for bit; and an fp32 engine on the card
    within ``SERVE_LOGIT_RTOL`` of the same engine on the CPU."""
    import copy

    from horovod_tpu_torch.serve import SlotEngine

    reqs = chip_smoke.serve_requests(10, (8, 100), (4, 24), 3, vocab=1024)
    model = gpt("nano", num_heads=2, emb_dim=128, max_len=128,
                device="cuda")
    toks = {}
    for mode, kw in (("contiguous", {}),
                     ("paged", {"kv_mode": "paged", "page_size": 16,
                                "num_pages": 24})):
        run = chip_smoke.serve_loop(SlotEngine(model, 4, **kw), reqs)
        toks[mode] = run["tokens"]
    assert toks["paged"] == toks["contiguous"]
    assert all(len(toks["paged"][r.rid]) == r.max_new_tokens for r in reqs)

    cpu = gpt("nano", num_heads=2, emb_dim=128, max_len=128, device="cpu",
              dtype=torch.float32, attention_impl="reference")
    runs = {}
    for dev, m in (("cpu", cpu), ("cuda", copy.deepcopy(cpu).cuda())):
        with chip_smoke.LogitTap(keep=True) as tap:
            runs[dev] = chip_smoke.serve_loop(SlotEngine(m, 4), reqs, tap)
    for r in reqs:
        want = runs["cpu"]["logits"][r.rid]
        m = chip_smoke.margin_rule(runs["cuda"]["tokens"][r.rid],
                                   runs["cpu"]["tokens"][r.rid],
                                   torch.stack(want),
                                   chip_smoke.SERVE_FP32_MARGIN,
                                   teacher_forced=False)
        chip_smoke.check_stream_logits(
            r.rid, runs["cuda"]["logits"][r.rid][:m["compared"]],
            want[:m["compared"]], chip_smoke.SERVE_LOGIT_RTOL)
