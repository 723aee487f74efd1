#!/usr/bin/env python3
"""On-card smoke run of horovod_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py        # from the repo root, on a machine with one GPU

Drives the port's main path — one data-parallel gpt-small training step
at full width and depth (12 layers, 12 heads, emb 768, vocab 32000, bf16,
seq 1024, batch 8 per GPU, AdamW lr 1e-4) — and holds every kernel of it
against its plain PyTorch version.  Six kernels: the tensor-core forward,
dK/dV and dQ (``flash_fwd_tc``, ``flash_bwd_dkdv_tc``, ``flash_bwd_dq_tc``;
bf16 at head_dim 64, the main path) and the scalar-FMA forward, dK/dV and
dQ (``flash_fwd``, ``flash_bwd_dkdv``, ``flash_bwd_dq``: fp32 and head_dims
16/32).  Phases, one JSON line each:

1. ``build``: compile the CUDA kernels from ``horovod_tpu_torch/csrc``
   (one nvcc per source, all at once), print the seconds taken, each
   kernel's registers, and the HGMMA (wgmma) and UTMALDG (TMA load)
   instructions in the tensor-core libraries' SASS.
2. ``kernel_check``: each kernel against its plain version at the main
   path's shape (Z=96, S=1024, D=64, bf16, causal; the scalar kernels
   too, through their launch helpers), at a bf16 GQA + window shape
   with a ragged S (tensor-core kernels) and at the same shape in fp32
   (scalar kernels); device times of all six kernels at the main shape,
   of the plain versions and of the PyTorch library call (SDPA; a
   yardstick the port never calls).  ``tile_skip``: each kernel's time
   unmasked, causal and windowed; the masked runs must be faster by the
   tiles they skip.
3. ``model_check``: gpt-nano in fp32 on the card, flash kernels against
   the plain reference attention: logits and gradients.
4. ``train``: ``init()``, ``build_gpt_step("small", "bf16", 8, 1024)``,
   2 warm-up and 5 timed steps; every loss finite, each main-path kernel
   launched 12 times per step, and the 7 losses within 1% of the same
   steps run with the plain reference attention.
5. ``profile``: one more step under ``torch.profiler``: device time by
   kernel, the device's busy share, host busy time by op (the phases
   below profile one step of each of their runs the same way).
6. ``overlap``: the same 7 steps from the same weights and tokens through
   the backward-overlap plane, ``overlap_mode="bucket"`` and
   ``"bucket+zero1"`` (16 MB buckets): losses against ``train``'s within
   ``OVERLAP_LOSS_RTOL`` (and whether bit for bit), exact launch counts,
   step time, MFU, peak memory, the buckets, and the issue order: the
   bucket collectives issued on the host before the step's last
   ``flash_bwd_dkdv_tc`` launch, held at the buckets that hold no
   gradient produced after block 0's attention backward or more.
7. ``rope_remat``: ``pos_embedding="rope"``, ``remat=True``,
   ``"bucket+zero1"``: ``flash_fwd_tc`` launched twice per layer and step
   (the recompute), the backward kernels once; losses within 1% of the
   same steps with the plain reference attention; peak memory no higher
   than the same run without remat.
8. ``conv``: the conv zoo, which runs no kernel of this repo (its
   convolutions are cuDNN's).  ``conv_check``: one SGD step of ResNet-18
   (batch 4, 64x64), ResNet-50 (batch 2, 64x64), VGG-16 (64x64) and
   Inception V3 (96x96, eval mode: see ``CONV_CHECKS``) in fp32 with TF32
   off, on the card and on the CPU from the same weights: logits, loss,
   every gradient, the updated parameters and running statistics within
   ``CONV_TOL``.  ``resnet``:
   ``build_step("resnet50", "bf16", 128, 224)``, 2 warm-up and 5 timed
   steps in ``off`` and ``bucket`` (16 MB buckets): every loss finite,
   ``bucket`` within ``OVERLAP_LOSS_RTOL`` of ``off``, the bf16 first
   loss within ``LOSS_RTOL`` of the same step in fp32 (TF32 off), no
   flash launch; images/s/GPU, MFU, memory, the buckets and their issue
   order, and one profiled step with the share of device time in cuDNN's
   layout conversions (0 if channels_last holds end to end).  ``zoo``:
   VGG-16 at 224 and Inception V3 at 299, bf16, batch 32, 1 warm-up and
   3 steps: finite losses, images/s/GPU.
9. ``reductions``: ``train``'s 7 steps from its weights and tokens through
   ``DistributedOptimizer(op=Adasum)`` and ``OverlapPlan`` with
   ``hierarchical_axes=(LOCAL_AXIS, CROSS_AXIS)`` in ``bucket``,
   ``bucket+zero1`` and ``bucket`` with a bf16 cross leg: exact launches,
   finite losses, the first three bit for bit ``train``'s (at world 1
   Adasum is the identity on fp32 gradients and both group legs reduce
   nothing), the bf16 one within ``LOSS_RTOL``; step time, busy share,
   peak memory.  Then an ``nn.Embedding(sparse=True)`` trained by SGD
   under ``sparse_as_dense`` True and False: the same weights.
10. ``eager``: ``train``'s 7 steps from its weights and tokens through the
   ``horovod.torch`` script's optimizer, ``interop.torch.
   DistributedOptimizer(named_parameters=...)``: each parameter's
   post-accumulate-grad hook enqueues ``allreduce_async`` on the eager
   engine under ``allreduce.<name>`` (149 a step), ``step()`` synchronizes
   and writes the results back; exact launches, losses bit for bit
   ``train``'s (the world-1 engine resolves every allreduce to its input,
   scale 1), gradients on the card; step time, busy share, peak memory.
   Then every eager op on CUDA tensors (result on the card, the input's
   dtype), and the engine's data plane on a 1-rank NCCL group: one fused,
   pre- and post-scaled allreduce of a block's gradients run as the engine
   runs it, against its plain version (bit for bit), with the payloads
   written late on the caller's stream (the engine's stream waits on their
   ready events) and ``synchronize`` returning while the caller's stream
   is still busy (the result is ordered on the stream, not the host).
11. ``fp8``: gpt-small ``--dtype fp8`` (e4m3 storage of the attention
   context, the branch deltas and the GELU output; 12 launches of each
   flash kernel a step) from ``train``'s weights and tokens, and ResNet-50
   fp8 (every ReLU output) from the ``resnet`` phase's, each against its
   bf16 run with the reference's ``test_fp8.py`` gates (first loss within
   2%, later ones within 15% + 0.05, finite); step time, rate, MFU, peak
   memory beside bf16's.  Then ``act_store`` on the card against the CPU
   on ``act_store_grid``, values and gradients, NaN where NaN.

12. ``serve_check`` (fp32, TF32 off): the serving path, which runs no
   kernel of this repo (decode and prefill attention are fp32 einsums, as
   the reference's).  gpt-small (reference attention, seed-0 weights) in
   a contiguous ``SlotEngine`` of 8 slots serving 12 greedy requests of
   16 tokens (prompts of ``RandomState(0).randint(16, 257)`` tokens): each
   emission's logit row (the first token's and the decoded ones') within
   ``SERVE_LOGIT_RTOL`` x max |logit| of a teacher-forced ``GPT.forward``
   over prompt + tokens, every token by the margin rule (``margin_rule``)
   at ``SERVE_FP32_MARGIN`` against it, and the same gate rejecting a
   planted fault (``planted_fault``); then the same engine and
   requests at 2 layers on the card and on the CPU from the same weights:
   logits of every emission within ``SERVE_LOGIT_RTOL``, tokens by the
   margin rule.
13. ``serve`` (bf16): gpt-small as ``train`` builds it (learned positions,
   seed 0) behind a 16-slot ``SlotEngine``, contiguous (``cache_len``
   1024) and then paged (512 pages of 16 rows, half the worst case, so
   admission waits for pages), serving 48 requests enqueued at step 0
   (prompts of ``randint(16, 769)`` tokens, budgets ``randint(16, 129)``,
   every 4th request sampled at temperature 0.8, top-k 50) through the
   scheduler loop: every request ends with exactly its budget of tokens
   in range, no NaN logit, no kernel launch, the paged streams equal the
   contiguous ones bit for bit, and each greedy stream, whole, passes the
   margin rule at ``SERVE_BF16_MARGIN`` against a teacher-forced bf16
   forward (flash kernels); the same gate must reject a planted fault
   (``planted_fault``).  Printed: wall seconds, requests/s, generated
   tokens/s, the median decode-step ms (CUDA events and host clock) at 16
   active slots, prefill ms by prompt bucket (these timed numbers include
   the NaN tap's three small launches per engine call), ``kv_stats`` at
   the step of most live rows (read after the loop), peak memory, and,
   untapped, one decode step and one 512-token admission profiled as
   ``profile_step`` does.
14. ``sampler_check``: ``ops/prng.py`` and ``serve/sampling.py`` on the
   card against the CPU: keys, folds, splits and 32000 random bits equal
   on a grid of seeds, rids and emission indices; Gumbel noise within
   ``GUMBEL_ULPS`` ulp (at the scale max(|g|, 1)); ``sample_token`` on 256
   rows of 32000 fp32 logits, the same tokens by the margin rule at 1e-5.

Then the ``kernels`` summary, the card's name and power limit, and
``{"ok": true, ...}`` as the last line.  Any failure raises and exits
nonzero; without a GPU it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

H100_BF16_PEAK = 989e12     # FLOP/s, dense, H100 SXM data sheet
H100_HBM_BYTES = 3.35e12    # B/s

# (atol, rtol) of |kernel - plain| <= atol + rtol * |plain|, elementwise.
# bf16: the outputs are rounded to bf16 (8 bits of mantissa) after fp32
# sums taken in another order than the plain version's, and the
# tensor-core kernels also round P and dS to bf16 before their second
# product; fp32: sums in another order only.
TOL = {"bf16": (1e-2, 1e-2), "fp32": (1e-4, 1e-4), "lse": (1e-3, 0.0)}

# what each kernel replaces (horovod_tpu/ops/flash_attention.py) and the
# launch helper's pass name
SOURCES = {
    "flash_fwd_tc": ("horovod_tpu_torch/csrc/flash_fwd_tc.cu",
                     "horovod_tpu/ops/flash_attention.py:158"),
    "flash_bwd_dkdv_tc": ("horovod_tpu_torch/csrc/flash_bwd_dkdv_tc.cu",
                          "horovod_tpu/ops/flash_attention.py:291"),
    "flash_bwd_dq_tc": ("horovod_tpu_torch/csrc/flash_bwd_dq_tc.cu",
                        "horovod_tpu/ops/flash_attention.py:324"),
    "flash_fwd": ("horovod_tpu_torch/csrc/flash_fwd.cu",
                  "horovod_tpu/ops/flash_attention.py:158"),
    "flash_bwd_dkdv": ("horovod_tpu_torch/csrc/flash_bwd_dkdv.cu",
                       "horovod_tpu/ops/flash_attention.py:291"),
    "flash_bwd_dq": ("horovod_tpu_torch/csrc/flash_bwd_dq.cu",
                     "horovod_tpu/ops/flash_attention.py:324"),
}
PASS = {"flash_fwd_tc": "fwd", "flash_fwd": "fwd",
        "flash_bwd_dkdv_tc": "dkdv", "flash_bwd_dkdv": "dkdv",
        "flash_bwd_dq_tc": "dq", "flash_bwd_dq": "dq"}
# tensor-core kernel -> the scalar kernel of the same function
SCALAR_TWIN = {"flash_fwd_tc": "flash_fwd",
               "flash_bwd_dkdv_tc": "flash_bwd_dkdv",
               "flash_bwd_dq_tc": "flash_bwd_dq"}
MIN_SPEEDUP = 3.0


def act_store_grid(dtype):
    """The inputs ``act_store`` is held on (a CPU tensor of ``dtype``):
    in bf16 every value of magnitude up to 1024, subnormals included; in
    another dtype every e4m3 value, every midpoint between two neighbours
    (the rounding boundaries), the neighbours of each in ``dtype``, and
    448..1024 around 464, where XLA's conversion turns to NaN; both signs
    of each, then +-inf and nan."""
    import torch

    if dtype == torch.bfloat16:
        # bf16 bit patterns 0 .. 0x4480 (= 1024.0) in order of magnitude
        pos = torch.arange(0, 0x4481, dtype=torch.int16).view(torch.bfloat16)
    else:
        e4m3 = torch.arange(0, 256, dtype=torch.int32).to(torch.uint8).view(
            torch.float8_e4m3fn).float()
        vals = torch.unique(e4m3[torch.isfinite(e4m3) & (e4m3 >= 0)])
        mids = (vals[1:] + vals[:-1]) / 2
        edge = torch.tensor([448.0, 456.0, 464.0, 472.0, 480.0, 1024.0])
        base = torch.cat([vals, mids, edge]).to(dtype)
        inf = torch.tensor(float("inf"), dtype=dtype)
        pos = torch.unique(torch.cat([base, torch.nextafter(base, inf),
                                      torch.nextafter(base, -inf)]))
        pos = pos[pos >= 0]
    special = torch.tensor([float("inf"), float("-inf"), float("nan")],
                           dtype=dtype)
    return torch.cat([pos, -pos, special])


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, CUDA
    events around the batch, after ``warmup`` calls.  The batch is queued
    behind a device-side sleep, so the host's launch overhead between calls
    does not show as device time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)  # ~10 ms of cycles
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name, got, want, tol) -> float:
    """Max |got - want|; raises if any element is outside the tolerance."""
    import torch

    got, want = got.float(), want.float()
    err = (got - want).abs()
    atol, rtol = tol
    bad = err > atol + rtol * want.abs()
    if not torch.isfinite(got).all() or bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol={atol} "
            f"rtol={rtol}; max abs err {err.max().item()}")
    return err.max().item()


def launcher(fa, name, q, k, v, o, lse, do, cfg):
    """One launch of kernel ``name`` through its launch helper, into
    scratch outputs; ``cfg`` is (causal, scale, h, hkv, window).  A dQ
    kernel's launches follow one dK/dV launch, as in ``flash_bwd``: it
    fills the (lse, delta) pairs that the tensor-core dQ reads, outside
    the timed launches."""
    import torch

    if PASS[name] == "fwd":
        o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
        return lambda: fa.launch_fwd(q, k, v, o2, lse2, *cfg, kernel=name)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if PASS[name] == "dkdv":
        pairs = fa.pair_scratch(q)
        return lambda: fa.launch_dkdv(q, k, v, o, lse, do, dk, dv, *cfg,
                                      kernel=name, pairs=pairs)
    pairs = fa.launch_dkdv_for_dq(name, q, k, v, o, lse, do, dk, dv, *cfg)
    dq = torch.empty_like(q)
    return lambda: fa.launch_dq(q, k, v, o, lse, do, dq, *cfg, kernel=name,
                                pairs=pairs)


# The kernels skip the (Q, K) tiles their masks rule out, and that shows in
# their times.  A causal mask leaves about half the tiles and a 64-key
# window a small band of the causal ones; a kernel that visited every tile
# would take as long masked as not.  The check runs at S = 4096: at the
# main path's S = 1024 the tensor-core kernels come near their byte floor,
# which no mask lowers (every row of q, k, v, o and dO is still read
# once), so there the ratios are reported, not held.
SKIP_WINDOW = 64
SKIP_LIMITS = {"causal_over_full": 0.7, "window_over_causal": 0.5}
SKIP_SHAPE = {"b": 2, "s": 4096, "h": 12, "d": 64}
MAIN_SHAPE = {"b": 8, "s": 1024, "h": 12, "d": 64}
# dtype each kernel is timed in: the one the route sends it
SKIP_DTYPE = {"flash_fwd_tc": "bf16", "flash_bwd_dkdv_tc": "bf16",
              "flash_bwd_dq_tc": "bf16", "flash_fwd": "fp32",
              "flash_bwd_dkdv": "fp32", "flash_bwd_dq": "fp32"}


def mask_times(fa, names, b, s, h, d, dtype):
    """Device ms of each kernel in ``names`` unmasked, causal and with a
    ``SKIP_WINDOW``-key band, on one set of inputs."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b * h, s, d, device="cuda",
                               generator=g).to(dtype) for _ in range(4))
    ms = {}
    for mask, (causal, window) in {"full": (False, None),
                                   "causal": (True, None),
                                   "window": (True, SKIP_WINDOW)}.items():
        cfg = (causal, d ** -0.5, h, h, window)
        o, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5, s, s, h, h, window)
        ms[mask] = {n: cuda_ms(launcher(fa, n, q, k, v, o, lse, do, cfg), 10)
                    for n in names}
    return ms


def ratios_of(ms):
    return {n: {"causal_over_full": ms["causal"][n] / ms["full"][n],
                "window_over_causal": ms["window"][n] / ms["causal"][n]}
            for n in ms["full"]}


def tile_skip(fa):
    """Each of the six kernels' device time unmasked, causal and windowed
    at ``SKIP_SHAPE``, in the dtype its route gives it.  Raises unless each
    masked run is as much faster as ``SKIP_LIMITS`` says; returns the times
    and ratios per kernel, and the tensor-core kernels' ratios at the main
    shape (reported only)."""
    import torch

    dts = {"bf16": torch.bfloat16, "fp32": torch.float32}
    ms = {"full": {}, "causal": {}, "window": {}}
    for tname, dt in dts.items():
        names = [n for n, t in SKIP_DTYPE.items() if t == tname]
        for mask, row in mask_times(fa, names, dtype=dt,
                                    **SKIP_SHAPE).items():
            ms[mask].update(row)
    ratios = ratios_of(ms)
    main = ratios_of(mask_times(fa, list(SCALAR_TWIN), dtype=torch.bfloat16,
                                **MAIN_SHAPE))
    bad = {n: r for n, r in ratios.items()
           if any(r[key] >= lim for key, lim in SKIP_LIMITS.items())}
    if bad:
        raise AssertionError(f"masked tiles are not skipped: {bad} "
                             f"(limits {SKIP_LIMITS})")
    return ms, ratios, main


def attention_work(b, s, h, hkv, d, causal, window, itemsize):
    """FLOPs of each kernel's products and the bytes it must move (each
    of its inputs read once, each of its outputs written once) on these
    shapes; only the (q, k) pairs the masks leave alive count.  Keyed by
    kernel: the tensor-core backward kernels move other tensors than their
    scalar twins (dK/dV's pre-pass also writes the (lse, delta) pairs, dQ
    reads them in place of o and lse)."""
    import torch

    qp = torch.arange(s)[:, None]
    kp = torch.arange(s)[None, :]
    alive = torch.ones(s, s, dtype=torch.bool)
    if causal:
        alive &= kp <= qp
    if window:
        alive &= kp >= qp - (window - 1)
    pairs = int(alive.sum()) * b * h
    q_bytes = b * h * s * d * itemsize
    kv_bytes = b * hkv * s * d * itemsize
    lse_bytes = b * h * s * 4
    # [Z, S rounded up to 64] float2 (lse, delta): fa.pair_scratch
    pair_bytes = b * h * -(-s // 64) * 64 * 8
    # S = QK^T and O = PV: q, k, v in; o, lse out
    fwd = (4 * d * pairs, q_bytes + 2 * kv_bytes + q_bytes + lse_bytes)
    # S, dP = dO V^T, dV = P^T dO, dK = dS^T Q: q, o, dO, k, v, lse in;
    # dk, dv out
    dkdv = (8 * d * pairs, 3 * q_bytes + 2 * kv_bytes + lse_bytes
            + 2 * kv_bytes)
    # S, dP, dQ = dS K: q, o, dO, k, v, lse in; dq out
    dq = (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes + lse_bytes + q_bytes)
    return {
        "flash_fwd_tc": fwd, "flash_fwd": fwd,
        "flash_bwd_dkdv_tc": (dkdv[0], dkdv[1] + pair_bytes),
        "flash_bwd_dkdv": dkdv,
        # q, dO, k, v and the pairs in; dq out
        "flash_bwd_dq_tc": (dq[0], dq[1] - q_bytes - lse_bytes + pair_bytes),
        "flash_bwd_dq": dq,
    }


def bound(flops: int, nbytes: int, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_check(fa):
    """Every kernel against its plain version at three shapes; returns the
    main shape's record per kernel."""
    import torch
    import torch.nn.functional as F

    shapes = [
        # the main path: gpt-small attention, one layer
        dict(b=8, s=1024, h=12, hkv=12, d=64, dtype=torch.bfloat16,
             causal=True, window=None, main=True),
        # GQA + sliding window, S not a multiple of any tile: bf16 takes
        # the tensor-core kernels, fp32 the scalar ones
        dict(b=2, s=300, h=8, hkv=2, d=64, dtype=torch.bfloat16,
             causal=True, window=100, main=False),
        dict(b=2, s=300, h=8, hkv=2, d=64, dtype=torch.float32,
             causal=True, window=100, main=False),
    ]
    records = {}
    for shp in shapes:
        b, s, h, hkv, d = (shp[x] for x in ("b", "s", "h", "hkv", "d"))
        dt, causal, window = shp["dtype"], shp["causal"], shp["window"]
        tname = "bf16" if dt == torch.bfloat16 else "fp32"
        g = torch.Generator(device="cuda").manual_seed(0)
        mk = lambda heads: torch.randn(b * heads, s, d, device="cuda",
                                       generator=g).to(dt)
        q, k, v, do = mk(h), mk(hkv), mk(hkv), mk(h)
        scale = d ** -0.5
        bq, bk = fa._pick_block(s, 512), fa._pick_block(s, 256)
        args = (causal, scale, bq, bk, h, hkv, window)
        cfg = (causal, scale, h, hkv, window)
        route = {p: fa.kernel_for(p, dt, d) for p in ("fwd", "dkdv", "dq")}

        o, lse = fa.flash_fwd(q, k, v, *args)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, *args)
        err = {
            route["fwd"]: check_close(route["fwd"] + " o", o, o_p,
                                      TOL[tname]),
            "lse": check_close(route["fwd"] + " lse", lse, lse_p,
                               TOL["lse"]),
        }
        # both backward passes from the plain forward's (o, lse)
        dq, dk, dv = fa.flash_bwd(q, k, v, o_p, lse_p, do, *args)
        dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do,
                                              causal, scale, bk, h, hkv,
                                              window)
        err[route["dq"]] = check_close(route["dq"], dq, dq_p, TOL[tname])
        err[route["dkdv"]] = max(
            check_close(route["dkdv"] + " dk", dk, dk_p, TOL[tname]),
            check_close(route["dkdv"] + " dv", dv, dv_p, TOL[tname]),
        )
        line = {"shape": {"b": b, "s": s, "h": h, "hkv": hkv, "d": d,
                          "dtype": tname, "causal": causal,
                          "window": window},
                "route": route,
                "tolerance": {"atol": TOL[tname][0],
                              "rtol": TOL[tname][1],
                              "lse_atol": TOL["lse"][0]},
                "max_abs_err": err}
        if shp["main"]:
            # the scalar kernels at the main path's shape, through their
            # launch helpers: the "before" of the tensor-core kernels
            o_s, lse_s = torch.empty_like(q), torch.empty_like(lse)
            fa.launch_fwd(q, k, v, o_s, lse_s, *cfg, kernel="flash_fwd")
            err["flash_fwd"] = check_close("flash_fwd o", o_s, o_p,
                                           TOL[tname])
            dk_s, dv_s = torch.empty_like(k), torch.empty_like(v)
            fa.launch_dkdv(q, k, v, o_p, lse_p, do, dk_s, dv_s, *cfg,
                           kernel="flash_bwd_dkdv")
            err["flash_bwd_dkdv"] = max(
                check_close("flash_bwd_dkdv dk", dk_s, dk_p, TOL[tname]),
                check_close("flash_bwd_dkdv dv", dv_s, dv_p, TOL[tname]))
            dq_s = torch.empty_like(q)
            fa.launch_dq(q, k, v, o_p, lse_p, do, dq_s, *cfg,
                         kernel="flash_bwd_dq")
            err["flash_bwd_dq"] = check_close("flash_bwd_dq", dq_s, dq_p,
                                              TOL[tname])
            ms = {n: cuda_ms(launcher(fa, n, q, k, v, o_p, lse_p, do, cfg),
                             20 if n in SCALAR_TWIN else 10)
                  for n in SOURCES}
            plain_fwd = cuda_ms(lambda: fa.flash_fwd_plain(q, k, v, *args),
                                3, warmup=1)
            # the plain backward computes dq, dk and dv together
            plain_bwd = cuda_ms(lambda: fa.flash_bwd_plain(
                q, k, v, o_p, lse_p, do, causal, scale, bk, h, hkv, window),
                3, warmup=1)
            q4, k4, v4, do4 = (x.view(b, h, s, d) for x in (q, k, v, do))
            lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True, scale=scale), 20)
            fw = torch.ops.aten._scaled_dot_product_flash_attention(
                q4, k4, v4, 0.0, True, False, scale=scale)
            # one call computes dq, dk and dv together
            lib_bwd = cuda_ms(
                lambda: torch.ops.aten
                ._scaled_dot_product_flash_attention_backward(
                    do4, q4, k4, v4, fw[0], fw[1], fw[2], fw[3], fw[4],
                    fw[5], 0.0, True, fw[6], fw[7], scale=scale), 10)
            work = attention_work(b, s, h, hkv, d, causal, window,
                                  q.element_size())
            for name in SOURCES:
                flops, nbytes = work[name]
                bms, by = bound(flops, nbytes, H100_BF16_PEAK)
                fwd = PASS[name] == "fwd"
                records[name] = {
                    "max_abs_err": err[name], "ms": ms[name],
                    "plain_ms": plain_fwd if fwd else plain_bwd,
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_fwd if fwd else lib_bwd,
                    "flops": flops, "bytes": nbytes,
                }
            speedup = {n: ms[twin] / ms[n] for n, twin in SCALAR_TWIN.items()}
            line["kernel_ms"] = ms
            line["speedup_over_scalar"] = speedup
            # the like-for-like backward: the tensor-core dQ's time leaves
            # out delta, which dK/dV's pre-pass computes for it
            line["backward_ms"] = {
                "tensor_core_dkdv_plus_dq":
                    ms["flash_bwd_dkdv_tc"] + ms["flash_bwd_dq_tc"],
                "scalar_dkdv_plus_dq":
                    ms["flash_bwd_dkdv"] + ms["flash_bwd_dq"]}
            line["plain_ms"] = {"forward": plain_fwd,
                                "backward_dq_dk_dv": plain_bwd}
            line["library_ms"] = {"sdpa_forward": lib_fwd,
                                  "sdpa_flash_backward_dq_dk_dv": lib_bwd}
            line["bound_ms"] = {n: records[n]["bound_ms"] for n in records}
            slow = {n: x for n, x in speedup.items() if x < MIN_SPEEDUP}
            if slow:
                raise AssertionError(
                    f"tensor-core kernels under {MIN_SPEEDUP}x the scalar "
                    f"kernels at the main shape: {slow}")
        emit("kernel_check", **line)
    return records


def model_check(hvd_models, fa):
    """gpt-nano, fp32, on the card: the flash kernels against the plain
    reference attention through the whole model, logits and grads."""
    import numpy as np
    import torch

    toks = torch.from_numpy(
        np.random.RandomState(1).randint(0, 1024, (2, 128))).cuda()
    out = {}
    for impl in ("flash", "reference"):
        m = hvd_models.gpt("nano", device="cuda", dtype=torch.float32,
                           attention_impl=impl)
        logits = m(toks)
        logits.square().mean().backward()
        out[impl] = (logits.detach(),
                     {n: p.grad for n, p in m.named_parameters()})
    err_logits = check_close("nano logits", out["flash"][0],
                             out["reference"][0], (2e-4, 2e-4))
    err_grads = max(
        check_close(f"nano grad {n}", g, out["reference"][1][n],
                    (5e-4, 5e-4))
        for n, g in out["flash"][1].items()
    )
    emit("model_check", model="gpt-nano fp32 seq 128 batch 2",
         max_abs_err_logits=err_logits, max_abs_err_grads=err_grads,
         tolerance={"logits": [2e-4, 2e-4], "grads": [5e-4, 5e-4]})


# the kernels of the main path (bf16, head_dim 64) and the ones it must not
# reach
MAIN_PATH = ("flash_fwd_tc", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc")
LOSS_RTOL = 0.01
STEPS, WARMUP = 5, 2
# the gpt-small step every phase from ``train`` on drives
GPT_STEP = ("small", "bf16", 8, 1024)
# bucket and bucket+zero1 compute off's update: at world 1 the reduce of a
# bucket is its own gradient and AdamW the same elementwise arithmetic, so
# the losses may differ from off's only where a kernel of the step sums in
# a run-dependent order
OVERLAP_LOSS_RTOL = 1e-3
OVERLAP_MODES = ("bucket", "bucket+zero1")
# parameters whose gradients the backward produces only after block 0's
# attention backward, the step's last flash_bwd_dkdv_tc launch
LATE_PARAMS = ("block0.qkv.", "block0.ln1.", "wpe", "wte.")


def run_steps(step, state, n):
    losses = []
    for _ in range(n):
        model, opt, loss = step(*state)
        state = (model, opt) + state[2:]
        losses.append(loss)
    return state, losses


def drive(fa, step, state, remat: bool = False):
    """``WARMUP`` then ``STEPS`` timed steps from ``state``: the launch
    counts are set to 0 just before and read just after, and must be exact
    (each main-path kernel once per layer and step; the forward twice
    under remat, which recomputes it; none of the others).  Returns the
    state and the run's record."""
    import torch

    model = state[0]
    batch, seq = state[2].shape[0], state[2].shape[1] - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30

    fa.reset_launch_counts()                # the main path starts here
    state, losses = run_steps(step, state, WARMUP)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, timed = run_steps(step, state, STEPS)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / STEPS
    launches = dict(fa.LAUNCHES)            # ... and ends here
    losses = [float(x) for x in losses + timed]

    total = STEPS + WARMUP
    layers = model.cfg.num_layers
    per_step = {n: (layers * (2 if remat and n == "flash_fwd_tc" else 1)
                    if n in MAIN_PATH else 0) for n in launches}
    want = {n: k * total for n, k in per_step.items()}
    if launches != want:
        raise AssertionError(
            f"kernel launches {launches} != {want} ({per_step} per step x "
            f"{total} steps)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    from horovod_tpu_torch.bench import model_flops_per_step

    flops = model_flops_per_step(model.cfg, batch, seq)
    return state, {
        "losses": losses, "step_ms": secs * 1e3,
        "tokens_per_s_per_gpu": batch * seq / secs,
        "model_flops_per_step": flops, "mfu": flops / secs / H100_BF16_PEAK,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        # what the built model, optimizer and buffers hold before a step
        "resident_mem_gib": resident,
        "launches": launches, "launches_per_step": per_step}


def losses_of(build, **kwargs):
    """The losses of the same steps built with ``kwargs`` (no timing)."""
    step, state, _ = build(*GPT_STEP, **kwargs)
    return [float(x) for x in run_steps(step, state, STEPS + WARMUP)[1]]


def max_rel(losses, ref) -> float:
    return max(abs(a - r) / abs(r) for a, r in zip(losses, ref))


# what may stay allocated once a run is dropped (library workspaces); a
# gpt-small run that stayed alive would hold over 1 GiB
RELEASE_SLACK_GIB = 0.5


def release() -> None:
    """Free what the last run left on the card and check that it is gone,
    so the next run's resident and peak memory are its own."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() / 2**30
    if left > RELEASE_SLACK_GIB:
        raise AssertionError(f"{left:.3f} GiB still allocated after the last "
                             f"run was dropped (> {RELEASE_SLACK_GIB})")


def train(hvd, fa):
    from horovod_tpu_torch.train import build_gpt_step

    topo = hvd.init()
    assert topo.device.type == "cuda" and topo.backend == "nccl", topo
    step, state, static = build_gpt_step(*GPT_STEP)
    state, run = drive(fa, step, state)
    # the same steps from the same weights and tokens, with the plain
    # reference attention in place of the kernels
    ref_losses = losses_of(build_gpt_step, attention="reference")
    rel = max_rel(run["losses"], ref_losses)
    if rel > LOSS_RTOL:
        raise AssertionError(
            f"losses {run['losses']} differ from the reference attention's "
            f"{ref_losses} by {rel:.4f} > {LOSS_RTOL}")
    emit("train", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3],
         world=static["n_chips"], steps_timed=STEPS, warmup=WARMUP,
         reference_losses=ref_losses, max_rel_loss_diff=rel,
         loss_rtol=LOSS_RTOL, mfu_peak_flops=H100_BF16_PEAK, **run)
    return state, step, run, static["n_chips"]


def issue_order(fa, plan, names):
    """Record, at each bucket collective the plan issues, how many
    ``flash_bwd_dkdv_tc`` launches came before it.  Returns the record and
    *expected*: the buckets holding no parameter of ``LATE_PARAMS``."""
    seen = []
    plan.on_issue = lambda index: seen.append(
        (index, fa.LAUNCHES["flash_bwd_dkdv_tc"]))
    late = {i for i, n in enumerate(names) if n.startswith(LATE_PARAMS)}
    expected = sum(1 for b in plan.layout.buckets
                   if not late & set(b.leaf_indices))
    return seen, expected


def early_issues(seen, n_buckets: int, layers: int) -> list:
    """Per step: the bucket collectives issued before the step's last
    ``flash_bwd_dkdv_tc`` launch (its ``layers``-th), from
    :func:`issue_order`'s record; every bucket must be issued once per
    step."""
    if len(seen) % n_buckets:
        raise AssertionError(f"{len(seen)} bucket issues for {n_buckets} "
                             "buckets a step")
    steps = [seen[i:i + n_buckets] for i in range(0, len(seen), n_buckets)]
    out = []
    for k, issues in enumerate(steps):
        if sorted(i for i, _ in issues) != list(range(n_buckets)):
            raise AssertionError(f"step {k} issued buckets {issues}")
        out.append(sum(1 for _, dkdv in issues if dkdv < layers * (k + 1)))
    return out


def overlap(fa, off_losses):
    """gpt-small in ``bucket`` and ``bucket+zero1``: the ``train`` phase's
    steps, through the overlap plane."""
    from horovod_tpu_torch.train import build_gpt_step

    out = {}
    for mode in OVERLAP_MODES:
        step, state, _ = build_gpt_step(*GPT_STEP, overlap_mode=mode)
        model, plan = state[0], state[1]
        seen, expected = issue_order(
            fa, plan, [n for n, _ in model.named_parameters()])
        state, run = drive(fa, step, state)
        layout = plan.layout
        early = early_issues(seen, len(layout.buckets), model.cfg.num_layers)
        run["profile"] = profile_step(state, step, run["step_ms"], top=6)
        rel = max_rel(run["losses"], off_losses)
        out[mode] = dict(
            run, buckets=len(layout.buckets), bucket_mb=layout.bucket_bytes
            / 2**20, bucket_bytes=[b.nbytes for b in layout.buckets],
            total_grad_bytes=layout.total_bytes,
            issued_before_last_dkdv=min(early),
            issued_before_last_dkdv_per_step=early,
            expected_before_last_dkdv=expected,
            max_rel_loss_diff_vs_off=rel,
            bitwise_equal_to_off=run["losses"] == off_losses)
        del step, state, model, plan
        release()
        if rel > OVERLAP_LOSS_RTOL:
            raise AssertionError(
                f"{mode} losses {run['losses']} differ from off's "
                f"{off_losses} by {rel:.2e} > {OVERLAP_LOSS_RTOL}")
        if min(early) < expected:
            raise AssertionError(
                f"{mode}: {early} bucket collectives issued before the last "
                f"dK/dV launch per step, fewer than the {expected} buckets "
                "complete by then")
    emit("overlap", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], world=1,
         off_losses=off_losses, loss_rtol=OVERLAP_LOSS_RTOL, modes=out)


def rope_remat(fa):
    """RoPE + remat + ZeRO-1 at full width: exact launches (the forward
    twice per layer), losses against the reference attention, and peak
    memory against the same run without remat."""
    from horovod_tpu_torch.train import build_gpt_step

    kw = dict(pos_embedding="rope", overlap_mode="bucket+zero1")
    runs = {}
    for remat in (True, False):
        step, state, _ = build_gpt_step(*GPT_STEP, remat=remat, **kw)
        state, runs[remat] = drive(fa, step, state, remat=remat)
        runs[remat]["profile"] = profile_step(state, step,
                                              runs[remat]["step_ms"], top=6)
        del step, state
        release()
    ref_losses = losses_of(build_gpt_step, attention="reference", remat=True,
                           **kw)
    release()
    rel = max_rel(runs[True]["losses"], ref_losses)
    if rel > LOSS_RTOL:
        raise AssertionError(
            f"rope+remat losses {runs[True]['losses']} differ from the "
            f"reference attention's {ref_losses} by {rel:.4f} > {LOSS_RTOL}")
    peak, plain_peak = runs[True]["peak_mem_gib"], runs[False]["peak_mem_gib"]
    if peak > plain_peak:
        raise AssertionError(f"remat raised the peak memory: {peak:.3f} GiB "
                             f"against {plain_peak:.3f} without it")
    emit("rope_remat", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], world=1, **kw,
         remat=runs[True], no_remat=runs[False],
         reference_losses=ref_losses, max_rel_loss_diff=rel,
         loss_rtol=LOSS_RTOL,
         max_rel_loss_diff_remat_vs_not=max_rel(runs[True]["losses"],
                                                runs[False]["losses"]),
         bitwise_equal_remat_vs_not=(runs[True]["losses"]
                                     == runs[False]["losses"]))


# (atol, rtol) of the card's fp32 conv step against the CPU's: both sum in
# fp32, in orders their libraries choose (cuDNN with TF32 off, oneDNN)
CONV_TOL = (1e-4, 1e-4)
# model, batch, image size, train mode of the card-vs-CPU step.  Inception
# V3 runs in eval mode (BatchNorm on its running statistics): its
# train-mode fp32 step is ill-conditioned at init, at any size (on the
# CPU the port's own fp32 and fp64 gradients differ by 3-5% normwise, and
# at 96x96 its last blocks normalise 1x1 maps over 2 values), so there a
# card-vs-CPU difference would measure rounding, not the path.
CONV_CHECKS = (("resnet18", 4, 64, True), ("resnet50", 2, 64, True),
               ("vgg16", 2, 64, True), ("inception3", 2, 96, False))
# the headline step: Horovod's ResNet-50 images/s benchmark
RESNET_STEP = ("resnet50", "bf16", 128, 224)
ZOO = (("vgg16", 224), ("inception3", 299))
ZOO_BATCH, ZOO_STEPS, ZOO_WARMUP = 32, 3, 1


def sgd_step_record(model, images, labels) -> dict:
    """One SGD-momentum step of ``model`` on one batch: its logits, loss,
    gradients, updated parameters and running statistics, copied to the
    CPU."""
    import torch.nn.functional as F

    from horovod_tpu_torch.train import make_sgd

    logits = model(images)
    loss = F.cross_entropy(logits, labels)
    loss.backward()
    out = {"logits": logits.detach(), "loss": loss.detach()}
    out.update({f"grad {n}": p.grad for n, p in model.named_parameters()})
    make_sgd(model.parameters()).step()
    out.update({f"param {n}": p.detach()
                for n, p in model.named_parameters()})
    out.update({f"stat {n}": b for n, b in model.named_buffers()})
    return {k: v.cpu() for k, v in out.items()}


def conv_inputs(batch: int, size: int):
    """The seeded batch of ``build_step``: NCHW (channels_last) images and
    labels, fp32, on the CPU."""
    import numpy as np
    import torch

    from horovod_tpu_torch.models.layers import from_nhwc

    images = from_nhwc(np.random.RandomState(0).randn(
        batch, size, size, 3).astype(np.float32))
    labels = torch.from_numpy(
        np.random.RandomState(1).randint(0, 1000, size=(batch,)))
    return images, labels


def card_vs_cpu(name: str, batch: int, size: int, train: bool = True):
    """One fp32 SGD step of conv model ``name`` on the card (TF32 off) and
    on the CPU from the same weights and batch.  Returns the max abs error
    by kind (logits, loss, grad, param, stat) and the failures outside
    ``CONV_TOL``."""
    import copy

    import torch

    from horovod_tpu_torch.train import conv_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = conv_model(name, "fp32", size).train(train)
    card = copy.deepcopy(model).cuda()
    images, labels = conv_inputs(batch, size)
    want = sgd_step_record(model, images, labels)
    got = sgd_step_record(card, images.cuda(), labels.cuda())
    errs: dict = {}
    failures = []
    for key, w in want.items():
        kind = key.split(" ")[0]
        e = (got[key].double() - w.double()).abs().max().item()
        errs[kind] = max(errs.get(kind, 0.0), e)
        try:
            check_close(f"{name} {key}", got[key], w, CONV_TOL)
        except AssertionError as exc:
            failures.append(str(exc))
    return errs, failures


def conv_check() -> None:
    errs, failures = {}, []
    for name, batch, size, train in CONV_CHECKS:
        errs[name], bad = card_vs_cpu(name, batch, size, train)
        failures += bad
    release()
    emit("conv_check", dtype="fp32", tf32=False,
         models=[{"model": n, "batch": b, "image_size": s,
                  "mode": "train" if t else "eval"}
                 for n, b, s, t in CONV_CHECKS],
         tolerance={"atol": CONV_TOL[0], "rtol": CONV_TOL[1]},
         max_abs_err=errs, failures=failures[:20])
    if failures:
        raise AssertionError(f"{len(failures)} tensors of the card's conv "
                             f"step outside {CONV_TOL}: {failures[:3]}")


def run_carry(step, state, carry: int, n: int):
    """``n`` steps of a step whose first ``carry`` state entries come back
    updated; the new state and the losses (device tensors)."""
    losses = []
    for _ in range(n):
        *out, loss = step(*state)
        state = tuple(out) + state[carry:]
        losses.append(loss)
    return state, losses


def drive_conv(fa, model_name, step, state, static, warmup: int,
               steps: int):
    """``warmup`` then ``steps`` timed steps of a conv-zoo step: every
    loss finite and no flash kernel launched (the counts are set to 0
    just before and read just after).  Returns the state and the run's
    record."""
    import torch

    from horovod_tpu_torch.bench import conv_flops_per_image

    carry = static["carry_len"]
    images = state[carry]
    batch, size = images.shape[0], images.shape[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2**30
    fa.reset_launch_counts()
    state, losses = run_carry(step, state, carry, warmup)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, timed = run_carry(step, state, carry, steps)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = {n: k for n, k in fa.LAUNCHES.items() if k}
    losses = [float(x) for x in losses + timed]
    if launches:
        raise AssertionError(f"flash kernels launched on a conv step: "
                             f"{launches}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    flops = conv_flops_per_image(model_name, size)
    return state, {
        "model": model_name, "batch_per_gpu": batch, "image_size": size,
        "world": static["n_chips"], "steps_timed": steps, "warmup": warmup,
        "losses": losses, "step_ms": secs * 1e3,
        "images_per_s_per_gpu": batch / secs, "flops_per_image": flops,
        "mfu": flops * batch / secs / H100_BF16_PEAK,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "resident_mem_gib": resident, "flash_launches": launches}


def bn_costs(model) -> dict:
    """What BatchNorm's flax bookkeeping costs on the step, apart from the
    normalisation itself: the biased-variance read-back and the running
    update of every BatchNorm of ``model`` (device ms, and host ms per
    step), and which implementation ``F.batch_norm`` picks for the bf16
    channels_last input (0 native, 1 cuDNN)."""
    import torch

    from horovod_tpu_torch.models.layers import BatchNorm

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    stats = [(torch.zeros_like(m.running_mean), torch.ones_like(
        m.running_var)) for m in bns]

    def update():
        with torch.no_grad():
            for m, (mean, invstd) in zip(bns, stats):
                m.update_running(mean, invstd.pow(-2).sub_(m.eps))

    # two updates a batch: ~640 launches, which the host issues within
    # cuda_ms's device sleep, so the time is the device's
    device_ms = cuda_ms(update, 2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        update()
    host_ms = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    dev = bns[0].running_mean.device
    x = torch.randn(8, 64, 56, 56, device=dev, dtype=torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.ones(64, device=dev)
    impl = torch.ops.aten._batch_norm_impl_index(
        x, w, w, None, None, True, 0.0, 1e-5, True)[4]
    return {"batch_norms": len(bns), "update_device_ms": device_ms,
            "update_host_ms": host_ms, "bf16_channels_last_impl": impl}


def resnet(fa) -> dict:
    """ResNet-50, bf16, 224, batch 128: ``off`` and ``bucket`` against
    each other and the first loss against fp32 (TF32 off).  Returns the
    ``off`` run's record."""
    from horovod_tpu_torch.train import build_step

    name, _, batch, size = RESNET_STEP
    step, state, static = build_step(name, "fp32", batch, size)
    fp32_first = float(step(*state)[-1])
    costs = bn_costs(state[0])
    del step, state
    release()
    runs, issues = {}, []
    for mode in ("off", "bucket"):
        step, state, static = build_step(*RESNET_STEP, overlap_mode=mode,
                                         grad_bucket_mb=16)
        plan = state[2]
        if mode != "off":
            plan.on_issue = issues.append
        state, run = drive_conv(fa, name, step, state, static, WARMUP, STEPS)
        if mode != "off":
            plan.on_issue = None
            n = len(plan.layout.buckets)
            run.update(buckets=n, bucket_bytes=[b.nbytes for b in
                                                plan.layout.buckets],
                       issue_order_step_1=issues[:n])
            per_step = [sorted(issues[i:i + n])
                        for i in range(0, len(issues), n)]
            if len(issues) != n * (WARMUP + STEPS) or \
                    any(p != list(range(n)) for p in per_step):
                raise AssertionError(f"bucket issues {issues} are not each "
                                     f"of {n} buckets once per step")
        run["profile"] = profile_step(state, step, run["step_ms"], top=8)
        runs[mode] = run
        del step, state, plan
        release()
    off, bucket = runs["off"]["losses"], runs["bucket"]["losses"]
    rel_bucket = max_rel(bucket, off)
    rel_bf16 = abs(off[0] - fp32_first) / abs(fp32_first)
    emit("resnet", model=name, dtype="bf16", mfu_peak_flops=H100_BF16_PEAK,
         modes=runs, batch_norm_bookkeeping=costs,
         max_rel_loss_diff_bucket_vs_off=rel_bucket,
         bitwise_equal_bucket_vs_off=bucket == off,
         bucket_loss_rtol=OVERLAP_LOSS_RTOL, fp32_first_loss=fp32_first,
         rel_diff_bf16_vs_fp32_first_loss=rel_bf16, bf16_loss_rtol=LOSS_RTOL)
    if rel_bucket > OVERLAP_LOSS_RTOL:
        raise AssertionError(f"bucket losses {bucket} differ from off's "
                             f"{off} by {rel_bucket:.2e}")
    if rel_bf16 > LOSS_RTOL:
        raise AssertionError(f"bf16 first loss {off[0]} differs from fp32's "
                             f"{fp32_first} by {rel_bf16:.4f}")
    return runs["off"]


def zoo(fa) -> None:
    """VGG-16 (224) and Inception V3 (299), bf16, batch ``ZOO_BATCH``."""
    from horovod_tpu_torch.train import build_step

    runs = {}
    for name, size in ZOO:
        step, state, static = build_step(name, "bf16", ZOO_BATCH, size)
        state, runs[name] = drive_conv(fa, name, step, state, static,
                                       ZOO_WARMUP, ZOO_STEPS)
        runs[name]["profile"] = profile_step(state, step,
                                             runs[name]["step_ms"], top=4)
        del step, state
        release()
    emit("zoo", dtype="bf16", mfu_peak_flops=H100_BF16_PEAK, models=runs)


def conv(fa) -> dict:
    """Phase ``conv``: ``conv_check``, ``resnet``, ``zoo``; returns the
    ResNet-50 ``off`` run's record."""
    conv_check()
    off = resnet(fa)
    zoo(fa)
    return off


# ---------------------------------------------------------------------------
# reductions: Adasum, the two-level schedules, the sparse path
# ---------------------------------------------------------------------------

def gpt_with(build_opt):
    """``train``'s gpt-small step, weights and tokens, its optimizer
    replaced by ``build_opt(model)`` (AdamW with optax's constants inside
    any plane)."""
    from horovod_tpu_torch.train import build_gpt_step

    step, state, _ = build_gpt_step(*GPT_STEP)
    model = state[0]
    return step, (model, build_opt(model), state[2])


def reduction_runs(hvd):
    """The four ways of phase ``reductions``: name -> (optimizer factory,
    whether its losses must equal ``train``'s bit for bit)."""
    from horovod_tpu_torch.optim.overlap import OverlapPlan
    from horovod_tpu_torch.train import make_adamw

    axes = (hvd.LOCAL_AXIS, hvd.CROSS_AXIS)
    return {
        "adasum": (lambda m: hvd.DistributedOptimizer(
            make_adamw(m.parameters()), op=hvd.Adasum), True),
        "hierarchical_bucket": (lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket",
            hierarchical_axes=axes), True),
        "hierarchical_bucket+zero1": (lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket+zero1",
            hierarchical_axes=axes), True),
        "hierarchical_bucket_bf16_cross": (lambda m: OverlapPlan(
            m.parameters(), make_adamw, mode="bucket",
            hierarchical_axes=axes, dcn_compression="bf16"), False),
    }


SPARSE_ROWS, SPARSE_DIM, SPARSE_LOOKUPS, SPARSE_STEPS = 64, 16, 32, 3


def sparse_sgd(sparse_as_dense: bool, device: str = "cuda"):
    """``SPARSE_STEPS`` SGD steps (lr 0.5) of an ``nn.Embedding(sparse=True)``
    through ``DistributedOptimizer(sparse_as_dense=...)`` on ``device`` (a
    world of one); the final weights on the CPU and the kind of gradient
    SGD got at each step.  Weights and loss weights are multiples
    of 2^-4 no larger than 4 and the lookups repeat rows, so every sum is
    exact in any order: the paths may differ only in where the duplicate
    rows are combined."""
    import numpy as np
    import torch

    import horovod_tpu_torch as hvd

    rng = np.random.RandomState(3)
    weight = torch.from_numpy(
        (rng.randint(-32, 33, (SPARSE_ROWS, SPARSE_DIM)) / 16)
        .astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, SPARSE_ROWS // 4,
                                       (SPARSE_STEPS, SPARSE_LOOKUPS)))
    w = torch.from_numpy((rng.randint(-8, 9, (SPARSE_STEPS, SPARSE_LOOKUPS,
                                              SPARSE_DIM)) / 16)
                         .astype(np.float32))
    emb = torch.nn.Embedding(SPARSE_ROWS, SPARSE_DIM, sparse=True)
    with torch.no_grad():
        emb.weight.copy_(weight)
    emb = emb.to(device)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(emb.parameters(), lr=0.5),
                                   sparse_as_dense=sparse_as_dense)
    kinds = []
    for k in range(SPARSE_STEPS):
        opt.zero_grad()
        (emb(idx[k].to(device)) * w[k].to(device)).sum().backward()
        opt.synchronize()
        kinds.append("sparse" if emb.weight.grad.is_sparse else "dense")
        opt.optimizer.step()
    return emb.weight.detach().cpu(), kinds


def reductions(hvd, fa, train_run) -> dict:
    """Phase ``reductions``: gpt-small from ``train``'s weights and tokens
    through Adasum and the two-level planes (exact launches, losses
    against ``train``'s), then the sparse embedding path."""
    import torch

    out = {}
    for name, (build_opt, bitwise) in reduction_runs(hvd).items():
        step, state = gpt_with(build_opt)
        state, run = drive(fa, step, state)
        run["profile"] = profile_step(state, step, run["step_ms"], top=4)
        rel = max_rel(run["losses"], train_run["losses"])
        run.update(max_rel_loss_diff_vs_train=rel,
                   bitwise_equal_to_train=run["losses"]
                   == train_run["losses"])
        out[name] = run
        del step, state
        release()
        if bitwise and not run["bitwise_equal_to_train"]:
            raise AssertionError(
                f"{name}: losses {run['losses']} differ from train's "
                f"{train_run['losses']} (at world 1 the reduce is the "
                "identity)")
        if rel > LOSS_RTOL:
            raise AssertionError(f"{name}: losses {run['losses']} differ "
                                 f"from train's by {rel:.4f} > {LOSS_RTOL}")
    sparse = {d: sparse_sgd(d) for d in (True, False)}
    same = torch.equal(sparse[True][0], sparse[False][0])
    emit("reductions", model="gpt-small", dtype="bf16",
         batch_per_gpu=GPT_STEP[2], seq=GPT_STEP[3], world=1,
         train_losses=train_run["losses"], loss_rtol=LOSS_RTOL, runs=out,
         sparse={"rows": SPARSE_ROWS, "dim": SPARSE_DIM,
                 "lookups_per_step": SPARSE_LOOKUPS, "steps": SPARSE_STEPS,
                 "grad_kinds": {str(d): sparse[d][1] for d in sparse},
                 "dense_equals_sparse": same})
    if not same or sparse[False][1] != ["sparse"] * SPARSE_STEPS:
        raise AssertionError(f"sparse_as_dense=False left "
                             f"{sparse[False][1]} gradients, or its weights "
                             "differ from the densified path's")
    return out


# ---------------------------------------------------------------------------
# the eager named-tensor engine
# ---------------------------------------------------------------------------

# the data plane's check: one fused response of a transformer block's
# gradients at gpt-small's width (fp32 and bf16), pre- and post-scaled
PLANE_SHAPES = ((2304, 768), (2304,), (768, 768), (768,), (768,), (768,),
                (3072, 768), (3072,), (768, 3072), (768,), (768,), (768,))
PLANE_SCALES = (0.5, 3.0)
# device cycles the producer's stream sleeps before it writes the payloads
# (~0.5 s at the H100's clock): an engine that read them without waiting on
# their ready events would reduce stale memory
PLANE_SLEEP = 1_000_000_000


def eager_ops_check(device: str = "cuda") -> dict:
    """Every eager op on ``device`` tensors in a world of one: the result
    on the caller's device with the input's dtype, equal to the input (the
    scales applied), in place where asked.  Returns name -> (device,
    dtype); raises on a mismatch."""
    import torch

    import horovod_tpu_torch as hvd
    import horovod_tpu_torch.interop.torch as ht
    from horovod_tpu_torch.ops import eager

    x = torch.arange(12, dtype=torch.float32, device=device).reshape(4, 3)
    cases = {
        "allreduce_average": (x, lambda t: eager.allreduce(t), x),
        "allreduce_sum_bf16": (x.bfloat16(), lambda t: eager.allreduce(
            t, hvd.Sum), x.bfloat16()),
        "allreduce_min_int32": (x.int(), lambda t: eager.allreduce(
            t, hvd.Min), x.int()),
        "allreduce_max": (x, lambda t: eager.allreduce(t, hvd.Max), x),
        "allreduce_scaled": (x, lambda t: eager.allreduce(
            t, hvd.Sum, prescale_factor=2.0, postscale_factor=3.0), x * 6),
        "allreduce_adasum": (x, lambda t: eager.allreduce(t, hvd.Adasum), x),
        "allreduce_inplace": (x.clone(), lambda t: eager.allreduce_(
            t, hvd.Sum), x),
        "allgather": (x, eager.allgather, x),
        "broadcast": (x, lambda t: eager.broadcast(t, 0), x),
        "broadcast_inplace": (x.clone(), lambda t: eager.broadcast_(t, 0), x),
        "alltoall": (x, eager.alltoall, x),
        "reducescatter": (x, eager.reducescatter, x),
        "interop_allreduce_fp16_wire": (x, lambda t: ht.allreduce(
            t, op=ht.Sum, compression=ht.Compression.fp16), x),
    }
    out = {}
    for name, (t, fn, want) in cases.items():
        got = fn(t)
        out[name] = (str(got.device), str(got.dtype))
        if got.device != t.device or got.dtype != t.dtype \
                or not torch.equal(got, want):
            raise AssertionError(f"eager {name}: {got.dtype} on {got.device}"
                                 f" {got.flatten()[:4].tolist()}, want "
                                 f"{want.dtype} on {t.device} "
                                 f"{want.flatten()[:4].tolist()}")
    return out


def eager_plane_check(shapes=PLANE_SHAPES, scales=PLANE_SCALES) -> dict:
    """The engine's device data plane on a 1-rank NCCL group of its own:
    one fused response (pack into the fusion buffer, one NCCL allreduce,
    unpack), pre- and post-scaled, in fp32 and bf16, run on a background
    thread with the engine's stream current, as the engine's loop runs it.
    The payloads are written on the caller's stream behind a device sleep,
    so only an engine stream that waits on their ready events reads them.
    ``synchronize`` must return while the caller's stream is still busy
    (it orders the result on the stream, it does not block the host), and
    the results are read on the caller's stream right after it, before
    anything drains the card: only a caller's stream that waits on the
    results' completion events reads them written.  Held against the
    plain version (scale, reduce over one rank, scale) on the same inputs:
    equal, bit for bit (the same elementwise operations in the same
    order).  Each dtype runs twice, the first time on the negated values
    to warm the communicator and the allocator up (so memory the second
    pass reuses holds other numbers).  Returns the record."""
    import threading

    import torch
    import torch.distributed as dist

    from horovod_tpu_torch.ops import eager
    from horovod_tpu_torch.ops.collectives import ReduceOp
    from horovod_tpu_torch.runtime.device_plane import DataPlane
    from horovod_tpu_torch.runtime.engine import EagerEngine, \
        TensorTableEntry, dtype_name
    from horovod_tpu_torch.runtime.messages import Request, RequestType, \
        Response, ResponseType

    dev = torch.device("cuda", torch.cuda.current_device())
    eng = EagerEngine()  # a world of one: no thread, no planes of its own
    eng._device_plane = DataPlane(dist.new_group([0], backend="nccl"), dev,
                                  1)
    eng._stream = torch.cuda.Stream(dev)
    pre, post = scales
    gen = torch.Generator(device=dev).manual_seed(0)

    def fused_pass(dtype, values):
        """One engine cycle's worth of the response; the results, the host
        time to the last synchronize, and whether the caller's stream was
        still busy then."""
        names = [f"plane.{dtype_name(dtype)}.{i}" for i in range(len(shapes))]
        srcs = [torch.empty_like(v) for v in values]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(PLANE_SLEEP)
        futures = []
        for name, src, v, shape in zip(names, srcs, values, shapes):
            src.copy_(v)  # the late write, then enqueue's snapshot of it
            copy, ready = eng._snapshot(src)
            req = Request(0, RequestType.ALLREDUCE, name, dtype_name(dtype),
                          tuple(shape), int(ReduceOp.AVERAGE), -1, pre, post,
                          True)
            entry = TensorTableEntry(request=req, tensor=copy, ready=ready)
            eng._table[name] = entry
            futures.append(entry.future)
        resp = Response(ResponseType.ALLREDUCE, list(names))
        resp._shapes = [tuple(s) for s in shapes]
        resp._dtype = dtype_name(dtype)
        resp._fuse_meta = (dtype_name(dtype), int(ReduceOp.AVERAGE), pre,
                           post)
        resp._device = True

        def cycle():
            torch.cuda.set_device(dev)
            with torch.cuda.stream(eng._stream):
                eng._perform_operation(resp)

        thread = threading.Thread(target=cycle)
        thread.start()
        thread.join(timeout=120)
        outs = [eager.synchronize(f) for f in futures]
        host_ms = (time.perf_counter() - t0) * 1e3
        busy = not torch.cuda.current_stream().query()
        # read on the caller's stream, queued behind synchronize's wait
        reads = [o.clone() for o in outs]
        torch.cuda.synchronize()
        return outs, reads, host_ms, busy

    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        values = [torch.randn(s, generator=gen, device=dev).to(dtype)
                  for s in shapes]
        fused_pass(dtype, [-v for v in values])  # warm-up
        outs, reads, host_ms, busy = fused_pass(dtype, values)
        plain = [(((v.float() * pre).to(dtype).float()) / 1 * post).to(dtype)
                 for v in values]
        err = max(float((o.float() - w.float()).abs().max())
                  for o, w in zip(reads, plain))
        on_card = all(o.is_cuda and o.dtype == dtype for o in outs)
        record[dtype_name(dtype)] = dict(
            tensors=len(shapes),
            bytes=sum(v.numel() * v.element_size() for v in values),
            on_card=on_card, max_abs_err=err, tolerance=0.0,
            synchronize_left_stream_busy=busy,
            host_ms_to_synchronized=host_ms)
        if err != 0.0 or not on_card:
            raise AssertionError(f"data plane {dtype}: max |engine - plain| "
                                 f"{err}, results on the card {on_card}")
        if not busy:
            raise AssertionError(
                "synchronize returned after the caller's stream drained: it "
                "blocked the host instead of ordering the stream")
    record["device_data_ops"] = eng.stats["device_data_ops"]
    # the fused allreduce (pack, NCCL, scales) and its plain version at these
    # shapes, device time
    x = [torch.randn(s, device=dev) for s in shapes]
    entries = [TensorTableEntry(None, t) for t in x]

    def fused():
        buf = eng._pack(entries, shapes, torch.float32, dev, None)
        eng._device_plane.allreduce(buf, int(ReduceOp.AVERAGE), pre, post,
                                    torch.float32, False)

    record["fused_allreduce_ms"] = cuda_ms(fused, 20)
    record["plain_ms"] = cuda_ms(lambda: [t * pre * post for t in x], 20)
    return record


def eager(hvd, fa, train_run) -> dict:
    """Phase ``eager``: ``train``'s gpt-small steps from its weights and
    tokens through ``interop.torch.DistributedOptimizer`` (per-parameter
    hooks -> ``allreduce_async`` named ``allreduce.<param>`` ->
    ``synchronize`` in ``step()``): exact launches, losses bit for bit
    ``train``'s (at world 1 every allreduce is the identity, scale 1), one
    handle per parameter and step (149); then every eager op's result on the card and the data
    plane's fused allreduce on a 1-rank NCCL group against its plain
    version."""
    import horovod_tpu_torch.interop.torch as ht
    from horovod_tpu_torch._obs import get_registry
    from horovod_tpu_torch.train import make_adamw

    step, state = gpt_with(lambda m: ht.DistributedOptimizer(
        make_adamw(m.parameters()), named_parameters=m.named_parameters()))
    names = set(state[1]._names.values())
    # one named allreduce per parameter and step: 149 for gpt-small (12
    # blocks of 12, wpe, wte, the final LayerNorm's 2, the head)
    n_params = len(list(state[0].parameters()))
    completed = get_registry().counter("engine.collectives_completed")
    before = completed.value
    state, run = drive(fa, step, state)
    handles = (completed.value - before) / (STEPS + WARMUP)
    run["profile"] = profile_step(state, step, run["step_ms"], top=6)
    grads_on_card = all(p.grad is None or p.grad.is_cuda
                        for p in state[0].parameters())
    run.update(handles_per_step=handles, named_tensors=len(names),
               parameters=n_params,
               grads_on_card=grads_on_card,
               bitwise_equal_to_train=run["losses"] == train_run["losses"],
               max_rel_loss_diff_vs_train=max_rel(run["losses"],
                                                  train_run["losses"]))
    del step, state
    release()
    ops = eager_ops_check()
    plane = eager_plane_check()
    emit("eager", model="gpt-small", dtype="bf16", batch_per_gpu=GPT_STEP[2],
         seq=GPT_STEP[3], world=1, train_losses=train_run["losses"],
         run=run, ops=ops, plane=plane)
    if not run["bitwise_equal_to_train"]:
        raise AssertionError(
            f"eager: losses {run['losses']} differ from train's "
            f"{train_run['losses']} (at world 1 every allreduce is the "
            "identity)")
    if handles != n_params or len(names) != n_params:
        raise AssertionError(f"eager: {handles} handles a step over "
                             f"{len(names)} names, want {n_params}")
    if not grads_on_card:
        raise AssertionError("eager: a gradient left the card")
    return run


# ---------------------------------------------------------------------------
# fp8 activation storage
# ---------------------------------------------------------------------------

# the reference's tests/test_fp8.py contract: the first loss within 2% of
# bf16's (same weights: pure storage rounding), every later one within
# 15% + 0.05 (trajectories compound it)
FP8_FIRST_RTOL, FP8_LATER = 0.02, (0.15, 0.05)


def fp8_gates(name, fp8, bf16) -> None:
    if not all(math.isfinite(x) for x in fp8):
        raise AssertionError(f"{name} fp8: non-finite loss {fp8}")
    if abs(fp8[0] - bf16[0]) > FP8_FIRST_RTOL * abs(bf16[0]):
        raise AssertionError(f"{name} fp8 first loss {fp8[0]} vs bf16's "
                             f"{bf16[0]}: over {FP8_FIRST_RTOL}")
    rel, add = FP8_LATER
    for f, b in zip(fp8[1:], bf16[1:]):
        if abs(f - b) > rel * abs(b) + add:
            raise AssertionError(f"{name} fp8 losses {fp8} left bf16's "
                                 f"{bf16} by more than {rel} x + {add}")


def act_store_check() -> dict:
    """``act_store`` on the card against the CPU on ``act_store_grid`` (and
    the gradient, the same grid as cotangent): equal element for element,
    NaN where NaN."""
    import torch

    from horovod_tpu_torch.models.layers import act_store

    def same(a, b):
        a, b = a.double(), b.double()
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b))
                    and torch.equal(a[~nan], b[~nan]))

    out = {}
    for dt in (torch.bfloat16, torch.float16, torch.float32):
        x = act_store_grid(dt)
        res = {}
        for dev in ("cpu", "cuda"):
            y = torch.linspace(-3, 3, x.numel()).to(dt).to(dev)
            y.requires_grad_()
            val = act_store(x.to(dev), torch.float8_e4m3fn, dt)
            act_store(y, torch.float8_e4m3fn, dt).backward(x.to(dev))
            res[dev] = (val.cpu(), y.grad.cpu())
        ok = (same(res["cuda"][0], res["cpu"][0])
              and same(res["cuda"][1], res["cpu"][1]))
        out[str(dt)] = {"values": x.numel(), "card_equals_cpu": ok,
                        "nans": int(torch.isnan(res["cpu"][0]).sum())}
        if not ok:
            raise AssertionError(f"act_store on the card differs from the "
                                 f"CPU on the {dt} grid")
    return out


def fp8(fa, train_run, resnet_off) -> None:
    """Phase ``fp8``: gpt-small ``--dtype fp8`` from ``train``'s weights and
    tokens, ResNet-50 fp8 from the ``resnet`` phase's, each against its
    bf16 run; then ``act_store`` card against CPU."""
    from horovod_tpu_torch.train import build_gpt_step, build_step

    step, state, _ = build_gpt_step(GPT_STEP[0], "fp8", *GPT_STEP[2:])
    state, gpt_run = drive(fa, step, state)
    gpt_run["profile"] = profile_step(state, step, gpt_run["step_ms"], top=4)
    del step, state
    release()
    fp8_gates("gpt-small", gpt_run["losses"], train_run["losses"])

    name, _, batch, size = RESNET_STEP
    step, state, static = build_step(name, "fp8", batch, size)
    state, res_run = drive_conv(fa, name, step, state, static, WARMUP, STEPS)
    res_run["profile"] = profile_step(state, step, res_run["step_ms"], top=6)
    del step, state
    release()
    fp8_gates(name, res_run["losses"], resnet_off["losses"])

    def side_by_side(run, bf16, rate):
        return {"fp8_losses": run["losses"], "bf16_losses": bf16["losses"],
                "fp8_decreases": run["losses"][-1] < run["losses"][0],
                "bf16_decreases": bf16["losses"][-1] < bf16["losses"][0],
                "max_rel_loss_diff": max_rel(run["losses"], bf16["losses"]),
                "step_ms": {"fp8": run["step_ms"], "bf16": bf16["step_ms"]},
                rate: {"fp8": run[rate], "bf16": bf16[rate]},
                "mfu": {"fp8": run["mfu"], "bf16": bf16["mfu"]},
                "peak_mem_gib": {"fp8": run["peak_mem_gib"],
                                 "bf16": bf16["peak_mem_gib"]},
                "fp8_profile": run["profile"]}

    emit("fp8", store_dtype="float8_e4m3fn", compute_dtype="bf16",
         gates={"first_rtol": FP8_FIRST_RTOL, "later": FP8_LATER},
         gpt_small=dict(side_by_side(gpt_run, train_run,
                                     "tokens_per_s_per_gpu"),
                        launches=gpt_run["launches"]),
         resnet50=side_by_side(res_run, resnet_off, "images_per_s_per_gpu"),
         act_store=act_store_check())


# ---------------------------------------------------------------------------
# Serving: phases serve_check, serve and sampler_check.  The serving path
# runs no kernel of this repo: decode and prefill attention are fp32
# einsums in the reference (horovod_tpu/models/decode.py:115-168), and so
# in the port; the Dense products are cuBLAS's through F.linear.
# ---------------------------------------------------------------------------

VOCAB = 32000
# serve_check: gpt-small fp32, reference attention, TF32 off
SERVE_CHECK = {"slots": 8, "requests": 12, "prompt": (16, 257), "new": 16}
# logits, engine against a teacher-forced forward and card against CPU:
# |got - want| <= SERVE_LOGIT_RTOL x max |want| (fp32 sums in other
# orders over 768-wide rows and a 32000-wide head)
SERVE_LOGIT_RTOL = 1e-4
# fp32 tokens are held by the margin rule at this gap of the reference's
# top two logits
SERVE_FP32_MARGIN = 1e-3
SERVE_CPU_LAYERS = 2
# serve: gpt-small bf16, 48 requests all enqueued at step 0
SERVE_SLOTS = 16
SERVE_REQUESTS = 48
SERVE_PROMPT = (16, 769)
SERVE_NEW = (16, 129)
SERVE_SAMPLE_EVERY = 4
SERVE_SAMPLING = {"temperature": 0.8, "top_k": 50}
SERVE_PAGE_SIZE = 16
SERVE_PAGES = 512      # half the worst case (16 slots x 64 pages)
# bf16 greedy tokens against a teacher-forced bf16 forward (flash
# kernels): decode attends in fp32 over the bf16 cache, the forward in the
# flash kernels with bf16 P, and the head rounds the logits to bf16 (steps
# of 0.03125 at |logit| 4-8, where the top logits sit), so near ties are
# one or two such steps apart.  Held over whole streams on an NVIDIA H100
# 80GB HBM3 (700 W), the 36 greedy streams (2,293 tokens) show 51 near
# ties in 23 streams, the largest gap 0.03125; the margin is twice that.
# The phase checks that it still rejects a planted fault (``planted_fault``).
SERVE_BF16_MARGIN = 0.0625
# sampler_check
SAMPLER_SEEDS = (0, 7, 2**31 + 5, 2**40 + 3)
SAMPLER_RIDS = ("", "r0", "req-1")
SAMPLER_INDICES = (0, 1, 17, 1000)
SAMPLER_ROWS = 256
SAMPLER_MARGIN = 1e-5
GUMBEL_ULPS = 2


def margin_rule(got, want, scores, tol, *, teacher_forced: bool) -> dict:
    """Hold token stream ``got`` against ``want``: equal, or a near tie:
    the reference's score of ``got`` within ``tol`` of its score of
    ``want`` (its top; bf16 logits tie three ways too, so this is the
    top-two rule without the count).  Raises on a violation.

    ``teacher_forced``: the reference's scores come from a forward over
    ``got``'s own history, so both sides share it at every step and the
    whole stream is held, near ties counted.  Otherwise (two engines
    decoding on their own) the histories part at the first near tie, and
    the comparison stops there."""
    import numpy as np

    scores = np.asarray(scores, dtype=np.float64)
    ties, gaps = [], []
    for i, (g, w) in enumerate(zip(list(got), list(want))):
        if g == w:
            continue
        gap = float(scores[i][w] - scores[i][g])
        if not gap <= tol:
            raise AssertionError(
                f"step {i}: token {g} != reference {w}, {gap:.4g} below it "
                f"in the reference's scores (tolerance {tol})")
        ties.append(i)
        gaps.append(gap)
        if not teacher_forced:
            return {"compared": i + 1, "near_ties": ties, "max_gap": gap}
    return {"compared": min(len(got), len(want)), "near_ties": ties,
            "max_gap": max(gaps, default=None)}


def serve_requests(n, prompt, new, sample_every=None, vocab=VOCAB):
    """``n`` requests: prompt lengths ``RandomState(0).randint(*prompt)``,
    budgets ``randint(*new)`` (or ``new`` itself), tokens ``randint(0,
    vocab)``; every ``sample_every``-th request (the 4th, 8th, ...)
    sampled with ``SERVE_SAMPLING``."""
    import numpy as np

    from horovod_tpu_torch.serve import Request

    rng = np.random.RandomState(0)
    lens = rng.randint(*prompt, size=n)
    news = rng.randint(*new, size=n) if isinstance(new, tuple) else [new] * n
    reqs = []
    for i in range(n):
        sampled = sample_every and (i + 1) % sample_every == 0
        reqs.append(Request(
            rid=f"r{i}", prompt=tuple(int(t) for t in rng.randint(
                0, vocab, lens[i])), max_new_tokens=int(news[i]),
            **(SERVE_SAMPLING if sampled else {})))
    return reqs


class LogitTap:
    """Taps the logits the engine's decode functions return (patched into
    ``horovod_tpu_torch.serve.engine`` while entered): a device-side NaN
    flag always, and with ``keep`` the last logits on the host."""

    NAMES = ("assign_slot", "assign_slot_paged", "decode_step",
             "decode_step_paged")

    def __init__(self, keep: bool):
        self.keep, self.last, self.nan = keep, None, None

    def __enter__(self):
        from horovod_tpu_torch.serve import engine

        self._orig = {n: getattr(engine, n) for n in self.NAMES}
        for n, fn in self._orig.items():
            setattr(engine, n, self._wrap(fn, n.startswith("assign")))
        return self

    def __exit__(self, *exc):
        from horovod_tpu_torch.serve import engine

        for n, fn in self._orig.items():
            setattr(engine, n, fn)

    def _wrap(self, fn, admit: bool):
        import torch

        def tapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            logits = out[1] if admit else out[0]
            flag = torch.isnan(logits).any()
            self.nan = flag if self.nan is None else self.nan | flag
            if self.keep:
                self.last = logits.float().cpu()
            return out

        return tapped


def serve_loop(engine, reqs, tap=None, timed: bool = False) -> dict:
    """The scheduler loop of ``tests/test_serve.py`` over ``reqs``, all
    enqueued at step 0: admit (the paged engine's page gate), record,
    evict, step, record, evict (``release_slot`` in paged mode).  Returns
    the tokens by request, with ``tap.keep`` the logits of each emission
    by request, and with ``timed`` CUDA events around every admission and
    step, the host time of each, and ``kv_stats`` at the step of most
    live KV rows (read after the loop)."""
    import torch

    from horovod_tpu_torch.serve import SlotScheduler, prompt_bucket

    sched = SlotScheduler(engine.num_slots)
    for r in reqs:
        sched.enqueue(r)
    paged = engine.paged is not None
    tokens, logits = {}, {r.rid: [] for r in reqs}
    admits_t, steps_t = [], []
    peak = {"live_rows": -1}

    def evict():
        for ev in sched.evict_finished():
            tokens[ev.rid] = list(ev.tokens)
            if paged:
                engine.release_slot(ev.slot)

    def events():
        if not timed:
            return None
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        return ev

    step = 0
    t0 = time.perf_counter()
    while len(tokens) < len(reqs):
        step += 1
        if step > 10_000:
            raise AssertionError(f"serving {len(reqs)} requests did not end")
        for adm in sched.admit(step, can_admit=engine.admission_gate()):
            req = adm.req
            ev, h0 = events(), time.perf_counter()
            tok = engine.admit(adm.slot, req.prompt, adm.resume,
                               total_len=len(req.prompt) + req.max_new_tokens,
                               temperature=req.temperature, top_k=req.top_k,
                               rid=req.rid)
            if ev:
                ev[1].record()
                admits_t.append((ev, time.perf_counter() - h0, prompt_bucket(
                    len(req.prompt), engine.serve_len)))
            if tap is not None and tap.keep:
                logits[req.rid].append(tap.last)
            sched.record(adm.slot, tok)
        evict()
        active = sorted(sched.active)
        if active:
            ev, h0 = events(), time.perf_counter()
            toks = engine.step(active)
            if ev:
                ev[1].record()
                steps_t.append((ev, time.perf_counter() - h0, len(active)))
            for slot in active:
                if tap is not None and tap.keep:
                    logits[sched.active[slot].req.rid].append(tap.last[slot])
                sched.record(slot, toks[slot])
            live = sum(len(a.req.prompt) + len(a.emitted) - 1
                       for a in sched.active.values())
            if timed and live > peak["live_rows"]:
                # no host read here: the paged stats are host state, the
                # contiguous positions are cloned on the card and read
                # after the loop
                peak = {"live_rows": live, "step": step,
                        "active": active,
                        "kv_stats": engine.kv_stats(active) if paged
                        else engine.cache["pos"].clone()}
        evict()
    wall = time.perf_counter() - t0
    if timed and not paged:
        pos, engine.cache["pos"] = engine.cache["pos"], peak["kv_stats"]
        peak["kv_stats"] = engine.kv_stats(peak["active"])
        engine.cache["pos"] = pos
    return {"tokens": tokens, "logits": logits, "steps": step, "wall_s": wall,
            "admits": admits_t, "decode_steps": steps_t, "peak": peak}


def teacher_forced(model, req, toks, device):
    """The model's logits over ``req.prompt + toks[:-1]`` at the positions
    that predict ``toks`` (fp32 on the host): the engine's own history."""
    import torch

    seq = torch.tensor([list(req.prompt) + toks[:-1]], device=device)
    return model(seq)[0, len(req.prompt) - 1:].float().cpu()


def bf16_margins(model, greedy, tokens, device) -> dict:
    """Each greedy request's tokens under the margin rule at
    ``SERVE_BF16_MARGIN`` against the teacher-forced forward; raises
    after the last request, naming every stream that failed."""
    import torch

    out, failed = {}, {}
    with torch.inference_mode():
        for r in greedy:
            want = teacher_forced(model, r, tokens[r.rid], device)
            try:
                out[r.rid] = margin_rule(
                    tokens[r.rid], want.argmax(-1).tolist(), want,
                    SERVE_BF16_MARGIN, teacher_forced=True)
            except AssertionError as e:
                failed[r.rid] = str(e)
    if failed:
        raise AssertionError(f"serve: {len(failed)} of {len(greedy)} greedy "
                             f"streams fail the bf16 margin rule: {failed}")
    return out


def planted_fault(model, reqs, slots, hold) -> dict:
    """A gate against a planted fault: a contiguous engine of ``slots``
    whose decode writes to the last row of every ``SERVE_PAGE_SIZE``-row
    block land one row late (so each such token drops out of every later
    step's history, a fault that shows only after the stream's first
    block boundary) serves ``reqs`` with its logits tapped;
    ``hold(run)``, the gate, must raise."""
    import torch

    from horovod_tpu_torch.models import decode
    from horovod_tpu_torch.serve import SlotEngine

    write_rows = decode._write_rows

    def late(buf, dest, valid, new):
        edge = dest % SERVE_PAGE_SIZE == SERVE_PAGE_SIZE - 1
        write_rows(buf, torch.where(edge, dest + 1, dest).clamp(
            max=buf.shape[1] - 1), valid, new)

    decode._write_rows = late
    try:
        with LogitTap(keep=True) as tap:
            run = serve_loop(SlotEngine(model, slots), reqs, tap)
    finally:
        decode._write_rows = write_rows
    try:
        hold(run)
    except AssertionError as e:
        return {"requests": len(reqs), "rejected": str(e)}
    raise AssertionError("a gate passed a planted fault (decode writes one "
                         "row late at each block boundary)")


def check_stream_logits(name, got, want, tol_rel) -> float:
    """The engine's logits of one request against the reference's, step by
    step: max |got - want| / max |want|; raises past ``tol_rel``."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        rel = (g - w).abs().max().item() / w.abs().max().item()
        worst = max(worst, rel)
        if not rel <= tol_rel:
            raise AssertionError(f"{name} step {i}: logits {rel:.3g} x max "
                                 f"|logit| from the reference's (> {tol_rel})")
    return worst


def serve_check(device: str = "cuda") -> dict:
    """Phase ``serve_check`` (fp32, TF32 off): gpt-small's contiguous
    ``SlotEngine`` (8 slots, 12 greedy requests of 16 tokens) against a
    teacher-forced ``GPT.forward`` (and the same gate against a planted
    fault), and at 2 layers the same engine on the card against the
    CPU."""
    import copy

    import torch

    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.serve import SlotEngine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    reqs = serve_requests(SERVE_CHECK["requests"], SERVE_CHECK["prompt"],
                          SERVE_CHECK["new"])
    model = gpt("small", dtype=torch.float32, attention_impl="reference",
                device=device)

    def hold(run):
        """Every emission's logits within ``SERVE_LOGIT_RTOL`` of the
        teacher-forced forward (the first token's apart), every token by
        the margin rule; raises."""
        rel, margins = {"first": 0.0, "later": 0.0}, []
        with torch.inference_mode():
            for r in reqs:
                toks, got = run["tokens"][r.rid], run["logits"][r.rid]
                want = teacher_forced(model, r, toks, device)
                rel["first"] = max(rel["first"], check_stream_logits(
                    f"{r.rid} first token", got[:1], want[:1],
                    SERVE_LOGIT_RTOL))
                rel["later"] = max(rel["later"], check_stream_logits(
                    f"{r.rid} decode", got[1:], want[1:], SERVE_LOGIT_RTOL))
                margins.append(margin_rule(
                    toks, want.argmax(-1).tolist(), want, SERVE_FP32_MARGIN,
                    teacher_forced=True))
        return rel, margins

    with LogitTap(keep=True) as tap:
        run = serve_loop(SlotEngine(model, SERVE_CHECK["slots"]), reqs, tap)
    rel, margins = hold(run)
    fault = planted_fault(model, reqs, SERVE_CHECK["slots"], hold)
    del model, tap, run
    release()

    # card against CPU at gpt-small's widths, 2 layers, same weights
    cpu = gpt("small", dtype=torch.float32, attention_impl="reference",
              num_layers=SERVE_CPU_LAYERS, device="cpu")
    card = copy.deepcopy(cpu).to(device)
    runs = {}
    for dev, m in (("cpu", cpu), ("card", card)):
        with LogitTap(keep=True) as tap:
            runs[dev] = serve_loop(SlotEngine(m, SERVE_CHECK["slots"]), reqs,
                                   tap)
    step_rel, card_margins = 0.0, []
    for r in reqs:
        want_toks = runs["cpu"]["tokens"][r.rid]
        want_logits = runs["cpu"]["logits"][r.rid]
        m = margin_rule(runs["card"]["tokens"][r.rid], want_toks,
                        torch.stack(want_logits), SERVE_FP32_MARGIN,
                        teacher_forced=False)
        card_margins.append(m)
        n = m["compared"]
        step_rel = max(step_rel, check_stream_logits(
            f"{r.rid} card vs CPU", runs["card"]["logits"][r.rid][:n],
            want_logits[:n], SERVE_LOGIT_RTOL))
    del card, cpu
    release()
    out = {
        "model": "gpt-small", "dtype": "fp32", "tf32": False,
        "attention_impl": "reference", "slots": SERVE_CHECK["slots"],
        "requests": len(reqs), "new_tokens": SERVE_CHECK["new"],
        "logit_rtol": SERVE_LOGIT_RTOL, "margin": SERVE_FP32_MARGIN,
        "first_token_max_rel": rel["first"],
        "decode_max_rel": rel["later"],
        "tokens_compared": sum(m["compared"] for m in margins),
        "tokens": sum(r.max_new_tokens for r in reqs),
        "forward_near_ties": sum(len(m["near_ties"]) for m in margins),
        "planted_fault": fault,
        "card_vs_cpu": {"layers": SERVE_CPU_LAYERS, "step_max_rel": step_rel,
                        "tokens_compared": sum(m["compared"]
                                               for m in card_margins),
                        "streams_stopped_at_a_near_tie": [
                            r.rid for r, m in zip(reqs, card_margins)
                            if m["near_ties"]]},
    }
    emit("serve_check", **out)
    return out


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if xs else None


def serve_record(run, reqs, peak_mem) -> dict:
    """The timed numbers of one traffic run."""
    import torch

    torch.cuda.synchronize()
    new = sum(r.max_new_tokens for r in reqs)
    full = [(ev[0].elapsed_time(ev[1]), host * 1e3)
            for ev, host, n in run["decode_steps"] if n == SERVE_SLOTS]
    by_bucket: dict = {}
    for ev, host, bucket in run["admits"]:
        by_bucket.setdefault(bucket, []).append(ev[0].elapsed_time(ev[1]))
    return {
        "wall_s": run["wall_s"], "steps": run["steps"],
        "requests_per_s": len(reqs) / run["wall_s"],
        "generated_tokens_per_s": new / run["wall_s"],
        "decode_steps": len(run["decode_steps"]),
        "decode_steps_at_16": len(full),
        "decode_step_ms_median_at_16": _median([f[0] for f in full]),
        "decode_step_host_ms_median_at_16": _median([f[1] for f in full]),
        "prefill_ms_by_bucket": {
            str(b): {"median_ms": _median(v), "admissions": len(v)}
            for b, v in sorted(by_bucket.items())},
        "peak": run["peak"], "peak_mem_gib": peak_mem,
    }


def serve(fa, device: str = "cuda") -> dict:
    """Phase ``serve`` (bf16): gpt-small's ``SlotEngine`` with 16 slots,
    contiguous, then paged (512 pages of 16, half the worst case), over 48
    requests enqueued at step 0; the gates and numbers of the module
    docstring.  Each engine is profiled after its run and dropped before
    the next is built, so each run's peak memory is its own."""
    import torch

    from horovod_tpu_torch.models import gpt
    from horovod_tpu_torch.serve import SlotEngine

    reqs = serve_requests(SERVE_REQUESTS, SERVE_PROMPT, SERVE_NEW,
                          SERVE_SAMPLE_EVERY)
    model = gpt("small", device=device)
    modes = {"contiguous": {},
             "paged": {"kv_mode": "paged", "page_size": SERVE_PAGE_SIZE,
                       "num_pages": SERVE_PAGES}}
    tokens, records = {}, {}
    for mode, kw in modes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        eng = SlotEngine(model, SERVE_SLOTS, sample_seed=0, **kw)
        fa.reset_launch_counts()              # the serving path starts here
        with LogitTap(keep=False) as tap:
            run = serve_loop(eng, reqs, tap, timed=True)
            nan = bool(tap.nan)
        launches = dict(fa.LAUNCHES)          # ... and ends here
        records[mode] = serve_record(run, reqs,
                                     torch.cuda.max_memory_allocated() / 2**30)
        records[mode]["kernel_launches"] = launches
        tokens[mode] = run["tokens"]
        if nan:
            raise AssertionError(f"serve {mode}: a NaN logit")
        if any(launches.values()):
            raise AssertionError(f"serve {mode}: kernels of this repo "
                                 f"launched on the serving path: {launches}")
        records[mode]["after_the_run"] = serve_profiles(eng)
        del eng, run
        release_cache()
    for r in reqs:
        toks = tokens["contiguous"][r.rid]
        if len(toks) != r.max_new_tokens or not all(
                0 <= t < VOCAB for t in toks):
            raise AssertionError(f"serve {r.rid}: {len(toks)} tokens for a "
                                 f"budget of {r.max_new_tokens}, or one out "
                                 f"of range")
    differ = [r.rid for r in reqs
              if tokens["paged"][r.rid] != tokens["contiguous"][r.rid]]
    if differ:
        raise AssertionError(f"serve: paged and contiguous streams differ "
                             f"for {differ}")
    greedy = [r for r in reqs if r.temperature == 0]
    margins = bf16_margins(model, greedy, tokens["contiguous"], device)
    fault = planted_fault(
        model, greedy, SERVE_SLOTS,
        lambda run: bf16_margins(model, greedy, run["tokens"], device))
    del model
    release()
    gaps = [m["max_gap"] for m in margins.values() if m["near_ties"]]
    out = {
        "model": "gpt-small", "dtype": "bf16", "pos_embedding": "learned",
        "slots": SERVE_SLOTS, "requests": len(reqs),
        "prompt_range": SERVE_PROMPT, "new_range": SERVE_NEW,
        "sampled_every": SERVE_SAMPLE_EVERY, "sampling": SERVE_SAMPLING,
        "generated_tokens": sum(r.max_new_tokens for r in reqs),
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        "page_pool": {"page_size": SERVE_PAGE_SIZE,
                      "num_pages": SERVE_PAGES},
        "paged_equals_contiguous": True,
        "bf16_margin": SERVE_BF16_MARGIN,
        "greedy_tokens_compared": sum(m["compared"]
                                      for m in margins.values()),
        "greedy_tokens": sum(r.max_new_tokens for r in greedy),
        "near_ties": sum(len(m["near_ties"]) for m in margins.values()),
        "streams_with_a_near_tie": len(gaps),
        "max_near_tie_gap": max(gaps, default=None),
        "planted_fault": fault,
        **records,
    }
    emit("serve", **out)
    return out


def release_cache() -> None:
    """Return the blocks of dropped tensors to the card (no check: the
    model of the phase is still alive)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


PROFILE_PROMPT = 480   # 16 x 31 pages of 16 fit the 512-page pool
PROFILE_STEPS = 5


def serve_profiles(eng) -> dict:
    """After a traffic run: 16 requests of ``PROFILE_PROMPT`` tokens in
    every slot, the decode step's host-clock time (median of
    ``PROFILE_STEPS``, each ending in the host read of the tokens) and one
    more step profiled as ``profile_step`` does; then one admission into
    slot 0 timed and profiled the same way."""
    import numpy as np

    eng.reset()
    rng = np.random.RandomState(1)
    prompts = [tuple(int(t) for t in rng.randint(0, VOCAB, PROFILE_PROMPT))
               for _ in range(SERVE_SLOTS)]
    total = PROFILE_PROMPT + 2 * PROFILE_STEPS + 2

    def admit():
        eng.release_slot(0)
        eng.admit(0, prompts[0], total_len=total)

    for slot, p in enumerate(prompts):
        eng.admit(slot, p, total_len=total)
    slots = list(range(SERVE_SLOTS))
    out = {}
    for name, fn in (("decode_step_16", lambda: eng.step(slots)),
                     ("admission_480", admit)):
        times = []
        for _ in range(PROFILE_STEPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = _median(times)
        out[name] = {"host_ms_median": ms, "host_ms": times,
                     "profile": profile_step((), fn, ms, top=8)}
    eng.reset()
    return out


def sampler_check(device: str = "cuda") -> dict:
    """Phase ``sampler_check``: the threefry layer and the sampler on the
    card against the CPU: keys, folds, splits and bits equal; Gumbel
    noise within ``GUMBEL_ULPS`` ulp at the scale ``max(|g|, 1)``; tokens
    of 256 rows of 32000 fp32 logits under the margin rule."""
    import numpy as np
    import torch

    from horovod_tpu_torch.ops import prng
    from horovod_tpu_torch.serve import sampling

    keys = 0
    for seed in SAMPLER_SEEDS:
        for rid in SAMPLER_RIDS:
            base = {d: sampling.request_key(seed, rid, device=d)
                    for d in ("cpu", device)}
            outs = {d: [base[d], prng.split(base[d], (3, 4)),
                        prng.random_bits(base[d], (VOCAB,))]
                    + [sampling.token_key(base[d], i)
                       for i in SAMPLER_INDICES] for d in base}
            for a, b in zip(outs["cpu"], outs[device]):
                if not torch.equal(a, b.cpu()):
                    raise AssertionError(f"threefry on the card differs from "
                                         f"the CPU (seed {seed}, rid {rid!r})")
                keys += 1
    worst_ulps = 0.0
    for seed in SAMPLER_SEEDS:
        g = {d: prng.gumbel(prng.prng_key(seed, d), (VOCAB,)).cpu()
             for d in ("cpu", device)}
        scale = np.spacing(np.maximum(np.abs(g["cpu"].numpy()), 1.0)
                           .astype(np.float32))
        ulps = float((np.abs(g[device].numpy() - g["cpu"].numpy())
                      / scale).max())
        worst_ulps = max(worst_ulps, ulps)
        if ulps > GUMBEL_ULPS:
            raise AssertionError(f"gumbel on the card {ulps} ulp from the "
                                 f"CPU's (> {GUMBEL_ULPS})")
    rng = np.random.RandomState(0)
    logits = torch.from_numpy((rng.randn(SAMPLER_ROWS, VOCAB) * 3)
                              .astype(np.float32))
    temps = rng.choice([0.0, 0.8, 1.0], SAMPLER_ROWS).astype(np.float32)
    topks = rng.choice([0, 50, 1000], SAMPLER_ROWS)
    base = torch.stack([sampling.request_key(0, f"r{i}")
                        for i in range(SAMPLER_ROWS)])
    idx = torch.arange(SAMPLER_ROWS) % 7
    got = sampling.sample_token(logits.to(device), temps, topks,
                                sampling.token_key(base.to(device),
                                                   idx.to(device))).cpu()
    keys_cpu = sampling.token_key(base, idx)
    want = sampling.sample_token(logits, temps, topks, keys_cpu)
    lt = logits / torch.from_numpy(np.where(temps > 0, temps, 1.0))[:, None]
    k = torch.from_numpy(np.where((topks > 0) & (topks < VOCAB), topks,
                                  VOCAB))
    kth = torch.sort(lt, dim=-1, descending=True).values.gather(
        1, (k - 1)[:, None])
    lt = torch.where(lt < kth, -torch.inf, lt)
    noise = prng.gumbel(keys_cpu, (VOCAB,))
    differ = 0
    for i in range(SAMPLER_ROWS):
        score = (lt[i] + noise[i]) if temps[i] > 0 else logits[i]
        m = margin_rule([int(got[i])], [int(want[i])], score[None].numpy(),
                        SAMPLER_MARGIN, teacher_forced=True)
        differ += len(m["near_ties"])
    out = {"key_checks": keys, "gumbel_max_ulps": worst_ulps,
           "gumbel_ulp_limit": GUMBEL_ULPS, "rows": SAMPLER_ROWS,
           "vocab": VOCAB, "tokens_differing_at_near_ties": differ,
           "sampled_rows": int((temps > 0).sum())}
    emit("sampler_check", **out)
    return out


# cuDNN's NCHW <-> NHWC conversion kernels: device time in them means a
# tensor reached a convolution in the other layout
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")
# device time by family of kernel: the first family whose any substring is
# in the kernel's name (cuDNN's and cuBLAS's sm90 kernels: "xmma", "gemm")
FAMILIES = (("flash", ("flash_",)), ("batch_norm", ("batch_norm",)),
            ("conv_matmul", ("xmma", "gemm", "conv", "cudnn", "cutlass")),
            ("pool", ("pool",)), ("concat", ("CatArray",)),
            ("optimizer", ("multi_tensor",)), ("nccl", ("nccl",)),
            ("reduce", ("reduce",)),
            ("elementwise", ("elementwise", "copy", "fill")))


def profile_step(state, step, step_ms: float, top: int = 12) -> dict:
    """One more step under torch.profiler: device time by kernel, the
    share of the timed (unprofiled) step the device was busy, the share of
    device time in layout conversions, and the host's busy time by op (the
    profiler's own overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        step(*state)
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = sorted(
        ((ev.self_device_time_total / 1e3, ev.key, ev.count)
         for ev in events
         if ev.device_type == torch.autograd.DeviceType.CUDA
         and not ev.is_user_annotation and ev.self_device_time_total > 0),
        reverse=True,
    )
    cpu = sorted(((ev.self_cpu_time_total / 1e3, ev.key, ev.count)
                  for ev in events if ev.self_cpu_time_total > 0
                  and "Synchronize" not in ev.key),
                 reverse=True)
    busy_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows if "flash_" in r[1])
    layout_ms = sum(r[0] for r in rows
                    if any(k in r[1] for k in LAYOUT_KERNELS))
    families: dict = {}
    for ms, name, _ in rows:
        fam = next((f for f, keys in FAMILIES
                    if any(k in name for k in keys)), "other")
        families[fam] = families.get(fam, 0.0) + ms
    return dict(device_busy_ms=busy_ms, step_ms=step_ms,
                device_busy_share=busy_ms / step_ms,
                layout_conversion_ms=layout_ms,
                layout_conversion_share=layout_ms / busy_ms if busy_ms else 0,
                device_ms_by_family=families,
                flash_kernels_ms=flash_ms, kernels=len(rows),
                flash=[{"name": n[:60], "ms": ms, "calls": c}
                       for ms, n, c in rows if "flash_" in n],
                host_busy_ms=sum(r[0] for r in cpu),
                top=[{"name": n[:80], "ms": ms, "calls": c}
                     for ms, n, c in rows[:top]],
                host_top=[{"name": n[:80], "ms": ms, "calls": c}
                          for ms, n, c in cpu[:top]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    import horovod_tpu_torch as hvd
    from horovod_tpu_torch import models as hvd_models
    from horovod_tpu_torch.ops import flash_attention as fa
    from horovod_tpu_torch.ops import kernels

    card = card_line()
    t0 = time.perf_counter()
    kernels.build_all()
    build_s = time.perf_counter() - t0
    sass = {n: kernels.sass_counts(n) for n in SCALAR_TWIN}
    emit("build", seconds=build_s, card=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         ptxas={n: kernels.ptxas_report(n).splitlines()
                for n in kernels.SOURCES},
         sass=sass)
    missing = {n: c for n, c in sass.items() if not all(c.values())}
    if missing:
        raise AssertionError(f"tensor-core libraries without wgmma/TMA "
                             f"instructions: {missing}")

    records = kernel_check(fa)
    skip_ms, skip_ratios, main_ratios = tile_skip(fa)
    emit("tile_skip", shape={**SKIP_SHAPE, "window": SKIP_WINDOW},
         dtype=SKIP_DTYPE, ms=skip_ms, ratios=skip_ratios,
         limits=SKIP_LIMITS,
         main_shape={**MAIN_SHAPE, "ratios": main_ratios,
                     "held": False})
    model_check(hvd_models, fa)
    state, step, run, world = train(hvd, fa)
    launches = run["launches"]
    emit("profile", **profile_step(state, step, run["step_ms"]))
    del state, step
    release()
    overlap(fa, run["losses"])
    rope_remat(fa)
    resnet_off = conv(fa)
    reductions(hvd, fa, run)
    release()
    eager(hvd, fa, run)
    release()
    fp8(fa, run, resnet_off)
    release()
    serve_check()
    serve(fa)
    sampler_check()

    summary = [
        {"name": n, "route": "cuda", "source": SOURCES[n][0],
         "replaces": SOURCES[n][1], "launches": launches[n],
         "max_abs_err": records[n]["max_abs_err"], "ms": records[n]["ms"],
         "plain_ms": records[n]["plain_ms"],
         "bound_ms": records[n]["bound_ms"],
         "bound_by": records[n]["bound_by"],
         "library_ms": records[n]["library_ms"]}
        for n in SOURCES
    ]
    hvd.shutdown()
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": world}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
