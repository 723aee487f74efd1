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


def resnet(fa) -> None:
    """ResNet-50, bf16, 224, batch 128: ``off`` and ``bucket`` against
    each other and the first loss against fp32 (TF32 off)."""
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


def conv(fa) -> None:
    """Phase ``conv``: ``conv_check``, ``resnet``, ``zoo``."""
    conv_check()
    resnet(fa)
    zoo(fa)


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
    conv(fa)

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
