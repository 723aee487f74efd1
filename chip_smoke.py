#!/usr/bin/env python3
"""On-card smoke run of horovod_tpu_torch, the PyTorch/CUDA port.

    python3 chip_smoke.py        # from the repo root, on a machine with one GPU

Drives the port's main path — one data-parallel gpt-small training step
at full width and depth (12 layers, 12 heads, emb 768, vocab 32000, bf16,
seq 1024, batch 8 per GPU, AdamW lr 1e-4) — and holds every kernel of it
against its plain PyTorch version.  Phases, one JSON line each:

1. ``build``: compile the CUDA kernels from ``horovod_tpu_torch/csrc``
   (one nvcc per source, all at once) and print the seconds taken.
2. ``kernel_check``: each kernel against its plain version at the main
   path's shape (Z=96, S=1024, D=64, bf16, causal) and at a small fp32
   GQA + window shape with a ragged S; times of kernel, plain version and
   the PyTorch library call (SDPA; a yardstick the port never calls).
   ``tile_skip``: each kernel's time unmasked, causal and windowed at the
   main shape; the masked runs must be faster by the tiles they skip.
3. ``model_check``: gpt-nano in fp32 on the card, flash kernels against
   the plain reference attention: logits and gradients.
4. ``train``: ``init()``, ``build_gpt_step("small", "bf16", 8, 1024)``,
   2 warm-up and 5 timed steps; every loss finite and each kernel launched
   12 times per step.
5. ``profile``: one more step under ``torch.profiler``: device time by
   kernel and the device's busy share.

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
# sums taken in another order than the plain version's; fp32: sums in
# another order only.
TOL = {"bf16": (1e-2, 1e-2), "fp32": (1e-4, 1e-4), "lse": (1e-3, 0.0)}


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
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    CUDA events around the batch, after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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


def backward_pass_ms(fa, q, k, v, o, lse, do, cfg, iters: int = 10):
    """Device time of each backward pass alone, through the launch helpers
    the backward wrapper calls; ``cfg`` is (causal, scale, h, hkv,
    window)."""
    import torch

    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    return {
        "flash_bwd_dkdv": cuda_ms(
            lambda: fa.launch_dkdv(q, k, v, o, lse, do, dk, dv, *cfg), iters),
        "flash_bwd_dq": cuda_ms(
            lambda: fa.launch_dq(q, k, v, o, lse, do, dq, *cfg), iters),
    }


# The kernels skip the (Q, K) tiles their masks rule out, and that shows in
# their times.  At S=1024 a causal mask leaves about half the tiles, and a
# 64-key window about a quarter of the causal ones; a kernel that visited
# every tile would take as long masked as not.
SKIP_WINDOW = 64
SKIP_LIMITS = {"causal_over_full": 0.7, "window_over_causal": 0.5}


def tile_skip(fa, b: int = 8, s: int = 1024, h: int = 12, d: int = 64):
    """Each kernel's device time with no mask, causal, and causal with a
    ``SKIP_WINDOW``-key band, bf16 at one shape.  Raises unless each masked
    run is as much faster as ``SKIP_LIMITS`` says; returns the times and
    their ratios per kernel."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(b * h, s, d, device="cuda",
                               generator=g).to(torch.bfloat16)
                   for _ in range(4))
    ms = {}
    for mask, (causal, window) in {"full": (False, None),
                                   "causal": (True, None),
                                   "window": (True, SKIP_WINDOW)}.items():
        cfg = (causal, d ** -0.5, h, h, window)
        o, lse = fa.flash_fwd(q, k, v, causal, d ** -0.5, s, s, h, h, window)
        ms[mask] = {"flash_fwd": cuda_ms(
            lambda: fa.flash_fwd(q, k, v, causal, d ** -0.5, s, s, h, h,
                                 window), 10),
            **backward_pass_ms(fa, q, k, v, o, lse, do, cfg)}
    ratios = {n: {"causal_over_full": ms["causal"][n] / ms["full"][n],
                  "window_over_causal": ms["window"][n] / ms["causal"][n]}
              for n in ms["full"]}
    bad = {n: r for n, r in ratios.items()
           if any(r[key] >= lim for key, lim in SKIP_LIMITS.items())}
    if bad:
        raise AssertionError(f"masked tiles are not skipped: {bad} "
                             f"(limits {SKIP_LIMITS})")
    return ms, ratios


def attention_work(b, s, h, hkv, d, causal, window, itemsize):
    """FLOPs of each kernel's products and the bytes it must move (each
    input read once, each output written once) on these shapes; only the
    (q, k) pairs the masks leave alive count."""
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
    return {
        # S = QK^T and O = PV
        "flash_fwd": (4 * d * pairs, q_bytes + 2 * kv_bytes + q_bytes
                      + lse_bytes),
        # S, dP = dO V^T, dV = P^T dO, dK = dS^T Q
        "flash_bwd_dkdv": (8 * d * pairs, 3 * q_bytes + 2 * kv_bytes
                           + lse_bytes + 2 * kv_bytes),
        # S, dP, dQ = dS K
        "flash_bwd_dq": (6 * d * pairs, 3 * q_bytes + 2 * kv_bytes
                         + lse_bytes + q_bytes),
    }


def bound(flops: int, nbytes: int, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / H100_HBM_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_check(fa):
    """Every kernel against its plain version at two shapes; returns the
    main shape's record per kernel."""
    import torch
    import torch.nn.functional as F

    shapes = [
        # the main path: gpt-small attention, one layer
        dict(b=8, s=1024, h=12, hkv=12, d=64, dtype=torch.bfloat16,
             causal=True, window=None, main=True),
        # GQA + sliding window, fp32, S not a multiple of any tile
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

        o, lse = fa.flash_fwd(q, k, v, *args)
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, *args)
        err = {
            "flash_fwd": check_close("flash_fwd o", o, o_p, TOL[tname]),
            "lse": check_close("flash_fwd lse", lse, lse_p, TOL["lse"]),
        }
        # both backward passes from the plain forward's (o, lse)
        dq, dk, dv = fa.flash_bwd(q, k, v, o_p, lse_p, do, *args)
        dq_p, dk_p, dv_p = fa.flash_bwd_plain(q, k, v, o_p, lse_p, do,
                                              causal, scale, bk, h, hkv,
                                              window)
        err["flash_bwd_dq"] = check_close("flash_bwd_dq", dq, dq_p,
                                          TOL[tname])
        err["flash_bwd_dkdv"] = max(
            check_close("flash_bwd_dkdv dk", dk, dk_p, TOL[tname]),
            check_close("flash_bwd_dkdv dv", dv, dv_p, TOL[tname]),
        )
        line = {"shape": {"b": b, "s": s, "h": h, "hkv": hkv, "d": d,
                          "dtype": tname, "causal": causal,
                          "window": window},
                "tolerance": {"atol": TOL[tname][0],
                              "rtol": TOL[tname][1],
                              "lse_atol": TOL["lse"][0]},
                "max_abs_err": err}
        if shp["main"]:
            ms = {
                "flash_fwd": cuda_ms(lambda: fa.flash_fwd(q, k, v, *args),
                                     20),
                # one call of the backward wrapper launches both passes;
                # each pass is timed alone
                **backward_pass_ms(fa, q, k, v, o_p, lse_p, do,
                                   (causal, scale, h, hkv, window)),
            }
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
            for name in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"):
                flops, nbytes = work[name]
                bms, by = bound(flops, nbytes, H100_BF16_PEAK)
                records[name] = {
                    "max_abs_err": err[name], "ms": ms[name],
                    "plain_ms": plain_fwd if name == "flash_fwd"
                    else plain_bwd,
                    "bound_ms": bms, "bound_by": by,
                    "library_ms": lib_fwd if name == "flash_fwd"
                    else lib_bwd,
                    "flops": flops, "bytes": nbytes,
                }
            line["kernel_ms"] = ms
            line["plain_ms"] = {"forward": plain_fwd,
                                "backward_dq_dk_dv": plain_bwd}
            line["library_ms"] = {"sdpa_forward": lib_fwd,
                                  "sdpa_flash_backward_dq_dk_dv": lib_bwd}
            line["bound_ms"] = {n: records[n]["bound_ms"] for n in records}
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


def model_flops_per_step(cfg, batch: int, seq: int) -> float:
    """Training FLOPs of one step, counted from the model: 6 per parameter
    of the matrix products per token (forward 2, backward 4), plus the
    attention products (forward 4 * emb per (q, k) pair alive under the
    causal mask, times 3 for forward and backward); the backward's
    recompute of the scores is not counted."""
    e, L, v = cfg.emb_dim, cfg.num_layers, cfg.vocab_size
    kv = cfg.kv_heads * cfg.head_dim
    n_mm = L * (e * (e + 2 * kv) + e * e + 2 * cfg.mlp_ratio * e * e) + e * v
    pairs = seq * (seq + 1) // 2
    return 6 * n_mm * batch * seq + 3 * L * 4 * e * pairs * batch


def train(hvd, fa, steps: int = 5, warmup: int = 2):
    import torch

    from horovod_tpu_torch.train import build_gpt_step

    topo = hvd.init()
    assert topo.device.type == "cuda" and topo.backend == "nccl", topo
    step, state, static = build_gpt_step("small", "bf16", 8, 1024)
    model = state[0]
    batch, seq = state[2].shape[0], state[2].shape[1] - 1
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fa.reset_launch_counts()                # the main path starts here
    losses = []
    for _ in range(warmup):
        model, opt, loss = step(*state)
        state = (model, opt) + state[2:]
        losses.append(loss.item())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model, opt, loss = step(*state)
        state = (model, opt) + state[2:]
        losses.append(loss)
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / steps
    launches = dict(fa.LAUNCHES)            # ... and ends here
    losses = [float(x) for x in losses]

    total = steps + warmup
    layers = model.cfg.num_layers
    want = layers * total
    bad = {n: c for n, c in launches.items() if c != want}
    if bad:
        raise AssertionError(
            f"kernel launches {bad} != {layers} per step x {total} steps")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    flops = model_flops_per_step(model.cfg, batch, seq)
    tokens = batch * seq
    emit("train", model="gpt-small", dtype="bf16", batch_per_gpu=batch,
         seq=seq, world=static["n_chips"], steps_timed=steps,
         warmup=warmup, losses=losses, step_ms=secs * 1e3,
         tokens_per_s_per_gpu=tokens / secs,
         model_flops_per_step=flops,
         mfu=flops / secs / H100_BF16_PEAK,
         mfu_peak_flops=H100_BF16_PEAK,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches, launches_per_step_per_kernel=layers)
    return state, step, launches, secs * 1e3


def profile(state, step, step_ms: float):
    """One more step under torch.profiler: device time by kernel, and the
    share of the timed (unprofiled) step the device was busy."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        step(*state)
        torch.cuda.synchronize()
    rows = sorted(
        ((ev.self_device_time_total / 1e3, ev.key, ev.count)
         for ev in prof.key_averages()
         if ev.device_type == torch.autograd.DeviceType.CUDA
         and not ev.is_user_annotation and ev.self_device_time_total > 0),
        reverse=True,
    )
    busy_ms = sum(r[0] for r in rows)
    flash_ms = sum(r[0] for r in rows if "flash_" in r[1])
    emit("profile", device_busy_ms=busy_ms, step_ms=step_ms,
         device_busy_share=busy_ms / step_ms, flash_kernels_ms=flash_ms,
         kernels=len(rows),
         top=[{"name": n[:80], "ms": ms, "calls": c}
              for ms, n, c in rows[:12]])


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
    emit("build", seconds=time.perf_counter() - t0, card=card,
         torch=torch.__version__, cuda=torch.version.cuda,
         ptxas={n: kernels.ptxas_report(n).splitlines()
                for n in kernels.SOURCES})

    records = kernel_check(fa)
    skip_ms, skip_ratios = tile_skip(fa)
    emit("tile_skip", shape={"b": 8, "s": 1024, "h": 12, "d": 64,
                             "dtype": "bf16", "window": SKIP_WINDOW},
         ms=skip_ms, ratios=skip_ratios, limits=SKIP_LIMITS)
    model_check(hvd_models, fa)
    state, step, launches, step_ms = train(hvd, fa)
    profile(state, step, step_ms)

    sources = {"flash_fwd": ("horovod_tpu_torch/csrc/flash_fwd.cu",
                             "horovod_tpu/ops/flash_attention.py:158"),
               "flash_bwd_dkdv": ("horovod_tpu_torch/csrc/flash_bwd_dkdv.cu",
                                  "horovod_tpu/ops/flash_attention.py:291"),
               "flash_bwd_dq": ("horovod_tpu_torch/csrc/flash_bwd_dq.cu",
                                "horovod_tpu/ops/flash_attention.py:324")}
    summary = [
        {"name": n, "route": "cuda", "source": sources[n][0],
         "replaces": sources[n][1], "launches": launches[n],
         "max_abs_err": records[n]["max_abs_err"], "ms": records[n]["ms"],
         "plain_ms": records[n]["plain_ms"],
         "bound_ms": records[n]["bound_ms"],
         "bound_by": records[n]["bound_by"],
         "library_ms": records[n]["library_ms"]}
        for n in ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
    ]
    hvd.shutdown()
    print(json.dumps({"kernels": summary}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
