"""Flash attention: hand-written CUDA kernels for Hopper, and their plain
PyTorch versions.

The counterpart of ``horovod_tpu/ops/flash_attention.py``: the same
``[batch, seq, heads, head_dim]`` signature and causal / scale / window /
GQA semantics, and the same ``ValueError``s.  Kernels under ``csrc/``
replace the three Pallas kernels:

* ``_flash_fwd_kernel`` <- ``flash_fwd_tc`` (``csrc/flash_fwd_tc.cu``,
  bf16 tensor cores) for bf16, ``flash_fwd_f32tc``
  (``csrc/flash_fwd_f32tc.cu``, 3xTF32 tensor cores) for fp32
* ``kernel_dkdv`` <- ``flash_bwd_dkdv_tc`` (``csrc/flash_bwd_dkdv_tc.cu``)
  for bf16, ``flash_bwd_dkdv_f32tc`` (``csrc/flash_bwd_dkdv_f32tc.cu``) for
  fp32
* ``kernel_dq`` <- ``flash_bwd_dq_tc`` (``csrc/flash_bwd_dq_tc.cu``) for
  bf16, ``flash_bwd_dq_f32tc`` (``csrc/flash_bwd_dq_f32tc.cu``) for fp32

:func:`kernel_for` is the whole route table; the bf16 kernels are one
source each, instantiated at every head_dim of :data:`KERNEL_HEAD_DIMS`,
and so are the fp32 ones.  ``wgmma`` has no fp32 form; the fp32 kernels
take each product as three TF32 products (hi*hi + hi*lo + lo*hi of a
split x = hi + lo), which holds the fp32 tolerance where a single TF32
product would not.  No route reaches a scalar kernel: the scalar forward,
dK/dV and dQ (``csrc/flash_fwd.cu``, ``csrc/flash_bwd_dkdv.cu``,
``csrc/flash_bwd_dq.cu``) are :data:`OFF_ROUTE`: built, counted and held
against their plain versions, they are launched only when named through
the launch helpers' ``kernel=``, as the yardstick the tensor-core kernels
are timed against.

Dispatch is by the device of the tensors: CUDA tensors launch the kernels
(or raise), CPU tensors take the plain versions below — a port of the
forward recurrence and of the reference's ``_flash_bwd_blockwise``.  There
is no fallback from one to the other, nor from one kernel to another.
Each kernel wrapper counts its launches in :data:`LAUNCHES`.

Tiles.  The plain versions tile like the reference: ``_pick_block`` picks
the largest power of two <= ``block_q`` / ``block_k`` that divides S.  The
CUDA kernels use their own fixed tiles (:data:`KERNEL_TILES`) and mask
ragged tails themselves, so ``block_q`` / ``block_k`` are only hints to
the plain versions; the result does not depend on the tiling beyond float
summation order.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import kernels

__all__ = [
    "flash_attention",
    "flash_fwd",
    "flash_bwd",
    "kernel_for",
    "launch_fwd",
    "launch_dkdv",
    "launch_dq",
    "launch_dkdv_for_dq",
    "pair_scratch",
    "flash_fwd_plain",
    "flash_bwd_plain",
    "LAUNCHES",
    "reset_launch_counts",
    "NEG_INF",
]

NEG_INF = float(torch.finfo(torch.float32).min) / 2
# head_dim values the CUDA kernels are instantiated for
KERNEL_HEAD_DIMS = (16, 32, 64)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# kernel name -> (query rows, key rows) of the tile it skips or visits as a
# whole: the CTA's block and the streamed tile (csrc/flash_common.cuh and
# the tensor-core sources)
KERNEL_TILES = {
    "flash_fwd": (64, 32),
    "flash_bwd_dkdv": (32, 64),
    "flash_bwd_dq": (64, 32),
    "flash_fwd_tc": (64, 64),
    "flash_bwd_dkdv_tc": (64, 64),
    "flash_bwd_dq_tc": (64, 64),
    "flash_fwd_f32tc": (64, 32),
    "flash_bwd_dkdv_f32tc": (32, 128),
    "flash_bwd_dq_f32tc": (128, 32),
}
# kernels no route reaches: the scalar twins of the tensor-core kernels,
# launched only through the helpers' ``kernel=``
OFF_ROUTE = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
# kernels fed by TMA and bulk copies, which need 16-byte aligned tensors
_TC_KERNELS = ("flash_fwd_tc", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc",
               "flash_fwd_f32tc", "flash_bwd_dkdv_f32tc",
               "flash_bwd_dq_f32tc")
# a dQ kernel that reads the (lse, delta) scratch (pair_scratch) -> the
# dK/dV kernel whose pre-pass fills it (launch_dkdv_for_dq)
_PAIRS_FILLED_BY = {"flash_bwd_dq_tc": "flash_bwd_dkdv_tc"}
_PAIR_KERNELS = (*_PAIRS_FILLED_BY.values(), *_PAIRS_FILLED_BY)
# rows of that scratch are padded to this
_TC_PAIR_ROWS = 64

# kernel name -> launches since the last reset; each wrapper adds one where
# it launches its kernel, and nowhere else
LAUNCHES = {name: 0 for name in kernels.SOURCES}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check_type(dtype: torch.dtype, head_dim: int) -> None:
    if dtype not in _DTYPE_CODE:
        raise ValueError(
            f"the flash kernels take float32 or bfloat16, got {dtype}"
        )
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(
            f"the flash kernels take head_dim in {KERNEL_HEAD_DIMS}, got "
            f"{head_dim}"
        )


def kernel_for(pass_: str, dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that runs pass ``"fwd"``, ``"dkdv"`` or ``"dq"`` on
    inputs of ``dtype`` and ``head_dim``: the bf16 tensor-core kernels for
    bf16, the 3xTF32 tensor-core kernels for fp32, at every head_dim.
    Raises ``ValueError`` for what no kernel takes."""
    _check_type(dtype, head_dim)
    bf16 = dtype == torch.bfloat16
    if pass_ == "fwd":
        return "flash_fwd_tc" if bf16 else "flash_fwd_f32tc"
    if pass_ == "dkdv":
        return "flash_bwd_dkdv_tc" if bf16 else "flash_bwd_dkdv_f32tc"
    if pass_ == "dq":
        return "flash_bwd_dq_tc" if bf16 else "flash_bwd_dq_f32tc"
    raise ValueError(f"unknown flash pass {pass_!r}")


def _pick_block(seq: int, want: int) -> int:
    """Largest power-of-two block <= want that divides seq."""
    b = min(want, seq)
    while seq % b:
        b //= 2
    return max(b, 1)


def tile_needed(i: int, j: int, bq: int, bk: int, causal: bool,
                window: Optional[int]) -> bool:
    """Whether (q tile i of bq rows, k tile j of bk rows) holds any
    unmasked score: the reference predicate (flash_attention.py:171-175,
    :304-308, :333-337).  The CUDA kernels carry their own copy of it
    (``tile_needed`` in ``csrc/flash_common.cuh``); the GPU tests see the
    kernels skip the tiles it rules out by their times."""
    need = (j * bk <= (i + 1) * bq - 1) if causal else True
    if window is not None:
        need = need and (j + 1) * bk - 1 >= i * bq - (window - 1)
    return need


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    block_q: int = 512,
    block_k: int = 256,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention over ``[batch, seq, heads, head_dim]`` inputs.

    Differentiable.  ``window=W`` (requires ``causal=True``) restricts each
    position to its last ``W`` keys (self included); tiles entirely
    outside the band are skipped in forward and backward; ``W >= S`` is
    plain causal.  k/v may have fewer heads than q (GQA/MQA).
    """
    b, s, h, d = q.shape
    if k.shape != v.shape:
        raise ValueError(
            f"flash_attention requires matching k/v shapes, got "
            f"{tuple(k.shape)}/{tuple(v.shape)}"
        )
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or h % hkv:
        raise ValueError(
            f"flash_attention q {tuple(q.shape)} incompatible with k/v "
            f"{tuple(k.shape)}: batch/seq/head_dim must match and num_heads "
            "must be a multiple of num_kv_heads (MQA/GQA)"
        )
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window >= s:
            window = None  # full causal
    scale_ = scale if scale is not None else d ** -0.5
    bq = _pick_block(s, block_q)
    bk = _pick_block(s, block_k)
    # [B,S,H,D] -> [B*H, S, D]; GQA k/v fold to [B*HKV, S, D].  At B = 1
    # the reshape of the transpose is a strided view (a slice of the fused
    # qkv), which the kernels refuse: made contiguous (a no-op otherwise)
    fold = lambda x: x.transpose(1, 2).reshape(
        b * x.shape[2], s, d).contiguous()
    out = _FlashAttention.apply(fold(q), fold(k), fold(v), causal, scale_,
                                bq, bk, h, hkv, window)
    return out.reshape(b, h, s, d).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):
    """Saves ``(q, k, v, o, lse)`` like the reference's custom_vjp
    ``_flash`` (flash_attention.py:109-131)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, bq, bk, h, hkv, window):
        o, lse = flash_fwd(q, k, v, causal, scale, bq, bk, h, hkv, window)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.cfg = (causal, scale, bq, bk, h, hkv, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, o, lse, do.contiguous(), *ctx.cfg)
        return (dq, dk, dv) + (None,) * 7


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def flash_fwd(q, k, v, causal, scale, bq, bk, h, hkv, window):
    """Folded forward -> ``(o [Z,S,D], lse [Z,S] fp32)``."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, scale, bq, bk, h, hkv, window)
    _check_kernel_inputs(h, hkv, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    launch_fwd(q, k, v, o, lse, causal, scale, h, hkv, window)
    return o, lse


def flash_bwd(q, k, v, o, lse, do, causal, scale, bq, bk, h, hkv, window):
    """Folded backward -> ``(dq, dk, dv)`` in the input dtypes."""
    del bq  # the plain backward tiles K only, as the reference blockwise
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, o, lse, do, causal, scale, bk, h,
                               hkv, window)
    _check_kernel_inputs(h, hkv, q, k, v, o, do)
    if (lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.shape != q.shape[:2] or lse.device != q.device):
        raise ValueError("flash backward needs a contiguous fp32 lse [Z, S] "
                         "on the device of q")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    cfg = (causal, scale, h, hkv, window)
    dq_kernel = kernel_for("dq", q.dtype, q.shape[-1])
    pairs = launch_dkdv_for_dq(dq_kernel, q, k, v, o, lse, do, dk, dv, *cfg)
    launch_dq(q, k, v, o, lse, do, dq, *cfg, kernel=dq_kernel, pairs=pairs)
    return dq, dk, dv


def launch_dkdv_for_dq(dq_kernel, q, k, v, o, lse, do, dk, dv, causal,
                       scale, h, hkv, window):
    """Launch the dK/dV pass into ``dk`` / ``dv`` ahead of a ``dq_kernel``
    launch on the same inputs, and return the ``pairs`` to hand that
    launch.  For a dQ kernel that reads the (lse, delta) scratch this is
    the kernel whose pre-pass fills it, so the dK/dV launch must come
    first; for one that reads ``o`` and ``lse`` it is the routed dK/dV
    kernel.  The one place that knows the dK/dV -> dQ order."""
    name = (_PAIRS_FILLED_BY.get(dq_kernel)
            or kernel_for("dkdv", q.dtype, q.shape[-1]))
    pairs = pair_scratch(q) if name in _PAIR_KERNELS else None
    launch_dkdv(q, k, v, o, lse, do, dk, dv, causal, scale, h, hkv, window,
                kernel=name, pairs=pairs)
    return pairs


def pair_scratch(q: torch.Tensor) -> torch.Tensor:
    """The (lse, delta) scratch of the tensor-core backward for folded
    ``q`` [Z, S, D]: [Z, S_pad, 2] fp32 with S_pad = S rounded up to 64.
    ``flash_bwd_dkdv_tc`` fills every row of it (pad rows with zeros);
    ``flash_bwd_dq_tc`` reads it."""
    return torch.empty(_pair_shape(q), dtype=torch.float32, device=q.device)


def _pair_shape(q: torch.Tensor) -> tuple:
    z, s = q.shape[:2]
    return (z, -(-s // _TC_PAIR_ROWS) * _TC_PAIR_ROWS, 2)


def _checked_pairs(name, q, pairs) -> torch.Tensor:
    if pairs is None:
        raise ValueError(f"{name} needs the (lse, delta) scratch: pass "
                         "pairs=pair_scratch(q)")
    want = _pair_shape(q)
    if (pairs.dtype != torch.float32 or tuple(pairs.shape) != want
            or not pairs.is_contiguous() or pairs.device != q.device):
        raise ValueError(f"{name} needs a contiguous fp32 (lse, delta) "
                         f"scratch of shape {want} on the device of q")
    return pairs


# The launch helpers take ``kernel=`` only so that chip_smoke.py can hold
# and time the scalar kernels (OFF_ROUTE) at the tensor-core kernels'
# shapes; the port's own calls leave it to kernel_for.


def launch_fwd(q, k, v, o, lse, causal, scale, h, hkv, window, kernel=None):
    """Launch the forward into ``o`` / ``lse``, on inputs :func:`flash_fwd`
    has checked."""
    name = kernel or kernel_for("fwd", q.dtype, q.shape[-1])
    _launch(name, q, (q, k, v, o, lse), causal, scale, h, hkv, window)


def launch_dkdv(q, k, v, o, lse, do, dk, dv, causal, scale, h, hkv, window,
                kernel=None, pairs=None):
    """Launch the dK/dV pass into ``dk`` / ``dv``, on inputs
    :func:`flash_bwd` has checked.  ``flash_bwd_dkdv_tc`` also writes
    (lse, delta) per query row into ``pairs`` (:func:`pair_scratch`)."""
    name = kernel or kernel_for("dkdv", q.dtype, q.shape[-1])
    tensors = (q, k, v, o, lse, do, dk, dv)
    if name in _PAIR_KERNELS:
        tensors += (_checked_pairs(name, q, pairs),)
    _launch(name, q, tensors, causal, scale, h, hkv, window)


def launch_dq(q, k, v, o, lse, do, dq, causal, scale, h, hkv, window,
              kernel=None, pairs=None):
    """Launch the dQ pass into ``dq``, on inputs :func:`flash_bwd` has
    checked.  ``flash_bwd_dq_tc`` reads (lse, delta) from ``pairs``, which
    :func:`launch_dkdv_for_dq` must have filled on the same inputs, and
    reads neither ``o`` nor ``lse``."""
    name = kernel or kernel_for("dq", q.dtype, q.shape[-1])
    if name in _PAIR_KERNELS:
        tensors = (q, k, v, _checked_pairs(name, q, pairs), do, dq)
    else:
        tensors = (q, k, v, o, lse, do, dq)
    _launch(name, q, tensors, causal, scale, h, hkv, window)


def _launch(name, q, tensors, causal, scale, h, hkv, window) -> None:
    z, s, d = q.shape
    if name in _TC_KERNELS and any(t.data_ptr() % 16 for t in tensors):
        # TMA reads and bulk copies start on 16-byte boundaries
        raise ValueError(f"{name} needs 16-byte aligned tensors")
    with torch.cuda.device(q.device):
        rc = kernels.library(name)(
            *(t.data_ptr() for t in tensors), z, s, d, h, hkv, int(causal),
            window or 0, float(scale), _DTYPE_CODE[q.dtype], _stream(q),
        )
    _check_launch(name, rc)
    LAUNCHES[name] += 1


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_kernel_inputs(h, hkv, q, k, v, *like_q) -> None:
    """Everything the kernels assume of the pointers they are handed."""
    if q.device.type != "cuda":
        raise ValueError(
            f"flash attention runs its CUDA kernels on CUDA tensors and its "
            f"plain version on CPU tensors; got a {q.device.type} tensor"
        )
    _check_type(q.dtype, q.shape[-1])
    z, s, d = q.shape
    if h < 1 or hkv < 1 or h % hkv or z % h:
        raise ValueError(
            f"folded q of {z} rows does not split into heads={h} / "
            f"kv_heads={hkv}")
    kv_shape = (z // h * hkv, s, d)
    for t in (q, k, v) + like_q:
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError("flash attention inputs must share device/dtype")
        if not t.is_contiguous():
            raise ValueError("flash attention kernels need contiguous inputs")
        want = kv_shape if t is k or t is v else tuple(q.shape)
        if tuple(t.shape) != want:
            raise ValueError(
                f"flash attention kernel input of shape {tuple(t.shape)}, "
                f"expected {want}")


def _check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the kernels' yardstick on the card)
# ---------------------------------------------------------------------------


def kv_index(z: int, h: int, hkv: int, device) -> torch.Tensor:
    """kv row of every folded q row (the reference's ``_kv_row``)."""
    zi = torch.arange(z, device=device)
    return (zi // h) * hkv + (zi % h) // (h // hkv)


def flash_fwd_plain(q, k, v, causal, scale, bq, bk, h, hkv, window):
    """The reference forward recurrence (online softmax over K tiles,
    skipping the tiles :func:`tile_needed` rules out) in PyTorch ops.
    ``bq`` / ``bk`` must divide S."""
    z, s, d = q.shape
    f32 = torch.float32
    kv = kv_index(z, h, hkv, q.device)
    qf = q.to(f32) * scale
    kf, vf = k.to(f32)[kv], v.to(f32)[kv]
    o = torch.empty_like(q)
    lse = torch.empty((z, s), dtype=f32, device=q.device)
    for i in range(s // bq):
        rows = slice(i * bq, (i + 1) * bq)
        q_pos = torch.arange(i * bq, (i + 1) * bq, device=q.device)[:, None]
        acc = torch.zeros((z, bq, d), dtype=f32, device=q.device)
        m = torch.full((z, bq), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((z, bq), dtype=f32, device=q.device)
        for j in range(s // bk):
            if not tile_needed(i, j, bq, bk, causal, window):
                continue
            cols = slice(j * bk, (j + 1) * bk)
            st = qf[:, rows] @ kf[:, cols].transpose(1, 2)
            if causal:
                k_pos = torch.arange(j * bk, (j + 1) * bk,
                                     device=q.device)[None, :]
                st = st.masked_fill(k_pos > q_pos, NEG_INF)
                if window is not None:
                    st = st.masked_fill(k_pos < q_pos - (window - 1),
                                        NEG_INF)
            m_new = torch.maximum(m, st.amax(-1))
            p = torch.exp(st - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vf[:, cols]
            m = m_new
        o[:, rows] = (acc / l[..., None]).to(q.dtype)
        lse[:, rows] = m + torch.log(l)
    return o, lse


def flash_bwd_plain(q, k, v, o, lse, do, causal, scale, bk, h, hkv,
                    window=None):
    """The reference's blockwise backward (``_flash_bwd_blockwise``,
    flash_attention.py:408-450): a loop over K tiles of ``bk`` rows (which
    must divide S), fp32 throughout.  GQA: k/v are routed to full heads
    and dk/dv summed back over each group in fp32 before the cast."""
    z, s, d = q.shape
    f32 = torch.float32
    kv = kv_index(z, h, hkv, q.device)
    qf, kf, vf = q.to(f32), k.to(f32)[kv], v.to(f32)[kv]
    dof, of = do.to(f32), o.to(f32)
    delta = (dof * of).sum(-1)  # [Z,S]
    q_pos = torch.arange(s, device=q.device)[:, None]
    dq = torch.zeros_like(qf)
    dk = torch.empty_like(kf)
    dv = torch.empty_like(vf)
    for j in range(s // bk):
        cols = slice(j * bk, (j + 1) * bk)
        kb, vb = kf[:, cols], vf[:, cols]
        st = (qf @ kb.transpose(1, 2)) * scale
        p = torch.exp(st - lse[..., None])  # exact softmax: exp(s-m)/l
        if causal:
            k_pos = torch.arange(j * bk, (j + 1) * bk, device=q.device)[None]
            p = p.masked_fill(k_pos > q_pos, 0.0)
            if window is not None:
                p = p.masked_fill(k_pos < q_pos - (window - 1), 0.0)
        dp = dof @ vb.transpose(1, 2)
        ds = p * (dp - delta[..., None])
        dq = dq + (ds @ kb) * scale
        dk[:, cols] = (ds.transpose(1, 2) @ qf) * scale
        dv[:, cols] = p.transpose(1, 2) @ dof
    if hkv != h:
        group = h // hkv
        dk = dk.reshape(-1, hkv, group, s, d).sum(2).reshape(-1, s, d)
        dv = dv.reshape(-1, hkv, group, s, d).sum(2).reshape(-1, s, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
