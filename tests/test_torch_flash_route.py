"""Which flash kernel runs what, and the tile predicate at the
tensor-core kernels' tiles (horovod_tpu_torch.ops.flash_attention).

The route is a plain table (``kernel_for``): bf16 at every head_dim runs
the bf16 tensor-core forward, dK/dV and dQ; fp32 at every head_dim the
3xTF32 tensor-core forward, dK/dV and dQ.  The scalar forward, dK/dV and
dQ are on no route (``fa.OFF_ROUTE``).  The CUDA kernels cannot run here;
what they are held to on the card is the plain version, and the last test
holds that plain version against the JAX package's Pallas kernels on the
inputs the tensor-core routes take (bf16 and fp32 at head_dim 16, 32 and
64, GQA, a window and an S that is not a multiple of the kernels' 64-row
tiles).  Tolerances there: bf16 0.05 and fp32 1e-5, as
tests/test_torch_flash_attention.py holds them.
"""

from __future__ import annotations

import ctypes
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horovod_tpu.ops.flash_attention import flash_attention as jax_flash
from horovod_tpu_torch.ops import flash_attention as fa
from horovod_tpu_torch.ops import kernels

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repo root's on-card smoke run)

BF16_TOL = 0.05
FP32_TOL = 1e-5
TC = ("flash_fwd_tc", "flash_bwd_dkdv_tc", "flash_bwd_dq_tc",
      "flash_fwd_f32tc", "flash_bwd_dkdv_f32tc", "flash_bwd_dq_f32tc")


@pytest.mark.parametrize("pass_,dtype,d,want", [
    ("fwd", torch.bfloat16, 64, "flash_fwd_tc"),
    ("dkdv", torch.bfloat16, 64, "flash_bwd_dkdv_tc"),
    ("dq", torch.bfloat16, 64, "flash_bwd_dq_tc"),
    ("fwd", torch.float32, 64, "flash_fwd_f32tc"),
    ("dkdv", torch.float32, 64, "flash_bwd_dkdv_f32tc"),
    ("dq", torch.float32, 64, "flash_bwd_dq_f32tc"),
    ("fwd", torch.float32, 32, "flash_fwd_f32tc"),
    ("dkdv", torch.float32, 32, "flash_bwd_dkdv_f32tc"),
    ("dq", torch.float32, 32, "flash_bwd_dq_f32tc"),
    ("fwd", torch.float32, 16, "flash_fwd_f32tc"),
    ("dkdv", torch.float32, 16, "flash_bwd_dkdv_f32tc"),
    ("fwd", torch.bfloat16, 32, "flash_fwd_tc"),
    ("dkdv", torch.bfloat16, 32, "flash_bwd_dkdv_tc"),
    ("fwd", torch.bfloat16, 16, "flash_fwd_tc"),
    ("dkdv", torch.bfloat16, 16, "flash_bwd_dkdv_tc"),
    ("dq", torch.float32, 16, "flash_bwd_dq_f32tc"),
    ("dq", torch.bfloat16, 32, "flash_bwd_dq_tc"),
    ("dq", torch.bfloat16, 16, "flash_bwd_dq_tc"),
])
def test_route_table(pass_, dtype, d, want):
    assert fa.kernel_for(pass_, dtype, d) == want


def test_every_kernel_is_built_counted_and_tiled():
    """Nine kernels, each with a source, a C signature, a launch counter
    and its tiles; the route reaches every one of them but the scalar
    twins of ``fa.OFF_ROUTE``, which it reaches nowhere."""
    assert len(kernels.SOURCES) == 9
    assert set(kernels.SOURCES) == set(kernels._SIGNATURES)
    assert set(fa.LAUNCHES) == set(kernels.SOURCES) == set(fa.KERNEL_TILES)
    reached = {fa.kernel_for(p, dt, d)
               for p in ("fwd", "dkdv", "dq")
               for dt in (torch.float32, torch.bfloat16)
               for d in fa.KERNEL_HEAD_DIMS}
    assert reached == set(kernels.SOURCES) - set(fa.OFF_ROUTE)
    assert set(fa.OFF_ROUTE) == {"flash_fwd", "flash_bwd_dkdv",
                                 "flash_bwd_dq"}
    assert set(fa._TC_KERNELS) == set(kernels.SOURCES) - set(fa.OFF_ROUTE)
    assert set(chip_smoke.OFF_ROUTE_SHAPE) == set(fa.OFF_ROUTE)
    # the dK/dV tensor-core entry point takes the (lse, delta) scratch
    assert len(kernels._SIGNATURES["flash_bwd_dkdv_tc"][1]) == \
        len(kernels._SIGNATURES["flash_bwd_dkdv"][1]) + 1
    # the dQ one takes the filled scratch in place of o and lse: q, k, v,
    # pairs, dO, dq, then the scalar dQ's ints, scale, dtype and stream
    sym, args = kernels._SIGNATURES["flash_bwd_dq_tc"]
    assert sym == "hvd_flash_bwd_dq_tc"
    assert args == [ctypes.c_void_p] * 6 + \
        kernels._SIGNATURES["flash_bwd_dq"][1][7:]
    # the fp32 tensor-core kernels take the scalar kernels' arguments
    for name, twin in (("flash_fwd_f32tc", "flash_fwd"),
                       ("flash_bwd_dkdv_f32tc", "flash_bwd_dkdv"),
                       ("flash_bwd_dq_f32tc", "flash_bwd_dq")):
        assert kernels._SIGNATURES[name][1] == kernels._SIGNATURES[twin][1]


# tensors each kernel reads or writes once: its launch helper's pointers
_MOVED = {
    "flash_fwd_tc": ("q", "k", "v", "o", "lse"),
    "flash_fwd": ("q", "k", "v", "o", "lse"),
    "flash_bwd_dkdv_tc": ("q", "k", "v", "o", "lse", "do", "dk", "dv",
                          "pairs"),
    "flash_bwd_dkdv": ("q", "k", "v", "o", "lse", "do", "dk", "dv"),
    "flash_bwd_dq_tc": ("q", "k", "v", "pairs", "do", "dq"),
    "flash_bwd_dq": ("q", "k", "v", "o", "lse", "do", "dq"),
    "flash_fwd_f32tc": ("q", "k", "v", "o", "lse"),
    "flash_bwd_dkdv_f32tc": ("q", "k", "v", "o", "lse", "do", "dk", "dv"),
    "flash_bwd_dq_f32tc": ("q", "k", "v", "o", "lse", "do", "dq"),
}


@pytest.mark.parametrize("name", sorted(_MOVED))
def test_bound_counts_the_bytes_each_kernel_moves(name):
    """chip_smoke's bound is per kernel: the tensor-core dQ is charged for
    the (lse, delta) pairs it reads, not for o and lse, which dK/dV's
    pre-pass reads for it."""
    b, s, h, hkv, d = 1, 300, 4, 2, 64
    q = torch.zeros(b * h, s, d, dtype=torch.bfloat16)
    kv = torch.zeros(b * hkv, s, d, dtype=torch.bfloat16)
    nbytes = lambda t: t.numel() * t.element_size()
    size = {"q": nbytes(q), "o": nbytes(q), "do": nbytes(q),
            "dq": nbytes(q), "k": nbytes(kv), "v": nbytes(kv),
            "dk": nbytes(kv), "dv": nbytes(kv), "lse": b * h * s * 4,
            "pairs": nbytes(fa.pair_scratch(q))}
    work = chip_smoke.attention_work(b, s, h, hkv, d, True, 100, 2)
    assert set(work) == set(_MOVED) == set(kernels.SOURCES)
    assert work[name][1] == sum(size[t] for t in _MOVED[name])


@pytest.mark.parametrize("d", [16, 32, 64])
def test_dkdv_bound_counts_the_pairs_only_where_dq_reads_them(d):
    """The bf16 tensor-core dK/dV's pre-pass writes the (lse, delta) pairs
    and the bf16 tensor-core dQ reads them, at every head_dim: they are
    part of the bf16 dK/dV's bytes.  The fp32 dQ recomputes delta and
    reads no pairs, and the fp32 dK/dV writes none; a dK/dV's bound counts
    the pairs only where its dQ reads them."""
    b, s, h, hkv = 1, 300, 4, 2
    assert fa.kernel_for("dq", torch.bfloat16, d) in fa._PAIRS_FILLED_BY
    assert fa.kernel_for("dq", torch.float32, d) not in fa._PAIRS_FILLED_BY
    assert fa.kernel_for("dkdv", torch.float32, d) not in fa._PAIR_KERNELS
    q = torch.zeros(b * h, s, d, dtype=torch.bfloat16)
    pair_bytes = fa.pair_scratch(q).numel() * 4
    with_pairs = chip_smoke.attention_work(b, s, h, hkv, d, True, 100, 2)
    without = chip_smoke.attention_work(b, s, h, hkv, d, True, 100, 2,
                                        pairs_read=False)
    assert with_pairs["flash_bwd_dkdv_tc"] == (
        without["flash_bwd_dkdv_tc"][0],
        without["flash_bwd_dkdv_tc"][1] + pair_bytes)
    assert without["flash_bwd_dkdv_tc"] == without["flash_bwd_dkdv"]
    assert {n: w for n, w in with_pairs.items() if n != "flash_bwd_dkdv_tc"} \
        == {n: w for n, w in without.items() if n != "flash_bwd_dkdv_tc"}
    # the fp32 route's dK/dV and dQ move the scalar pair's bytes
    fp32 = chip_smoke.attention_work(b, s, h, hkv, d, True, 100, 4,
                                     pairs_read=False)
    assert fp32["flash_bwd_dkdv_f32tc"] == fp32["flash_bwd_dkdv"]
    assert fp32["flash_bwd_dq_f32tc"] == fp32["flash_bwd_dq"]


@pytest.mark.parametrize("name", sorted(_MOVED))
def test_bound_takes_each_kernels_peak(name):
    """chip_smoke's bound takes the peak of the work a kernel does on its
    route: 989 TFLOP/s for bf16, 495 / 3 TFLOP/s (3xTF32) for fp32, the
    scalar dQ's fp32 route included; bytes at 3.35 TB/s.  Each shape a
    kernel's records are taken at is one ``kernel_for`` sends to it; an
    off-route twin's one shape is one ``kernel_for`` sends elsewhere."""
    shapes = {s["name"]: s for s in chip_smoke.SHAPES}
    on_route = chip_smoke.RECORD_SHAPE.get(name, ())
    off_route = chip_smoke.OFF_ROUTE_SHAPE.get(name)
    assert bool(on_route) != bool(off_route)
    for where in on_route or (off_route,):
        shape = shapes[where]
        dtype = shape["dtype"]
        assert shape["timed"]
        torch_dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dtype]
        routed = fa.kernel_for(chip_smoke.PASS[name], torch_dtype,
                               shape["d"])
        assert (routed == name) == bool(on_route)
        assert off_route is None or name in shape["forced"]
        want = {"bf16": 989e12, "fp32": 495e12 / 3}[dtype]
        assert chip_smoke.PEAK[dtype] == want
    # 4-byte items at the fp32 main shape: the operations bound
    work = chip_smoke.attention_work(8, 1024, 12, 12, 64, True, None, 4)
    flops, nbytes = work[name]
    ms, by = chip_smoke.bound(flops, nbytes, want)
    assert ms == pytest.approx(max(flops / want, nbytes / 3.35e12) * 1e3)
    if dtype == "fp32":
        assert by == "operations"


@pytest.mark.parametrize("s,s_pad", [(1, 64), (64, 64), (300, 320),
                                     (1024, 1024)])
def test_pair_scratch_pads_rows_to_the_tile(s, s_pad):
    """One [Z, S_pad, 2] fp32 buffer per backward: a 64-row slice of it is
    one 512-byte bulk copy for both tensor-core backward kernels."""
    pairs = fa.pair_scratch(torch.zeros(6, s, 64, dtype=torch.bfloat16))
    assert pairs.shape == (6, s_pad, 2) and pairs.dtype == torch.float32
    assert pairs.is_contiguous()


@pytest.mark.parametrize("launch,kernel", [
    ("launch_dkdv", "flash_bwd_dkdv_tc"),
    ("launch_dq", "flash_bwd_dq_tc"),
])
@pytest.mark.parametrize("bad", ["missing", "short", "dtype"])
def test_tc_backward_refuses_a_bad_pair_buffer(launch, kernel, bad):
    """The tensor-core backward kernels read or write (lse, delta) pairs
    sized from q; the launch helpers refuse a missing or mis-shaped
    buffer before any launch (so the check holds on CPU tensors too)."""
    z, s, d = 4, 100, 64
    q = torch.zeros(z, s, d, dtype=torch.bfloat16)
    lse = torch.zeros(z, s)
    pairs = {"missing": None,
             "short": torch.zeros(z, s, 2),
             "dtype": torch.zeros(z, 128, 2, dtype=torch.float64)}[bad]
    outs = (q, q) if launch == "launch_dkdv" else (q,)
    with pytest.raises(ValueError, match="lse, delta"):
        getattr(fa, launch)(q, q, q, q, lse, q, *outs, True, 0.125, 4, 4,
                            None, kernel=kernel, pairs=pairs)


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 64, "float32 or bfloat16"),
    (torch.float64, 64, "float32 or bfloat16"),
    (torch.bfloat16, 48, "head_dim"),
    (torch.float32, 128, "head_dim"),
])
def test_route_refuses_what_no_kernel_takes(dtype, d, match):
    """The wrappers' own errors on a CUDA tensor (held on the card by
    tests/test_torch_kernels_gpu.py) come from the same check."""
    for pass_ in ("fwd", "dkdv", "dq"):
        with pytest.raises(ValueError, match=match):
            fa.kernel_for(pass_, dtype, d)


def test_route_refuses_an_unknown_pass():
    with pytest.raises(ValueError, match="unknown flash pass"):
        fa.kernel_for("dv", torch.bfloat16, 64)


def _reference_predicates(i, j, bq, bk, causal, window):
    """flash_attention.py's forward (:171-175), dk/dv (:304-308) and dq
    (:333-337) predicates, transcribed."""
    fwd = (j * bk <= (i + 1) * bq - 1) if causal else True
    dkdv = ((i + 1) * bq - 1 >= j * bk) if causal else True
    dq = (j * bk <= (i + 1) * bq - 1) if causal else (j >= 0)
    if window is not None:
        band = (j + 1) * bk - 1 >= i * bq - (window - 1)
        fwd, dkdv, dq = fwd and band, dkdv and band, dq and band
    return fwd, dkdv, dq


def _holds_unmasked_pair(i, j, bq, bk, s, causal, window):
    q = np.arange(i * bq, min((i + 1) * bq, s))[:, None]
    k = np.arange(j * bk, min((j + 1) * bk, s))[None, :]
    alive = np.ones((q.size, k.size), bool)
    if causal:
        alive &= k <= q
    if window is not None:
        alive &= k >= q - (window - 1)
    return bool(alive.any())


@pytest.mark.parametrize("kernel", TC)
@pytest.mark.parametrize("causal,window", [
    (False, None), (True, None), (True, 1), (True, 37), (True, 64),
    (True, 100), (True, 200),
])
def test_tile_predicate_at_tensor_core_tiles(kernel, causal, window):
    """At the tensor-core kernels' tiles, over ragged and whole S,
    tile_needed is the reference's predicate, and it never skips a tile
    that holds an unmasked (query, key) pair of the sequence."""
    bq, bk = fa.KERNEL_TILES[kernel]
    for s in (64, 97, 300, 1024):
        nq, nk = -(-s // bq), -(-s // bk)
        for i, j in itertools.product(range(nq), range(nk)):
            got = fa.tile_needed(i, j, bq, bk, causal, window)
            fwd, dkdv, dq = _reference_predicates(i, j, bq, bk, causal,
                                                  window)
            assert got == fwd == dkdv == dq, (s, i, j)
            if not got:
                assert not _holds_unmasked_pair(i, j, bq, bk, s, causal,
                                                window), (s, i, j)


@pytest.mark.parametrize("dtype,d", [
    pytest.param(torch.bfloat16, 16, id="16"),
    pytest.param(torch.bfloat16, 32, id="32"),
    pytest.param(torch.bfloat16, 64, id="64"),
    pytest.param(torch.float32, 16, id="fp32-16"),
    pytest.param(torch.float32, 32, id="fp32-32"),
    pytest.param(torch.float32, 64, id="fp32-64"),
])
def test_tc_route_inputs_match_jax(dtype, d):
    """The plain version the tensor-core kernels are held to on the card,
    at their routes' inputs (bf16 and fp32 at head_dim 16, 32 and 64, GQA,
    causal band, S not a multiple of 64), against the JAX package's Pallas
    kernels in interpret mode: output and all three gradients."""
    rng = np.random.RandomState(7)
    b, s, h, hkv, window = 1, 96, 4, 2, 40
    mk = lambda heads: (rng.randn(b, s, heads, d) * 0.5).astype(np.float32)
    q, k, v = mk(h), mk(hkv), mk(hkv)
    w = rng.randn(b, s, h, d).astype(np.float32)
    kw = dict(causal=True, window=window, block_q=32, block_k=32)
    bf16 = dtype == torch.bfloat16
    route = {p: fa.kernel_for(p, dtype, d) for p in ("fwd", "dkdv", "dq")}
    assert route == ({"fwd": "flash_fwd_tc", "dkdv": "flash_bwd_dkdv_tc",
                      "dq": "flash_bwd_dq_tc"} if bf16 else
                     {"fwd": "flash_fwd_f32tc",
                      "dkdv": "flash_bwd_dkdv_f32tc",
                      "dq": "flash_bwd_dq_f32tc"})
    tol = BF16_TOL if bf16 else FP32_TOL

    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, **kw)
    (out.float() * torch.from_numpy(w)).sum().backward()

    jdt = jnp.bfloat16 if bf16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    loss = lambda a, b_, c: (jax_flash(a, b_, c, interpret=True, **kw)
                             .astype(jnp.float32) * jnp.asarray(w)).sum()
    want_out = jax_flash(jq, jk, jv, interpret=True, **kw)
    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want_out, np.float32),
                               atol=tol, rtol=tol)
    for name, got, ref in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert got.grad.shape == ref.shape
        np.testing.assert_allclose(got.grad.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol, err_msg=name)
