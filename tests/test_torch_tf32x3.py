"""The arithmetic of the fp32 tensor-core flash kernels, held on the CPU.

``csrc/flash_fwd_f32tc.cu``, ``csrc/flash_bwd_dkdv_f32tc.cu`` and
``csrc/flash_bwd_dq_f32tc.cu`` take every fp32 product on the tf32 tensor
cores as three products (hopper_tc.cuh, "3xTF32"): x = hi + lo, hi = x
with its low 13 mantissa bits cleared, lo = x - hi rounded to tf32
(cvt.rna: to nearest, ties away from zero), and
a b = lo_a hi_b + hi_a lo_b + hi_a hi_b in fp32.  This file emulates that
split in torch and takes the forward's two products and the dQ pass's two
others on the main path's magnitudes (q, k, v, dO ~ randn from a numpy
seed, S = (Q * D^-0.5) K^T, P = exp(S - rowmax S), O = P V; then with the
normalised P = exp(S - lse), dP = dO V^T, delta = rowsum(dO * O),
dS = P (dP - delta) and dS K; 8 rows of 256 x 64) against fp64.

The gate is the one the kernels are held to on the card,
``chip_smoke.TOL["fp32"]``: |got - fp64| <= 1e-4 + 1e-4 |fp64|.
3xTF32 must fall well inside it, a single TF32 product outside it.
Measured on the CPU: 3xTF32 max error 1.9e-6 on S, 5.2e-6 on P V, 1.6e-5
on dP and 2.9e-6 on dS K, its worst element 0.009, 0.035, 0.057 and 0.012
of the gate; one TF32 product (operands rounded to nearest) 1.6e-3 on S,
4.7e-3 on P V, 1.3e-2 on dP and 2.3e-3 on dS K, its worst element 14.7x,
38.5x, 101.0x and 13.5x the gate: the single-TF32 miss holds for every
product.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the repo root's on-card smoke run)

ATOL, RTOL = chip_smoke.TOL["fp32"]
Z, S, D = 8, 256, 64
# how far inside the gate 3xTF32 must stay: its worst element at most this
# share of atol + rtol |want|
MARGIN = 0.1


def tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """x with its low 13 mantissa bits cleared (the kernels' tf32_hi)."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to tf32, to nearest with ties away from zero
    (cvt.rna.tf32.f32): half a tf32 ulp added to the magnitude, then the
    low 13 bits cleared."""
    return ((x.view(torch.int32) + 4096) & -8192).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_hi(x)
    return hi, tf32_round(x - hi)


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels take it: three tf32 products into fp32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def matmul_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One tf32 product (operands rounded to nearest) into fp32."""
    return tf32_round(a) @ tf32_round(b)


def _inputs():
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(Z, S, D).astype(np.float32))
                   for _ in range(4))
    return q * D ** -0.5, k, v, do


def _share(got: torch.Tensor, want: torch.Tensor) -> float:
    """The worst element's error as a share of the gate (> 1: outside)."""
    err = (got.double() - want).abs()
    return float((err / (ATOL + RTOL * want.abs())).max())


def _products(matmul):
    """(S, P V, dP, dS K) by ``matmul`` and in fp64, from the same fp32
    inputs; P, O and dS are computed once in fp64 and rounded to fp32, as
    the kernels hold them."""
    q, k, v, do = _inputs()
    s64 = q.double() @ k.double().transpose(1, 2)
    p = torch.exp(s64 - s64.amax(-1, keepdim=True)).float()
    pv64 = p.double() @ v.double()
    # the backward's recompute: the normalised P, delta from O = P V
    pn = torch.exp(s64 - torch.logsumexp(s64, -1, keepdim=True))
    o = (pn @ v.double()).float()
    dp64 = do.double() @ v.double().transpose(1, 2)
    delta = (do.double() * o.double()).sum(-1, keepdim=True)
    ds = (pn * (dp64 - delta)).float()
    dsk64 = ds.double() @ k.double()
    return ((matmul(q, k.transpose(1, 2)), s64),
            (matmul(p, v), pv64),
            (matmul(do, v.transpose(1, 2)), dp64),
            (matmul(ds, k), dsk64))


PRODUCTS = ["S=QK^T", "PV", "dP=dOV^T", "dSK"]


@pytest.mark.parametrize("which", range(4), ids=PRODUCTS)
def test_3xtf32_is_well_inside_the_fp32_gate(which):
    got, want = _products(matmul_3xtf32)[which]
    assert _share(got, want) < MARGIN


@pytest.mark.parametrize("which", range(4), ids=PRODUCTS)
def test_one_tf32_product_misses_the_fp32_gate(which):
    got, want = _products(matmul_tf32)[which]
    assert _share(got, want) > 1.0


def test_the_split_is_exact():
    """hi is a tf32 value, x - hi is exact in fp32 and lo is within half a
    tf32 ulp of it, so hi + lo is x to about 2^-22 relative."""
    x = torch.from_numpy(np.random.RandomState(1).randn(4096)
                         .astype(np.float32)) * 3.0
    hi, lo = split(x)
    assert torch.equal(tf32_hi(hi), hi) and torch.equal(tf32_hi(lo), lo)
    rest = (x.double() - hi.double())
    assert torch.equal(rest, (x - hi).double())  # x - hi has no rounding
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max()
    assert float(rel) <= 2.0 ** -22
