"""Shared math helpers (the port's copy of ``tmac_tpu/utils.py``)."""

from __future__ import annotations

import numpy as np
import torch


def get_bits_alphas(bits: int):
    """Bit-plane recombination weights: with signed states s' = 2s - 1 and
    the s0 = -1 bias fold, an n-bit biased-unsigned w satisfies
    w - 2^(n-1) = 1/2 (b0' + s0) + b1' + 2 b2' + 4 b3', so the planes'
    weights are [1/2, 1, 2, 4][:bits]."""
    return [0.5, 1.0, 2.0, 4.0][:bits]


def nmse(a, b) -> float:
    """Normalized mean squared error of b against reference a."""
    a = np.asarray(a, dtype=np.float32)
    b = np.asarray(b, dtype=np.float32)
    denom = np.mean(np.square(a))
    if denom == 0:
        return float(np.mean(np.square(a - b)))
    return float(np.mean(np.square(a - b)) / denom)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


def argmax_agreement(ref, got, tie_margin: float) -> float:
    """Share of rows (..., V) whose argmax in `got` is the reference's,
    counting a disagreement as agreement when the reference's own top-1
    lead over the chosen token, or over its runner-up, is below
    `tie_margin` (a near-tie that rounding noise may flip; the rule of
    tmac_tpu/tools/parity.py)."""
    ref = np.asarray(ref, np.float32).reshape(-1, np.shape(ref)[-1])
    got = np.asarray(got, np.float32).reshape(ref.shape)
    ok = 0
    for r, g in zip(ref, got):
        top, chosen = int(np.argmax(r)), int(np.argmax(g))
        srt = np.sort(r)
        if (top == chosen or r[top] - r[chosen] < tie_margin
                or srt[-1] - srt[-2] < tie_margin):
            ok += 1
    return ok / len(ref)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c in float32 with one rounding, as CUDA's fmaf and the fused
    multiply-adds XLA's CPU backend emits compute it.  The product of two
    float32 values is exact in float64; their sum with c is rounded to odd
    in float64 (nearest, then moved to the odd neighbour when inexact), so
    that the one rounding to float32 that follows is the correct one."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)          # p + c == s + err exactly
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.full_like(s, float("inf")),
                         torch.full_like(s, float("-inf")))
    return torch.where(fix, torch.nextafter(s, toward), s).float()
