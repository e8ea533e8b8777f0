"""Executable specification of the T-MAC LUT-mpGEMM algorithm, in PyTorch.

The port of ``tmac_tpu/ops/lut.py``, function for function: a direct,
readable form of the reference algorithm --

  1. bit-plane decomposition with signed states s' = 2s - 1 and the s0 = -1
     bias fold,
  2. group-of-g=4 lookup tables over activations,
  3. int8 LUT quantization with one scale + bias per act group,
  4. table lookup + accumulate + alpha recombination.

It is a test oracle only: no path of the port calls it.  The kernels
compute the same function by bit-field extraction and integer dots; the
tests hold this spec to a dequantized-matmul oracle at NMSE <= 5e-4 (the
reference's gate) and to the JAX package's spec on the same inputs.  The
rounding is JAX's: MAXV 127, scale = absmax / 127 (a true division), codes
rint(table * (1 / scale)), one scale and bias per act group.  Inputs are
torch tensors or numpy arrays; the float math runs in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tmac_tpu_torch.utils import get_bits_alphas

MAXV = 127  # int8 LUT range


def _t(a, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def sign_codes(g: int = 4) -> np.ndarray:
    """(2^g, g) matrix of signed states: row c, col j = 2*((c>>j)&1) - 1."""
    c = np.arange(1 << g)[:, None]
    j = np.arange(g)[None, :]
    return (2 * ((c >> j) & 1) - 1).astype(np.float32)


def build_lut(b, g: int = 4) -> torch.Tensor:
    """Full-precision LUTs of activations b (..., K) -> (..., K//g, 2^g),
    lut[..., k, c] = sum_j s_j(c) * b[..., k*g + j].  Mirror symmetry
    lut[..., c] == -lut[..., 2^g-1-c] holds by construction."""
    b = _t(b)
    K = b.shape[-1]
    assert K % g == 0
    m = torch.from_numpy(sign_codes(g).T.copy()).to(b.dtype)  # (g, 2^g)
    bg = b.reshape(*b.shape[:-1], K // g, g)
    # the g signed terms (exact) added pairwise, as XLA's CPU dot adds them
    terms = [bg[..., j:j + 1] * m[j] for j in range(g)]
    while len(terms) > 1:
        terms = [terms[i] + terms[i + 1] if i + 1 < len(terms) else terms[i]
                 for i in range(0, len(terms), 2)]
    return terms[0]


def quantize_lut(lut, act_group_size: int, g: int = 4):
    """LUTs (..., K//g, 2^g) -> (qlut int8, lut_scales (..., K//ags),
    lut_biases (..., K//ags)): scale = absmax over the act group's table
    entries / 127; bias = the act group's sum of entry 0 (all states -1,
    so -sum(b)), the constant term of the s0 = -1 fold."""
    lut = _t(lut)
    ng = lut.shape[-2]
    K = ng * g
    assert K % act_group_size == 0
    gpa = act_group_size // g
    shape = lut.shape[:-2]
    lg = lut.reshape(*shape, K // act_group_size, gpa, lut.shape[-1])
    absmax = lg.abs().amax(dim=(-1, -2))
    # a true division, by a tensor, as JAX's absmax / MAXV
    lut_scales = (absmax / torch.tensor(float(MAXV), dtype=absmax.dtype)).to(lut.dtype)
    inv = torch.where(lut_scales == 0, torch.zeros_like(lut_scales), 1.0 / lut_scales)
    qlut = torch.round(lg * inv[..., None, None]).to(torch.int8)
    qlut = qlut.reshape(*shape, ng, lut.shape[-1])
    lut_biases = lg[..., 0].sum(-1).to(lut.dtype)
    return qlut, lut_scales, lut_biases


def lut_ctor(b, act_group_size: int, g: int = 4):
    """The preprocessor: activations -> (qlut, lut_scales, lut_biases)."""
    return quantize_lut(build_lut(b, g), act_group_size, g)


def lut_gemm_spec(qlut, lut_scales, lut_biases, idx, scales, sub, bits: int,
                  group_size: int, act_group_size: int, g: int = 4,
                  out_dtype=torch.float32,
                  fast_aggregation: bool = False) -> torch.Tensor:
    """Reference LUT-GEMM: gather + accumulate + alpha recombination.

    qlut (N, K//g, 2^g) int8; lut_scales, lut_biases (N, K//ags); idx
    (bits, K//g, M) uint8 per-plane LUT indices (ops/packing.py
    group_indices); scales, sub (K//gs, M) with Wdq = scales*wq - sub.
    Returns C (N, M) = B @ Wdq rebuilt from the tables:
        C = sum_b alphas[b] * sum_k s[k,m] * qlut[n,kg,idx_b]*lut_scale
            + sum_k (s*S - sub)[k,m] * b[n,k],   S = 2^(bits-1) - 1/2,
    the second sum taken from the biases (sum of b over an act group =
    -lut_bias).  fast_aggregation=True models the reference's -fa mode: the
    int8 sum over each act group's tables becomes a rounding-halving-add
    tree, compensated by lut_scale *= ActK and the closed-form bias shift
    (needs act_group_size == group_size, a power-of-2 table count)."""
    qlut, lut_scales, lut_biases = _t(qlut), _t(lut_scales), _t(lut_biases)
    scales, sub = _t(scales).float(), _t(sub).float()
    N, ng = qlut.shape[0], qlut.shape[1]
    K = ng * g
    M = idx.shape[-1]
    alphas = get_bits_alphas(bits)
    idx = _t(idx).long()  # (bits, K//g, M)
    gpa = act_group_size // g
    nag = K // act_group_size
    gpw = group_size // g
    if fast_aggregation:
        assert act_group_size == group_size, "fa spec models aligned act/weight groups"
        assert gpa & (gpa - 1) == 0, "fa needs power-of-2 tables per group"
        fa_scales, fa_biases = fast_aggregation_correction(lut_scales, lut_biases,
                                                           gpa, bits)

    acc = torch.zeros((N, M), dtype=torch.float32)
    for b in range(bits):
        # vals[n, kg, m] = qlut[n, kg, idx[b, kg, m]]
        vals = torch.gather(qlut, -1, idx[b][None].expand(N, -1, -1)).float()
        if fast_aggregation:
            agg = halving_add_tree(vals.reshape(N, nag, gpa, M).to(torch.int32), axis=2)
            vs = agg.float() * fa_scales[..., None].float() * scales[None]
            acc = acc + alphas[b] * vs.sum(1)
            continue
        vs = vals.reshape(N, nag, gpa, M) * lut_scales[..., None, None].float()
        vs = vs.reshape(N, K // group_size, gpw, M) * scales[None, :, None, :]
        acc = acc + alphas[b] * vs.sum(dim=(1, 2))

    S = float((1 << (bits - 1)) - 0.5)
    const = S * scales - sub  # (K//gs, M)
    if group_size % act_group_size:
        raise NotImplementedError("act_group_size must divide group_size")
    const_ag = const.repeat_interleave(group_size // act_group_size, dim=0)
    acc = acc + torch.einsum("na,am->nm", -lut_biases.float(), const_ag)
    if fast_aggregation:
        # the closed-form -fa bias shift, weight-scaled like every lut_bias
        # application (ags == gs here); zero for ActK <= 8
        delta = (fa_biases - lut_biases).float()
        acc = acc + alphas[0] * torch.einsum("na,am->nm", delta, scales)
    return acc.to(out_dtype)


def halving_add_tree(vals, axis: int) -> torch.Tensor:
    """Signed rounding-halving-add reduction ((a + b + 1) >> 1, NEON
    vrhaddq_s8) of the 2^n elements along `axis` to ~sum/2^n with a small
    positive rounding bias: the reference's fast-aggregation adder."""
    vals = _t(vals)
    n = vals.shape[axis]
    assert n & (n - 1) == 0, f"fast aggregation needs a power-of-2 depth, got {n}"
    v = torch.movedim(vals, axis, -1).to(torch.int32)
    while v.shape[-1] > 1:
        v = (v[..., 0::2] + v[..., 1::2] + 1) >> 1
    return v[..., 0]


def fast_aggregation_correction(lut_scales, lut_biases, act_k: int, bits: int):
    """The reference's -fa correction: lut_scale *= ActK and lut_bias -=
    lut_scale * (log2(ActK) // 4 * bias_scale), bias_scale 15/7/3/1 for
    bits 4/3/2/1 (integer division, as the reference's C++).  Returns
    (scales', biases')."""
    bias_scale = {4: 15, 3: 7, 2: 3, 1: 1}[bits]
    s = _t(lut_scales) * act_k
    b = _t(lut_biases) - s * (int(math.log2(act_k)) // 4 * bias_scale)
    return s, b


def act_group_sums(b, group_size: int) -> torch.Tensor:
    """Per-group activation sums sum_{k in g} b[..., k] -> (..., K//gs)."""
    b = _t(b)
    K = b.shape[-1]
    assert K % group_size == 0
    return b.reshape(*b.shape[:-1], K // group_size, group_size).sum(-1)
