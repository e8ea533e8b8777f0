"""Kernel K5's plain version and the grouped large-N route against the JAX
package's grouped Pallas qgemm (qgemm_pallas act="fused", interpret mode
on the CPU, compiled as the model runs it).

From 3 * group_size rows of x (384 at g128) qgemm_pallas takes its
dequant_dot kernel: bf16 activations (after the SwiGLU or rms_norm
prologue) times bf16 dequantized weights, one f32 dot.  Its bf16 operands
are exact functions of the inputs, so the port holds them byte for byte;
the f32 sum is XLA's dot on the CPU there and an f32 matmul here, whose
orders differ, so the outputs are held to a bound on f32 rounding: at most
2^-20 (16 units in the last place) of sum_k |xa[n, k] * W[k, m]| for each
output (measured on the CPU: at most 1.5e-7 of it).  With an rms_norm
fold, XLA's CPU rsqrt (a hardware estimate refined by Newton steps, not
IEEE 1 / sqrt) moves a bf16 rounding of the activations in some rows;
given XLA's rsqrt values the bound holds there too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops.pallas.qgemm_kernel import qgemm_pallas
from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as k45
from tmac_tpu_torch.ops.qgemm import (QuantizedTensor, kernel_for, qgemm,
                                      route, unpack_codes)
from tmac_tpu_torch.utils import nmse
from test_torch_qgemm_grouped import GS, _pair

torch.set_num_threads(2)

ROUNDING = 2.0 ** -20   # of sum_k |xa * W|, per output
NORM_NMSE = 1e-8        # with a norm fold, against XLA's rsqrt (measured 3.7e-10)


def _pallas(xb, jqt, dispatch, norm=None, glu=False, residual=None):
    eps = None if norm is None else norm[1]

    def f(x, q, w, r):
        return qgemm_pallas(x, q, out_dtype=jnp.float32, interpret=True,
                            act="fused", glu=glu, residual=r, dispatch=dispatch,
                            norm=None if w is None else (w, eps))
    return np.asarray(jax.jit(f)(xb, jqt, None if norm is None else norm[0],
                                 residual))


def _inputs(rng, qt, N, K, norm, glu, residual):
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if norm:
        w = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        kw_j["norm"] = (jnp.asarray(w, jnp.bfloat16), 1e-5)
        kw_t["norm"] = (torch.from_numpy(w).to(torch.bfloat16), 1e-5)
    if glu:
        kw_j["glu"] = kw_t["glu"] = True
    if residual:
        r = rng.standard_normal((N, qt.mdim)).astype(np.float32)
        kw_j["residual"] = jnp.asarray(r, jnp.bfloat16)
        kw_t["residual"] = torch.from_numpy(r).to(torch.bfloat16)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16), kw_j, kw_t


def _within_rounding(qt, xt, kw_t, want, got):
    """|got - want| <= ROUNDING * (|xa| @ |W|), elementwise."""
    xa = k45.act_bf16_plain(xt, qt, kw_t.get("norm"), kw_t.get("glu", False))
    mag = qt.slice_m(xa.float().abs() @ k45.dequant_weights_plain(qt).float().abs())
    assert (np.abs(got - want) <= ROUNDING * mag.numpy()).all()


# (bits, N, K, Ms, norm, glu, residual): every fold, padded K (W2 down:
# 1280 -> 1536), fused and padded M, N at and past 3 * GS
CASES = [
    (2, 384, 512, (256,), False, False, False),
    (4, 384, 512, (200,), False, False, False),          # M padded
    (2, 384, 512, (256, 256, 256), True, False, False),  # wqkv form
    (2, 400, 512, (256,), False, False, True),           # wo form
    (4, 384, 512, (512, 512), True, False, False),       # gate_up form
    (2, 384, 1280, (256,), False, False, True),          # W2 down: K padded
    (4, 384, 1024, (256,), False, True, True),           # W4 down: glu folded
    # bits 3 (lo and hi planes) and bits 1, K padded to 8 * GS
    (3, 384, 1024, (256,), False, False, False),
    (3, 400, 512, (256,), False, False, True),           # K padded
    (3, 384, 1024, (256, 256), True, False, False),
    (3, 512, 1024, (256,), False, True, True),           # glu folded
    (1, 384, 1024, (256,), False, False, True),
    (1, 384, 1024, (256,), False, True, False),
]


@pytest.mark.parametrize("bits,N,K,Ms,norm,glu,residual", CASES)
def test_plain_k5_matches_pallas_dequant(bits, N, K, Ms, norm, glu, residual):
    rng = np.random.default_rng(bits * 1000 + N + K + sum(Ms))
    qt, jqt = _pair(rng, bits, K, Ms)
    xb, xt, kw_j, kw_t = _inputs(rng, qt, N, K, norm, glu, residual)
    want = _pallas(xb, jqt, "dequant", **kw_j)
    assert route(qt, N) == "K5" and kernel_for(qt, N) is k45.qgemm_dequant
    got = k45.qgemm_dequant(xt, qt, **kw_t).numpy()
    assert got.shape == want.shape == (N, sum(Ms)) and np.isfinite(got).all()
    if norm:
        assert nmse(want, got) <= NORM_NMSE
        return
    _within_rounding(qt, xt, kw_t, want, got)
    # the exact parts: the bf16 activations (x itself without a fold, zero
    # past K) and the dequantized weights
    xa = k45.act_bf16_plain(xt, qt, glu=glu).float().numpy()
    if not glu:
        np.testing.assert_array_equal(xa[:, :K], np.asarray(xb, np.float32))
    assert not xa[:, K:].any()
    wd = k45.dequant_weights_plain(qt).float().numpy()
    codes = unpack_codes(qt).numpy().astype(np.float32)
    G = qt.kdim_padded // GS
    sc = np.repeat(qt.scales.float().numpy(), GS, 0)
    sb = np.repeat(qt.sub.float().numpy(), GS, 0)
    assert G == qt.scales.shape[0]
    np.testing.assert_array_equal(
        wd, np.asarray(jnp.asarray(codes * sc - sb, jnp.bfloat16), np.float32))


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_plain_k5_matches_pallas_dequant_given_xla_rsqrt(bits, monkeypatch):
    """The rms_norm fold with XLA's rsqrt values given to the prologue: the
    gap of the norm cases is XLA's rsqrt alone."""
    from test_torch_model import _given_xla_rsqrt
    _given_xla_rsqrt(monkeypatch)
    rng = np.random.default_rng(bits + 7)
    qt, jqt = _pair(rng, bits, 512, (256, 256))
    xb, xt, kw_j, kw_t = _inputs(rng, qt, 400, 512, True, False, False)
    want = _pallas(xb, jqt, "dequant", **kw_j)
    got = k45.qgemm_dequant(xt, qt, **kw_t).numpy()
    _within_rounding(qt, xt, kw_t, want, got)


def test_route_and_dispatch():
    rng = np.random.default_rng(5)
    grouped, _ = _pair(rng, 2, 512, (256,))
    per_tensor = QuantizedTensor.from_float(
        rng.standard_normal((256, 128)).astype(np.float32), 2, device="cpu")
    # K4's function: the decode form below 64 rows, K4L (tensor cores)
    # from 64 rows to 3 * GS, and from 64 with dispatch "chunk"
    assert [route(grouped, n) for n in (1, 63, 64, 383, 384, 1024)] == \
        ["K4", "K4", "K4L", "K4L", "K5", "K5"]
    assert [route(grouped, n, "dequant") for n in (63, 64)] == ["K4", "K5"]
    assert route(grouped, 512, "chunk") == "K4L"
    assert kernel_for(grouped, 100) is k45.qgemm_grouped_large
    assert kernel_for(grouped, 100, plain=True) is k45.qgemm_grouped_plain
    assert [route(per_tensor, n, d) for n, d in ((63, None), (64, None),
                                                 (64, "chunk"))] == ["K1", "K3", "K3"]
    with pytest.raises(ValueError):
        route(grouped, 384, "dense")
    x = torch.zeros((64, 512))
    assert torch.equal(qgemm(x, grouped, dispatch="dequant", out_dtype=torch.float32),
                       k45.qgemm_dequant_plain(x, grouped))
    with pytest.raises(ValueError):       # K5 takes grouped bf16 scales
        k45.qgemm_dequant(torch.zeros((64, 256)), per_tensor)
    with pytest.raises(ValueError, match="K5 runs on CPU or CUDA"):
        k45.qgemm_dequant(x.to("meta"), grouped.to("meta"))


# f32 scales and sub (GGUF's block types): (bits, gs, N, K, Ms, norm, glu,
# residual), bits 4 at gs 32 (3 * gs = 96 rows) and ternary bits 2 at 256
F32_CASES = [
    (4, 32, 96, 512, (256,), False, False, False),
    (4, 32, 200, 1024, (256, 256, 256), True, False, False),
    (4, 32, 128, 512, (256,), False, True, True),
    (2, 256, 768, 1024, (256,), False, False, True),
]


@pytest.mark.parametrize("bits,gs,N,K,Ms,norm,glu,residual", F32_CASES)
def test_plain_k5_f32_scales_match_pallas_dequant(bits, gs, N, K, Ms, norm, glu, residual):
    """K5's function with f32 scales against the dequant kernel: the same
    gates as the bf16 form's; the dequantized weights are now an FMA,
    code * scale - sub rounded once, then to bf16, as XLA compiles the
    reference's `(wf * sc - sb)` (and as K5 computes them)."""
    rng = np.random.default_rng(bits * 1000 + gs + N + K + sum(Ms))
    qt, jqt = _pair(rng, bits, K, Ms, gs, f32=True)
    xb, xt, kw_j, kw_t = _inputs(rng, qt, N, K, norm, glu, residual)
    want = _pallas(xb, jqt, None, **kw_j)
    assert route(qt, N) == "K5" and qt.scales.dtype == torch.float32
    got = k45.qgemm_dequant(xt, qt, **kw_t).numpy()
    assert got.shape == want.shape == (N, sum(Ms)) and np.isfinite(got).all()
    if norm:
        assert nmse(want, got) <= NORM_NMSE
        return
    _within_rounding(qt, xt, kw_t, want, got)


@pytest.mark.parametrize("bits,gs", [(4, 32), (2, 256)])
def test_k5_f32_dequantized_weights_are_the_references(bits, gs):
    """The reference's bf16 dequantized weights, read back through one-hot
    rows of x (each output one exact product), equal dequant_weights_plain
    byte for byte with f32 scales, which an f32 product then a difference
    (two roundings) would not give."""
    rng = np.random.default_rng(bits + gs)
    K = 8 * gs if bits == 2 else 512
    qt, jqt = _pair(rng, bits, K, (256,), gs, f32=True)
    x = jnp.eye(K, dtype=jnp.bfloat16)
    ws = _pallas(x, jqt, "dequant")
    wd = k45.dequant_weights_plain(qt).float().numpy()
    np.testing.assert_array_equal(wd, ws)
    w = unpack_codes(qt).float().reshape(K // gs, gs, -1)
    two = (w * qt.scales.float()[:, None] - qt.sub.float()[:, None]).reshape(K, -1)
    assert (two.to(torch.bfloat16).float().numpy() != ws).any()
