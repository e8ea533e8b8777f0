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
    assert torch.equal(qgemm(x, grouped, dispatch="dequant", out_dtype=torch.float32, act="fused"),
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


@pytest.mark.parametrize("bits,gs", [(4, 32), (2, 256), (2, 16), (3, 16)])
def test_k5_f32_dequantized_weights_are_the_references(bits, gs):
    """The reference's bf16 dequantized weights, read back through one-hot
    rows of x (each output one exact product), equal dequant_weights_plain
    byte for byte with f32 scales, which an f32 product then a difference
    (two roundings) would not give."""
    rng = np.random.default_rng(bits + gs)
    K = 8 * gs if bits == 2 and gs > 16 else 512
    qt, jqt = _pair(rng, bits, K, (256,), gs, f32=True)
    x = jnp.eye(K, dtype=jnp.bfloat16)
    ws = _pallas(x, jqt, "dequant")
    wd = k45.dequant_weights_plain(qt).float().numpy()
    np.testing.assert_array_equal(wd, ws)
    w = unpack_codes(qt).float().reshape(K // gs, gs, -1)
    two = (w * qt.scales.float()[:, None] - qt.sub.float()[:, None]).reshape(K, -1)
    assert (two.to(torch.bfloat16).float().numpy() != ws).any()


@pytest.mark.parametrize("bits,gs", [(2, 16), (3, 16), (1, 16), (8, 16), (8, 32), (4, 32)])
def test_k5_producer_dequantizes_as_the_plain_version(bits, gs):
    """A model of dequant_wgmma_kernel's producer: step = rb * P + j
    dequantizes field j of packed rows 64 rb .. +64 (k = j * Kb + r), its
    thread (q, rlo) the 8 columns 8 q .. +8 of rows rlo + 16 i (i < 4);
    the scale and zero point rows prefetched for row rlo's group, and
    reloaded where a chunk's row is in another group (every chunk at gs
    16: the in-step group change); the code taken as a float by the exact
    add (bits 8: the signed byte xor 0x80, less 2^23 + 128); then
    fma(code, scale, -sub) rounded to bf16: the plain version's weights
    bit for bit, f32 scales (and bits 8's sub shifted by 128 * scale)."""
    from tmac_tpu_torch.utils import fma_f32
    rng = np.random.default_rng(bits * 7 + gs)
    K = 1024 if bits in (1, 3) else 512
    qt, _ = _pair(rng, bits, K, (128,), gs, f32=True)
    Kp, Mp = qt.kdim_padded, qt.mdim_padded
    P = 1 if bits == 8 else 4 if bits == 3 else 8 // bits
    Kb, Kh = Kp // P, Kp // 8
    pk = qt.packed.long()
    hi = qt.packed_hi.long() if bits == 3 else None
    sc, sb = qt.scales.float(), qt.sub.float()
    out = torch.zeros((Kp, Mp), dtype=torch.bfloat16)
    reloads = 0
    for step in range(Kp // 64):
        rb, j = divmod(step, P)
        r0 = rb * 64
        for rlo in range(16):
            g_pre = ((step % P) * Kb + (step // P) * 64 + rlo) // gs   # load_scales
            g_cur, s_row, z_row = (j * Kb + r0 + rlo) // gs, sc[g_pre], sb[g_pre]
            assert g_cur == g_pre
            for i in range(4):
                rr = rlo + 16 * i
                g = (j * Kb + r0 + rr) // gs
                if g != g_cur:
                    g_cur, s_row, z_row = g, sc[g], sb[g]
                    reloads += 1
                byte = pk[r0 + rr]
                if bits == 3:
                    code = (((byte >> (2 * j)) & 3)
                            | (((hi[(r0 + rr) % Kh] >> (2 * j + (r0 >= Kh))) & 1) << 2))
                    cf = code.float()
                elif bits == 8:
                    biased = torch.from_numpy((byte.numpy() ^ 0x80).astype(np.uint32)
                                              | 0x4B000000).view(torch.float32)
                    cf = biased - torch.tensor(8388736.0)
                else:
                    cf = ((byte >> (bits * j)) & ((1 << bits) - 1)).float()
                v = fma_f32(cf, s_row, -z_row)
                out[j * Kb + r0 + rr] = v.to(torch.bfloat16)
    assert torch.equal(out.view(torch.int16), k45.dequant_weights_plain(qt).view(torch.int16))
    assert (reloads > 0) == (gs < 64)


@pytest.mark.parametrize("gs", [32, 16])
def test_bits8_dequant_reads_signed_codes(gs):
    """Grouped bits 8 (GGUF's Q8_0) on K5's route: the port dequantizes the
    signed codes the packing stores (wq - 128, the shift folded into sub),
    as the reference's own XLA route (qgemm_xla) does, within the bf16
    rounding of the weights.  The reference's Pallas dequant route in
    interpret mode reads the same bytes as unsigned (its interpret-mode
    unpack masks the widened bytes and, unlike its single-dot branch,
    never wraps them to int8), 256 * scale off on every weight whose
    code is negative: a fault of the reference (ROADMAP Queue 3), pinned
    here, which the port does not follow."""
    from tmac_tpu.ops.qgemm import qgemm_xla
    rng = np.random.default_rng(gs)
    K = 512
    qt, jqt = _pair(rng, 8, K, (256,), gs, f32=True)
    eye = jnp.eye(K, dtype=jnp.bfloat16)
    wd = k45.dequant_weights_plain(qt).float().numpy()
    wx = np.asarray(qgemm_xla(eye, jqt, out_dtype=jnp.float32))
    assert np.abs(wd - wx).max() <= 2.0 ** -8 * np.abs(wx).max()
    ws = _pallas(eye, jqt, "dequant")
    codes = np.asarray(jqt.packed)
    sc, sb = np.asarray(jqt.scales, np.float32), np.asarray(jqt.sub, np.float32)
    unsigned = (codes.astype(np.float32).reshape(K // gs, gs, -1) * sc[:, None]
                - sb[:, None]).reshape(K, -1)
    assert np.abs(unsigned.astype(jnp.bfloat16).astype(np.float32) - ws).max() \
        <= 2.0 ** -8 * np.abs(ws).max()
    neg = codes.view(np.int8) < 0
    assert np.allclose((ws - wd)[neg].mean() / (256 * sc.mean()), 1.0, rtol=0.2)
