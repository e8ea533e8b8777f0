"""Kernel K4's plain version against the JAX package's grouped Pallas qgemm
(qgemm_pallas act="fused", interpret mode on CPU, compiled as the model
runs it), against the dequant oracle, and the layout contract between the
CUDA kernel's packed-field walk and the per-group dots."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops import packing as jpacking
from tmac_tpu.ops.pallas.qgemm_kernel import qgemm_pallas
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu.ops.qgemm import fuse_m as jfuse_m
from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (
    act_quant_grouped_plain, check_kernel_form, group_dots_plain, qgemm_grouped,
    qgemm_grouped_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m, qgemm, unpack_codes
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

GS = 128


def _pair(rng, bits, K, Ms, gs=GS, f32=False):
    """The same grouped weights (random codes, per-group scales and zero
    points, bf16 scales and sub, as the model's init draws them; with f32,
    f32 scales and sub off any zero-point grid, as GGUF's Q4_K gives them)
    as a port and a JAX QuantizedTensor; several Ms make a fused tensor."""
    qmax = (1 << bits) - 1
    G = K // gs
    sdt, jsdt = (torch.float32, jnp.float32) if f32 else (torch.bfloat16, jnp.bfloat16)
    ts, js = [], []
    for M in Ms:
        wq = rng.integers(0, qmax + 1, (K, M)).astype(np.uint8)
        sc = ((0.5 + rng.random((G, M))) * 0.05).astype(np.float32)
        sub = sc * rng.integers(0, qmax + 1, (G, M)).astype(np.float32)
        if f32:
            sub = (sub * (1 + 1e-3 * rng.random((G, M)))).astype(np.float32)
        ts.append(QuantizedTensor.from_quantized(
            wq, sc, sub, bits, gs, scale_dtype=sdt, device="cpu"))
        js.append(JQT.from_quantized(wq, sc, sub, bits, gs, scale_dtype=jsdt))
    if len(Ms) == 1:
        return ts[0], js[0]
    return fuse_m(ts), jfuse_m(js)


def _pallas(xb, jqt, norm=None, glu=False, residual=None, dispatch=None):
    """qgemm_pallas(act="fused") compiled as the model runs it (inside jit),
    on the route its N picks: fused chunk kernel below 64 rows, XLA
    prologue + external-int8 chunk kernel from 64, the dequant kernel from
    3 * GS rows (or as dispatch says)."""
    eps = None if norm is None else norm[1]

    def f(x, q, w, r):
        return qgemm_pallas(x, q, out_dtype=jnp.float32, interpret=True,
                            act="fused", glu=glu, residual=r, dispatch=dispatch,
                            norm=None if w is None else (w, eps))
    return np.asarray(jax.jit(f)(xb, jqt, None if norm is None else norm[0],
                                 residual))


@functools.partial(jax.jit, static_argnums=1)
def _jax_group_quant(x, gs=GS):
    """The reference's per-(row, group) quantization (qgemm_pallas's int8
    prologue), compiled: codes, scales, dequantized code sums."""
    N, K = x.shape
    xg = x.astype(jnp.float32).reshape(N, K // gs, gs)
    xs = jnp.maximum(jnp.max(jnp.abs(xg), axis=-1), 1e-20) / 127.0
    q = jnp.clip(jnp.rint(xg / xs[..., None]), -127, 127).astype(jnp.int8)
    xsum = jnp.sum(q.astype(jnp.int32), -1).astype(jnp.float32) * xs
    return q.reshape(N, K), xs, xsum


# (bits, N, K, Ms, norm, glu, residual): every fold at the decode (N=1),
# short-prefill (N=16) and long-prefill (N=72, the N >= 64 route) forms
CASES = [
    (2, 1, 512, (256,), False, False, False),
    (2, 1, 512, (200,), False, False, False),          # M padded
    (2, 1, 512, (256, 256, 256), True, False, False),  # wqkv form
    (2, 16, 512, (256,), False, False, True),          # wo form
    (2, 1, 512, (512, 512), True, False, False),       # gate_up form
    (2, 16, 1280, (256,), False, False, True),         # W2 down: K 1280 -> 1536
    (4, 1, 1024, (256,), False, True, True),           # W4 down: glu folded
    (4, 16, 512, (384,), True, False, False),
    (2, 72, 512, (256,), False, False, True),
    (4, 72, 512, (200,), False, False, False),
    (2, 72, 1280, (256,), True, False, False),
    (4, 72, 512, (256,), False, True, True),
    # K4L's route (64 <= N < 3 * GS) at its edges and ragged row tiles
    (2, 64, 512, (256,), False, False, True),
    (4, 100, 512, (256,), True, False, False),
    (2, 100, 512, (200,), False, False, False),        # M padded
    (2, 256, 512, (256, 256), False, False, False),    # gate_up form
    (4, 256, 512, (256,), False, False, True),
    (4, 383, 1024, (256,), False, True, True),         # W4 down: glu folded
    (2, 383, 1280, (256,), False, False, True),        # W2 down: K padded
    # bits 3 (a lo and a hi plane) and bits 1: K padded to 8 * GS
    (3, 2, 1024, (256,), False, False, True),
    (3, 2, 1024, (256, 256), True, False, False),
    (3, 16, 512, (200,), False, False, False),         # K 512 -> 1024, M padded
    (3, 2, 1024, (256,), False, True, True),           # glu folded
    (1, 2, 1024, (256,), False, False, True),
    (1, 16, 1024, (256, 256), True, False, False),
    (1, 2, 1024, (256,), False, True, True),
    (3, 64, 1024, (256,), False, False, True),         # K4L's route
    (3, 100, 512, (256,), True, False, False),
    (3, 256, 1024, (256,), False, True, True),
    (1, 64, 1024, (200,), False, False, False),
    (1, 256, 512, (256,), False, False, True),
]


# K4L at group sizes that are not a multiple of 64 (its KT = 32 form),
# against the reference's chunk kernel (dispatch "chunk": from 3 * gs rows
# its default is the dequant kernel): (group_size, bits, N, K, Ms, norm,
# glu, residual)
GS_CASES = [
    (32, 2, 100, 1120, (256,), False, False, True),    # K padded 1120 -> 1152
    (32, 4, 256, 1024, (256,), False, True, True),     # glu folded
    (96, 2, 64, 960, (256,), True, False, False),      # K padded 960 -> 1152
    (96, 2, 383, 960, (256,), False, False, True),
    (96, 4, 256, 1152, (200,), False, False, False),   # M padded
]


@pytest.mark.parametrize("bits,N,K,Ms,norm,glu,residual", CASES)
def test_plain_k4_matches_pallas(bits, N, K, Ms, norm, glu, residual):
    _check_against_pallas(bits, N, K, Ms, norm, glu, residual)


# f32 scales and sub (GGUF's block types): K4 below 64 rows and K4L from
# 64, bits 4 at gs 32 (below 3 * gs = 96 rows) and ternary bits 2 at gs
# 256: (gs, bits, N, K, Ms, norm, glu, residual)
F32_CASES = [
    (32, 4, 1, 512, (256, 256, 256), True, False, False),
    (32, 4, 1, 512, (256,), False, False, True),
    (32, 4, 4, 1024, (256,), False, True, True),
    (32, 4, 16, 512, (200,), False, False, False),
    (32, 4, 64, 512, (256,), False, False, True),
    (32, 4, 88, 1024, (256,), False, True, True),
    (32, 4, 72, 512, (256, 256), True, False, False),
    (256, 2, 1, 1024, (256,), False, False, True),
    (256, 2, 72, 2048, (256,), False, False, False),
    (256, 2, 300, 1024, (256,), False, True, True),
]


@pytest.mark.parametrize("gs,bits,N,K,Ms,norm,glu,residual", F32_CASES)
def test_plain_f32_scales_match_pallas(gs, bits, N, K, Ms, norm, glu, residual):
    """The f32 form: the reference widens any scale dtype to f32 where it
    reads it, so the plain version's fold (scales read as f32) holds to it
    bit for bit without a norm or glu fold, as the bf16 form does."""
    _check_against_pallas(bits, N, K, Ms, norm, glu, residual, gs, "chunk", f32=True)


@pytest.mark.parametrize("gs,bits,N,K,Ms,norm,glu,residual", GS_CASES)
def test_plain_k4l_group_sizes_match_pallas(gs, bits, N, K, Ms, norm, glu, residual):
    _check_against_pallas(bits, N, K, Ms, norm, glu, residual, gs, "chunk")


def _check_against_pallas(bits, N, K, Ms, norm, glu, residual, gs=GS,
                          dispatch=None, f32=False):
    seed = bits * 1000 + N * 100 + K + sum(Ms) + (0 if gs == GS else gs)
    rng = np.random.default_rng(seed)
    qt, jqt = _pair(rng, bits, K, Ms, gs, f32)
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kw_j, kw_t = {}, {}
    if norm:
        w = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        kw_j["norm"] = (jnp.asarray(w, jnp.bfloat16), 1e-5)
        kw_t["norm"] = (torch.from_numpy(w).to(torch.bfloat16), 1e-5)
    if glu:
        kw_j["glu"] = kw_t["glu"] = True
    if residual:
        r = rng.standard_normal((N, sum(Ms))).astype(np.float32)
        kw_j["residual"] = jnp.asarray(r, jnp.bfloat16)
        kw_t["residual"] = torch.from_numpy(r).to(torch.bfloat16)
    want = _pallas(xb, jqt, dispatch=dispatch, **kw_j)
    got = qgemm_grouped(xt, qt, **kw_t).numpy()
    assert got.shape == want.shape == (N, sum(Ms))
    if norm or glu:
        # XLA's CPU rsqrt (a hardware estimate refined by Newton steps) and
        # exp differ from IEEE 1/sqrt and torch's exp by an ulp in some
        # rows, which can move a code at a .5 tie
        assert nmse(want, got) <= 1e-6
        return
    # no norm or glu: codes, scales, code sums and per-group int32 dots are
    # exact, and the f32 fold is the one XLA compiles the reference's to,
    # FMAs and group order included, so the outputs are bit for bit
    np.testing.assert_array_equal(got, want)
    codes, xs, xsum = act_quant_grouped_plain(xt, qt)
    jc, jxs, jxsum = _jax_group_quant(jnp.pad(xb, ((0, 0), (0, qt.kdim_padded - K))), gs)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
    np.testing.assert_array_equal(xsum.numpy(), np.asarray(jxsum))
    parts = group_dots_plain(codes, qt).numpy()
    G = qt.kdim_padded // gs
    w64 = unpack_codes(qt).numpy().astype(np.int64).reshape(G, gs, -1)
    c64 = codes.numpy().astype(np.int64).reshape(N, G, gs)
    np.testing.assert_array_equal(parts, np.einsum("ngk,gkm->gnm", c64, w64))


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_grouped_route_at_384_rows_matches_pallas(bits):
    """At N = 3 * GS rows with dispatch=None the reference takes its
    dequant kernel (bf16 activations times bf16 dequantized weights), and
    so must the port's qgemm and every grouped linear of its model: the
    same bf16 operands, the f32 sums in another order (measured NMSE
    ~1e-14; K4's int8-activation function differs by ~1e-5)."""
    from tmac_tpu_torch.models.llama import apply_qlinear
    rng = np.random.default_rng(bits + 11)
    K = 1024 if bits in (1, 3) else 512
    qt, jqt = _pair(rng, bits, K, (256,))
    x = rng.standard_normal((3 * GS, K)).astype(np.float32)
    r = rng.standard_normal((3 * GS, 256)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    rt = torch.from_numpy(r).to(torch.bfloat16)
    want = _pallas(jnp.asarray(x, jnp.bfloat16), jqt,
                   residual=jnp.asarray(r, jnp.bfloat16))
    got = qgemm(xt, qt, impl="fused", act="fused", out_dtype=torch.float32, residual=rt)
    assert nmse(want, got.numpy()) <= 1e-10
    assert torch.equal(apply_qlinear(xt[None], qt, residual=rt[None])[0],
                       got.to(torch.bfloat16))
    # dispatch="chunk" keeps K4's function, as in the reference
    chunk = qgemm(xt, qt, impl="fused", act="fused", out_dtype=torch.float32, residual=rt,
                  dispatch="chunk")
    np.testing.assert_array_equal(
        chunk.numpy(), _pallas(jnp.asarray(x, jnp.bfloat16), jqt,
                               residual=jnp.asarray(r, jnp.bfloat16),
                               dispatch="chunk"))
    assert nmse(want, chunk.numpy()) > 1e-7


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_plain_k4_matches_dequant_oracle(bits):
    """Against the float dequant oracle (docs/contracts.md's 5e-4 gate)."""
    rng = np.random.default_rng(bits)
    K, M, N = 1024, 384, 4
    w = (rng.standard_normal((K, M)) * 0.02).astype(np.float32)
    wq, s, sub = jpacking.quantize_weights(w, bits, GS, True)
    qt = QuantizedTensor.from_quantized(wq, s, sub, bits, GS,
                                        scale_dtype=torch.bfloat16, device="cpu")
    x = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32))
    wdq = (unpack_codes(qt).float().reshape(K // GS, GS, M)
           * qt.scales.float()[:, None] - qt.sub.float()[:, None]).reshape(K, M)
    oracle = x.to(torch.bfloat16).float() @ wdq
    assert nmse(oracle.numpy(), qgemm_grouped_plain(x, qt).numpy()) <= 5e-4


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_packed_field_walk_feeds_the_group_dots(bits):
    """Emulates the packed-field walk of K4's decode matmul
    (csrc/decode_matmul.cuh): a chunk of gs packed rows holds, in field j,
    the gs consecutive k of group j * nchunks + c, so 4 packed rows meet
    one 32-bit word of natural-order codes in each dp4a."""
    rng = np.random.default_rng(bits)
    qt, _ = _pair(rng, bits, 1024, (128,))
    x = torch.from_numpy(rng.standard_normal((3, 1024)).astype(np.float32))
    codes, _, _ = act_quant_grouped_plain(x, qt)
    P, Kp, Mp = 8 // bits, qt.kdim_padded, qt.mdim_padded
    Kb, nchunks = Kp // P, Kp // P // GS
    pk = qt.packed.numpy().astype(np.int64)
    c = codes.numpy().astype(np.int64)
    parts = np.zeros((Kp // GS, 3, Mp), np.int64)
    for chunk in range(nchunks):
        for r in range(chunk * GS, (chunk + 1) * GS, 4):
            for j in range(P):
                fields = (pk[r:r + 4] >> (bits * j)) & ((1 << bits) - 1)
                xw = c[:, j * Kb + r:j * Kb + r + 4]            # one code word
                parts[j * nchunks + chunk] += xw @ fields
    np.testing.assert_array_equal(parts, group_dots_plain(codes, qt).numpy())


@pytest.mark.parametrize("bits,N", [(3, 2), (3, 72), (3, 384), (1, 2), (1, 72), (1, 384)])
def test_fold_chunk_below_the_group_matches_pallas(bits, N):
    """A tensor packed by hand with Kp = 512 at g128 (the packing pads K
    to 8 * gs = 1024 at bits 1 and 3): the reference's fold chunk is then
    Kp / 8 = 64 < gs (at bits 3 min(gs, Kp / 4, Kp / 8)), so it scales and
    adds each group's int32 dot in two parts.  The plain versions follow
    (fold_chunk): bit for bit on the K4 (N = 2) and K4L (N = 72) routes,
    within f32 rounding on K5's (N = 384, whose dequantized weights do not
    depend on the chunk); a per-group fold gives other bits.  The CUDA
    kernels K4 and K4L raise for such a tensor (Kp a multiple of 8 * gs)."""
    from tmac_tpu_torch.ops import packing
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import fold_chunk, fold_plain
    rng = np.random.default_rng(bits * 10 + N)
    K, M, G = 512, 256, 512 // GS
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    sc = ((0.5 + rng.random((G, M))) * 0.05).astype(np.float32)
    sub = sc * rng.integers(0, 1 << bits, (G, M)).astype(np.float32)
    lo, hi = packing.pack_b3(wq) if bits == 3 else (packing.pack_strided(wq, 1), None)
    bf = jnp.asarray(sc, jnp.bfloat16), jnp.asarray(sub, jnp.bfloat16)
    jqt = JQT(jnp.asarray(lo), None if hi is None else jnp.asarray(hi), *bf, bits, GS,
              1, 1, (K, M), None)
    qt = QuantizedTensor(torch.from_numpy(lo), None if hi is None else torch.from_numpy(hi),
                         *(torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
                           for a in bf), bits, GS, 1, 1, (K, M))
    assert qt.kdim_padded == K and fold_chunk(K, bits, GS) == 64
    x = rng.standard_normal((N, K)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    want = _pallas(jnp.asarray(x, jnp.bfloat16), jqt)
    got = qgemm(xt, qt, impl="fused", act="fused", out_dtype=torch.float32).numpy()
    if N >= 3 * GS:
        assert nmse(want, got) <= 1e-12
        return
    np.testing.assert_array_equal(got, want)
    codes, xs, xsum = act_quant_grouped_plain(xt, qt)
    whole = torch.stack([(codes[:, k:k + GS].double() @ unpack_codes(qt)[k:k + GS].double())
                         .to(torch.int32) for k in range(0, K, GS)])
    assert not np.array_equal(fold_plain(whole, xs, xsum, qt).numpy(), want)


def test_wrapper_dispatch_and_limits():
    rng = np.random.default_rng(3)
    qt, _ = _pair(rng, 2, 512, (256,))
    x = torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))
    assert torch.equal(qgemm(x, qt, out_dtype=torch.float32, act="fused"),  # auto -> K4
                       qgemm_grouped_plain(x, qt))
    # grouped bits 8 and f32 scales: the function's forms, on the CPU the
    # plain version's (bits 8 the kernel lacks: check_kernel_form names it)
    bits8 = QuantizedTensor.from_quantized(
        rng.integers(0, 256, (512, 256)).astype(np.uint8),
        np.ones((4, 256), np.float32), np.zeros((4, 256), np.float32), 8, GS,
        scale_dtype=torch.bfloat16, device="cpu")
    f32 = QuantizedTensor.from_quantized(
        rng.integers(0, 4, (512, 256)).astype(np.uint8),
        np.ones((4, 256), np.float32), np.zeros((4, 256), np.float32), 2, GS,
        device="cpu")
    for ok in (bits8, f32):
        assert torch.equal(qgemm_grouped(x, ok), qgemm_grouped_plain(x, ok))
        check_kernel_form(ok)
    per_tensor = QuantizedTensor.from_float(
        rng.standard_normal((512, 256)).astype(np.float32), 2, device="cpu")
    f16 = QuantizedTensor.from_quantized(       # neither bf16 nor f32
        rng.integers(0, 4, (512, 256)).astype(np.uint8),
        np.ones((4, 256), np.float32), np.zeros((4, 256), np.float32), 2, GS,
        scale_dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="takes bf16 or f32 scales"):
        check_kernel_form(f16)
    padded_k, _ = _pair(rng, 2, 640, (256,))    # K 640 -> 1024
    padded_m, _ = _pair(rng, 2, 512, (200,))
    for bad, kw in ((f16, {}), (per_tensor, {}),
                    (padded_k, dict(glu=True)),
                    (padded_m, dict(residual=torch.zeros(2, 200, dtype=torch.bfloat16))),
                    (qt, dict(residual=torch.zeros(2, 256)))):
        xb = x if not kw.get("glu") else torch.zeros(2, 2 * bad.kdim)
        with pytest.raises(ValueError):
            qgemm_grouped(xb, bad, **kw)


def _k4l_b_reads(bits, KT, rbase, Kb):
    """A model of group_mma_kernel's B path for one depth step of KT
    packed rows from rbase (field j = step's k // Kb): where cp.async puts
    packed row r, logical 16-byte chunk q of the block's 128 columns, and
    which tile byte each (warp column wn, lane, ks, h, tile c, byte i)
    reads for its B register.  -> (chunk map {(r, q): physical byte
    offset}, reads [(wn, lane, ks, h, c, i, byte offset)])."""
    def chunk(r, q):
        return q ^ (((r >> 2) & 3) << 1)
    stores = {(r, q): r * 128 + chunk(r, q) * 16
              for r in range(KT) for q in range(8)}
    reads = []
    for wn in (0, 32, 64, 96):
        for lane in range(32):
            gq, tq = lane >> 2, lane & 3
            word = (wn >> 2) + gq
            for ks in range(KT // 32):
                for h in range(2):
                    r = ks * 32 + h * 16 + tq * 4
                    for c in range(4):
                        for i in range(4):
                            # transpose4: byte i of column word c is byte c
                            # of the word read from row r + i
                            reads.append((wn, lane, ks, h, c, i, (r + i) * 128
                                          + chunk(r + i, word >> 2) * 16
                                          + (word & 3) * 4 + c))
    return stores, reads


@pytest.mark.parametrize("bits,KT", [(2, 64), (4, 64), (2, 32), (8, 64), (8, 32)])
def test_k4l_fragment_map_reads_the_unpacked_codes(bits, KT):
    """The swizzled packed tile is a bijection onto its bytes, with the 4
    packed rows that one B register reads in 4 distinct 16-byte chunk
    columns (8 chunks of the 128-byte row, no bank shared by a warp's
    lanes); every (k, column) of the step is read by exactly one fragment
    element; and the byte a fragment element gets, masked to field j, is
    the weight code unpack_codes gives for k = j * Kb + rbase + k_local,
    at the column the epilogue stores it to (bits 8: the byte itself, a
    signed code, with no field to mask)."""
    rng = np.random.default_rng(bits + KT)
    qt, _ = _pair(rng, bits, 1024, (256,))
    P, Kp, Mp = 8 // bits, qt.kdim_padded, qt.mdim_padded
    Kb = Kp // P
    codes = unpack_codes(qt).numpy()
    pk = qt.packed.numpy()
    for t in (0, 3, Kp // KT - 1):            # first, a middle and the last step
        rbase, j = (t * KT) % Kb, (t * KT) // Kb
        for m0 in (0, 128):
            stores, reads = _k4l_b_reads(bits, KT, rbase, Kb)
            offs = sorted(stores.values())
            assert offs == list(range(0, KT * 128, 16))     # a bijection
            tile = np.zeros(KT * 128, np.uint8)
            for (r, q), off in stores.items():
                tile[off:off + 16] = pk[rbase + r, m0 + q * 16:m0 + q * 16 + 16]
            seen = set()
            for wn, lane, ks, h, c, i, off in reads:
                gq, tq = lane >> 2, lane & 3
                k_local = ks * 32 + h * 16 + tq * 4 + i        # m16n8k32 B row
                # the column the epilogue gives tile c's B column gq
                m = m0 + wn + 4 * gq + c
                assert (k_local, m) not in seen
                seen.add((k_local, m))
                field = (int(tile[off]) >> (bits * j)) & ((1 << bits) - 1)
                if bits == 8:
                    field -= 256 * (field >= 128)
                assert field == codes[j * Kb + rbase + k_local, m]
            assert len(seen) == KT * 128
            # one register's 4 rows land in 4 distinct chunk columns, and a
            # warp's 32 lanes read 32 distinct banks in each read
            for ks in range(KT // 32):
                for h in range(2):
                    for i in range(4):
                        for wn in (0, 32, 64, 96):
                            banks = {(off // 4) % 32 for w, lane, k2, h2, c, i2, off
                                     in reads if (w, k2, h2, i2, c) == (wn, ks, h, i, 0)}
                            assert len(banks) == 32


def test_k4l_epilogue_columns_cover_the_tile():
    """group_mma_kernel's accumulator (mt, c, 2h + e) of warp w (columns
    wn = 32 w) and lane l is row 16 mt + l / 4 + 8 h and column
    wn + 4 (2 (l % 4) + e) + c: the 4 warps' 64 outputs a thread cover the
    64 x 128 block tile once, and the m16n8 C fragment's column 2 (l % 4)
    + e of tile c is the B column that the lanes with l / 4 = 2 (l % 4) + e
    supplied, column wn + 4 (l / 4) + c of the packed tile."""
    seen = set()
    for warp in range(4):
        wn = warp * 32
        for lane in range(32):
            for mt in range(4):
                for c in range(4):
                    for h in range(2):
                        for e in range(2):
                            n = 2 * (lane % 4) + e     # the C fragment's column
                            cell = (16 * mt + lane // 4 + 8 * h, wn + 4 * n + c)
                            assert cell not in seen
                            seen.add(cell)
    assert seen == {(r, m) for r in range(64) for m in range(128)}


@pytest.mark.parametrize("gs,bits,scale_dtype,form", [
    (16, 2, torch.float32, "group size 16"), (16, 3, torch.float32, "group size 16"),
    (32, 8, torch.float32, "grouped bits 8"), (32, 8, torch.bfloat16, "grouped bits 8"),
    (32, 4, torch.float32, None), (256, 2, torch.float32, None),
    (128, 3, torch.bfloat16, None), (16, 8, torch.float32, "grouped bits 8"),
    (16, 1, torch.bfloat16, "group size 16"), (32, 2, torch.float16, "float16 scales")])
def test_kernel_form_check_names_what_the_card_lacks(gs, bits, scale_dtype, form):
    """check_kernel_form, what K4, K4L and K5 run before they launch: group
    size 16 (GGUF's Q2_K and Q3_K) and grouped bits 8 (Q8_0), which the
    kernels take since they have a 16-row unit and an s8 x s8 form, pass
    with f32 and bf16 scales, as every multiple of 32 does, and so does an
    activation group size of 16 (_check_ags); the one form it names is a
    scale dtype other than bf16 and f32.  The plain version computes every
    form it passes."""
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import _check_ags
    rng = np.random.default_rng(gs + bits)
    K = 8 * max(gs, 32) if bits in (1, 3) else 512
    qmax = (1 << bits) - 1
    qt = QuantizedTensor.from_quantized(
        rng.integers(0, qmax + 1, (K, 256)).astype(np.uint8),
        np.full((K // gs, 256), 0.01, np.float32), np.full((K // gs, 256), 0.05, np.float32),
        bits, gs, scale_dtype=scale_dtype, device="cpu")
    for kernel in ("K4", "K4L", "K5"):
        if scale_dtype == torch.float16:
            with pytest.raises(ValueError, match=f"{kernel} on the card takes bf16 or f32"):
                check_kernel_form(qt, kernel)
            continue
        check_kernel_form(qt, kernel)
        if gs >= 32:
            _check_ags(kernel, qt, 16)
    if scale_dtype == torch.float16:
        return
    x = torch.from_numpy(rng.standard_normal((3, K)).astype(np.float32)).to(torch.bfloat16)
    assert torch.isfinite(qgemm_grouped(x, qt)).all()
    for ags in (8, 48):     # the plain version's, not the kernels'
        with pytest.raises(ValueError, match="activation group size of 16"):
            _check_ags("K4", qt, ags)


def _k4l_streamed(codes, xs, xsum, qt, KT, scale_bytes):
    """A model of group_mma_kernel's streamed fold factors for one block
    (64 token rows, 128 columns): the factors of fold units 4 b .. +4 (the
    last block's 2 where the units are not a multiple of 4; their xs
    columns and weight groups' scales) land in slot b % K4L_FACTOR_BLOCKS
    with the first depth step of unit 4 b, issued K4L_STAGES - 1 steps
    ahead of it (the worst case: landing at once); unit g >= 2's factors
    are read after its first step's barrier (which has waited for that
    step's loads, so the block must have come with a step no later), units
    0 and 1's at unit 1's fold, and each must find its own factors in its
    slot; the z chain runs in passes of as many groups as the idle ring
    holds.  The arithmetic is the kernel's order: fma(p_0, x_0, p_1 * x_1),
    then fma(p_g, x_g, acc); z = fma(xsum_g, sub_g, z); acc - z.
    -> (64, 128)."""
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (
        K4L_FACTOR_BLOCKS, K4L_ROW_BYTES, K4L_STAGES, k4l_ring)
    from tmac_tpu_torch.utils import fma_f32
    Kp, gs = qt.kdim_padded, qt.group_size
    G, ntiles, steps_g = Kp // gs, Kp // KT, gs // KT
    fu = 4
    parts = group_dots_plain(codes, qt).float()        # exact int32 partials
    scales, sub = qt.scales.float(), qt.sub.float()
    slots = [None] * K4L_FACTOR_BLOCKS

    def issue(t):   # step t's loads: a block's factors with its first step
        if t < ntiles and t % (steps_g * fu) == 0:
            b = t // (steps_g * fu)
            slots[b % K4L_FACTOR_BLOCKS] = (t, {
                f: (xs[:, f].clone(), scales[f].clone())
                for f in range(fu * b, min(fu * b + fu, G))})

    def read(f, t):  # after step t's barrier
        t0, block = slots[(f // fu) % K4L_FACTOR_BLOCKS]
        assert t0 <= t, (f, t0, t)
        row, col = block[f]
        return row[:, None] * col[None, :]
    for t in range(K4L_STAGES - 1):
        issue(t)
    acc = x_g = None
    for t in range(ntiles):
        issue(t + K4L_STAGES - 1)      # after step t's barrier
        g, i = divmod(t, steps_g)
        if g > 1 and i == 0:
            x_g = read(g, t)           # during unit g's first step
        if i != steps_g - 1:
            continue
        if g == 1:                     # unit g's last step: its fold
            acc = fma_f32(parts[0], read(0, t), parts[1] * read(1, t))
        elif g > 1:
            acc = fma_f32(parts[g], x_g, acc)
    per_pass = k4l_ring(qt.bits, KT) // (K4L_ROW_BYTES + 128 * scale_bytes)
    z = torch.zeros_like(acc)
    for g0 in range(0, G, per_pass):
        for g in range(g0, min(G, g0 + per_pass)):
            z = fma_f32(xsum[:, g:g + 1].expand_as(z), sub[g].expand_as(z), z)
    return acc - z


@pytest.mark.parametrize("K", [14336, 4160])
@pytest.mark.parametrize("f32", [False, True])
def test_k4l_streamed_factors_at_k14336_match_the_plain_version(f32, K):
    """K4L past its old shared-memory limit: Llama-3-8B's and Mixtral's
    down (K 14336) at gs 32, bits 4, bf16 and f32 scales (and K 4160, 130
    groups: a last block of 2 fold units); the model of its streamed factor
    staging (_k4l_streamed) gives the plain version's outputs bit for
    bit, and its shared memory is the same at any K."""
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (K4L_TWO_BLOCKS, k4l_kt,
                                                              k4l_smem)
    rng = np.random.default_rng(K + f32)
    gs = 32
    qt, _ = _pair(rng, 4, K, (128,), gs, f32)
    x = torch.from_numpy(rng.standard_normal((64, K)).astype(np.float32)).to(torch.bfloat16)
    codes, xs, xsum = act_quant_grouped_plain(x, qt)
    sb = qt.scales.element_size()
    KT = k4l_kt(4, gs, scale_bytes=sb)
    assert KT == 32 and k4l_smem(4, KT, sb) <= K4L_TWO_BLOCKS
    got = _k4l_streamed(codes, xs, xsum, qt, KT, sb)
    want = qgemm_grouped_plain(x, qt)
    assert torch.equal(got, want)


def test_k4l_half_steps_are_the_k16_operands():
    """K4L's U16 form splits a KT = 32 step's m16n8k32 operands into two
    m16n8k16 products: ldmatrix.x4's matrix i (lanes 8 i .. 8 i + 7 give
    its row addresses) holds token rows 8 (i % 2) .. +8 and k bytes 16 (i //
    2) .. +16, so A registers 2 h and 2 h + 1 are the m16n8k16 A fragment
    (rows +0 and +8) of k half h, and B register h (packed rows 16 h + 4 tq
    .. +3, _k4l_b_reads) is its B fragment: each half's sums are exactly
    fold unit 2 t + h's."""
    for lane in range(32):
        i = lane >> 3                      # the matrix this lane addresses
        row = (lane & 7) + ((lane >> 3) & 1) * 8
        kbyte = (lane >> 4) * 16
        assert (row // 8, kbyte // 16) == (i % 2, i // 2)
    for h in range(2):
        for i in (2 * h, 2 * h + 1):       # A registers of half h
            assert i // 2 == h
    _, reads = _k4l_b_reads(2, 32, 0, 256)
    for wn, lane, ks, h, c, i, off in reads:
        k_local = ks * 32 + h * 16 + (lane & 3) * 4 + i
        assert 16 * h <= k_local < 16 * h + 16


def _k4l_u16(codes, xs, xsum, qt, ags=0):
    """A model of group_mma_kernel's U16 form for one block: fold units of
    16 k (the groups at gs 16, the activation groups at ags 16), two a KT =
    32 step, each half's int32 sums folded right after its m16n8k16; the
    factors of units 4 b .. +4 land in slot b % K4L_FACTOR_BLOCKS with step
    2 b's copies (issued K4L_STAGES - 1 steps ahead, after the barrier of
    the step that issues them) and are read at the fold, after the step's
    barrier, which must find its own block there; then the z chain over
    the weight groups.  The arithmetic is the kernel's: fma(p_0, x_0, p_1 *
    x_1), fma(p_f, x_f, acc), x_f = xs_f * scale of f's weight group.  ->
    (N, Mp)."""
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (K4L_FACTOR_BLOCKS,
                                                              K4L_STAGES)
    from tmac_tpu_torch.utils import fma_f32
    Kp, gs = qt.kdim_padded, qt.group_size
    assert (ags or gs) == 16
    Gf, per, G, ntiles, fu = Kp // 16, gs // 16, Kp // gs, Kp // 32, 4
    parts = group_dots_plain(codes, qt, ags).float()
    assert parts.shape[0] == Gf
    scales, sub = qt.scales.float(), qt.sub.float()
    slots = [None] * K4L_FACTOR_BLOCKS

    def issue(t):
        if t < ntiles and t % (fu // 2) == 0:
            b = t // (fu // 2)
            slots[b % K4L_FACTOR_BLOCKS] = (t, {f: (xs[:, f].clone(), scales[f // per].clone())
                                                for f in range(fu * b, min(fu * b + fu, Gf))})

    def read(f, t):
        t0, block = slots[(f // fu) % K4L_FACTOR_BLOCKS]
        assert t0 <= t, (f, t0, t)
        row, col = block[f]
        return row[:, None] * col[None, :]
    for t in range(K4L_STAGES - 1):
        issue(t)
    acc = None
    for t in range(ntiles):
        issue(t + K4L_STAGES - 1)
        for h in range(2):
            f = 2 * t + h
            if f == 0:
                acc = parts[0]
            elif f == 1:
                acc = fma_f32(acc, read(0, t), parts[1] * read(1, t))
            else:
                acc = fma_f32(parts[f], read(f, t), acc)
    z = torch.zeros_like(acc)
    for g in range(G):
        z = fma_f32(xsum[:, g:g + 1].expand_as(z), sub[g].expand_as(z), z)
    return acc - z


@pytest.mark.parametrize("bits,gs,ags,f32", [
    (2, 16, 0, True), (3, 16, 0, True), (1, 16, 0, False), (4, 16, 0, False),
    (8, 16, 0, True), (2, 128, 16, False), (4, 32, 16, True)])
def test_k4l_u16_form_matches_the_plain_version(bits, gs, ags, f32):
    """K4L at 16-k fold units (gs 16: Q2_K, Q3_K; bits 8 at gs 16; ags 16
    on a g128 and an f32 gs 32 tensor), modelled by _k4l_u16, gives the
    plain version's outputs bit for bit, at 64 and 88 rows (the route's
    chunk rows below 3 * 16 take K5, so K4L runs here with dispatch
    "chunk"); k4l_kt takes KT = 32 for it."""
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import k4l_kt
    rng = np.random.default_rng(bits * 100 + gs + ags)
    K = 1024 if bits in (1, 3) else 512
    qt, _ = _pair(rng, bits, K, (128,), gs, f32)
    assert k4l_kt(bits, gs, ags, qt.scales.element_size()) == 32
    for N in (64, 88):
        x = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(torch.bfloat16)
        codes, xs, xsum = act_quant_grouped_plain(x, qt, ags=ags)
        got = _k4l_u16(codes, xs, xsum, qt, ags)
        want = qgemm_grouped_plain(x, qt, act_gs=ags)
        assert torch.equal(got, want), N
