"""The forms of ``qgemm_pallas`` whose activations reach the kernel from
outside (``act`` "int8", "auto" or "native"; ``ops.qgemm.form``): E1 (int8
x, one scale row: K1 / K3), E2 (int8 activations per group: K4 / K4L), E3
(float dots on bf16 x: K4's native kernel / K4L's native instance) and E4
(float x at the dequant dot: K5).

Each plain version against the JAX package's ``qgemm_pallas(...,
interpret=True, act=...)`` compiled as a model runs it (inside jit): E1 and
E2 bit for bit, E3 and E4 within a stated NMSE (E4 at bits 8 against JAX's
XLA route, since its interpret-mode dequant reads bits-8 codes unsigned:
ROADMAP.md Queue 3).  Then Python models of what the CUDA forms add: K4L's
native fragment map (the m16n8k16 bf16 registers and their permuted k), K4's
native kernel's walk of the fold chunks, and ``as_grouped`` (one scale row
as the grouped kernels' tensor), each against the plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops.pallas.qgemm_kernel import qgemm_pallas
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu.ops.qgemm import qgemm_xla
from tmac_tpu_torch.ops.cuda import qgemm_grouped_kernel as gk
from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (
    as_grouped, dequant_ext_plain, external_int8, fold_chunk, fold_plain,
    grouped_ext_plain, native_bound, native_parts_plain, native_plain,
    native_sums, qgemm_dequant_ext, qgemm_grouped_ext, qgemm_native)
from tmac_tpu_torch.ops.cuda.qgemm_kernel import int8_x_plain, qgemm_int8_x
from tmac_tpu_torch.ops.qgemm import (QuantizedTensor, form, kernel_for, pad_x_for,
                                      qgemm, route, unpack_codes)
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

K, M = 512, 256
# E3 and E4 against the reference: its own float dots (or bf16 dequant dot)
# sum in another order; measured NMSE at these shapes ~1e-14 (E3) and
# ~1e-6 (E4's bf16 weights are the same bytes, the f32 sums differ)
NATIVE_NMSE, DEQUANT_NMSE = 1e-10, 1e-5


def _pair(rng, bits, K, M, gs, f32=False, zero_point=True):
    """The same weights as a port and a JAX QuantizedTensor: random codes,
    positive scales, zero points on the code grid (or none); bf16 scales, or
    f32 ones off any grid.  gs = K: one scale row (f32, as the packing
    stores per-tensor scales)."""
    qmax = (1 << bits) - 1
    G = K // gs
    wq = rng.integers(0, qmax + 1, (K, M)).astype(np.uint8)
    sc = ((0.5 + rng.random((G, M))) * 0.05).astype(np.float32)
    sub = (sc * rng.integers(0, qmax + 1, (G, M)) if zero_point
           else np.zeros((G, M))).astype(np.float32)
    if f32:
        sub = (sub * (1 + 1e-3 * rng.random((G, M)))).astype(np.float32)
    if G == 1:
        return (QuantizedTensor.from_quantized(wq, sc, sub, bits, K, device="cpu"),
                JQT.from_quantized(wq, sc, sub, bits, K))
    sdt, jsdt = (torch.float32, jnp.float32) if f32 else (torch.bfloat16, jnp.bfloat16)
    return (QuantizedTensor.from_quantized(wq, sc, sub, bits, gs, scale_dtype=sdt,
                                           device="cpu"),
            JQT.from_quantized(wq, sc, sub, bits, gs, scale_dtype=jsdt))


def _pallas(x, jqt, act, dispatch=None, ags=0, residual=None):
    def f(x, q, r):
        return qgemm_pallas(x, q, out_dtype=jnp.float32, interpret=True, act=act,
                            dispatch=dispatch, act_group_size=ags, residual=r)
    return np.asarray(jax.jit(f)(x, jqt, residual))


def _x(rng, N, K, dtype):
    x = rng.standard_normal((N, K)).astype(np.float32)
    if dtype == "int8":
        x = rng.integers(-127, 128, (N, K)).astype(np.int8)
        return x, torch.from_numpy(x)
    if dtype == "f32":
        return x, torch.from_numpy(x)
    return jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)


# ---------------------------------------------------------------------------
# E1: int8 x, one scale row
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [1, 4, 63, 64, 100])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_e1_int8_x_matches_pallas(bits, N):
    """int8 x with one scale row (zero points on and off): the exact int32
    dot and fma(acc, scale, -(xsum * sub)), bit for bit, on the K1 route
    below 64 rows and the K3 route from 64."""
    rng = np.random.default_rng(bits * 100 + N)
    qt, jqt = _pair(rng, bits, K, M, K, zero_point=N % 2 == 0)
    xj, xt = _x(rng, N, K, "int8")
    want = _pallas(jnp.asarray(xj), jqt, "auto")
    assert form(qt, N, "auto", True) == "E1"
    assert route(qt, N, act="int8", x_int8=True) == ("K3" if N >= 64 else "K1")
    got = qgemm(xt, qt, out_dtype=torch.float32, act="auto")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(int8_x_plain(xt, qt).numpy(), want)


def test_e1_residual_and_padding_match_pallas():
    """A residual in the epilogue, and a K the packing pads (1000)."""
    rng = np.random.default_rng(7)
    qt, jqt = _pair(rng, 2, 1000, M, 1000)
    xj, xt = _x(rng, 5, 1000, "int8")
    r = rng.standard_normal((5, M)).astype(np.float32)
    want = _pallas(jnp.asarray(xj), jqt, "int8", residual=jnp.asarray(r, jnp.bfloat16))
    got = qgemm(xt, qt, out_dtype=torch.float32,
                residual=torch.from_numpy(r).to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# E2: int8 activations per group from outside
# ---------------------------------------------------------------------------

# (bits, gs, f32 scales, N, act, x dtype, zero point)
E2_CASES = [
    (2, 128, False, 1, "auto", "bf16", True), (2, 128, False, 63, "int8", "bf16", False),
    (2, 128, True, 64, "auto", "bf16", True), (4, 128, False, 100, "auto", "bf16", True),
    (4, 128, False, 384, "int8", "bf16", True), (1, 32, False, 4, "auto", "bf16", True),
    (3, 32, True, 64, "int8", "bf16", True), (3, 16, False, 1, "int8", "bf16", True),
    (8, 32, True, 1, "auto", "bf16", True), (8, 128, False, 100, "int8", "bf16", True),
    (4, 16, True, 4, "auto", "bf16", True), (2, 16, False, 100, "int8", "bf16", True),
    (2, 128, False, 4, "int8", "f32", True), (4, 32, True, 64, "auto", "f32", True),
    # int8 x with grouped scales: no activation scale (the float-fold branch)
    (2, 128, False, 1, "auto", "int8", True), (4, 32, False, 64, "native", "int8", True),
    (8, 128, True, 100, "int8", "int8", True), (3, 128, False, 63, "auto", "int8", True),
]


@pytest.mark.parametrize("bits,gs,f32,N,act,xdt,zp", E2_CASES)
def test_e2_matches_pallas(bits, gs, f32, N, act, xdt, zp):
    """Per-group int8 activations from outside (the XLA prologue's codes,
    scales and sums, or int8 x as given), the int8 group dots and the f32
    fold, bit for bit, on the K4 route below 64 rows and K4L from 64."""
    rng = np.random.default_rng(bits * 1000 + gs + N)
    qt, jqt = _pair(rng, bits, K, M, gs, f32, zp)
    xj, xt = _x(rng, N, K, xdt)
    assert form(qt, N, act, xdt == "int8") == "E2"
    assert route(qt, N, act=act, x_int8=xdt == "int8") == ("K4L" if N >= 64 else "K4")
    want = _pallas(jnp.asarray(xj), jqt, act)
    got = qgemm(xt, qt, out_dtype=torch.float32, act=act)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N", [1, 64])
@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_e2_one_scale_row_matches_pallas(bits, N):
    """act "int8" on float x with one scale row: the reference quantizes the
    row as one activation group, folds its p chunks with the one scale
    (bits 8: one chunk) and fuses its one zero-point term into the
    subtraction (one_row_zero_fold); bit for bit, and through as_grouped
    (the grouped kernels' tensor of those chunks, with xsum 0) bit for bit
    too where it applies."""
    rng = np.random.default_rng(bits + N)
    qt, jqt = _pair(rng, bits, K, M, K)
    xj, xt = _x(rng, N, K, "bf16")
    want = _pallas(xj, jqt, "int8")
    np.testing.assert_array_equal(grouped_ext_plain(xt, qt).numpy(), want)
    codes, xs, xsum = external_int8(xt, qt)
    if bits == 8:
        # one chunk: as_grouped leaves it to K4L's one-unit fold, whose
        # epilogue is fma(p, xs * scale, -fma(xsum, sub, 0))
        assert as_grouped(qt, xs, xsum)[0] is qt
        p = gk.group_dots_plain(codes, qt)[0].float()
        z = gk.fma_f32(xsum.expand_as(p), qt.sub.float()[0].expand_as(p), torch.zeros_like(p))
        model = gk.fma_f32(p, (xs[:, :1] * qt.scales.float()[0]).expand_as(p), -z)
        np.testing.assert_array_equal(qt.slice_m(model).numpy(), want)
        return
    qk, xs_g, xsum_g = as_grouped(qt, xs, torch.zeros_like(xsum))
    assert qk.scales.shape[0] == K // fold_chunk(K, bits, K) >= 2
    acc = fold_plain(gk.group_dots_plain(codes, qk), xs_g, xsum_g, qk)
    np.testing.assert_array_equal(
        qt.slice_m(gk.one_row_zero_fold(acc, xsum, qt)).numpy(), want)


@pytest.mark.parametrize("bits,ags,N", [(2, 32, 1), (2, 64, 100), (4, 32, 64), (1, 32, 4)])
def test_e2_act_group_size_matches_pallas(bits, ags, N):
    """act_group_size on the external route at every N: the weight groups'
    code sums in the XLA prologue's order (an FMA chain) below 64 rows too,
    where the fused route adds them otherwise; at the widths where the
    reference takes an ags (Kp / p = 128)."""
    Kw = {1: 1024, 2: 512, 4: 256}[bits]
    rng = np.random.default_rng(bits * 10 + ags + N)
    qt, jqt = _pair(rng, bits, Kw, M, 128)
    xj, xt = _x(rng, N, Kw, "bf16")
    want = _pallas(xj, jqt, "int8", ags=ags)
    got = qgemm(xt, qt, out_dtype=torch.float32, act="int8", act_group_size=ags)
    np.testing.assert_array_equal(got.numpy(), want)


def test_e2_residual_matches_pallas():
    rng = np.random.default_rng(11)
    qt, jqt = _pair(rng, 2, K, M, 128)
    xj, xt = _x(rng, 3, K, "bf16")
    r = rng.standard_normal((3, M)).astype(np.float32)
    want = _pallas(xj, jqt, "int8", residual=jnp.asarray(r, jnp.bfloat16))
    got = qgemm(xt, qt, out_dtype=torch.float32, act="int8",
                residual=torch.from_numpy(r).to(torch.bfloat16))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# E3: act="native"
# ---------------------------------------------------------------------------

# (bits, gs, f32 scales, N, zero point)
E3_CASES = [(1, 32, False, 1, True), (2, 128, False, 1, True), (2, 128, True, 64, False),
            (3, 32, False, 4, True), (3, 128, True, 100, True), (4, 16, True, 1, True),
            (4, 128, False, 384, True), (8, 32, True, 63, True), (8, 128, False, 64, True),
            (2, 16, False, 100, True), (2, K, False, 1, True), (4, K, False, 64, True),
            (8, K, False, 4, True)]


@pytest.mark.parametrize("bits,gs,f32,N,zp", E3_CASES)
def test_e3_native_matches_pallas(bits, gs, f32, N, zp):
    """Float dots on bf16 x, a fold chunk at a time (one scale row too),
    pinned to the chunk path at any N: within NATIVE_NMSE of the
    reference (only the order of its f32 sums differs: every product is
    exact), and within native_bound of it per output."""
    rng = np.random.default_rng(bits * 7 + gs + N)
    qt, jqt = _pair(rng, bits, K, M, gs, f32, zp)
    xj, xt = _x(rng, N, K, "bf16")
    assert form(qt, N, "native") == "E3"
    assert route(qt, N, act="native") == ("K4L" if N >= 64 else "K4")
    want = _pallas(xj, jqt, "native")
    got = qgemm(xt, qt, out_dtype=torch.float32, act="native").numpy()
    assert nmse(want, got) < NATIVE_NMSE, nmse(want, got)
    assert np.all(np.abs(got - want) <= 4 * native_bound(xt, qt).numpy() + 1e-30)


def test_e3_f32_x_and_dispatch_dequant():
    """f32 x at "native" in the plain version (the reference's f32 dots),
    and "native" with dispatch "dequant" from 64 grouped rows: the dequant
    dot (E4), as the reference's rule."""
    rng = np.random.default_rng(3)
    qt, jqt = _pair(rng, 2, K, M, 128)
    xj, xt = _x(rng, 4, K, "f32")
    want = _pallas(jnp.asarray(xj), jqt, "native")
    got = qgemm(xt, qt, out_dtype=torch.float32, act="native").numpy()
    assert nmse(want, got) < NATIVE_NMSE
    assert form(qt, 64, "native", dispatch="dequant") == "E4"
    assert form(qt, 63, "native", dispatch="dequant") == "E3"


# ---------------------------------------------------------------------------
# E4: float x at the dequant dot
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,gs,f32,N,dispatch", [
    (2, 128, False, 384, None), (4, 128, False, 512, None), (2, 32, True, 100, None),
    (3, 32, False, 96, None), (1, 128, False, 64, "dequant"), (4, 16, True, 64, None)])
def test_e4_dequant_dot_matches_pallas(bits, gs, f32, N, dispatch):
    """act "auto" from 64 grouped rows where the dispatch is "dequant"
    (N >= 3 * gs, or forced): x stays float, the weights dequantized to
    bf16 (the same bytes), one f32 dot: within DEQUANT_NMSE."""
    rng = np.random.default_rng(bits * 3 + gs + N)
    qt, jqt = _pair(rng, bits, K, M, gs, f32)
    xj, xt = _x(rng, N, K, "bf16")
    assert form(qt, N, "auto", dispatch=dispatch) == "E4"
    assert route(qt, N, dispatch, act="auto") == "K5"
    want = _pallas(xj, jqt, "auto", dispatch=dispatch)
    got = qgemm(xt, qt, out_dtype=torch.float32, dispatch=dispatch).numpy()
    assert nmse(want, got) < DEQUANT_NMSE, nmse(want, got)
    np.testing.assert_array_equal(dequant_ext_plain(xt, qt).numpy(), got)


@pytest.mark.parametrize("gs", [32, 128])
def test_e4_bits8_matches_the_xla_route(gs):
    """Grouped bits 8 at the dequant dot against the reference's XLA route
    (its interpret-mode dequant reads bits-8 codes unsigned)."""
    rng = np.random.default_rng(gs)
    qt, jqt = _pair(rng, 8, K, M, gs)
    xj, xt = _x(rng, 384, K, "bf16")
    assert form(qt, 384, "auto") == "E4"
    want = np.asarray(jax.jit(lambda x, q: qgemm_xla(x, q, jnp.float32))(xj, jqt))
    got = qgemm(xt, qt, out_dtype=torch.float32).numpy()
    assert nmse(want, got) < DEQUANT_NMSE, nmse(want, got)


# ---------------------------------------------------------------------------
# the rule and the wrappers
# ---------------------------------------------------------------------------

def test_form_follows_the_reference_rule():
    rng = np.random.default_rng(0)
    qt, _ = _pair(rng, 2, K, M, 128)
    pt, _ = _pair(rng, 2, K, M, K)
    assert form(qt, 1) == form(qt, 400) == "fused"
    assert [form(qt, N, "auto") for N in (1, 63, 64, 383, 384)] == \
        ["E2", "E2", "E2", "E2", "E4"]
    assert form(qt, 64, "auto", dispatch="dequant") == "E4"
    assert form(qt, 500, "auto", dispatch="chunk") == "E2"
    assert form(qt, 500, "int8") == "E2"            # "int8" always quantizes
    assert form(qt, 500, "native") == "E3"          # pinned to the chunk path
    assert form(pt, 500, "auto") == form(pt, 500, "int8") == "E2"
    assert form(pt, 1, "native") == "E3" and form(pt, 5, "auto", True) == "E1"
    assert form(qt, 5, "native", True) == "E2"
    with pytest.raises(ValueError, match="float activations"):
        form(qt, 5, "fused", True)
    with pytest.raises(ValueError, match="act must be"):
        form(qt, 5, "bf16")
    # the fused rule is unchanged
    assert [route(qt, N) for N in (1, 64, 384)] == ["K4", "K4L", "K5"]
    assert [route(pt, N) for N in (1, 64)] == ["K1", "K3"]


def test_wrappers_refuse_folds_and_other_devices():
    rng = np.random.default_rng(1)
    qt, _ = _pair(rng, 2, K, M, 128)
    pt, _ = _pair(rng, 2, K, M, K)
    x = torch.zeros((2, K), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="act='fused'"):
        qgemm(x, qt, act="int8", norm=(torch.ones(K), 1e-5))
    with pytest.raises(ValueError, match="act='fused'"):
        qgemm(torch.zeros((2, 2 * K)), qt, act="native", glu=True)
    for fn, q, xm in ((qgemm_int8_x, pt, x.to(torch.int8)), (qgemm_grouped_ext, qt, x),
                      (qgemm_native, qt, x), (qgemm_dequant_ext, qt, x)):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            fn(xm.to("meta"), q.to("meta"))
    with pytest.raises(ValueError, match="int8 x"):
        int8_x_plain(x, pt)
    # the E forms count their own launches; the CPU runs none
    assert qgemm_int8_x.launches == qgemm_grouped_ext.launches == 0
    assert qgemm_native.launches == qgemm_dequant_ext.launches == 0
    f = kernel_for(qt, 4, plain=True, act="auto", act_gs=64)
    assert f.func is gk.grouped_ext_plain and f.keywords == {"act_gs": 64}


# ---------------------------------------------------------------------------
# Python models of the CUDA forms
# ---------------------------------------------------------------------------

def test_k4l_native_fragment_map_is_the_tile_product():
    """K4L's native instance: for m16n8k16 bf16, thread (gq, tq) holds A
    registers a0 = (row gq, hardware k 2tq, 2tq + 1), a1 = (row gq + 8,
    same), a2 = (row gq, 2tq + 8, 2tq + 9), a3 = (row gq + 8, same), B
    registers b0 = (hardware k 2tq, 2tq + 1; column gq), b1 = (2tq + 8,
    2tq + 9), and the f32 C fragment c0, c1 = (row gq, column 2tq, 2tq + 1),
    c2, c3 = (row gq + 8, same).  The kernel gives thread tq logical k 4tq
    .. 4tq + 3: a0, a2 the two halves of 8 bytes of its A row, b0, b1 bytes
    0-1 and 2-3 of the int8 form's B word (4 consecutive k of one column,
    tile c's column 4 (wn / 4 + gq) + c).  Emulating the mma on those
    registers gives x @ codes of the 16 k for every (row, column) of the
    warp's tile, each (row, column) from one register slot."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 16))                          # 16 rows x 16 logical k
    w = rng.integers(-128, 128, (16, 128)).astype(np.float64)  # logical k x 128 columns
    wn = 32
    for c in range(4):
        D = np.zeros((16, 8))
        A = np.zeros((32, 4, 2)); B = np.zeros((32, 2, 2))
        for lane in range(32):
            gq, tq = lane >> 2, lane & 3
            col = 4 * (wn // 4 + gq) + c
            word = w[4 * tq:4 * tq + 4, col]                    # the B word's 4 bytes
            B[lane] = [word[0:2], word[2:4]]
            ra, rb = x[gq, 4 * tq:4 * tq + 4], x[gq + 8, 4 * tq:4 * tq + 4]
            A[lane] = [ra[0:2], rb[0:2], ra[2:4], rb[2:4]]
        # the hardware's product: D[r][n] = sum over hardware k of A[r][k] B[k][n]
        hwA, hwB = np.zeros((16, 16)), np.zeros((16, 8))
        for lane in range(32):
            gq, tq = lane >> 2, lane & 3
            for i in range(2):
                hwA[gq, 2 * tq + i], hwA[gq + 8, 2 * tq + i] = A[lane, 0, i], A[lane, 1, i]
                hwA[gq, 2 * tq + 8 + i], hwA[gq + 8, 2 * tq + 8 + i] = A[lane, 2, i], A[lane, 3, i]
                hwB[2 * tq + i, gq], hwB[2 * tq + 8 + i, gq] = B[lane, 0, i], B[lane, 1, i]
        D = hwA @ hwB
        seen = set()
        for lane in range(32):
            gq, tq = lane >> 2, lane & 3
            for e in range(4):
                r, n = gq + 8 * (e >> 1), 2 * tq + (e & 1)
                col = wn + 4 * n + c        # the epilogue's column of slot e
                assert (r, col) not in seen
                seen.add((r, col))
                assert D[r, n] == pytest.approx(float(x[r] @ w[:, col]), abs=1e-9)
        assert len(seen) == 16 * 8


def _k4_native_model(xt, qt):
    """k4_native_kernel's walk in Python: for each fold chunk in k order, 16
    k lanes (lane kl takes rows kl, kl + 16, ...) each sum x * code over its
    rows in f32, lanes 2w and 2w + 1 add (shuffle), then warps 0-7 in
    order; the owner folds acc with the chain; z over the groups."""
    xf = pad_x_for(xt.float(), qt)
    N, Kp = xf.shape
    ch = fold_chunk(Kp, qt.bits, qt.group_size)
    w = unpack_codes(qt).float()
    parts = []
    for c in range(Kp // ch):
        lanes = []
        for kl in range(16):
            s = torch.zeros((N, qt.mdim_padded))
            for i in range(kl, ch, 16):
                k = c * ch + i
                s = s + xf[:, k:k + 1] * w[k]
            lanes.append(s)
        warps = [lanes[2 * v] + lanes[2 * v + 1] for v in range(8)]
        p = warps[0]
        for v in range(1, 8):
            p = p + warps[v]
        parts.append(p)
    xsum = native_sums(xt, qt)
    return qt.slice_m(fold_plain(torch.stack(parts), torch.ones_like(xsum), xsum, qt))


@pytest.mark.parametrize("bits,gs", [(2, 128), (3, 32), (8, K), (4, 16)])
def test_k4_native_walk_is_within_the_bound(bits, gs):
    """The decode kernel's order of a chunk's sums against the plain
    version's: within native_bound (sqrt(chunk) * 2^-23 * sum |x * w|),
    the gate chip_smoke.py holds the card to; the fold chain is the same."""
    rng = np.random.default_rng(bits + gs)
    qt, _ = _pair(rng, bits, K, M, gs)
    _, xt = _x(rng, 3, K, "bf16")
    got = _k4_native_model(xt, qt)
    want = native_plain(xt, qt)
    assert torch.all((got - want).abs() <= native_bound(xt, qt))
    assert native_parts_plain(xt, qt).shape[0] == K // fold_chunk(K, bits, gs)


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_as_grouped_native_is_the_one_row_fold(bits):
    """E3 from 64 rows with one scale row goes to K4L as as_grouped's
    tensor: its fold (xs = 1, xsum then zeros) equals the one-row fold."""
    rng = np.random.default_rng(bits)
    qt, _ = _pair(rng, bits, K, M, K)
    _, xt = _x(rng, 64, K, "bf16")
    xsum = native_sums(xt, qt)
    qk, _, xsum_g = as_grouped(qt, None, xsum)
    parts = native_parts_plain(xt, qk)
    got = qt.slice_m(fold_plain(parts, torch.ones_like(xsum_g), xsum_g, qk))
    assert torch.equal(got, native_plain(xt, qt))
    assert torch.equal(dataclasses.replace(qk, scales=qk.scales[:1], sub=qk.sub[:1],
                                           group_size=K).scales, qt.scales)


# ---------------------------------------------------------------------------
# E3 on f32 x, and one scale row at bits 8 from 64 rows (E2, E3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,gs,N", [(2, 128, 1), (4, 32, 64), (1, 128, 256),
                                       (8, 32, 100), (3, 128, 63), (4, K, 64)])
def test_e3_f32_x_matches_pallas(bits, gs, N):
    """act "native" on f32 x (the reference's f32 dots, the kernels' f32-x
    instances): the plain version within NATIVE_NMSE of qgemm_pallas and,
    per output, within native_bound's f32 form of it."""
    rng = np.random.default_rng(bits * 11 + gs + N)
    qt, jqt = _pair(rng, bits, K, M, gs)
    xj, xt = _x(rng, N, K, "f32")
    want = _pallas(jnp.asarray(xj), jqt, "native")
    got = qgemm(xt, qt, out_dtype=torch.float32, act="native").numpy()
    assert nmse(want, got) < NATIVE_NMSE, nmse(want, got)
    assert np.all(np.abs(got - want) <= native_bound(xt, qt).numpy() + 1e-30)


def _k4_native_parts_f32(xt: torch.Tensor, qt) -> torch.Tensor:
    """A model of K4's native kernel on f32 x (csrc/qgemm_grouped.cu,
    k4_native_kernel): a fold chunk at a time, each of 16 k lanes adds its
    products k = lane, lane + 16, ... in one fma each, lanes 2w + 1 into
    2w, then the 8 warps in order.  -> the chunk sums (C, N, Mp) f32."""
    xf = pad_x_for(xt.float(), qt)
    N, Kp = xf.shape
    ch = fold_chunk(Kp, qt.bits, qt.group_size)
    w = unpack_codes(qt).float()
    out = []
    for c in range(Kp // ch):
        lanes = []
        for kl in range(16):
            part = torch.zeros((N, w.shape[1]))
            for k in range(c * ch + kl, (c + 1) * ch, 16):
                part = gk.fma_f32(xf[:, k:k + 1].expand_as(part), w[k].expand_as(part), part)
            lanes.append(part)
        p = lanes[0] + lanes[1]
        for wi in range(1, 8):
            p = p + (lanes[2 * wi] + lanes[2 * wi + 1])
        out.append(p)
    return torch.stack(out)


@pytest.mark.parametrize("bits,gs,N", [(2, 128, 1), (8, K, 64), (4, 16, 3), (3, 128, 70)])
def test_k4_native_f32_x_model_is_within_the_bound(bits, gs, N):
    """A model of K4's native kernel on f32 x (which takes f32 x at any N)
    against the plain version: within native_bound's f32 form, the gate
    chip_smoke.py holds the card to."""
    rng = np.random.default_rng(bits + gs + N)
    qt, _ = _pair(rng, bits, K, M, gs)
    _, xt = _x(rng, N, K, "f32")
    xsum = native_sums(xt, qt)
    got = qt.slice_m(fold_plain(_k4_native_parts_f32(xt, qt), torch.ones_like(xsum), xsum, qt))
    assert torch.all((got - native_plain(xt, qt)).abs() <= native_bound(xt, qt))


@pytest.mark.parametrize("N", [64, 256])
@pytest.mark.parametrize("act", ["int8", "native"])
def test_bits8_one_scale_row_from_64_rows_matches_pallas(act, N):
    """One scale row at bits 8 from 64 rows: the reference folds its one
    chunk (Kp / p = Kp) once; the plain versions (K4L's one-unit fold on
    the card) against qgemm_pallas: E2 bit for bit, E3 within NATIVE_NMSE
    and native_bound; the route is K4L."""
    rng = np.random.default_rng(N + len(act))
    qt, jqt = _pair(rng, 8, K, M, K)
    xj, xt = _x(rng, N, K, "bf16")
    assert route(qt, N, act=act) == "K4L" and qt.scales.shape[0] == 1
    assert fold_chunk(qt.kdim_padded, 8, qt.kdim_padded) == qt.kdim_padded
    want = _pallas(xj, jqt, act)
    got = qgemm(xt, qt, out_dtype=torch.float32, act=act).numpy()
    if act == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert nmse(want, got) < NATIVE_NMSE
        assert np.all(np.abs(got - want) <= 4 * native_bound(xt, qt).numpy() + 1e-30)
    assert as_grouped(qt, None, native_sums(xt, qt))[0] is qt


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("form,bits,gs,N,xdt", [
    ("E3", 2, 128, 1, "f32"), ("E3", 2, 128, 256, "f32"), ("E3", 8, K, 64, "f32"),
    ("E3", 8, K, 256, "bf16"), ("E2", 8, K, 64, "bf16"), ("E2", 8, K, 1, "bf16")])
def test_forms_match_plain_on_card(form, bits, gs, N, xdt):
    """On a card: E3 on f32 x and the bits-8 one-row forms against their
    plain versions (E2 bit for bit, E3 within native_bound)."""
    rng = np.random.default_rng(bits + N)
    qt = _pair(rng, bits, K, M, gs)[0].to("cuda")
    x = _x(rng, N, K, xdt)[1].cuda()
    if form == "E2":
        assert torch.equal(qgemm_grouped_ext(x, qt), grouped_ext_plain(x, qt))
    else:
        got, want = qgemm_native(x, qt), native_plain(x, qt)
        assert torch.all((got - want).abs() <= native_bound(x, qt))
