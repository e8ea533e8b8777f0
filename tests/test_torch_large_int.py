"""K3 (qgemm_large_int: per-token int8 codes x packed 1- to 4- or 8-bit
weights with one scale row from 64 rows, wgmma s8 on Hopper) on the CPU,
where its kernel cannot run:
a byte-level model of the kernel's unpack into the K-major, 128-byte
swizzled B tile wgmma reads, an emulation of its tiles, steps and split
of K against int_dot_plain, large_plan's partition and refusals, the split's
int32 partials through the unchanged epilogue against qgemm_fused_plain,
and the plain version against the JAX package's single-dot Pallas route
(interpret mode)."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops.pallas.qgemm_kernel import qgemm_pallas
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (
    LARGE_MAX_SPLIT, LARGE_STEP, LARGE_TILES, act_quant_plain, check_large,
    decode_fields, dp4a_order, int_dot_plain, large_epilogue_plain, large_partials_plain,
    large_plan, large_smem, large_spans, large_steps, qgemm_fused_plain,
    qgemm_large_int)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, unpack_codes
from tmac_tpu_torch.utils import cdiv, nmse

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# a byte-level model of k3_wgmma_kernel's unpack (csrc/qgemm_large.cu)
# ---------------------------------------------------------------------------

def _bytes(w):
    return [(w >> (8 * i)) & 0xFF for i in range(4)]


def _word(bs):
    return sum(b << (8 * i) for i, b in enumerate(bs))


def _transpose4(a, b, c, d):
    """tmac::transpose4: word i holds byte i of a, b, c, d."""
    rows = [_bytes(x) for x in (a, b, c, d)]
    return [_word([r[i] for r in rows]) for i in range(4)]


def _byte_perm(a, b, sel):
    """__byte_perm(a, b, sel): byte i of the result is byte (sel >> 4i) & 7
    of b:a."""
    bs = _bytes(a) + _bytes(b)
    return _word([bs[(sel >> (4 * i)) & 7] for i in range(4)])


def _rotate(w, rot):
    """__byte_perm(w, 0, sel): byte i of the result is byte (i + rot) % 4."""
    b = _bytes(w)
    return _word([b[(i + rot) & 3] for i in range(4)])


def b_offset(m, c):
    """Where column m's 16-byte chunk c (k' 16c .. 16c + 15) sits in the B
    tile: rows of 128 bytes, chunks XOR-swizzled by m % 8."""
    return m * 128 + ((c ^ (m & 7)) << 4)


def _slots(x, mask, shifts):
    """Word t4 of the result: byte i is (byte t4 of x >> shifts[i]) & mask
    (a transpose4 of the shifted, masked words)."""
    return _transpose4(*((x >> s) & mask for s in shifts))


def unpack_step(raw, bits, bn, threads):
    """The kernel's unpack of one step's packed tile raw (rows, bn) uint8
    (bits 3: lo rows r, lo rows r + Kp/8 and hi rows r, 16 each) by
    `threads` compute threads -> (the B tile's bytes, how often each
    16-byte chunk was written, the stores by (warp, unit, t4): [(lane,
    byte offset)])."""
    rows = LARGE_STEP // decode_fields(bits)   # a plane's rows of the step
    rpc = rows // 8                            # a plane's rows of a unit
    kwords = rpc * (3 if bits == 3 else 1)
    tile = np.zeros(bn * 128, np.uint8)
    hits = np.zeros(bn * 8, np.int64)
    stores = {}
    words = raw.reshape(raw.shape[0], -1, 4).astype(np.int64)
    words = words[..., 0] | words[..., 1] << 8 | words[..., 2] << 16 | words[..., 3] << 24
    for tid in range(threads):
        lane = tid & 31
        rot = (lane >> 1) & 3
        for k in range(8 * (bn // 4) // threads):
            u = tid + threads * k
            q, c = u % (bn // 4), u // (bn // 4)
            w = [_rotate(int(words[(i // rpc) * rows + rpc * c + i % rpc, q]), rot)
                 for i in range(kwords)]
            if bits in (1, 3):
                o = [[0] * 4 for _ in range(4)]
                for i in range(2):
                    if bits == 1:
                        lo = _slots(w[i], 0x01010101, range(4))
                        hi = _slots(w[i], 0x01010101, range(4, 8))
                    else:
                        x0, x1, h = w[i], w[2 + i], w[4 + i]

                        def slot(e):
                            return ((((x1 if e % 2 else x0) >> (2 * (e // 2))) & 0x03030303)
                                    | (((h >> e) & 0x01010101) << 2))
                        lo = _transpose4(*(slot(e) for e in range(4)))
                        hi = _transpose4(*(slot(e) for e in range(4, 8)))
                    for t4 in range(4):
                        o[t4][2 * i], o[t4][2 * i + 1] = lo[t4], hi[t4]
            elif bits == 4:
                o = [[0] * 4 for _ in range(4)]
                for g in range(2):
                    for t4, col in enumerate(_transpose4(*w[4 * g:4 * g + 4])):
                        lo, hi = col & 0x0F0F0F0F, (col >> 4) & 0x0F0F0F0F
                        o[t4][2 * g] = _byte_perm(lo, hi, 0x5140)
                        o[t4][2 * g + 1] = _byte_perm(lo, hi, 0x7362)
            elif bits == 2:
                o = [_transpose4(x & 0x03030303, (x >> 2) & 0x03030303,
                                 (x >> 4) & 0x03030303, (x >> 6) & 0x03030303)
                     for x in _transpose4(*w)]
            else:
                cols = [_transpose4(*w[4 * g:4 * g + 4]) for g in range(4)]
                o = [[cols[g][t4] for g in range(4)] for t4 in range(4)]
            for t4 in range(4):
                m = 4 * q + ((t4 + rot) & 3)
                off = b_offset(m, c)
                tile[off:off + 16] = np.frombuffer(np.array(o[t4], "<u4").tobytes(), np.uint8)
                hits[off // 16] += 1
                stores.setdefault((tid >> 5, k, t4), []).append((lane, off))
    return tile, hits, stores


def read_b(tile, bn):
    """The B tile as wgmma reads it through its 128-byte-swizzle
    descriptor: (128 k', bn columns) int8."""
    kp = np.arange(LARGE_STEP)
    m = np.arange(bn)[None, :]
    off = m * 128 + (((kp[:, None] // 16) ^ (m & 7)) << 4) + kp[:, None] % 16
    return tile[off].view(np.int8)


def _weights(rng, bits, K, M):
    if bits in (1, 3, 4):   # per channel, with zero points
        wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
        s = ((0.5 + rng.random((1, M))) / np.sqrt(K)).astype(np.float32)
        return wq, s, s * rng.integers(0, 1 << bits, (1, M)).astype(np.float32)
    if bits == 2:
        wq = rng.integers(0, 4, (K, M)).astype(np.uint8)
        s = np.full((1, M), 1.0 / np.sqrt(K), np.float32)
        return wq, s, 2 * s
    wq = rng.integers(0, 256, (K, M)).astype(np.uint8)
    s = (0.5 + rng.random((1, M))).astype(np.float32) / 64
    return wq, s, 128 * s


def _pair(rng, bits, K, M):
    wq, s, sub = _weights(rng, bits, K, M)
    return (QuantizedTensor.from_quantized(wq, s, sub, bits, K, device="cpu"),
            JQT.from_quantized(wq, s, sub, bits, K))


def _tiles(bits):
    return [t for t in LARGE_TILES if bits == 2 or t[1] == 128]


def _step_codes(raw, bits):
    """The weight code of each k' (rows of the result) of a step's packed
    tile raw, as the prologue's order k' = F r + j pairs them."""
    kp = np.arange(LARGE_STEP)[:, None]
    F = decode_fields(bits)
    r, j = kp[:, 0] // F, kp % F
    if bits == 3:   # slot j: field j // 2 of lo row r (+ Kp/8 for odd j), bit j of hi row r
        lo = (np.where(j % 2, raw[16 + r], raw[r]) >> (2 * (j // 2))) & 3
        return (lo + 4 * ((raw[32 + r] >> j) & 1)).astype(np.int8)
    if bits == 8:
        return raw.view(np.int8)
    return ((raw[r] >> (bits * j)) & ((1 << bits) - 1)).astype(np.int8)


@pytest.mark.parametrize("bits,tile", [(b, t) for b in (2, 8) for t in _tiles(b)]
                         + [(b, t) for b in (1, 3, 4) for t in _tiles(b)])
def test_unpack_lands_every_weight_once_in_the_swizzled_tile(bits, tile):
    """Every (k', m) of a step is written exactly once, where wgmma's
    descriptor reads it: field k' % F of packed row k' / F (the prologue's
    order, F the slots of a row: bits 3, field j // 2 of lo row r or r +
    Kp/8 plus 4 times bit j of hi row r); bits 8, code row k'.  Each
    quarter-warp's 8 lanes store to 8 distinct 16-byte bank groups."""
    bm, bn = tile
    threads = 128 * (1 if bm == 64 else 2)
    rng = np.random.default_rng(bits * 1000 + bm + bn)
    rows = LARGE_STEP // decode_fields(bits) * (3 if bits == 3 else 1)
    raw = rng.integers(0, 256, (rows, bn)).astype(np.uint8)
    tile_b, hits, stores = unpack_step(raw, bits, bn, threads)
    assert (hits == 1).all()
    got = read_b(tile_b, bn)
    want = _step_codes(raw, bits)
    np.testing.assert_array_equal(got, want)
    for lanes in stores.values():
        offs = dict(lanes)
        for qw in range(4):
            groups = {(offs[lane] % 128) // 16 for lane in range(8 * qw, 8 * qw + 8)}
            assert len(groups) == 8


def emulate_k3(codes, qt, bm, bn, ksplit):
    """K3's int32 sums (N, Mp) as its kernel forms them, on the CPU: for
    every block (column tile, token tile, rank) the steps of large_steps,
    each the codes' 128 x bm box and the packed box of the step (both
    zero past the ends, as TMA fills them) through the unpack model, the
    int dot of the two tiles, and the ranks' partials added."""
    N, Kp = codes.shape
    Mp, bits = qt.mdim_padded, qt.bits
    rows = LARGE_STEP // decode_fields(bits)
    nsteps = cdiv(Kp, LARGE_STEP)
    threads = 128 * (1 if bm == 64 else 2)
    pk = qt.packed.numpy()
    if bits == 3:   # a step's three boxes: lo rows r, lo rows r + Kp/8, hi rows r
        planes = [(pk, 0), (pk, Kp // 8), (qt.packed_hi.numpy(), 0)]
    else:
        planes = [(pk, 0)]
    c = np.zeros((cdiv(N, bm) * bm, nsteps * LARGE_STEP), np.int64)
    c[:N, :Kp] = codes.numpy()
    acc = np.zeros((cdiv(N, bm) * bm, cdiv(Mp, bn) * bn), np.int64)
    for tile in range(cdiv(Mp, bn)):
        m0 = tile * bn
        for rank in range(ksplit):
            for t in large_steps(nsteps, ksplit, rank, tile):
                raw = np.zeros((rows * len(planes), bn), np.uint8)
                for p, (plane, off) in enumerate(planes):
                    part = plane[off + t * rows:off + (t + 1) * rows, m0:m0 + bn]
                    raw[p * rows:p * rows + part.shape[0], :part.shape[1]] = part
                w = read_b(unpack_step(raw, bits, bn, threads)[0], bn).astype(np.int64)
                acc[:, m0:m0 + bn] += c[:, t * LARGE_STEP:(t + 1) * LARGE_STEP] @ w
    return acc[:N, :Mp]


@pytest.mark.parametrize("bits,tile,ksplit", [
    (2, (64, 128), 1), (2, (128, 128), 3), (2, (256, 128), 2), (2, (64, 256), 1),
    (2, (128, 256), 4), (8, (64, 128), 2), (8, (256, 128), 1), (8, (128, 128), 5)])
def test_emulated_tiles_give_the_exact_int_dot(bits, tile, ksplit):
    """The tiles, ragged last step and column tile, and the split's ranks
    together give int_dot_plain's exact sums on dp4a-order codes."""
    rng = np.random.default_rng(bits + tile[0] + tile[1] + ksplit)
    K, M, N = 624, 384, 70   # Kp 624: five steps, the last ragged
    qt, _ = _pair(rng, bits, K, M)
    nat = torch.from_numpy(rng.integers(-127, 128, (N, qt.kdim_padded)).astype(np.int8))
    got = emulate_k3(dp4a_order(nat, bits), qt, *tile, ksplit)
    np.testing.assert_array_equal(got, int_dot_plain(nat, qt).numpy())


@pytest.mark.parametrize("bits,tile,ksplit", [
    (1, (64, 128), 1), (1, (256, 128), 3), (3, (64, 128), 2), (3, (128, 128), 1),
    (3, (256, 128), 5), (4, (64, 128), 1), (4, (128, 128), 2), (4, (256, 128), 4)])
def test_emulated_tiles_give_the_exact_int_dot_per_channel(bits, tile, ksplit):
    """Bits 1, 3 and 4 with per-column zero points: K = 600 pads to 608 at
    bits 1 and 3 (4.75 steps: bits 3's last lo box of the first half runs
    into the second half, whose codes are past Kp, and its other boxes
    past their planes) and stays 600 at bits 4 (a ragged last step)."""
    rng = np.random.default_rng(bits + tile[0] + ksplit)
    K, M, N = 600, 384, 70
    qt, _ = _pair(rng, bits, K, M)
    assert qt.kdim_padded == (608 if bits in (1, 3) else 600)
    nat = torch.from_numpy(rng.integers(-127, 128, (N, qt.kdim_padded)).astype(np.int8))
    got = emulate_k3(dp4a_order(nat, bits), qt, *tile, ksplit)
    np.testing.assert_array_equal(got, int_dot_plain(nat, qt).numpy())


# ---------------------------------------------------------------------------
# large_plan
# ---------------------------------------------------------------------------

# BitNet-3B's five prefill shapes and Llama-2-7B's int8 head (K, Mp, bits)
PLAN_SHAPES = [(3200, 9600, 2), (3200, 3200, 2), (3200, 17280, 2), (8640, 3200, 2),
               (3200, 32128, 8), (4096, 32000, 8)]


@pytest.mark.parametrize("K,Mp,bits", PLAN_SHAPES)
@pytest.mark.parametrize("N", [64, 65, 255, 256, 1024, 1088])
def test_large_plan_walks_every_step_once(K, Mp, bits, N):
    """The plan's tile and cluster, and every cluster size it may be forced
    to: the ranks' walks cover every 128-k' step of K exactly once, for
    every column tile; the shared memory fits a block."""
    bm, bn, ksplit = large_plan(N, K, Mp, bits)
    assert (bm, bn) in LARGE_TILES and 1 <= ksplit <= LARGE_MAX_SPLIT
    assert large_plan(N, K, Mp, bits) == (bm, bn, ksplit)   # static
    nsteps = cdiv(K, LARGE_STEP)
    for ks in sorted({ksplit, 1, min(8, nsteps)}):
        check_large(N, K, Mp, bits, bm, bn, ks)
        for tile in range(cdiv(Mp, bn)):
            walked = [t for r in range(ks) for t in large_steps(nsteps, ks, r, tile)]
            assert sorted(walked) == list(range(nsteps))
        spans = large_spans(nsteps, ks)
        assert spans[0][0] == 0 and spans[-1][1] == nsteps
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert large_smem(bits, bm, bn)[2] <= 227 * 1024


@pytest.mark.parametrize("args,match", [
    ((256, 3200, 3200, 5), "bits 1 to 4 and 8"),
    ((63, 3200, 3200, 2), "N >= 64"),
    ((256, 3208 - 1, 3200, 2), "Kp % 16"),
    ((256, 3200, 3264, 2), "Mp % 128"),
])
def test_large_plan_refuses_what_k3_does_not_take(args, match):
    with pytest.raises(ValueError, match=match):
        large_plan(*args)


@pytest.mark.parametrize("tile,ksplit,bits,match", [
    ((256, 256), 1, 2, "tile of 256 x 256"),
    ((64, 256), 1, 8, "at bits 8"),
    ((256, 128), 0, 2, "a cluster of 0"),
    ((256, 128), 9, 2, "a cluster of 9"),
])
def test_forced_tiles_and_splits_are_checked(tile, ksplit, bits, match):
    with pytest.raises(ValueError, match=match):
        check_large(256, 3200, 3200, bits, *tile, ksplit)
    with pytest.raises(ValueError, match="a cluster of 8 along 1 steps"):
        check_large(256, 64, 256, 2, 256, 128, 8)


# ---------------------------------------------------------------------------
# the split's partials through the epilogue, against the plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,ksplit", [(2, 2), (2, 3), (2, 5), (2, 8), (8, 4), (8, 8)])
@pytest.mark.parametrize("residual", [False, True])
def test_split_partials_in_any_rank_order_match_the_plain_version(bits, ksplit, residual):
    """Integer sums are exact in any order: the ranks' int32 partials added
    in every order (ksplit <= 3) or in shuffled orders, through K3's
    epilogue, equal qgemm_fused_plain bit for bit."""
    rng = np.random.default_rng(10 * bits + ksplit + residual)
    K, M, N = 1152, 256, 65
    qt, _ = _pair(rng, bits, K, M)
    x = torch.from_numpy(rng.standard_normal((N, K)).astype(np.float32)).to(torch.bfloat16)
    res = (torch.from_numpy(rng.standard_normal((N, M)).astype(np.float32)).to(torch.bfloat16)
           if residual else None)
    want = qgemm_fused_plain(x, qt, residual=res)
    codes, xs, xsum = act_quant_plain(x, qt, large_n=True)
    parts = large_partials_plain(dp4a_order(codes, bits), qt, ksplit)
    assert len(parts) == ksplit
    orders = (list(itertools.permutations(range(ksplit))) if ksplit <= 3 else
              [list(range(ksplit))[::-1]] + [list(rng.permutation(ksplit)) for _ in range(4)])
    for order in orders:
        acc = torch.zeros_like(parts[0])
        for r in order:
            acc += parts[r]
        acc = acc.to(torch.int32)
        assert torch.equal(acc, int_dot_plain(codes, qt))
        got = qt.slice_m(large_epilogue_plain(acc, xs, xsum, qt, res))
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the plain version against the JAX package's single-dot route
# ---------------------------------------------------------------------------

def _pallas_fused(xb, jqt, norm=None, glu=False, residual=None):
    eps = None if norm is None else norm[1]

    def f(x, q, w, r):
        return qgemm_pallas(x, q, out_dtype=jnp.float32, interpret=True, act="fused",
                            glu=glu, residual=r, norm=None if w is None else (w, eps))
    return np.asarray(jax.jit(f)(xb, jqt, None if norm is None else norm[0], residual))


@pytest.mark.parametrize("bits,N,K,M,folds", [
    (2, 65, 384, 256, ""),
    (2, 130, 256, 384, "residual"),
    (2, 64, 384, 256, "norm"),
    (2, 96, 256, 256, "glu residual"),
    (8, 65, 256, 384, ""),
    (8, 128, 384, 256, "residual"),
])
def test_plain_matches_the_single_dot_route(bits, N, K, M, folds):
    """K3's plain version (what the kernel is held to on the card) against
    qgemm_pallas(act="fused") from 64 rows, compiled as the model runs it:
    bit for bit without the norm and glu folds, NMSE <= 1e-6 with them
    (XLA's CPU rsqrt and exp differ from IEEE ones by an ulp in some
    rows)."""
    rng = np.random.default_rng(bits * 100 + N + K + M)
    qt, jqt = _pair(rng, bits, K, M)
    glu = "glu" in folds
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if "norm" in folds:
        w = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        kw_j["norm"] = (jnp.asarray(w, jnp.bfloat16), 1e-6)
        kw_t["norm"] = (torch.from_numpy(w).to(torch.bfloat16), 1e-6)
    if glu:
        kw_j["glu"] = kw_t["glu"] = True
    if "residual" in folds:
        r = rng.standard_normal((N, M)).astype(np.float32)
        kw_j["residual"] = jnp.asarray(r, jnp.bfloat16)
        kw_t["residual"] = torch.from_numpy(r).to(torch.bfloat16)
    want = _pallas_fused(jnp.asarray(x, jnp.bfloat16), jqt, **kw_j)
    got = qgemm_large_int(torch.from_numpy(x).to(torch.bfloat16), qt, **kw_t).numpy()
    assert got.shape == want.shape == (N, M)
    if "norm" in folds or glu:
        assert nmse(want, got) <= 1e-6
    else:
        np.testing.assert_array_equal(got, want)
    # and the codes' int dot K3's partials add up to, in K3's order
    codes, _, _ = act_quant_plain(torch.from_numpy(x).to(torch.bfloat16), qt,
                                  **{k: v for k, v in kw_t.items() if k in ("norm", "glu")})
    w8 = unpack_codes(qt).long()
    assert torch.equal(sum(large_partials_plain(dp4a_order(codes, bits), qt, 3)),
                       codes.long() @ w8)
