"""The decode matmul that K1 and K4 share below 64 rows
(csrc/decode_matmul.cuh): its static plan, the split of K over a cluster,
the lane and ring layout it reads the packed weights in, and the on-chip
group fold, each emulated in plain PyTorch and held to the plain versions
(and, for the split fold, to the JAX package's grouped Pallas qgemm)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops.pallas.qgemm_kernel import qgemm_pallas
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (
    act_quant_grouped_plain, block_partials_plain, fold_plain,
    fold_split_plain, group_dots_plain, qgemm_grouped_plain)
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (
    DECODE_MAX_SPLIT, DECODE_SMEM_LIMIT, act_quant_plain, decode_fields,
    decode_nt, decode_owner, decode_plan, decode_smem, decode_spans,
    decode_units, int_dot_plain, int_dot_split_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor

torch.set_num_threads(2)

# (N, Kp, Mp, bits, group size) of the paths' decode calls: BitNet-3B's
# per-tensor linears and int8 head, Llama-2-7B W2 and W4, Phi-3-mini and
# Mixtral-8x7B (attention and expert shapes), at decode and prompt rows;
# 22, 28 and 43 chunks split unevenly
PATH_SHAPES = [(n, *s) for n in (1, 4, 16, 63) for s in (
    (3200, 9600, 2, 0), (3200, 3200, 2, 0), (3200, 17280, 2, 0),
    (8704, 3200, 2, 0), (3200, 32000, 8, 0),
    (4096, 12288, 2, 128), (4096, 4096, 2, 128), (4096, 22016, 2, 128),
    (11264, 4096, 2, 128), (11008, 4096, 4, 128),
    (3072, 9216, 2, 128), (3072, 3072, 2, 128), (3072, 16384, 2, 128),
    (8192, 3072, 2, 128), (4096, 6144, 2, 128), (4096, 28672, 2, 128),
    (14336, 4096, 2, 128),
    # Llama-3.1-8B at bits 3 and 1, Qwen2-7B at bits 4
    (4096, 6144, 3, 128), (4096, 4096, 3, 128), (4096, 28672, 3, 128),
    (14336, 4096, 3, 128), (4096, 6144, 1, 128), (14336, 4096, 1, 128),
    (3584, 4608, 4, 128), (18944, 3584, 4, 128))]


@pytest.mark.parametrize("N,Kp,Mp,bits,gs", PATH_SHAPES)
def test_decode_plan_is_static_and_partitions_k(N, Kp, Mp, bits, gs):
    ksplit, nt = decode_plan(N, Kp, Mp, bits, gs)
    assert decode_plan(N, Kp, Mp, bits, gs) == (ksplit, nt)
    Kb, unit, nunits = decode_units(Kp, bits, gs)
    assert 1 <= ksplit <= min(DECODE_MAX_SPLIT, nunits)
    assert nt == decode_nt(N, bits) == (1 if N == 1 else 2 if bits in (1, 3) else 4)
    assert decode_smem(bits, nt, gs > 0, nunits, unit, ksplit,
                       Kp // gs if gs else 1) <= DECODE_SMEM_LIMIT
    if gs:
        assert Kb % gs == 0 and unit == gs
    # every cluster size partitions the units exactly, in rank order
    for k in range(1, DECODE_MAX_SPLIT + 1):
        spans = decode_spans(nunits, k)
        assert spans[0][0] == 0 and spans[-1][1] == nunits
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(u1 - u0 in (nunits // k, -(-nunits // k)) for u0, u1 in spans)
        owner = decode_owner(nunits, k)
        assert [spans[r][0] + lc for r, lc in owner] == list(range(nunits))


def _grouped(rng, bits, G, gs=32, M=128):
    K = G * gs
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    sc = ((0.5 + rng.random((G, M))) * 0.05).astype(np.float32)
    sub = sc * rng.integers(0, 1 << bits, (G, M)).astype(np.float32)
    return QuantizedTensor.from_quantized(wq, sc, sub, bits, gs,
                                          scale_dtype=torch.bfloat16, device="cpu")


# Llama-3.1-8B Q4_K's (gguf) linears: bits 4 at gs 32, f32 factors
GGUF_SHAPES = [(n, *s) for n in (1, 4, 16) for s in (
    (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))]


@pytest.mark.parametrize("N,Kp,Mp", GGUF_SHAPES)
def test_decode_plan_counts_f32_factors(N, Kp, Mp):
    """With f32 scales and sub the fold stages 4 bytes a factor: the plan
    fits the block's shared memory counting them, and where no cluster
    size fits at decode_nt's token rows (down, K 14336 at gs 32, 448
    groups) it takes one token row a block; bf16 factors at the same
    shapes keep their plan wherever it fitted."""
    ksplit, nt = decode_plan(N, Kp, Mp, 4, 32, scale_bytes=4)
    _, unit, nunits = decode_units(Kp, 4, 32)
    assert decode_smem(4, nt, True, nunits, unit, ksplit, Kp // 32,
                       scale_bytes=4) <= DECODE_SMEM_LIMIT
    assert nt == (decode_nt(N, 4) if N == 1 or Kp == 4096 else 1)
    assert decode_smem(4, nt, True, nunits, unit, ksplit, Kp // 32, scale_bytes=4) > \
        decode_smem(4, nt, True, nunits, unit, ksplit, Kp // 32)
    if Kp == 4096:
        assert decode_plan(N, Kp, Mp, 4, 32)[1] == decode_nt(N, 4)


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
@pytest.mark.parametrize("ksplit", range(1, DECODE_MAX_SPLIT + 1))
def test_split_fold_equals_fold_plain(ksplit, bits):
    """The on-chip fold: each block's per-group partials of its chunks,
    folded in group order through the owner map, give fold_plain's bytes,
    for every G from 2 to 88 the packing admits (chunks split unevenly
    and, past the chunk count, blocks left empty).  At bits 3 a chunk is
    gs rows of lo plane rows r and r + Kb and hi plane row r (its 8 slots
    the groups e * nchunks + c), so the split pairs each hi row with both
    lo rows that share it."""
    rng = np.random.default_rng(100 * bits + ksplit)
    P = decode_fields(bits)
    for G in range(P, 89, P):
        qt = _grouped(rng, bits, G)
        N = 2
        codes = torch.from_numpy(rng.integers(-127, 128, (N, qt.kdim_padded)).astype(np.int8))
        xs = torch.from_numpy((rng.random((N, G)) * 0.02 + 1e-3).astype(np.float32))
        xsum = torch.from_numpy(rng.standard_normal((N, G)).astype(np.float32))
        res = torch.from_numpy(rng.standard_normal((N, 128)).astype(np.float32)).to(torch.bfloat16)
        blocks = block_partials_plain(codes, qt, ksplit)
        want_parts = group_dots_plain(codes, qt)
        _, _, nchunks = decode_units(qt.kdim_padded, bits, qt.group_size)
        for g, (rank, lc) in enumerate(decode_owner(nchunks, ksplit) * P):
            assert torch.equal(blocks[rank][lc, g // nchunks], want_parts[g]), (G, g)
        got = fold_split_plain(blocks, xs, xsum, qt, ksplit, res)
        want = fold_plain(want_parts, xs, xsum, qt, res)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), G


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
def test_split_fold_matches_pallas(bits):
    """22 chunks (Llama-2-7B's down at bits 2 has 22) split over a
    cluster of 8 and folded on chip, emulated, against the JAX package's
    fused grouped Pallas qgemm (interpret mode) on the same weights and
    activations: bit for bit with the plain version, and within f32
    rounding of the reference (whose compiled fold is the plain version's
    order at a few groups, test_torch_qgemm_grouped.py, but not bit for bit
    at 88)."""
    rng = np.random.default_rng(bits)
    gs, M, N = 32, 128, 1
    G = 22 * decode_fields(bits)
    K = G * gs
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    sc = ((0.5 + rng.random((G, M))) * 0.05).astype(np.float32)
    sub = sc * rng.integers(0, 1 << bits, (G, M)).astype(np.float32)
    qt = QuantizedTensor.from_quantized(wq, sc, sub, bits, gs,
                                        scale_dtype=torch.bfloat16, device="cpu")
    jqt = JQT.from_quantized(wq, sc, sub, bits, gs, scale_dtype=jnp.bfloat16)
    assert decode_units(qt.kdim_padded, bits, gs)[2] == 22
    x = rng.standard_normal((N, K)).astype(np.float32)
    codes, xs, xsum = act_quant_grouped_plain(torch.from_numpy(x).to(torch.bfloat16), qt)
    got = fold_split_plain(block_partials_plain(codes, qt, 8), xs, xsum, qt, 8)
    want = np.asarray(jax.jit(lambda a, q: qgemm_pallas(
        a, q, out_dtype=jnp.float32, interpret=True, act="fused"))(
            jnp.asarray(x, jnp.bfloat16), jqt))
    assert torch.equal(got, qgemm_grouped_plain(torch.from_numpy(x).to(torch.bfloat16), qt))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


def _ternary(rng, bits, K, M):
    if bits == 8:
        w = (rng.standard_normal((K, M)) * 0.02).astype(np.float32)
        return QuantizedTensor.from_float(w, 8, K, device="cpu")
    wq = rng.integers(1, 4, (K, M)).astype(np.uint8)
    s = np.full((1, M), 1.0 / np.sqrt(K), np.float32)
    return QuantizedTensor.from_quantized(wq, s, 2 * s, 2, K, device="cpu")


@pytest.mark.parametrize("bits", [2, 8])
@pytest.mark.parametrize("ksplit", range(1, DECODE_MAX_SPLIT + 1))
def test_k1_split_sums_equal_int_dot(ksplit, bits):
    """K1's int32 sums as the decode matmul splits them (units of 32
    packed rows over the cluster, each field masked in place and shifted
    back, the blocks' sums added in rank order) equal int_dot_plain; K =
    1200 gives 75 (bits 2) or 1200 (bits 8) packed rows, split unevenly
    with a ragged last unit."""
    rng = np.random.default_rng(ksplit + bits)
    qt = _ternary(rng, bits, 1200, 256)
    x = torch.from_numpy(rng.standard_normal((3, 1200)).astype(np.float32))
    codes, _, _ = act_quant_plain(x, qt)
    assert torch.equal(int_dot_split_plain(codes, qt, ksplit), int_dot_plain(codes, qt))


def _transpose4(a, b, c, d):
    """tmac::transpose4 on four uint32 words: word i holds byte i of each."""
    ws = (a, b, c, d)
    return [sum(((int(w) >> (8 * i)) & 0xFF) << (8 * k) for k, w in enumerate(ws))
            for i in range(4)]


def _dp4a(a, b, c, a_unsigned):
    """dp4a of the 4 bytes of a (unsigned or signed) and b (signed), plus c."""
    def byte(w, i, signed):
        v = (int(w) >> (8 * i)) & 0xFF
        return v - 256 if signed and v >= 128 else v
    return c + sum(byte(a, i, not a_unsigned) * byte(b, i, True) for i in range(4))


def _b3_slot(e, lo1, lo2, hi):
    """tmac::decode::b3_slot on 32-bit words: slot e's 3-bit codes at bit
    t = min(2 * (e / 2), 4) of each byte."""
    j = e >> 1
    t = 2 * j if j < 2 else 4
    hs = t + 2 - e
    h = (hi << hs) & 0xFFFFFFFF if hs >= 0 else hi >> -hs
    lo = lo2 if e & 1 else lo1
    return ((lo >> (2 * j - t)) & (0x03030303 << t)) | (h & (0x04040404 << t)), t


@pytest.mark.parametrize("bits,gs", [(2, 0), (8, 0), (2, 32), (4, 32), (1, 32), (3, 32),
                                     (8, 32), (8, 16), (2, 16), (3, 16)])
def test_lane_reads_feed_the_matmul(bits, gs):
    """A model of decode_matmul's main loop for one block (ksplit 1, one
    128-column strip): stage t's packed rows land swizzled in the ring
    (16-byte chunk q of stage row i at chunk q ^ (i / 4) % 8); lane (rg, cw)
    of warp w reads 4 rows x 4 columns there, transposes them, masks field
    j in place and meets the natural-order code word of k = j * Kb + row;
    the shifted sums, added over the row groups, equal the plain dot per
    group (K4) or in all (K1).  At bits 3 a stage holds three planes (lo
    rows r and r + Kb, hi row r) and slot e's word is _b3_slot's, its
    codes assembled in place across the 32-bit word; at grouped bits 8
    the bytes are signed codes, met s8 x s8; at gs 16 a stage's rows hold
    two groups.  Also: the ring's reads hit each stored byte exactly
    once."""
    rng = np.random.default_rng(bits + gs)
    K, M = 256, 128
    if gs:
        qt = _grouped(rng, bits, K // gs, gs, M)
        codes = torch.from_numpy(rng.integers(-127, 128, (1, K)).astype(np.int8))
        want = group_dots_plain(codes, qt)[:, 0].numpy()
    else:
        qt = _ternary(rng, bits, K, M)
        codes, _, _ = act_quant_plain(torch.from_numpy(
            rng.standard_normal((1, K)).astype(np.float32)), qt)
        want = int_dot_plain(codes, qt)[0].numpy()[None]
    P = decode_fields(bits)
    Kb, unit, nunits = decode_units(K, bits, gs)
    pk = qt.packed.numpy()
    planes = [pk] if bits != 3 else [pk[:Kb], pk[Kb:], qt.packed_hi.numpy()]
    cw32 = codes.numpy().view(np.uint8)[0]
    mask = (1 << bits) - 1 if bits < 8 else 0xFF
    got = np.zeros_like(want, dtype=np.int64)
    seen = np.zeros((len(planes), Kb, M), np.int64)
    for t in range(-(-Kb // 32)):
        ring = np.zeros((len(planes), 32 * 128), np.uint8)
        for tid in range(256):            # one 16-byte copy a thread a plane
            i, q = tid >> 3, tid & 7
            if t * 32 + i < Kb:
                for p, plane in enumerate(planes):
                    ring[p, i * 128 + ((q ^ (i >> 2)) & 7) * 16:][:16] = \
                        plane[t * 32 + i, q * 16:q * 16 + 16]
        for warp in range(8):
            for lane in range(32):
                rg, cw = lane >> 2, lane & 3
                base = 4 * rg * 128 + ((warp ^ rg) & 7) * 16 + 4 * cw
                cols = [_transpose4(*[int.from_bytes(ring[p, base + r * 128:base + r * 128 + 4]
                                                     .tobytes(), "little") for r in range(4)])
                        for p in range(len(planes))]
                row = t * 32 + 4 * rg
                if row >= Kb:
                    continue
                for p in range(len(planes)):
                    for r in range(4):
                        seen[p, row + r, 16 * warp + 4 * cw:16 * warp + 4 * cw + 4] += 1
                for j in range(P):
                    k = j * Kb + row
                    xv = int.from_bytes(cw32[k:k + 4].tobytes(), "little")
                    g = k // gs if gs else 0
                    for c in range(4):
                        m = 16 * warp + 4 * cw + c
                        if bits == 3:
                            a, shift = _b3_slot(j, *(col[c] for col in cols))
                        elif bits < 8:
                            a = cols[0][c] & ((mask << (bits * j)) * 0x01010101)
                            shift = bits * j
                        else:
                            a, shift = cols[0][c], 0
                        got[g, m] += _dp4a(a, xv, 0, bits < 8) >> shift
    assert (seen == 1).all()
    np.testing.assert_array_equal(got, want)


def _flush_model(acc, P, half, blk, nblk, nchunks, shift):
    """decode_matmul.cuh's grouped flush for one token row and one column
    word of a warp: acc[rg] the (P, 4) int sums of row group rg's lane
    (field j, column c, times 2^shift(j)); each lane's PH * 4 values of a
    pass go through the exchange buffer (value e = 4 q + c of a lane is
    field pass * PH + q); lane rg then adds values e = rg * H .. +H over
    the 8 row groups (only row groups with rg * H < E: bits 8's E = 4), or
    with `half` values e = (rg % 4) * PH .. +PH of unit blk + rg / 4 over
    the 4 row groups of its half, stored if that unit is one of the
    block's nblk.  -> {(slot, c): value}, slot as part_s's (nchunks: a
    cluster of one's layout), asserting each is stored once."""
    PH = min(P, 4)
    E = PH * 4
    H = E // 8 if E >= 8 else 1
    out = {}
    for pass_ in range(P // PH):
        xbuf = [[acc[src][pass_ * PH + e // 4][e % 4] for e in range(E)] for src in range(8)]
        for rg in range(8):
            if half:
                u, q = rg >> 2, rg & 3
                if blk + u >= nblk:
                    continue
                es, srcs, unit = [q * PH + i for i in range(PH)], range(4 * u, 4 * u + 4), blk + u
            else:
                if rg * H >= E:
                    continue
                es, srcs, unit = [rg * H + i for i in range(H)], range(8), blk
            for e in es:
                j, c = pass_ * PH + e // 4, e % 4
                slot = j * nchunks + unit if nchunks else unit * P + j
                assert (slot, c) not in out
                out[(slot, c)] = sum(xbuf[src][e] for src in srcs) >> shift(j)
    return out


@pytest.mark.parametrize("bits,unit", [(b, u) for b in (1, 2, 3, 4, 8) for u in (16, 32)])
@pytest.mark.parametrize("ksplit", [1, 3, 8])
def test_half_stage_flush_stores_the_block_partials(bits, unit, ksplit):
    """The grouped decode matmul's flush at 16-row units (half a ring
    stage: row groups 0-3 hold the first unit's rows, 4-7 the second's, a
    block's last stage possibly half empty) and at 32, its bits-8 lanes
    (E = 4 values, row groups 0-3 store them): each block's lanes' dp4a
    sums (rows 4 rg .. +3 of each stage, slot j's weights formed in place)
    through _flush_model give every partial of its units exactly once,
    equal to block_partials_plain's, for cluster sizes that leave blocks
    an odd unit count (Kp 1536 at bits 8, 96 units of 16: 32, 32, 32 at 3;
    12 at 8)."""
    from tmac_tpu_torch.ops.cuda.qgemm_kernel import decode_slot_weights
    rng = np.random.default_rng(bits * 10 + unit + ksplit)
    P = decode_fields(bits)
    Kp = 1536 if bits == 8 else 256 * P * (2 if bits in (1, 3) else 1)
    qt = _grouped(rng, bits, Kp // unit, unit, 128)
    Kb, _, nunits = decode_units(Kp, bits, unit)
    codes = torch.from_numpy(rng.integers(-127, 128, (2, Kp)).astype(np.int8))
    c = codes.long()
    slots = [decode_slot_weights(qt, 0, Kb, j) for j in range(P)]
    shifts = [sh for _, sh in slots]
    blocks = block_partials_plain(codes, qt, ksplit)
    for rank, (u0, u1) in enumerate(decode_spans(nunits, ksplit)):
        if u1 == u0:
            continue
        r0, r1 = u0 * unit, min(u1 * unit, Kb)
        spu, upf = max(unit // 32, 1), 2 if unit < 32 else 1
        nst = -(-(r1 - r0) // 32)
        got = torch.zeros_like(blocks[rank].long())
        for t0 in range(0, nst, spu):
            acc = torch.zeros((8, 2, P, 128), dtype=torch.long)   # (rg, n, j, m)
            for t in range(t0, min(t0 + spu, nst)):
                for rg in range(8):
                    rows = [r for r in range(r0 + 32 * t + 4 * rg, r0 + 32 * t + 4 * rg + 4)
                            if r < r1]
                    for j in range(P):
                        acc[rg, :, j] += c[:, [j * Kb + r for r in rows]] @ slots[j][0][rows]
            blk = t0 // spu * upf
            for n in range(2):
                for word in range(32):
                    lanes = acc[:, n, :, 4 * word:4 * word + 4].tolist()
                    nch = nunits if ksplit == 1 else 0   # a cluster of one's layout
                    out = _flush_model(lanes, P, upf == 2, blk, u1 - u0,
                                       nch, lambda j: shifts[j])
                    for (slot, cc), v in out.items():
                        u, j = (slot % nch, slot // nch) if nch else divmod(slot, P)
                        got[u, j, n, 4 * word + cc] = v
            assert len(out) == (min(upf, u1 - u0 - blk)) * P * 4
        assert torch.equal(got, blocks[rank].long()), rank


# Llama-3.1-8B Q2_K's (gguf) linears: bits 2 at gs 16, f32 factors
Q2K_SHAPES = [(n, *s) for n in (1, 4, 16) for s in (
    (4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096))]


@pytest.mark.parametrize("N,Kp,Mp", Q2K_SHAPES)
def test_decode_plan_streams_factors_only_where_none_fit(N, Kp, Mp):
    """At gs 16 with f32 factors (Q2_K) every group's scale and zero point
    of a block's slice can pass its shared memory (K 14336: 896 groups); the
    plan then takes a block that streams them through two slots of equal
    windows (decode_windows, decode_matmul.cuh's Layout), which fits; where
    a block staging them all fits, the plan is that one (every earlier
    form's plan is unchanged: stream=False gives the same bytes)."""
    from tmac_tpu_torch.ops.cuda.qgemm_kernel import decode_windows
    ksplit, nt = decode_plan(N, Kp, Mp, 2, 16, scale_bytes=4)
    _, unit, nunits = decode_units(Kp, 2, 16)
    G = Kp // 16
    smem = decode_smem(2, nt, True, nunits, unit, ksplit, G, scale_bytes=4)
    staged = decode_smem(2, nt, True, nunits, unit, ksplit, G, scale_bytes=4, stream=False)
    assert smem <= DECODE_SMEM_LIMIT
    assert (smem == staged) == (staged <= DECODE_SMEM_LIMIT) == (Kp != 14336)
    # down's 896 groups at a cluster of 8 (a 16-column slice, 128 bytes of
    # f32 factors a group) beside 120 KB before the factors and 27 KB after:
    # 320 groups fit a slot, so three windows of 299
    assert decode_windows(120 * 1024, 27 * 1024, 896, 16, 4) == (299, 2)
    assert decode_windows(120 * 1024, 27 * 1024, 100, 16, 4) == (100, 1)
    for n, k, m, bits, gs in PATH_SHAPES:     # every earlier form: staged, as before
        ks, t = decode_plan(n, k, m, bits, gs)
        _, u, nu = decode_units(k, bits, gs)
        assert decode_smem(bits, t, gs > 0, nu, u, ks, k // gs if gs else 1,
                           stream=False) <= DECODE_SMEM_LIMIT


@pytest.mark.parametrize("G,fwin", [(896, 299), (896, 128), (10, 3), (7, 7)])
def test_factor_windows_land_before_their_fold(G, fwin):
    """The fold's factor windows as decode_matmul.cuh issues them: windows
    0 and 1 with the first stage's copies (complete after the main loop's
    last wait), window w + 2 into slot w % 2 after the barrier that ends
    window w's fold, one commit group each (empty past the last window);
    window w >= 2 is read after cp.async.wait_group 1 and a barrier.  Each
    window's reads find its own groups in its slot, and the chain visits
    the groups in order."""
    nwin = -(-G // fwin)
    slot = {0: 0, 1: 1 if nwin > 1 else None}
    groups = []          # commit groups issued in the fold: window or None
    done = 0             # groups complete
    visited = []
    for wi in range(nwin):
        if wi >= 2:
            done = max(done, len(groups) - 1)          # wait_group 1
            assert wi in groups[:done]
        assert slot[wi % 2] == wi
        visited += range(wi * fwin, min(G, wi * fwin + fwin))
        if nwin > 2:
            # the barrier: every thread has left window wi's slot
            groups.append(wi + 2 if wi + 2 < nwin else None)
            if wi + 2 < nwin:
                slot[wi % 2] = wi + 2
    assert visited == list(range(G))
