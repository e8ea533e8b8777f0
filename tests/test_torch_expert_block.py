"""K7's k-expert form and K10's static plan, on the CPU.

K7 (ops/cuda/expert_kernel.py): qgemm_experts, the k routed experts of a
token in one call (gate_up on the shared row, down on each expert's own
rows, read in f32 and rounded to bf16 as the kernel reads them), held to
the JAX package's expert-indexed Pallas qgemm (qgemm_expert_pallas,
interpret mode, compiled) expert by expert and to the one-expert form bit
for bit; the decode matmul's plan with an expert count.

K10 (ops/cuda/block_kernel.py): the kernel's partition of each phase into
(strip, 64-row) units over the blocks of the grid, every unit once, and
the blocks' int32 strip sums added as the kernel adds them (exact in any
order), against int_dot_plain; the function itself against JAX's
wo_mlp_block is in tests/test_torch_block_kernel.py.

Tolerances against JAX: as tests/test_torch_expert_kernel.py (the f32
fold's pairing, measured NMSE <= 4.1e-15; with glu XLA's exp may move a
code at a .5 tie)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models.moe import stack_experts as jstack
from tmac_tpu.ops.pallas.expert_kernel import qgemm_expert_pallas
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu.ops.qgemm import fuse_m as jfuse_m
from tmac_tpu_torch.models.moe import stack_experts
from tmac_tpu_torch.ops.cuda import expert_kernel as k7
from tmac_tpu_torch.ops.cuda.block_kernel import (BLOCK_STAGE_ROWS, BLOCK_STRIP,
                                                  block_plan, block_spans,
                                                  int_dot_units_plain)
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (DECODE_SMEM_LIMIT, act_quant_plain,
                                                  decode_plan, decode_smem,
                                                  decode_units, int_dot_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

GS, E = 128, 4
FOLD_NMSE, GLU_NMSE = 1e-12, 1e-6


def _stacks(rng, bits, K, Ms):
    """E experts with one meta (random codes, per-group bf16 scales and
    zero points) as a port and a JAX stack; several Ms fuse them."""
    qmax, G = (1 << bits) - 1, K // GS
    ts, js = [], []
    for _ in range(E):
        pt, pj = [], []
        for M in Ms:
            wq = rng.integers(0, qmax + 1, (K, M)).astype(np.uint8)
            sc = ((0.5 + rng.random((G, M))) * 0.05).astype(np.float32)
            sub = sc * rng.integers(0, qmax + 1, (G, M)).astype(np.float32)
            pt.append(QuantizedTensor.from_quantized(
                wq, sc, sub, bits, GS, scale_dtype=torch.bfloat16, device="cpu"))
            pj.append(JQT.from_quantized(wq, sc, sub, bits, GS, scale_dtype=jnp.bfloat16))
        ts.append(fuse_m(pt) if len(Ms) > 1 else pt[0])
        js.append(jfuse_m(pj) if len(Ms) > 1 else pj[0])
    return stack_experts(ts), jstack(js)


# (bits, N, K, Ms, glu): gate_up (fused, the row shared by the routed
# experts) and down (glu, each expert's own rows), N = 1 and 4
CASES = [(bits, N, K, Ms, glu) for bits, K in ((2, 512), (4, 256)) for N in (1, 4)
         for Ms, glu in (((256, 256), False), ((384,), True))]
ROUTES = ((0, 3), (2, 1), (3,))


@pytest.mark.parametrize("bits,N,K,Ms,glu", CASES)
def test_plain_k7_experts_match_pallas(bits, N, K, Ms, glu):
    """Each routed expert's rows of qgemm_experts against JAX's expert
    kernel on the same expert; gate_up on one shared bf16 row block, down
    on each expert's f32 rows (the gate_up output), which both sides
    round to bf16."""
    rng = np.random.default_rng(bits * 1000 + N * 100 + K + glu)
    st, jst = _stacks(rng, bits, K, Ms)
    width = 2 * K if glu else K
    for route in ROUTES:
        k = len(route)
        if glu:
            x = torch.from_numpy(rng.standard_normal((k, N, width)).astype(np.float32))
            rows = list(x)
        else:
            x = torch.from_numpy(rng.standard_normal((N, width)).astype(np.float32)
                                 ).to(torch.bfloat16)
            rows = [x] * k
        idx = torch.tensor(route, dtype=torch.int32)
        got = k7.qgemm_experts(x, st, idx, glu=glu)
        assert got.shape == (k, N, sum(Ms)) and got.dtype == torch.float32
        for j, e in enumerate(route):
            xb = jnp.asarray(rows[j].float().numpy(), jnp.bfloat16)
            want = np.asarray(qgemm_expert_pallas(xb, jst, jnp.int32(e), glu=glu,
                                                  interpret=True))
            assert nmse(want, got[j].numpy()) <= (GLU_NMSE if glu else FOLD_NMSE), (route, j)


@pytest.mark.parametrize("bits,glu", [(2, False), (2, True), (4, True)])
def test_plain_k7_experts_are_one_expert_calls(bits, glu):
    """qgemm_experts is qgemm_expert on each routed expert, bit for bit,
    whether the route is a tensor or a list of ints, and the f32 rows are
    the rows rounded to bf16 first (as .to(bfloat16) rounds them)."""
    rng = np.random.default_rng(bits + glu)
    K = 512
    st, _ = _stacks(rng, bits, K, (384,) if glu else (256, 256))
    width = 2 * K if glu else K
    x = torch.from_numpy(rng.standard_normal((2, 3, width)).astype(np.float32))
    xin = x if glu else x[0]
    for route in ((1, 2), [3, 0]):
        got = k7.qgemm_experts(xin, st, route if isinstance(route, list)
                               else torch.tensor(route, dtype=torch.int32), glu=glu)
        for j, e in enumerate(route):
            rows = x[j] if glu else x[0]
            want = k7.qgemm_expert_plain(rows, st, e, glu)
            assert torch.equal(got[j], want)
            assert torch.equal(got[j], k7.qgemm_expert_plain(rows.to(torch.bfloat16),
                                                             st, e, glu))
    assert k7.qgemm_experts.launches == 0


def test_k7_experts_checks_its_rows():
    rng = np.random.default_rng(7)
    st, _ = _stacks(rng, 2, 512, (384,))
    idx = torch.tensor([0, 1], dtype=torch.int32)
    for bad, glu in ((torch.zeros(3, 1, 1024), True),    # 3 row blocks, 2 experts
                     (torch.zeros(2, 1, 512), True),     # glu needs 2K
                     (torch.zeros(1, 1024), False),      # no glu: K
                     (torch.zeros(2, 2, 1, 1024), True)):
        with pytest.raises(ValueError):
            k7.qgemm_experts(bad, st, idx, glu=glu)


# Mixtral-8x7B's expert shapes (W2, g128): (K, Mp) of gate_up and down
MIXTRAL_EXPERT = ((4096, 28672), (14336, 4096))


def test_k7_plan_counts_the_routed_experts():
    """decode_plan with an expert count -> (ksplit, nt, stages), from shapes
    only, every expert's clusters in the waves.  On Mixtral's expert
    shapes it takes, for the 2 routed experts of the select form, the
    configuration that measured fastest on an H100, or within 1% of it
    (PERF.md's K7 findings), and none that passes a block's shared
    memory."""
    want = {(4096, 1): (1, 1, 6), (4096, 4): (2, 4, 6), (14336, 1): (2, 1, 8),
            (14336, 4): (2, 1, 6)}
    for K, Mp in MIXTRAL_EXPERT:
        _, unit, nunits = decode_units(K, 2, GS)
        for N in (1, 4):
            for k in (1, 2):
                ksplit, nt, stages = plan = decode_plan(N, K, Mp, 2, GS, experts=k)
                assert plan == decode_plan(N, K, Mp, 2, GS, experts=k)
                assert decode_smem(2, nt, True, nunits, unit, ksplit, K // GS,
                                   stages) <= DECODE_SMEM_LIMIT
                assert nt == 1 or N > 1
                if k == 2:
                    assert plan == want[K, N], (K, N)
    # twice the experts never takes a smaller grid
    assert decode_plan(1, 14336, 4096, 2, GS, experts=1)[0] >= \
        decode_plan(1, 14336, 4096, 2, GS, experts=2)[0]


def test_k4_plan_is_unchanged_without_experts():
    """K1's and K4's plan (no expert count) is the one fitted to their own
    sweep (decode_plan_sweep): the cluster sizes PERF.md records at N = 1."""
    for (K, Mp, bits, gs), ksplit in (((4096, 12288, 2, 128), 2), ((4096, 4096, 2, 128), 8),
                                      ((4096, 22016, 2, 128), 4), ((11264, 4096, 2, 128), 8),
                                      ((3072, 3072, 2, 128), 6), ((4096, 28672, 2, 128), 1),
                                      ((14336, 4096, 2, 128), 8), ((3200, 9600, 2, 0), 3),
                                      ((3200, 17280, 2, 0), 1), ((3200, 32000, 8, 0), 1)):
        assert decode_plan(1, K, Mp, bits, gs)[0] == ksplit, (K, Mp)


# (K, M, blocks): BitNet-3B's three matmuls over an H100's 132 SMs and
# other grids (one block, more blocks than a phase has units), and a
# scaled shape whose last stage of rows is ragged (Kb 200 = 3 * 64 + 8)
K10_PLANS = [(3200, 3200, 132), (3200, 17280, 132), (8640, 3200, 132),
             (3200, 3200, 1), (8640, 3200, 7), (800, 256, 100), (800, 256, 3)]


@pytest.mark.parametrize("K,M,blocks", K10_PLANS)
def test_k10_units_cover_each_strip_once(K, M, blocks):
    per_strip, total = block_plan(K, M)
    assert per_strip == -(-(K // 4) // BLOCK_STAGE_ROWS)
    assert total == (M // BLOCK_STRIP) * per_strip
    spans = block_spans(total, blocks)
    assert len(spans) == blocks and spans[0][0] == 0 and spans[-1][1] == total
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert all(u1 - u0 in (total // blocks, -(-total // blocks)) for u0, u1 in spans)
    rows = np.zeros((M // BLOCK_STRIP, K // 4), np.int64)
    for u0, u1 in spans:
        for u in range(u0, u1):
            r0 = (u % per_strip) * BLOCK_STAGE_ROWS
            rows[u // per_strip, r0:r0 + BLOCK_STAGE_ROWS] += 1
    assert (rows == 1).all()   # every (strip, packed row) exactly once


@pytest.mark.parametrize("K,M,blocks", [(800, 256, b) for b in (1, 3, 5, 100)] +
                         [(512, 384, 7)])
def test_k10_split_sums_equal_int_dot(K, M, blocks):
    """The blocks' strip sums of their units, each field masked in place
    and shifted back, added across blocks: int_dot_plain's, exactly."""
    rng = np.random.default_rng(K + M + blocks)
    wq = rng.integers(1, 4, (K, M)).astype(np.uint8)
    s = np.full((1, M), 0.02, np.float32)
    qt = QuantizedTensor.from_quantized(wq, s, 2 * s, 2, K, device="cpu")
    x = torch.from_numpy(rng.standard_normal((1, K)).astype(np.float32))
    codes = act_quant_plain(x, qt)[0]
    assert torch.equal(int_dot_units_plain(codes, qt, blocks), int_dot_plain(codes, qt))


# K10 at bits 1 and 4: BitNet-3B's three matmuls over 132 SMs and a
# scaled shape whose last stage of packed rows is ragged
K10_PLANS_BITS = [(3200, 3200, 132, 1), (8640, 3200, 132, 1), (3200, 17280, 132, 4),
                  (8640, 3200, 132, 4), (800, 256, 3, 1), (800, 256, 7, 4)]


@pytest.mark.parametrize("K,M,blocks,bits", K10_PLANS_BITS)
def test_k10_units_cover_each_strip_once_bits_1_4(K, M, blocks, bits):
    """The unit partition at bits 1 (8 fields a byte: K / 8 packed rows)
    and 4 (K / 2): every (strip, packed row) exactly once."""
    P = 8 // bits
    per_strip, total = block_plan(K, M, bits)
    assert per_strip == -(-(K // P) // BLOCK_STAGE_ROWS)
    rows = np.zeros((M // BLOCK_STRIP, K // P), np.int64)
    for u0, u1 in block_spans(total, blocks):
        for u in range(u0, u1):
            r0 = (u % per_strip) * BLOCK_STAGE_ROWS
            rows[u // per_strip, r0:r0 + BLOCK_STAGE_ROWS] += 1
    assert (rows == 1).all()


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("K,M,blocks", [(800, 256, 1), (800, 256, 5), (512, 384, 7)])
def test_k10_split_sums_equal_int_dot_bits_1_4(K, M, blocks, bits):
    """The blocks' strip sums at bits 1 and 4, each of the 8 // bits fields
    masked in place and shifted back by bits * j: int_dot_plain's."""
    rng = np.random.default_rng(K + M + blocks + bits)
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    s = np.full((1, M), 0.02, np.float32)
    qt = QuantizedTensor.from_quantized(wq, s, (1 << (bits - 1)) * s, bits, K, device="cpu")
    x = torch.from_numpy(rng.standard_normal((1, K)).astype(np.float32))
    codes = act_quant_plain(x, qt)[0]
    assert torch.equal(int_dot_units_plain(codes, qt, blocks), int_dot_plain(codes, qt))
