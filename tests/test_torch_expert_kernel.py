"""Kernel K7's plain version against the JAX package's expert-indexed Pallas
qgemm (qgemm_expert_pallas, interpret mode on CPU, compiled as the model
runs it), against K4's plain version on the same expert, the layout
contract of the CUDA kernel's packed-field walk, and the conversion of
stacked expert weights.

Where the outputs differ from the reference, the f32 fold is the cause:
XLA compiles the expert kernel's `acc + part * (xs * scale)` chain with
one FMA pairing or the other for its first two groups, depending on the
compiled block shape (the port's pairing at some shapes, e.g. bits 4 with
K 512 and 384 columns; the other one at all the shapes below), and from
32 groups on it adds the zero-point dot's group terms in vector lanes.
The port keeps K4's sequential order; the codes, scales and code sums are
exact, and the outputs agree to f32 rounding (measured NMSE <= 4.1e-15,
with and without glu)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models.moe import stack_experts as jstack
from tmac_tpu.ops.pallas.expert_kernel import (expert_kernel_supported as
                                               j_supported,
                                               qgemm_expert_pallas)
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu.ops.qgemm import fuse_m as jfuse_m
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.moe import expert_view, stack_experts
from tmac_tpu_torch.ops.cuda.expert_kernel import (expert_copy,
                                                   expert_kernel_supported,
                                                   qgemm_expert,
                                                   qgemm_expert_plain)
from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (
    act_quant_grouped_plain, qgemm_grouped_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

GS, E = 128, 4
# outputs against the reference: f32 rounding of the fold (module
# docstring), measured NMSE <= 4.1e-15; with glu, XLA's exp may also move a
# code at a .5 tie, as in K4's tests
FOLD_NMSE, GLU_NMSE = 1e-12, 1e-6


def _stacks(rng, bits, K, Ms, gs=GS, f32=False):
    """E experts with the same meta (random codes, per-group scales and
    zero points, bf16 scales and sub, as the model's init draws them; f32
    ones, as GGUF's block types give them, with f32) as a port and a JAX
    stack; several Ms make fused (gate_up-form) experts."""
    qmax, G = (1 << bits) - 1, K // gs
    sdt, jsdt = (torch.float32, jnp.float32) if f32 else (torch.bfloat16, jnp.bfloat16)
    ts, js = [], []
    for _ in range(E):
        pt, pj = [], []
        for M in Ms:
            wq = rng.integers(0, qmax + 1, (K, M)).astype(np.uint8)
            sc = ((0.5 + rng.random((G, M))) * 0.05).astype(np.float32)
            sub = sc * rng.integers(0, qmax + 1, (G, M)).astype(np.float32)
            pt.append(QuantizedTensor.from_quantized(
                wq, sc, sub, bits, gs, scale_dtype=sdt, device="cpu"))
            pj.append(JQT.from_quantized(wq, sc, sub, bits, gs, scale_dtype=jsdt))
        ts.append(fuse_m(pt) if len(Ms) > 1 else pt[0])
        js.append(jfuse_m(pj) if len(Ms) > 1 else pj[0])
    return stack_experts(ts), jstack(js)


@jax.jit
def _jax_group_quant(x):
    """The expert kernel's activation prologue without glu, compiled:
    codes, scales and dequantized code sums per (row, group)."""
    N, K = x.shape
    xg = x.astype(jnp.float32).reshape(N, K // GS, GS)
    xs = jnp.maximum(jnp.max(jnp.abs(xg), axis=2), 1e-20) / 127.0
    q = jnp.clip(jnp.rint(xg / xs[..., None]), -127, 127)
    return q.reshape(N, K).astype(jnp.int8), xs, jnp.sum(q, axis=2) * xs


# (bits, N, K, Ms, glu): the gate_up form (fused, no glu) and the down form
# (glu) at decode (N=1) and at the kernel's widest (N=4); bits 4 at K 256
# has the fold's least group count, 2
CASES = [
    (2, 1, 512, (256, 256), False),
    (2, 4, 512, (256, 256), False),
    (2, 1, 512, (384,), True),
    (2, 4, 512, (384,), True),
    (4, 1, 512, (256, 256), False),
    (4, 4, 512, (256, 256), False),
    (4, 1, 256, (384,), True),
    (4, 4, 256, (384,), True),
]


@pytest.mark.parametrize("bits,N,K,Ms,glu", CASES)
def test_plain_k7_matches_pallas(bits, N, K, Ms, glu):
    rng = np.random.default_rng(bits * 100 + N * 10 + K + glu)
    st, jst = _stacks(rng, bits, K, Ms)
    assert j_supported(jst) and expert_kernel_supported(st)
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    xb, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for e in range(E):
        want = np.asarray(qgemm_expert_pallas(xb, jst, jnp.int32(e), glu=glu,
                                              interpret=True))
        got = qgemm_expert(xt, st, e, glu=glu).numpy()
        assert got.shape == want.shape == (N, sum(Ms))
        if glu:
            assert nmse(want, got) <= GLU_NMSE, e
            continue
        codes, xs, xsum = act_quant_grouped_plain(xt, expert_view(st, e))
        jc, jxs, jxsum = _jax_group_quant(xb)
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(xs.numpy(), np.asarray(jxs))
        np.testing.assert_array_equal(xsum.numpy(), np.asarray(jxsum))
        assert nmse(want, got) <= FOLD_NMSE, (e, nmse(want, got))


# f32 scales and sub (GGUF's Q4_K, Q4_0 and grouped ternary experts):
# (bits, gs, N, K, Ms, glu), bits 4 at gs 32 and bits 2 at gs 256
F32_CASES = [
    (4, 32, 1, 512, (256, 256), False),
    (4, 32, 4, 512, (256, 256), False),
    (4, 32, 1, 512, (384,), True),
    (4, 32, 4, 256, (384,), True),
    (2, 256, 1, 1024, (256, 256), False),
    (2, 256, 4, 2048, (384,), True),
]


@pytest.mark.parametrize("bits,gs,N,K,Ms,glu", F32_CASES)
def test_plain_k7_f32_scales_match_pallas(bits, gs, N, K, Ms, glu):
    """K7's function with f32 grouped scales, in its scope (K7 on the card
    takes it), against qgemm_expert_pallas, which reads any scale dtype
    as f32: the same gates as the bf16 form's."""
    rng = np.random.default_rng(bits * 100 + gs + N * 10 + K + glu)
    st, jst = _stacks(rng, bits, K, Ms, gs, f32=True)
    assert st.scales.dtype == torch.float32
    assert j_supported(jst) and expert_kernel_supported(st)
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    xb, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for e in range(E):
        want = np.asarray(qgemm_expert_pallas(xb, jst, jnp.int32(e), glu=glu,
                                              interpret=True))
        got = qgemm_expert(xt, st, e, glu=glu).numpy()
        assert got.shape == want.shape == (N, sum(Ms))
        assert nmse(want, got) <= (GLU_NMSE if glu else FOLD_NMSE), (e, nmse(want, got))
        assert torch.equal(torch.from_numpy(got),
                           qgemm_grouped_plain(xt, expert_view(st, e), glu=glu))


@pytest.mark.parametrize("bits,N,K,Ms,glu", CASES[::2])
def test_plain_k7_is_k4_on_the_expert(bits, N, K, Ms, glu):
    """K7's function is K4's on expert e, in the same fold order: the plain
    versions agree bit for bit (NMSE 0), whether e is an int or a tensor."""
    rng = np.random.default_rng(bits + K + glu)
    st, _ = _stacks(rng, bits, K, Ms)
    x = torch.from_numpy(rng.standard_normal(
        (N, 2 * K if glu else K)).astype(np.float32)).to(torch.bfloat16)
    for e in range(E):
        want = qgemm_grouped_plain(x, expert_view(st, e), glu=glu)
        assert torch.equal(qgemm_expert_plain(x, st, e, glu), want)
        idx = torch.tensor([e], dtype=torch.int32)
        assert torch.equal(qgemm_expert_plain(x, st, idx, glu), want)


@pytest.mark.parametrize("bits", [2, 4])
def test_expert_walk_feeds_the_group_dots(bits):
    """Emulates K7's matmul (csrc/decode_matmul.cuh with the expert as
    grid.z): a block offsets the stack's packed weights by e * Kb * Mp and
    its scales and zero points by e * G * Mp, then runs K4's split of K over
    a cluster; every cluster size's per-group partials and on-chip fold
    must give K4's plain version on expert e, bit for bit."""
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import (block_partials_plain,
                                                            fold_split_plain)
    from tmac_tpu_torch.ops.cuda.qgemm_kernel import decode_units
    rng = np.random.default_rng(bits)
    K, M = 1024, 128
    st, _ = _stacks(rng, bits, K, (M,))
    x = torch.from_numpy(rng.standard_normal((2, K)).astype(np.float32))
    Kb, Mp, G = K * bits // 8, st.mdim_padded, K // GS
    flat_pk, flat_sc = st.packed.reshape(-1), st.scales.reshape(-1)
    _, _, nchunks = decode_units(K, bits, GS)
    for e in range(E):
        qt = expert_view(st, e)
        assert torch.equal(flat_pk[e * Kb * Mp:(e + 1) * Kb * Mp].reshape(Kb, Mp), qt.packed)
        assert torch.equal(flat_sc[e * G * Mp:(e + 1) * G * Mp].reshape(G, Mp), qt.scales)
        codes, xs, xsum = act_quant_grouped_plain(x, qt)
        want = qgemm_grouped_plain(x, qt)
        for ksplit in range(1, nchunks + 1):
            blocks = block_partials_plain(codes, qt, ksplit)
            got = fold_split_plain(blocks, xs, xsum, qt, ksplit)
            assert torch.equal(got, want), (e, ksplit)


def test_wrapper_dispatch_and_limits():
    rng = np.random.default_rng(5)
    st, _ = _stacks(rng, 2, 512, (256,))
    x = torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))
    assert torch.equal(qgemm_expert(x, st, 3), qgemm_expert_plain(x, st, 3))
    assert qgemm_expert.launches == 0       # CPU tensors never launch

    def stack_of(bits, K, gs, **kw):
        return stack_experts([QuantizedTensor.from_quantized(
            rng.integers(0, 1 << bits, (K, 256)).astype(np.uint8),
            np.ones((K // gs, 256), np.float32),
            np.zeros((K // gs, 256), np.float32), bits, gs, device="cpu", **kw)
            for _ in range(2)])
    bf = dict(scale_dtype=torch.bfloat16)
    for bad in (stack_of(3, 512, GS, **bf),     # bits 3
                stack_of(2, 512, GS, scale_dtype=torch.float16),  # grouped f16 scales
                stack_of(2, 512, 512, **bf),    # per-tensor bf16 scales
                stack_of(2, 640, GS, **bf),     # K padded 640 -> 1024
                expert_view(st, 0)):            # not a stack
        with pytest.raises(ValueError):
            qgemm_expert(torch.zeros(1, bad.kdim), bad, 0)
    # per-tensor f32 scales (G = 1, the w_a8 experts), grouped f32 scales
    # (GGUF's) and bits 1 are in the scope, as in the reference's
    for good in (stack_of(2, 512, 512), stack_of(2, 512, GS), stack_of(1, 1024, GS, **bf)):
        assert expert_kernel_supported(good)
        xg = torch.ones(1, good.kdim)
        assert torch.equal(qgemm_expert(xg, good, 1), qgemm_expert_plain(xg, good, 1))
    assert not expert_kernel_supported(stack_of(2, 512, 512), act_gs=32)
    with pytest.raises(ValueError):             # glu needs (N, 2K)
        qgemm_expert(x, st, 0, glu=True)
    with pytest.raises(TypeError):              # a device index gathers
        expert_view(st, torch.tensor(1))
    assert torch.equal(expert_copy(st, torch.tensor([2])).packed, st.packed[2])


def test_params_from_numpy_carries_stacked_experts():
    """A JAX tree whose MoE layer holds stacked experts (leading E axis on
    every array) converts field by field, bf16 bits and meta intact."""
    import dataclasses
    from tmac_tpu.models.config import get_preset as jax_preset
    from tmac_tpu.models.llama import init_params as jax_init
    jcfg = dataclasses.replace(jax_preset("mixtral-8x7b").scaled(8),
                               num_layers=1, moe_intermediate_size=512)
    cfg = dataclasses.replace(get_preset("mixtral-8x7b").scaled(8),
                              num_layers=1, moe_intermediate_size=512)
    jlayer = jax_init(jcfg, seed=2)["layers"][0]
    tree = jax.tree.map(np.asarray, {"layers": [jlayer]})
    layer = params_from_numpy(tree, cfg, device="cpu")["layers"][0]
    for name in ("experts_gate_up", "experts_down"):
        got, want = layer[name], jlayer[name]
        assert got.packed.shape == want.packed.shape
        assert got.packed.shape[0] == cfg.num_experts
        for f in ("bits", "group_size", "k_shards", "m_shards", "shape",
                  "m_segments"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        np.testing.assert_array_equal(got.packed.numpy(), np.asarray(want.packed))
        for f in ("scales", "sub"):
            assert getattr(got, f).dtype == torch.bfloat16
            np.testing.assert_array_equal(
                getattr(got, f).view(torch.int16).numpy(),
                np.asarray(getattr(want, f)).view(np.int16))
        assert expert_kernel_supported(got) and j_supported(want)
    assert layer["moe_router"].dtype == torch.bfloat16
    np.testing.assert_array_equal(layer["moe_router"].view(torch.int16).numpy(),
                                  np.asarray(jlayer["moe_router"]).view(np.int16))


# group size 16 (GGUF's Q2_K experts), bf16 and f32 scales: (bits, N, K,
# Ms, glu, f32)
GS16_CASES = [
    (2, 1, 512, (256, 256), False, True),
    (2, 4, 512, (384,), True, True),
    (4, 1, 256, (256, 256), False, False),
    (1, 4, 512, (384,), True, False),
]


@pytest.mark.parametrize("bits,N,K,Ms,glu,f32", GS16_CASES)
def test_plain_k7_gs16_matches_pallas(bits, N, K, Ms, glu, f32):
    """K7's function at group size 16, which K7 on the card takes since
    the decode matmul has a 16-row unit (as JAX's expert kernel takes any
    group size, its chunk min(gs, K / p)): against qgemm_expert_pallas in
    interpret mode, at the gates of the other group sizes, and bit for bit
    K4's plain version on the expert."""
    rng = np.random.default_rng(bits * 100 + N * 10 + K + glu + f32)
    st, jst = _stacks(rng, bits, K, Ms, 16, f32=f32)
    assert j_supported(jst) and expert_kernel_supported(st)
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    xb, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for e in range(E):
        want = np.asarray(qgemm_expert_pallas(xb, jst, jnp.int32(e), glu=glu,
                                              interpret=True))
        got = qgemm_expert(xt, st, e, glu=glu).numpy()
        assert got.shape == want.shape == (N, sum(Ms))
        assert nmse(want, got) <= (GLU_NMSE if glu else FOLD_NMSE), (e, nmse(want, got))
        assert torch.equal(torch.from_numpy(got),
                           qgemm_grouped_plain(xt, expert_view(st, e), glu=glu))


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_expert_scope_agrees_with_jax(bits):
    """The port's expert_kernel_supported against JAX's on a grid of forms:
    group sizes 16, 32, 64, 128 and per tensor, act_gs 0, 16 and 32, bf16
    and f32 scales.  They agree on every form but the narrowing the port
    documents, the scale dtype: per-tensor scales in bf16 (the model's are
    f32) are JAX's and not the port's.  Bits 3 (a hi plane) and 8 are in
    neither scope, nor is a K the packing pads (bits 1 at gs >= 64)."""
    rng = np.random.default_rng(bits)
    K = 256
    for gs in (16, 32, 64, 128, K):
        for f32 in (False, True):
            st, jst = _stacks(rng, bits, K, (128,), gs, f32=f32)
            for act_gs in (0, 16, 32):
                want = j_supported(jst, act_gs)
                got = expert_kernel_supported(st, act_gs)
                narrowed = gs == K and not f32
                assert got == (want and not narrowed), (gs, f32, act_gs)
                assert want == (bits in (1, 2, 4) and act_gs == 0 and st.kdim_padded == K)
