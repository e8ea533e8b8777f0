"""MoE at w_a8 (ternary per-tensor experts, as BitNet's linears) and K7 at
bits 1: kernel K7's per-tensor (G = 1) branch and its bits-1 forms.

K7's plain version against the JAX package's expert-indexed Pallas qgemm
(``qgemm_expert_pallas``, interpret mode on CPU, as
tests/test_expert_kernel.py runs it): per-tensor at bits 1, 2 and 4 with
nonzero zero points, bit for bit (the per-row int8 codes and the exact
int32 dot meet K1's epilogue, fma(acc * scale, xs, -(xsum * sub)), the
reference's compiled form); grouped at bits 1 within f32 rounding of the
fold (tests/test_torch_expert_kernel.py says why).  The decode matmul's
split of the per-tensor branch over a cluster against the plain sums, the
MoE MLP's select form at w_a8 against JAX's, params_from_numpy on a w_a8
MoE tree, and Mixtral-8x7B at w_a8 (scaled(8)) against JAX's
forward(impl="pallas") through a dispatch prefill (the expert blocks on
K1 below 64 slots, K3 from 64) and select decode steps (K7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tmac_tpu.ops.pallas.expert_kernel as jek
from tests.test_torch_act_groups import check, model_pair, port_logits, teacher_forced
from tests.test_torch_model_presets import assert_tree_equal, given_xla_rsqrt
from tmac_tpu.models import moe as jm
from tmac_tpu.models.llama import init_params as jax_init
from tmac_tpu.models.moe import stack_experts as jstack
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models import moe as tm
from tmac_tpu_torch.models.llama import init_params
from tmac_tpu_torch.models.moe import expert_view, stack_experts
from tmac_tpu_torch.ops.cuda.expert_kernel import (expert_kernel_supported, per_tensor,
                                                   qgemm_expert, qgemm_expert_plain,
                                                   qgemm_experts_plain)
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (act_quant_plain, decode_plan,
                                                  decode_units, int_dot_plain,
                                                  int_dot_split_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

E = 3
FOLD_NMSE, GLU_NMSE = 1e-12, 1e-6
MOE_NMSE = 3e-3


def _per_tensor_stacks(rng, bits, K, M):
    """E experts with one f32 scale per column and nonzero zero points (as
    tests/test_expert_kernel.py's per-tensor case, with the codes of every
    bits), as a port and a JAX stack."""
    ts, js = [], []
    for _ in range(E):
        wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
        s = (0.017 * (0.5 + rng.random((1, M)))).astype(np.float32)
        sub = s * rng.integers(0, 1 << bits, (1, M)).astype(np.float32)
        ts.append(QuantizedTensor.from_quantized(wq, s, sub, bits, K, device="cpu"))
        js.append(JQT.from_quantized(wq, s, sub, bits, K))
    return stack_experts(ts), jstack(js)


# (bits, N, K, M, glu): gate_up (no glu) and down (glu) forms at decode (N =
# 1) and at the kernel's widest (N = 4)
PT_CASES = [(2, 1, 512, 256, False), (2, 4, 512, 384, False), (2, 1, 512, 256, True),
            (2, 4, 256, 256, True), (1, 1, 512, 256, False), (1, 4, 1024, 128, True),
            (4, 1, 256, 384, False), (4, 4, 256, 256, True)]


@pytest.mark.parametrize("bits,N,K,M,glu", PT_CASES)
def test_per_tensor_k7_matches_pallas(bits, N, K, M, glu):
    rng = np.random.default_rng(bits * 1000 + N * 100 + K + glu)
    st, jst = _per_tensor_stacks(rng, bits, K, M)
    assert expert_kernel_supported(st) and jek.expert_kernel_supported(jst)
    assert per_tensor(st) and st.scales.dtype == torch.float32
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    xb, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for e in range(E):
        want = np.asarray(jek.qgemm_expert_pallas(xb, jst, jnp.int32(e), glu=glu,
                                                  interpret=True))
        got = qgemm_expert(xt, st, e, glu=glu).numpy()
        assert got.shape == want.shape == (N, M)
        np.testing.assert_array_equal(got, want, err_msg=f"expert {e}")


@pytest.mark.parametrize("N,glu", [(1, False), (4, False), (1, True), (3, True)])
def test_grouped_k7_at_bits1_matches_pallas(N, glu):
    """K7's grouped form at bits 1 (8 fields a byte), K4's function on the
    expert."""
    from tests.test_torch_expert_kernel import _stacks
    rng = np.random.default_rng(10 + N + glu)
    st, jst = _stacks(rng, 1, 1024, (256,) if glu else (128, 128))
    assert expert_kernel_supported(st) and jek.expert_kernel_supported(jst)
    x = rng.standard_normal((N, 2048 if glu else 1024)).astype(np.float32)
    xb, xt = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    for e in range(st.packed.shape[0]):
        want = np.asarray(jek.qgemm_expert_pallas(xb, jst, jnp.int32(e), glu=glu,
                                                  interpret=True))
        got = qgemm_expert(xt, st, e, glu=glu).numpy()
        assert nmse(want, got) <= (GLU_NMSE if glu else FOLD_NMSE), e


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_per_tensor_walk_feeds_the_int32_sums(bits):
    """K7's per-tensor matmul (csrc/decode_matmul.cuh, EXPERTS without
    GROUPED): a block offsets the stack's packed weights by e * Kb * Mp and
    the f32 scales and zero points by e * Mp, then runs K1's split of K over
    a cluster (units of 32 packed rows, the blocks' int32 sums added in rank
    order); every cluster size gives the exact sums on expert e, and the
    plan finds a configuration at Mixtral's expert shapes."""
    rng = np.random.default_rng(bits)
    K, M = 2048, 256
    st, _ = _per_tensor_stacks(rng, bits, K, M)
    Kb, Mp = K * bits // 8, st.mdim_padded
    flat_pk, flat_sc = st.packed.reshape(-1), st.scales.reshape(-1)
    x = torch.from_numpy(rng.standard_normal((2, K)).astype(np.float32))
    _, unit, nunits = decode_units(K, bits)
    assert unit == 32
    for e in range(E):
        qt = expert_view(st, e)
        assert torch.equal(flat_pk[e * Kb * Mp:(e + 1) * Kb * Mp].reshape(Kb, Mp), qt.packed)
        assert torch.equal(flat_sc[e * Mp:(e + 1) * Mp].reshape(1, Mp), qt.scales)
        codes, _, _ = act_quant_plain(x, qt)
        want = int_dot_plain(codes, qt)
        for ksplit in (1, 2, 3, 8):
            assert torch.equal(int_dot_split_plain(codes, qt, ksplit), want), (e, ksplit)
    for K, M in ((4096, 28672), (14336, 4096)):
        for N in (1, 4):
            ksplit, nt, stages = decode_plan(N, K, M, bits, 0, experts=2)
            assert nt in ((1,) if N == 1 else (1, 2 if bits == 1 else 4))


def test_per_tensor_experts_plain_routes_rows():
    """qgemm_experts_plain on a route (each expert its own rows, f32 as the
    select form gives down) is qgemm_expert_plain on each, with an index
    tensor or a list."""
    rng = np.random.default_rng(4)
    st, _ = _per_tensor_stacks(rng, 2, 512, 256)
    x = torch.from_numpy(rng.standard_normal((2, 1, 1024)).astype(np.float32))
    route = [2, 0]
    got = qgemm_experts_plain(x, st, torch.tensor(route, dtype=torch.int32), glu=True)
    for j, e in enumerate(route):
        assert torch.equal(got[j], qgemm_expert_plain(x[j], st, e, glu=True))
    assert torch.equal(qgemm_experts_plain(x, st, route, glu=True), got)


# ---------------------------------------------------------------------------
# the MoE MLP and the model at w_a8
# ---------------------------------------------------------------------------

def _wa8(name="mixtral-8x7b", **kw):
    return model_pair(name, quant=dict(mode="w_a8", group_size=-1, bits=2), **kw)


@pytest.fixture(scope="module")
def wa8_layer():
    cfg, jcfg = (dataclasses.replace(c, num_layers=1) for c in _wa8())
    jlayer = jax_init(jcfg, seed=0)["layers"][0]
    tree = jax.tree.map(np.asarray, {"layers": [jlayer]})
    return cfg, jcfg, params_from_numpy(tree, cfg, device="cpu")["layers"][0], jlayer


def test_params_from_numpy_carries_a_wa8_moe_tree(wa8_layer):
    """The JAX package's w_a8 MoE layer (stacked ternary experts, f32
    per-tensor scales (E, 1, Mp)) byte for byte, in K7's scope on both
    sides; init_params draws the same tree."""
    cfg, _, layer, jlayer = wa8_layer
    for name in ("experts_gate_up", "experts_down"):
        got, want = layer[name], jlayer[name]
        assert got.scales.shape == (cfg.num_experts, 1, got.mdim_padded)
        assert got.scales.dtype == got.sub.dtype == torch.float32
        for f in ("bits", "group_size", "k_shards", "m_shards", "shape", "m_segments"):
            assert getattr(got, f) == getattr(want, f), (name, f)
        for f in ("packed", "scales", "sub"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        assert expert_kernel_supported(got) and jek.expert_kernel_supported(want)
    params = init_params(cfg, seed=0, device="cpu")
    assert_tree_equal(params["layers"][0], layer)


_jmoe = jax.jit(jm.moe_mlp, static_argnames=("cfg", "mode", "impl", "moe_impl"))


@pytest.mark.parametrize("moe_impl,n", [("select", 1), ("dense", 8),
                                        ("dispatch", 72), ("dispatch", 136)])
def test_wa8_moe_mlp_matches_jax(wa8_layer, monkeypatch, moe_impl, n):
    """The MoE MLP at w_a8 in each form: select through K7's per-tensor
    branch (2 calls a routed expert in JAX's kernel, the port's plain K7
    once for all k experts' gate_up and once for their down), dense, and
    dispatch with expert blocks of 40 slots (K1) and 72 (K3)."""
    cfg, jcfg, layer, jlayer = wa8_layer
    calls = {"jax": 0, "port": 0}

    def counting(side, fn):
        def wrapped(*a, **k):
            calls[side] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(jek, "qgemm_expert_pallas", counting("jax", jek.qgemm_expert_pallas))
    monkeypatch.setattr(tm, "qgemm_experts_plain", counting("port", tm.qgemm_experts_plain))
    x = np.random.default_rng(n).standard_normal((1, n, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(_jmoe(jnp.asarray(x, jnp.bfloat16), jlayer, jcfg, "w_a8",
                            impl="pallas", moe_impl=moe_impl).astype(jnp.float32))
    got = tm.moe_mlp(torch.from_numpy(x).to(torch.bfloat16), layer, cfg, "w_a8",
                     moe_impl=moe_impl, plain=True).float().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    assert nmse(want, got) <= MOE_NMSE
    k = cfg.num_experts_per_tok
    assert calls == ({"jax": 2 * k, "port": 2} if moe_impl == "select"
                     else {"jax": 0, "port": 0})


@pytest.fixture(scope="module", params=[72, 136], ids=["prompt72", "prompt136"])
def mixtral_wa8(request):
    """Mixtral-8x7B's architecture at w_a8 bits 2 (ternary per-tensor
    experts), scaled(8): a dispatch prefill (expert blocks of 40 slots on
    K1, of 72 on K3) and select decode steps (K7's per-tensor branch)."""
    return teacher_forced(*_wa8(), request.param)


def test_mixtral_wa8_matches_jax_pallas(mixtral_wa8):
    """The decode steps at Mixtral's gates; the prefill's logits within
    its NMSE gate (its argmax: the next test)."""
    check(dict(ref=mixtral_wa8["ref"][1:], got=mixtral_wa8["got"][1:]), MOE_NMSE)
    assert nmse(mixtral_wa8["ref"][0], mixtral_wa8["got"][0]) <= MOE_NMSE


def test_mixtral_wa8_gap_is_xla_rsqrt(mixtral_wa8, monkeypatch):
    """Measured on the CPU without XLA's rsqrt values: the prefill's NMSE
    8.1e-5 (72 tokens) and 1.7e-3 (136), argmax agreement 1.0 and 0.993
    (one of 136 positions), the steps 1.9e-5 to 8.6e-4; with them every
    position within 4.3e-5, argmax 1.0: the recorded rsqrt deviation
    (ROADMAP Queue 3) amplified by the router's top-k, as
    test_torch_forward_options.py's test_mixtral_other_prompt_gap_is_xla_rsqrt
    finds at w_fp."""
    given_xla_rsqrt(monkeypatch)
    got = port_logits(mixtral_wa8["model"], mixtral_wa8["prompt"], mixtral_wa8["toks"])
    check(dict(ref=mixtral_wa8["ref"], got=got), 3e-4)
