"""The port's LUT spec (tmac_tpu_torch/ops/lut.py), its packing helpers
(bitplanes, group_indices) and get_bits_alphas against the JAX package's,
on the same numpy inputs: a mirror of each case of tests/test_lut_spec.py.

Integer results (int8 tables, indices, planes, the halving tree) are held
equal; float ones to the JAX tests' tolerances (1e-5 to 1e-6 on tables
and biases) and, for the products, to the reference's gate (NMSE <= 5e-4
against the dequant oracle) and to JAX's spec within 1e-6 NMSE (only the
order of the f32 sums differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops import lut as jlut
from tmac_tpu.ops import packing as jpacking
from tmac_tpu.utils import get_bits_alphas as jax_alphas
from tmac_tpu_torch.ops import lut, packing
from tmac_tpu_torch.utils import get_bits_alphas, nmse

torch.set_num_threads(2)

NMSE_GATE = 5e-4   # the reference's, as tests/test_lut_spec.py
SPEC_NMSE = 1e-6   # port spec against JAX's spec


def test_lut_mirror_symmetry():
    rng = np.random.default_rng(0)
    b = rng.standard_normal((2, 64)).astype(np.float32)
    t = lut.build_lut(torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(t, -t[..., ::-1], rtol=1e-6)
    np.testing.assert_allclose(t, np.asarray(jlut.build_lut(jnp.asarray(b))),
                               rtol=1e-6, atol=1e-6)


def test_lut_entries():
    rng = np.random.default_rng(1)
    b = rng.standard_normal((1, 8)).astype(np.float32)
    t = lut.build_lut(b).numpy()
    np.testing.assert_array_equal(lut.sign_codes(), jlut.sign_codes())
    for k in range(2):
        for c in range(16):
            signs = [(2 * ((c >> j) & 1) - 1) for j in range(4)]
            want = sum(s * b[0, 4 * k + j] for j, s in enumerate(signs))
            assert abs(t[0, k, c] - want) < 1e-5


def test_quantize_lut_bias_is_neg_group_sum():
    rng = np.random.default_rng(2)
    ags = 64
    b = rng.standard_normal((2, 256)).astype(np.float32)
    q, s, biases = lut.quantize_lut(lut.build_lut(b), ags)
    want = -b.reshape(2, 256 // ags, ags).sum(-1)
    np.testing.assert_allclose(biases.numpy(), want, rtol=1e-5, atol=1e-5)
    jq, js, jb = jlut.quantize_lut(jlut.build_lut(jnp.asarray(b)), ags)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(biases.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [1, 2, 3, 4])
@pytest.mark.parametrize("zero_point", [False, True])
def test_lut_gemm_vs_dequant_oracle(bits, zero_point):
    rng = np.random.default_rng(bits * 10 + zero_point)
    N, K, M, gs, ags = 2, 512, 128, 128, 64
    w = rng.standard_normal((K, M)).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    wq, scales, sub = packing.quantize_weights(w, bits, gs, zero_point)
    oracle = x @ packing.dequantize(wq, scales, sub, gs)
    idx = packing.group_indices(wq, bits)
    np.testing.assert_array_equal(idx, jpacking.group_indices(wq, bits))
    np.testing.assert_array_equal(packing.bitplanes(wq, bits), jpacking.bitplanes(wq, bits))
    assert get_bits_alphas(bits) == jax_alphas(bits)
    got = lut.lut_gemm_spec(*lut.lut_ctor(x, ags), idx, scales, sub, bits=bits,
                            group_size=gs, act_group_size=ags).numpy()
    assert nmse(oracle, got) <= NMSE_GATE
    want = jlut.lut_gemm_spec(*jlut.lut_ctor(jnp.asarray(x), ags), idx,
                              jnp.asarray(scales), jnp.asarray(sub), bits=bits,
                              group_size=gs, act_group_size=ags)
    assert nmse(np.asarray(want), got) <= SPEC_NMSE


def test_lut_gemm_bitnet_per_tensor():
    rng = np.random.default_rng(42)
    N, K, M = 1, 256, 128
    wt = rng.integers(-1, 2, (K, M)).astype(np.float32)
    s = 0.37
    wq = (wt + 2).astype(np.uint8)
    scales = np.full((1, M), s, np.float32)
    sub = np.full((1, M), 2 * s, np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    oracle = x @ (wt * s)
    idx = packing.group_indices(wq, 2)
    got = lut.lut_gemm_spec(*lut.lut_ctor(x, 64), idx, scales, sub, bits=2,
                            group_size=K, act_group_size=64).numpy()
    assert nmse(oracle, got) <= NMSE_GATE
    want = jlut.lut_gemm_spec(*jlut.lut_ctor(jnp.asarray(x), 64), idx,
                              jnp.asarray(scales), jnp.asarray(sub), bits=2,
                              group_size=K, act_group_size=64)
    assert nmse(np.asarray(want), got) <= SPEC_NMSE


def test_halving_add_tree_semantics():
    rng = np.random.default_rng(0)
    vals = rng.integers(-100, 100, (5, 16)).astype(np.int32)
    got = lut.halving_add_tree(vals, axis=1).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jlut.halving_add_tree(jnp.asarray(vals), axis=1)))
    exact = vals.sum(1) / 16.0
    assert (np.abs(got - exact) <= 2.0).all()
    assert (got - exact >= -0.5).all()


def test_fast_aggregation_correction_reference_semantics():
    s, b = torch.tensor([[2.0]]), torch.tensor([[10.0]])
    s2, b2 = lut.fast_aggregation_correction(s, b, act_k=16, bits=2)
    np.testing.assert_allclose(s2.numpy(), [[32.0]])
    np.testing.assert_allclose(b2.numpy(), [[10.0 - 32.0 * 3]])
    s3, b3 = lut.fast_aggregation_correction(s, b, act_k=8, bits=2)
    np.testing.assert_allclose(s3.numpy(), [[16.0]])
    np.testing.assert_allclose(b3.numpy(), [[10.0]])
    for bits in (1, 2, 3, 4):
        js, jb = jlut.fast_aggregation_correction(jnp.asarray([[2.0]]), jnp.asarray([[10.0]]),
                                                  act_k=16, bits=bits)
        ps, pb = lut.fast_aggregation_correction(s, b, act_k=16, bits=bits)
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))


@pytest.mark.parametrize("bits", [2, 4])
def test_fast_aggregation_accuracy_delta(bits):
    rng = np.random.default_rng(77 + bits)
    N, K, M, gs = 4, 512, 128, 64
    w = rng.standard_normal((K, M)).astype(np.float32)
    x = rng.standard_normal((N, K)).astype(np.float32)
    wq, scales, sub = packing.quantize_weights(w, bits, gs, True)
    oracle = x @ packing.dequantize(wq, scales, sub, gs)
    idx = packing.group_indices(wq, bits)
    kw = dict(bits=bits, group_size=gs, act_group_size=gs)
    tables = lut.lut_ctor(x, gs)
    exact = lut.lut_gemm_spec(*tables, idx, scales, sub, **kw).numpy()
    fa = lut.lut_gemm_spec(*tables, idx, scales, sub, fast_aggregation=True, **kw).numpy()
    e_exact, e_fa = nmse(oracle, exact), nmse(oracle, fa)
    assert e_exact <= NMSE_GATE
    assert e_fa > e_exact
    assert e_fa < 50 * NMSE_GATE
    jt = jlut.lut_ctor(jnp.asarray(x), gs)
    jargs = (*jt, idx, jnp.asarray(scales), jnp.asarray(sub))
    assert nmse(np.asarray(jlut.lut_gemm_spec(*jargs, **kw)), exact) <= SPEC_NMSE
    assert nmse(np.asarray(jlut.lut_gemm_spec(*jargs, fast_aggregation=True, **kw)),
                fa) <= SPEC_NMSE
