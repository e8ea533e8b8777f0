"""Kernels K1's and K3's plain version against the JAX package's fused
Pallas qgemm (qgemm_pallas act="fused", interpret mode on CPU: its small-N
kernel below 64 rows, its XLA prologue and single-dot kernel from 64), and
the layout contracts between K1's prologue and the two matmuls."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models.llama import quantize_activations_int8 as jquant
from tmac_tpu.ops.pallas.qgemm_kernel import qgemm_pallas
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu.ops.qgemm import fuse_m as jfuse_m
from tmac_tpu_torch.models.llama import quantize_activations_int8
from tmac_tpu_torch.ops.cuda.qgemm_kernel import (act_quant_plain,
                                                  dp4a_order, int_dot_plain,
                                                  qgemm_fused,
                                                  qgemm_fused_plain,
                                                  qgemm_large_int)
from tmac_tpu_torch.ops.qgemm import (QuantizedTensor, fuse_m, kernel_for,
                                      qgemm, unpack_codes)
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

# the JAX function as the model runs it, compiled: XLA turns its
# `amax / 127.0` into a multiply by the f32 reciprocal, and the port follows
jquant_jit = jax.jit(jquant)


def pallas_fused(xb, jqt, norm=None, glu=False, residual=None):
    """qgemm_pallas(act="fused") compiled as the model runs it (inside
    jit): XLA's rewrites of the N >= 64 route's XLA prologue and epilogue
    apply only then."""
    eps = None if norm is None else norm[1]

    def f(x, q, w, r):
        return qgemm_pallas(x, q, out_dtype=jnp.float32, interpret=True,
                            act="fused", glu=glu, residual=r,
                            norm=None if w is None else (w, eps))
    return np.asarray(jax.jit(f)(xb, jqt, None if norm is None else norm[0],
                                 residual))


def _pair(rng, bits, K, Ms):
    """The same weights as a port and a JAX QuantizedTensor; several Ms
    make a fused tensor."""
    ts, js = [], []
    for M in Ms:
        if bits == 2:
            wq = rng.integers(1, 4, (K, M)).astype(np.uint8)
            s = np.full((1, M), 1.0 / np.sqrt(K), np.float32)
            ts.append(QuantizedTensor.from_quantized(wq, s, 2 * s, 2, K, device="cpu"))
            js.append(JQT.from_quantized(wq, s, 2 * s, 2, K))
        else:
            w = (rng.standard_normal((K, M)) * 0.02).astype(np.float32)
            ts.append(QuantizedTensor.from_float(w, 8, K, device="cpu"))
            js.append(JQT.from_float(w, 8, K))
    if len(Ms) == 1:
        return ts[0], js[0]
    return fuse_m(ts), jfuse_m(js)


# (bits, N, K, Ms, norm, glu, residual): padded and fused M, every fold
CASES = [
    (2, 1, 200, (1000,), False, False, False),     # K and M padded
    (2, 16, 256, (400, 400, 400), False, False, False),  # fused, seg pad
    (2, 1, 256, (400, 400, 400), True, False, False),    # wqkv form
    (2, 16, 200, (1000,), True, False, False),
    (2, 1, 256, (256,), False, False, True),        # wo form
    (2, 16, 256, (512, 512), True, False, False),   # gate_up form
    (2, 1, 512, (256,), False, True, True),         # down form
    (2, 16, 512, (256,), False, True, True),
    (2, 16, 256, (384,), False, True, False),
    (8, 1, 256, (500,), False, False, False),       # lm head form
    (8, 16, 256, (500,), False, False, False),
    (8, 1, 300, (256,), True, False, True),
    (2, 72, 256, (384,), False, False, False),    # the N >= 64 route: K3
    (2, 72, 256, (256,), False, False, True),
    (2, 72, 512, (256,), False, True, True),
    (8, 72, 256, (500,), False, False, False),
    (2, 64, 256, (256, 256, 256), True, False, False),  # K3: wqkv form
    (2, 256, 256, (256,), False, False, True),          # wo form
    (2, 64, 256, (512, 512), True, False, False),       # gate_up form
    (2, 256, 512, (256,), False, True, True),           # down form
    (8, 256, 256, (500,), False, False, False),         # the int8 head
    (8, 64, 256, (256,), True, False, True),
]


@pytest.mark.parametrize("bits,N,K,Ms,norm,glu,residual", CASES)
def test_plain_k1_matches_pallas_fused(bits, N, K, Ms, norm, glu, residual):
    rng = np.random.default_rng(bits * 1000 + N * 100 + K + sum(Ms))
    qt, jqt = _pair(rng, bits, K, Ms)
    x = rng.standard_normal((N, 2 * K if glu else K)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    kw_j, kw_t = {}, {}
    if norm:
        w = (1.0 + 0.1 * rng.standard_normal(K)).astype(np.float32)
        kw_j["norm"] = (jnp.asarray(w, jnp.bfloat16), 1e-6)
        kw_t["norm"] = (torch.from_numpy(w).to(torch.bfloat16), 1e-6)
    if glu:
        kw_j["glu"] = kw_t["glu"] = True
    if residual:
        r = rng.standard_normal((N, sum(Ms))).astype(np.float32)
        kw_j["residual"] = jnp.asarray(r, jnp.bfloat16)
        kw_t["residual"] = torch.from_numpy(r).to(torch.bfloat16)
    want = pallas_fused(xb, jqt, **kw_j)
    kernel = kernel_for(qt, N)
    assert kernel is (qgemm_large_int if N >= 64 else qgemm_fused)
    got = kernel(xt, qt, **kw_t).numpy()
    assert got.shape == want.shape == (N, sum(Ms))
    if norm or glu:
        # XLA's CPU rsqrt (a hardware estimate refined by Newton steps) and
        # exp differ from IEEE 1/sqrt and torch's exp by an ulp in some rows
        assert nmse(want, got) <= 1e-6
        return
    # no folds: the int8 codes and the int32 accumulator are exact, and the
    # f32 epilogue is the one XLA compiles the reference's to, FMAs and all
    np.testing.assert_array_equal(got, want)
    codes, xs, xsum = act_quant_plain(xt, qt)
    jcodes, jscale = jquant_jit(xb)
    Kp = qt.kdim_padded
    np.testing.assert_array_equal(codes.numpy()[:, :K], np.asarray(jcodes))
    assert not codes.numpy()[:, K:Kp].any()
    np.testing.assert_array_equal(xs.numpy(), np.asarray(jscale)[:, 0])
    acc = int_dot_plain(codes, qt).numpy()
    w64 = unpack_codes(qt).numpy().astype(np.int64)
    np.testing.assert_array_equal(acc, codes.numpy().astype(np.int64) @ w64)


@pytest.mark.parametrize("bits", [2, 8])
def test_dp4a_grouping_feeds_the_matmul(bits):
    """Emulates K3's matmul on the prologue's dp4a code grouping (K1's
    decode matmul reads natural order, test_torch_decode_matmul.py): word
    q of a row holds the 4 codes that meet the 4 weights of packed word
    q."""
    rng = np.random.default_rng(bits)
    qt, _ = _pair(rng, bits, 256, (128,))
    x = torch.from_numpy(rng.standard_normal((3, 256)).astype(np.float32))
    codes, _, _ = act_quant_plain(x, qt)
    g = dp4a_order(codes, bits).numpy().astype(np.int64).reshape(3, -1, 4)
    pk = qt.packed.numpy()
    if bits == 2:
        w = np.stack([(pk >> (2 * j)) & 3 for j in range(4)], axis=1)
    else:
        w = pk.view(np.int8).reshape(-1, 4, pk.shape[1])
    acc = np.einsum("nqj,qjm->nm", g, w.astype(np.int64))
    np.testing.assert_array_equal(acc, int_dot_plain(codes, qt).numpy())


def test_activation_quant_matches_jax():
    x = np.random.default_rng(0).standard_normal((5, 300)).astype(np.float32)
    x[2] = 0.0  # the 1e-20 clamp
    q, s = quantize_activations_int8(torch.from_numpy(x).to(torch.bfloat16))
    jq, js = jquant_jit(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("N", [1, 16])
def test_codes_match_pallas_at_ties(N):
    """K1's int8 codes against the fused Pallas kernel's own, read back
    through identity weights (bits=8, unit scale), on rows whose values
    x = +-amax/2 land on the .5 tie 63.5 exactly: there the scale's
    rounding (amax * (1/127) as compiled, not amax / 127) decides the
    code."""
    rng = np.random.default_rng(N)
    K, f32 = 256, np.float32
    wq = (128 + np.eye(K)).astype(np.uint8)
    ones, subs = np.ones((1, K), f32), np.full((1, K), 128.0, f32)
    qt = QuantizedTensor.from_quantized(wq, ones, subs, 8, K, device="cpu")
    jqt = JQT.from_quantized(wq, ones, subs, 8, K)
    # bf16 row maxima whose tie falls on different codes under the two scales
    cand = np.asarray(jnp.asarray(rng.uniform(0.05, 50.0, 4096), jnp.bfloat16), f32)
    cand = cand[np.rint(cand / 2 / (cand / f32(127)))
                != np.rint(cand / 2 / (cand * f32(1 / 127)))][:N, None]
    x = (rng.uniform(-0.9, 0.9, (N, K)) * cand).astype(f32)
    x[:, 0] = cand[:, 0]
    x[:, 1:33] = cand / 2 * rng.choice([1.0, -1.0], (N, 32))
    xb = jnp.asarray(x, jnp.bfloat16)
    out = pallas_fused(xb, jqt)
    codes, xs, _ = act_quant_plain(torch.from_numpy(x), qt)
    np.testing.assert_array_equal(np.rint(out / xs.numpy()[:, None]),
                                  codes.numpy())
    np.testing.assert_array_equal(np.abs(codes.numpy()[:, 1:33]), 64)


def test_wrapper_dispatch_and_limits():
    rng = np.random.default_rng(1)
    qt, _ = _pair(rng, 2, 256, (384,))
    x = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32))
    via_qgemm = qgemm(x, qt, out_dtype=torch.float32, act="fused")   # auto -> fused
    assert torch.equal(via_qgemm, qgemm_fused_plain(x, qt))
    w = rng.standard_normal((256, 128)).astype(np.float32)
    grouped = QuantizedTensor.from_float(w, 2, 64, device="cpu")
    with pytest.raises(ValueError):
        qgemm_fused(x, grouped)
    # one scale row at any of bits 1 to 4 and 8 (per-channel w_fp at bits
    # 4 here); a k-sharded tensor (a scale row a shard) is refused
    w4 = QuantizedTensor.from_float(w, 4, device="cpu")
    assert torch.equal(qgemm_fused(x, w4), qgemm_fused_plain(x, w4))
    with pytest.raises(ValueError, match="k_shards == 1"):
        qgemm_fused(x, dataclasses.replace(w4, k_shards=2))
    padded, _ = _pair(rng, 2, 256, (200,))
    with pytest.raises(ValueError):  # residual on a padded M
        qgemm_fused(x, padded, residual=torch.zeros(2, 200))
    with pytest.raises(ValueError):  # K1 folds a bf16 residual only
        qgemm_fused(x, qt, residual=torch.zeros(2, 384))
    # K1 takes N < 64 rows and K3 the rest, on the CPU as on the card
    x64 = torch.zeros((64, 256))
    with pytest.raises(ValueError, match="K3"):
        qgemm_fused(x64, qt)
    with pytest.raises(ValueError, match="K1"):
        qgemm_large_int(x, qt)
    assert torch.equal(qgemm(x64, qt, out_dtype=torch.float32, act="fused"),
                       qgemm_large_int(x64, qt))



@pytest.mark.parametrize("form", ["bf16_g64", "f32_g32", "bits8_g64", "f16_g64",
                                  "mixed_dtypes", "g48"])
def test_auto_on_the_cpu_asks_the_functions_rule(form):
    """On the CPU, impl="auto" takes a grouped tensor's plain kernel version
    exactly where the function takes its weights (weights_form_error is
    None: the rule _check_supported raises on) and "torch" elsewhere."""
    import dataclasses
    from tmac_tpu_torch.ops.cuda.qgemm_grouped_kernel import weights_form_error
    rng = np.random.default_rng(4)
    bits, gs = (8, 64) if form == "bits8_g64" else (4, 32) if form == "f32_g32" else (2, 64)
    K = 384 if form == "g48" else 256
    w = rng.standard_normal((K, 128)).astype(np.float32)
    qt = QuantizedTensor.from_float(w, bits, 48 if form == "g48" else gs,
                                    scale_dtype=torch.bfloat16, device="cpu")
    if form == "f32_g32":
        qt = dataclasses.replace(qt, scales=qt.scales.float(), sub=qt.sub.float())
    elif form == "f16_g64":
        qt = dataclasses.replace(qt, scales=qt.scales.half(), sub=qt.sub.half())
    elif form == "mixed_dtypes":
        qt = dataclasses.replace(qt, sub=qt.sub.float())
    x = torch.from_numpy(rng.standard_normal((2, K)).astype(np.float32)).to(torch.bfloat16)
    takes = weights_form_error(qt) is None
    assert takes == (form in ("bf16_g64", "f32_g32", "bits8_g64"))
    want = (kernel_for(qt, 2, plain=True)(x, qt).to(torch.bfloat16) if takes
            else qgemm(x, qt, impl="torch", act="fused"))
    assert torch.equal(qgemm(x, qt, act="fused"), want)


@pytest.mark.parametrize("case", ["grouped", "grouped_bits3", "grouped_bits8", "int8_x"])
def test_auto_off_the_cpu_takes_k1_or_raises(case):
    """Off the CPU, impl="auto" never reaches the plain grouped matmul: it
    takes K4 for grouped scales and K1 otherwise, which raise on what they
    do not cover (shown on the meta device, which no kernel runs on)."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    x = torch.zeros((2, 256), dtype=torch.bfloat16)
    if case == "grouped":
        qt = QuantizedTensor.from_float(w, 2, 64, scale_dtype=torch.bfloat16,
                                        device="cpu")
        want = "K4 runs on CPU or CUDA tensors"   # K4 took it
    elif case == "grouped_bits3":
        qt = QuantizedTensor.from_float(w, 3, 64, scale_dtype=torch.bfloat16,
                                        device="cpu")
        want = "K4 runs on CPU or CUDA tensors"   # K4 took it (bits 1 to 4)
    elif case == "grouped_bits8":
        qt = QuantizedTensor.from_float(w, 8, 64, scale_dtype=torch.bfloat16,
                                        device="cpu")
        want = "K4 runs on CPU or CUDA tensors"   # K4 took it (grouped bits 8 too)
    else:
        qt = QuantizedTensor.from_float(w, 2, device="cpu")
        x = x.to(torch.int8)
        want = "quantize float activations"
    qgemm(x, qt, act="fused")  # the CPU takes a plain version
    with pytest.raises(ValueError, match=want):
        qgemm(x.to("meta"), qt.to("meta"), act="fused")
