"""Kernel K10's plain version against the JAX package's one-program
residual block (wo_mlp_block, interpret mode on the CPU, compiled), at
tests/test_block_kernel.py's shapes (H 256, I 384) and at a BitNet-like
scaled shape, and its checks against the reference's asserts.

The port follows the f32 steps XLA compiles the reference's kernel to
(csrc/block_kernel.cu's header); XLA's CPU rsqrt and exp may differ from
IEEE 1 / sqrt and torch's exp in the last bit, which can move an int8 code
at a .5 tie, so the gate is an NMSE of 1e-6 (measured: bit-identical at
these seeds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops.pallas.block_kernel import wo_mlp_block as jax_block
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu_torch.ops.cuda.block_kernel import (wo_mlp_block,
                                                  wo_mlp_block_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.utils import nmse

torch.set_num_threads(2)

BLOCK_NMSE = 1e-6
EPS = 1e-6


def _pair(rng, K, M):
    """The same per-tensor bits-2 weights (BitNet's ternary codes {1, 2, 3},
    sub = 2 * scale) as a port and a JAX QuantizedTensor."""
    wq = rng.integers(1, 4, (K, M)).astype(np.uint8)
    s = np.full((1, M), 1.0 / np.sqrt(K), np.float32)
    return (QuantizedTensor.from_quantized(wq, s, 2 * s, 2, K, device="cpu"),
            JQT.from_quantized(wq, s, 2 * s, 2, K))


_jax_block = jax.jit(lambda a, r, w, wo, gu, dn: jax_block(
    a, r.astype(jnp.float32), w, wo, gu, dn, EPS, interpret=True))


@pytest.mark.parametrize("H,I,seed", [(256, 384, 0), (256, 384, 1),
                                      (640, 1728, 2)],
                         ids=["test-shape", "test-shape-2", "bitnet-like"])
def test_plain_k10_matches_wo_mlp_block(H, I, seed):
    """(640, 1728) is BitNet-3B's hidden and FFN width over 5."""
    rng = np.random.default_rng(seed)
    (wo, jwo), (gu, jgu), (dn, jdn) = (_pair(rng, H, H), _pair(rng, H, 2 * I),
                                       _pair(rng, I, H))
    a, r = (rng.standard_normal((1, H)).astype(np.float32) for _ in range(2))
    w = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    bf = jnp.bfloat16
    want = np.asarray(_jax_block(jnp.asarray(a, bf), jnp.asarray(r, bf),
                                 jnp.asarray(w, bf), jwo, jgu, jdn))
    args = [torch.from_numpy(v).to(torch.bfloat16) for v in (a, r, w)]
    got = wo_mlp_block(*args, wo, gu, dn, EPS)
    assert got.dtype == torch.float32 and got.shape == (1, H)
    assert torch.equal(got, wo_mlp_block_plain(*args, wo, gu, dn, EPS))
    assert nmse(want, got.numpy()) <= BLOCK_NMSE


def test_k10_raises_where_the_reference_asserts():
    """Each case the reference's wo_mlp_block refuses with an assert."""
    rng = np.random.default_rng(3)
    H, I = 256, 384
    (wo, jwo), (gu, jgu), (dn, jdn) = (_pair(rng, H, H), _pair(rng, H, 2 * I),
                                       _pair(rng, I, H))
    w = rng.standard_normal((I, H)).astype(np.float32)
    grouped = (QuantizedTensor.from_float(w, 2, 128, device="cpu"),
               JQT.from_float(w, 2, 128))
    wo_short = _pair(rng, 192, H)        # wo's K is not the hidden size
    gu_wide = _pair(rng, H, 2 * I + 128)  # gate_up's M is not 2 * down's K
    for bad in (dict(dn=grouped), dict(wo=wo_short), dict(gu=gu_wide),
                dict(N=2)):
        ws = {"wo": (wo, jwo), "gu": (gu, jgu), "dn": (dn, jdn), **bad}
        N = bad.get("N", 1)
        a = np.zeros((N, ws["wo"][0].kdim), np.float32)
        r = np.zeros((N, H), np.float32)
        with pytest.raises(AssertionError):
            jax_block(jnp.asarray(a), jnp.asarray(r), jnp.ones((H,)),
                      ws["wo"][1], ws["gu"][1], ws["dn"][1], EPS, interpret=True)
        with pytest.raises(ValueError):
            wo_mlp_block(torch.from_numpy(a).bfloat16(),
                         torch.from_numpy(r).bfloat16(),
                         torch.ones(H, dtype=torch.bfloat16),
                         ws["wo"][0], ws["gu"][0], ws["dn"][0], EPS)
    # bits 4 passes the reference's asserts, and the port's (its kernel has
    # an instance at bits 1, 2 and 4)
    w4 = [QuantizedTensor.from_float(rng.standard_normal(km).astype(np.float32),
                                     4, device="cpu")
          for km in ((H, H), (H, 2 * I), (I, H))]
    args = (torch.zeros((1, H), dtype=torch.bfloat16), torch.zeros((1, H), dtype=torch.bfloat16),
            torch.ones(H, dtype=torch.bfloat16), *w4, EPS)
    assert torch.equal(wo_mlp_block(*args), wo_mlp_block_plain(*args))


def _pair_bits(rng, K, M, bits):
    """Per-tensor weights at bits 1 or 4 (random codes, sub = mid * scale)
    as a port and a JAX QuantizedTensor."""
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    s = np.full((1, M), 1.0 / np.sqrt(K), np.float32)
    sub = (1 << (bits - 1)) * s
    return (QuantizedTensor.from_quantized(wq, s, sub, bits, K, device="cpu"),
            JQT.from_quantized(wq, s, sub, bits, K))


@pytest.mark.parametrize("bits", [1, 4])
@pytest.mark.parametrize("H,I,seed", [(256, 384, 0), (640, 1728, 2)],
                         ids=["test-shape", "bitnet-like"])
def test_plain_k10_bits_1_4_matches_wo_mlp_block(bits, H, I, seed):
    """K10 at bits 1 and 4 (the reference's p = 8 // bits fields a byte):
    the plain version, which the card's instances are held to, against
    the reference's wo_mlp_block at the same bits."""
    rng = np.random.default_rng(seed + 10 * bits)
    (wo, jwo), (gu, jgu), (dn, jdn) = (_pair_bits(rng, H, H, bits),
                                       _pair_bits(rng, H, 2 * I, bits),
                                       _pair_bits(rng, I, H, bits))
    a, r = (rng.standard_normal((1, H)).astype(np.float32) for _ in range(2))
    w = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    bf = jnp.bfloat16
    want = np.asarray(_jax_block(jnp.asarray(a, bf), jnp.asarray(r, bf),
                                 jnp.asarray(w, bf), jwo, jgu, jdn))
    args = [torch.from_numpy(v).to(torch.bfloat16) for v in (a, r, w)]
    got = wo_mlp_block(*args, wo, gu, dn, EPS)
    assert got.shape == (1, H) and torch.isfinite(got).all()
    assert nmse(want, got.numpy()) <= BLOCK_NMSE


def test_k10_refuses_a_ragged_code_row():
    """The kernel reads 4 codes of a field at once: down's K must be a
    multiple of 4 * (8 // bits), which the packing's padding gives."""
    from tmac_tpu_torch.ops.cuda import block_kernel as k10
    rng = np.random.default_rng(5)
    H, I = 256, 400   # 400 = 50 * 8: a bits-1 packing pads it to 416
    tensors = [_pair_bits(rng, k, m, 1)[0] for k, m in ((H, H), (H, 2 * I), (I, H))]
    with pytest.raises(ValueError):
        k10.check_supported(torch.zeros((1, H)), *tensors)


@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA device")
@pytest.mark.parametrize("bits", [1, 2, 4])
def test_k10_kernel_matches_plain_on_card(bits):
    """On a card: K10's instance at bits against its plain version, bit for
    bit, at the bitnet-like shape (chip_smoke.py checks BitNet-3B's)."""
    rng = np.random.default_rng(bits)
    H, I = 640, 1728
    ts = [(_pair_bits(rng, k, m, bits)[0] if bits != 2 else _pair(rng, k, m)[0]).to("cuda")
          for k, m in ((H, H), (H, 2 * I), (I, H))]
    args = [torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(torch.bfloat16)
            .cuda().reshape(shape) for n, shape in ((H, (1, H)), (H, (1, H)), (H, (H,)))]
    got = wo_mlp_block(*args, *ts, EPS)
    assert torch.equal(got, wo_mlp_block_plain(*args, *ts, EPS))
