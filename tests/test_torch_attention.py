"""Kernel K2's plain version against the JAX package's flash-decode Pallas
kernel (flash_decode_stacked, interpret mode on CPU), and against the
model's masked prefill attention."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.ops.pallas.attention_kernel import flash_decode_stacked
from tmac_tpu_torch.ops.cuda.attention_kernel import (flash_decode,
                                                      flash_decode_plain)

torch.set_num_threads(2)


def _inputs(seed, L, B, KV, rep, Dl, Dp, S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, KV, rep, Dl)).astype(np.float32)
    k = np.zeros((L, B, KV, S, Dp), np.float32)
    v = np.zeros((L, B, KV, S, Dp), np.float32)
    k[..., :Dl] = rng.standard_normal((L, B, KV, S, Dl))
    v[..., :Dl] = rng.standard_normal((L, B, KV, S, Dl))
    return q, k, v


@pytest.mark.parametrize("rep,KV", [(1, 4), (4, 2)])
@pytest.mark.parametrize("S,lens", [(64, (1, 64)), (64, (17, 40)),
                                    (40, (1, 40))])  # S not a multiple of 16
def test_plain_k2_matches_pallas(rep, KV, S, lens):
    L, B, Dl, Dp, li = 2, 2, 100, 128, 1
    q, k, v = _inputs(rep * 10 + lens[0], L, B, KV, rep, Dl, Dp, S)
    lens = np.asarray(lens, np.int32)
    want = np.asarray(flash_decode_stacked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        jnp.int32(li), interpret=True))
    got = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), torch.from_numpy(lens),
                       torch.tensor([li], dtype=torch.int32))
    assert got.shape == (B, KV, rep, Dl) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_k2_empty_rows_give_zeros():
    """kv_lens 0: no valid row, the output is 0 (acc 0 / max(l, 1e-30))."""
    q, k, v = _inputs(3, 1, 2, 2, 1, 100, 128, 16)
    out = flash_decode_plain(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             torch.tensor([0, 5], dtype=torch.int32), 0)
    assert torch.isfinite(out).all()
    assert not out[0].any() and out[1].abs().sum() > 0


def test_plain_k2_bf16_matches_masked_softmax():
    """bf16 q and cache, as in the model: the decode path equals a masked
    softmax over the valid rows in f32, rounded once to bf16."""
    q, k, v = _inputs(5, 2, 1, 4, 1, 100, 128, 32)
    qb, kb, vb = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    lens = torch.tensor([9], dtype=torch.int32)
    got = flash_decode(qb, kb, vb, lens, torch.tensor([1], dtype=torch.int32))
    qf, kf, vf = qb.float(), kb[1, :, :, :9, :100].float(), vb[1, :, :, :9, :100].float()
    s = torch.einsum("bkrd,bksd->bkrs", qf, kf) / 10.0
    want = torch.einsum("bkrs,bksd->bkrd", torch.softmax(s, -1), vf)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=1e-2, atol=1e-2)
