"""The port's long-context RoPE scaling (models/llama.rope_freqs and
rope_tables) against the JAX package's (_scaled_inv_freqs, rope_tables),
the counterpart of tests/test_rope_scaling.py: the inverse frequencies of
every form bit for bit (both compute them in float64 numpy), and the
cos/sin tables at positions up to 131071 within a measured tolerance.

torch's and XLA's CPU cos and sin may round differently in the last bit:
at these positions (angles up to ~1.3e5 radians) the tables differed by at
most 1.2e-7 absolute, measured on the CPU (YaRN's table scale included:
the same f32 multiply on both sides); the gate leaves room for another
CPU's math library.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models.llama import _scaled_inv_freqs
from tmac_tpu.models.llama import rope_tables as jax_rope_tables
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import rope_freqs, rope_tables

TABLE_ATOL = 1e-6

SCALINGS = [
    None,
    ("linear", 4.0),
    ("factors", tuple(np.linspace(1.0, 8.0, 64))),
    ("llama3", 8.0, 8192, 1.0, 4.0),
    ("yarn", 4.0, 4096),
    ("yarn", 40.0, 4096),
]
IDS = ["plain", "linear", "factors", "llama3", "yarn", "yarn40"]


@pytest.mark.parametrize("theta", [10000.0, 500000.0])
@pytest.mark.parametrize("scaling", SCALINGS, ids=IDS)
def test_inv_freqs_match_bit_for_bit(scaling, theta):
    want, want_scale = _scaled_inv_freqs(128, theta, scaling)
    got, got_scale = rope_freqs(128, theta, scaling)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert got_scale == want_scale


def test_llama31_preset_freqs_match():
    cfg = get_preset("llama-3.1-8b")
    want, _ = _scaled_inv_freqs(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
    np.testing.assert_array_equal(rope_freqs(cfg.head_dim, cfg.rope_theta,
                                             cfg.rope_scaling)[0], want)


@pytest.mark.parametrize("scaling", SCALINGS, ids=IDS)
def test_tables_match_at_long_positions(scaling):
    theta = 500000.0
    pos = np.concatenate([np.arange(0, 64), np.array([8191, 8192, 32767, 65536,
                                                      100000, 131071])])[None, :]
    pos = pos.astype(np.int32)
    jc, js = jax.jit(jax_rope_tables, static_argnums=(1, 2, 3))(
        jnp.asarray(pos), 128, theta, scaling)
    freqs, scale = rope_freqs(128, theta, scaling)
    tc, ts = rope_tables(torch.from_numpy(pos), torch.from_numpy(freqs), scale)
    for got, want in ((tc, jc), (ts, js)):
        want = np.asarray(want)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TABLE_ATOL)


def test_unknown_scaling_raises():
    with pytest.raises(ValueError):
        rope_freqs(128, 10000.0, ("ntk", 2.0))
    with pytest.raises(ValueError):
        rope_freqs(128, 10000.0, ("factors", (1.0, 2.0)))
