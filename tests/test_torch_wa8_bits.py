"""w_a8 configs at bits 1, 3 and 4 against the JAX package.

The JAX package validates w_a8 at any of bits 1 to 4, but whatever the
config's bits, its init_params builds bits-2 ternary weights (as do its HF
converter, GGUF reader and CLI), so such a model runs K1 at bits 2 and its
int8 head; the port's init_params draws the same.  Each config at
bitnet-3b scaled(8) (head_dim 100, as tests/test_torch_model.py's BitNet
run) is held to JAX's forward(impl="pallas") teacher-forced, given XLA's
rsqrt values for the norm factors, at that file's gate: logits NMSE <=
1e-4 and tie-aware argmax agreement 1.0 on the prompt and each decode
step."""

import pytest
import torch

from tests.test_torch_model import (_cfgs, _given_xla_rsqrt, _logits_match,
                                    _teacher_forced)

torch.set_num_threads(2)


@pytest.mark.parametrize("bits", [1, 3, 4])
def test_wa8_at_bits_matches_jax_pallas(bits, monkeypatch):
    _given_xla_rsqrt(monkeypatch)
    cfg, jcfg = (c.with_quant(bits=bits) for c in _cfgs())
    run = _teacher_forced(cfg, jcfg)
    layer = run["model"].layers[0]
    assert {layer.wqkv.qt.bits, layer.down.qt.bits} == {2}
    assert {run["jparams"]["layers"][0][n].bits for n in ("wqkv", "down")} == {2}
    _logits_match(run)
