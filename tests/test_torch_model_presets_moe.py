"""qwen2-moe-a14b (attention bias, 64 experts top-8 with a gated shared
expert, W4A16 g128) at ``.scaled(8)`` against the JAX package, as
tests/test_torch_model_presets.py holds the dense presets: ``init_params``
byte for byte, an 8-token prefill and 4 greedy decode steps teacher-forced
against ``forward(impl="pallas")``, with the same nonzero q/k/v biases in
both trees.  Its own file, so that the test runner's workers split the
load.

The MoE block's f32 steps (the router's and the combine's dot orders,
XLA's per-shape FMA pairing; tests/test_torch_moe.py) differ in the last
bits, which bf16 roundings show, so the logits are held to Mixtral's gates
(tests/test_torch_model.py): measured on the CPU, NMSE 9.9e-5 without XLA's
rsqrt values and 9.9e-5 with them (so not from the norms), argmax
agreement 1.0.
"""

import pytest

from tests.test_torch_model_presets import (assert_tree_equal, cfg_pair,
                                            check_logits, given_xla_rsqrt,
                                            port_logits, teacher_forced)
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.llama import init_params
from tmac_tpu_torch.utils import nmse

MOE_NMSE, MOE_GIVEN_RSQRT_NMSE = 3e-3, 3e-4


@pytest.fixture(scope="module")
def run():
    return teacher_forced(*cfg_pair("qwen2-moe-a14b"))


def test_qwen2_moe_init_params_match_jax_byte_for_byte(run):
    cfg = run["cfg"]
    carried = params_from_numpy(run["tree"], cfg, device="cpu")
    assert_tree_equal(init_params(cfg, seed=0, device="cpu"), carried)
    layer = carried["layers"][0]
    assert {"bq", "shared_gate", "shared_gate_up", "experts_down"} <= layer.keys()


def test_qwen2_moe_logits_match_jax_pallas(run):
    check_logits(run, MOE_NMSE)


def test_qwen2_moe_given_xla_rsqrt(run, monkeypatch):
    given_xla_rsqrt(monkeypatch)
    got = port_logits(run["model"], run["prompt"], run["toks"])
    assert max(nmse(r, g) for r, g in zip(run["ref"], got)) <= MOE_GIVEN_RSQRT_NMSE
