"""Model and quantization configuration (the PyTorch port's own copy).

A verbatim copy of ``tmac_tpu/models/config.py``: the port imports nothing
from the JAX package, and its tests hold ``PRESETS`` equal to the JAX ones
field for field.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How matmul weights are quantized.

    mode:
      "w_fp" -- low-bit weights x bf16 activations (GPTQ / EfficientQAT /
                BitDistiller style, reference m_groups=-1)
      "w_a8" -- low-bit weights x per-token int8 activations with
                per-tensor weight scale (BitNet W1.58A8, reference
                m_groups=1 + do_scale_final int path)
    group_size: k elements per weight scale group; -1 means per-tensor.
    act_group_size: independent activation quant granularity (the
      reference's -ags knob, run_pipeline.py:405-419).  0 (default) =
      activations quantized at the weight group granularity (grouped
      modes) / per token (per-tensor modes).  A positive value that
      divides group_size quantizes activations in finer groups on the
      chunked int8 kernel paths (accuracy knob; costs smaller MXU chunks).
    """

    bits: int = 2
    group_size: int = 128
    zero_point: bool = False
    mode: str = "w_fp"
    act_group_size: int = 0

    def validate(self):
        assert self.bits in (1, 2, 3, 4)
        assert self.mode in ("w_fp", "w_a8")
        if self.mode == "w_a8":
            assert self.group_size == -1, "w_a8 requires per-tensor scales"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab_size: int
    hidden_size: int
    intermediate_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    # RoPE frequency scaling for long-context checkpoints, as a hashable
    # tuple (cfg is a static jit arg).  None = plain RoPE.  Forms:
    #   ("linear", factor)
    #   ("yarn", factor, original_context_length)
    #   ("llama3", factor, original_ctx, low_freq_factor, high_freq_factor)
    #   ("factors", (f0, ..., f_{head_dim/2-1}))  per-dim frequency
    #     divisors -- the gguf rope_freqs.weight representation
    # Applied in models/llama.rope_tables.
    rope_scaling: Optional[tuple] = None
    # training context length (HF max_position_embeddings / gguf
    # context_length) -- metadata for interchange and cache sizing hints;
    # the runtime itself is bounded only by the allocated KV cache
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    # sliding-window attention (mistral/phi-3 family): kv position s is
    # visible to query position p iff p - s < sliding_window.  0 = full
    # attention.  Applied in the attention masks (llama._attention,
    # parallel.sp chunked attention) and as a static block-skip bound in
    # the flash-decode kernel (attention_kernel._kernel window=).
    sliding_window: int = 0
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    # lm_head precision: 8 = int8 QuantizedTensor (llama.cpp likewise
    # quantizes output.weight, Q6_K by default); 16 = keep bf16.  The head
    # read is ~20% of decode HBM traffic on BitNet-3B.
    head_bits: int = 8
    # Mixture-of-Experts (net-new vs the reference, which has no MoE model;
    # the LUT-mpGEMM kernels apply per expert unchanged).  num_experts = 0
    # means a dense MLP; > 0 replaces the MLP with num_experts expert FFNs
    # of width moe_intermediate_size routed top-num_experts_per_tok
    # (Mixtral-style: softmax over the selected router logits).
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_intermediate_size: int = 0
    # routing normalization: True = softmax over the k SELECTED logits
    # (Mixtral); False = softmax over ALL experts, then take the top-k
    # weights unrenormalized (Qwen2-MoE norm_topk_prob=False default)
    moe_norm_topk: bool = True
    # optional always-on shared expert (Qwen2-MoE/DeepSeek family): a
    # dense FFN of this width added to every token, sigmoid-gated by a
    # (H, 1) shared_expert_gate when moe_shared_gate is set
    moe_shared_intermediate_size: int = 0
    moe_shared_gate: bool = False
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def with_quant(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, quant=dataclasses.replace(self.quant, **kw))

    def scaled(self, factor: int) -> "ModelConfig":
        """A tiny version of this architecture for tests/dryruns."""
        def _r256(x):  # keep dims divisible by group_size and lanes
            return max(256, (x // 256) * 256)
        return dataclasses.replace(
            self,
            vocab_size=max(256, self.vocab_size // (8 * factor)),
            hidden_size=_r256(self.hidden_size // factor),
            intermediate_size=_r256(self.intermediate_size // factor),
            num_layers=2,
            num_heads=max(2, self.num_heads // factor),
            num_kv_heads=max(1, self.num_kv_heads // factor),
            head_dim=128,
            moe_intermediate_size=(
                _r256(self.moe_intermediate_size // factor)
                if self.moe_intermediate_size else 0),
            moe_shared_intermediate_size=(
                _r256(self.moe_shared_intermediate_size // factor)
                if self.moe_shared_intermediate_size else 0),
        )

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ModelConfig":
        d = json.loads(s)
        d["quant"] = QuantConfig(**d["quant"])
        rs = d.get("rope_scaling")
        if rs is not None:  # json lists -> hashable tuples
            d["rope_scaling"] = tuple(
                tuple(x) if isinstance(x, list) else x for x in rs)
        return cls(**d)


def _bitnet_quant():
    return QuantConfig(bits=2, group_size=-1, zero_point=False, mode="w_a8")


# Architectures match the shape lists in reference model_utils.py:19-88 and
# the HF configs of the named checkpoints.
PRESETS = {
    # 1bitLLM/bitnet_b1_58-3B (reference "hf-bitnet-3b": M/K in
    # {3200x8640, 8640x3200, 3200x3200})
    "bitnet-3b": ModelConfig(
        name="bitnet-3b", max_position_embeddings=2048, vocab_size=32002, hidden_size=3200,
        intermediate_size=8640, num_layers=26, num_heads=32, num_kv_heads=32,
        head_dim=100, rope_theta=10000.0, rms_norm_eps=1e-6,
        quant=_bitnet_quant(),
    ),
    # 1bitLLM/bitnet_b1_58-large, 700M (reference "hf-bitnet-large-intn")
    "bitnet-700m": ModelConfig(
        name="bitnet-700m", max_position_embeddings=2048, vocab_size=32002, hidden_size=1536,
        intermediate_size=4096, num_layers=24, num_heads=16, num_kv_heads=16,
        head_dim=96, rms_norm_eps=1e-6, quant=_bitnet_quant(),
    ),
    # microsoft/BitNet-b1.58-2B-4T (the model T-MAN serves at ~50 t/s)
    "bitnet-2b-4t": ModelConfig(
        name="bitnet-2b-4t", vocab_size=128256, hidden_size=2560,
        intermediate_size=6912, num_layers=30, num_heads=20, num_kv_heads=5,
        head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
        quant=_bitnet_quant(),
    ),
    # reference "llama-2-7b-2bit"/"-4bit"
    "llama-2-7b": ModelConfig(
        name="llama-2-7b", vocab_size=32000, hidden_size=4096,
        intermediate_size=11008, num_layers=32, num_heads=32, num_kv_heads=32,
        head_dim=128, rms_norm_eps=1e-5,
        quant=QuantConfig(bits=2, group_size=128, zero_point=True),
    ),
    "llama-2-13b": ModelConfig(
        name="llama-2-13b", vocab_size=32000, hidden_size=5120,
        intermediate_size=13824, num_layers=40, num_heads=40, num_kv_heads=40,
        head_dim=128, rms_norm_eps=1e-5,
        quant=QuantConfig(bits=2, group_size=128, zero_point=True),
    ),
    "llama-3-8b": ModelConfig(
        name="llama-3-8b", max_position_embeddings=8192, vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
        quant=QuantConfig(bits=2, group_size=128, zero_point=True),
    ),
    # meta-llama/Llama-3.1-8B: llama-3-8b shapes + the llama3 piecewise
    # rope scaling (factor 8 over the 8192 original context) -- exercises
    # ModelConfig.rope_scaling end-to-end
    "llama-3.1-8b": ModelConfig(
        name="llama-3.1-8b", max_position_embeddings=131072, vocab_size=128256, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=500000.0, rms_norm_eps=1e-5,
        rope_scaling=("llama3", 8.0, 8192, 1.0, 4.0),
        quant=QuantConfig(bits=2, group_size=128, zero_point=True),
    ),
    # reference "phi-3-mini-2bit" (Phi-3-mini-4k-instruct: sliding
    # window 2047 per its HF config -- no effect at ctx <= 2047, bounds
    # attention beyond it)
    "phi-3-mini": ModelConfig(
        name="phi-3-mini", vocab_size=32064, hidden_size=3072,
        intermediate_size=8192, num_layers=32, num_heads=32, num_kv_heads=32,
        head_dim=96, rms_norm_eps=1e-5, sliding_window=2047,
        quant=QuantConfig(bits=2, group_size=128, zero_point=True),
    ),
    # BASELINE.json serving config: Qwen2-7B GPTQ-Int4
    "qwen2-7b": ModelConfig(
        name="qwen2-7b", max_position_embeddings=32768, vocab_size=152064, hidden_size=3584,
        intermediate_size=18944, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-6,
        attention_bias=True,
        quant=QuantConfig(bits=4, group_size=128, zero_point=True),
    ),
    # BASELINE.json serving config: Phi-3.5 W2
    "phi-3.5-mini": ModelConfig(
        name="phi-3.5-mini", max_position_embeddings=131072, vocab_size=32064, hidden_size=3072,
        intermediate_size=8192, num_layers=32, num_heads=32, num_kv_heads=32,
        head_dim=96, rope_theta=10000.0, rms_norm_eps=1e-5,
        quant=QuantConfig(bits=2, group_size=128, zero_point=True),
    ),
    # Mixtral-8x7B-v0.1 (the MoE family: 8 experts, top-2 routing; W2 GPTQ
    # EfficientQAT-style quantization applies per expert exactly as to a
    # dense MLP -- the reference's kernels have no MoE user only because
    # its llama.cpp harness predates one in its model list)
    "mixtral-8x7b": ModelConfig(
        name="mixtral-8x7b", max_position_embeddings=32768, vocab_size=32000, hidden_size=4096,
        intermediate_size=14336, num_layers=32, num_heads=32, num_kv_heads=8,
        head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-5,
        num_experts=8, num_experts_per_tok=2, moe_intermediate_size=14336,
        quant=QuantConfig(bits=2, group_size=128, zero_point=True),
    ),
    # Qwen2-57B-A14B (the shared-expert MoE family: 64 experts top-8 with
    # all-expert-softmax routing, norm_topk_prob=False, plus an always-on
    # sigmoid-gated shared expert)
    "qwen2-moe-a14b": ModelConfig(
        name="qwen2-moe-a14b", max_position_embeddings=32768, vocab_size=151936, hidden_size=3584,
        intermediate_size=2560, num_layers=28, num_heads=28, num_kv_heads=4,
        head_dim=128, rope_theta=1000000.0, rms_norm_eps=1e-6,
        attention_bias=True, num_experts=64, num_experts_per_tok=8,
        moe_intermediate_size=2560, moe_norm_topk=False,
        moe_shared_intermediate_size=20480, moe_shared_gate=True,
        quant=QuantConfig(bits=4, group_size=128, zero_point=True),
    ),
    # reference "trilm-3.9b"
    "trilm-3.9b": ModelConfig(
        name="trilm-3.9b", max_position_embeddings=2048, vocab_size=50688, hidden_size=3072,
        intermediate_size=9216, num_layers=30, num_heads=24, num_kv_heads=24,
        head_dim=128, rms_norm_eps=1e-5,
        quant=QuantConfig(bits=2, group_size=128, zero_point=False),
    ),
}


def get_preset(name: str, bits: Optional[int] = None, **quant_kw) -> ModelConfig:
    cfg = PRESETS[name]
    if bits is not None:
        quant_kw["bits"] = bits
    if quant_kw:
        cfg = cfg.with_quant(**quant_kw)
    return cfg
