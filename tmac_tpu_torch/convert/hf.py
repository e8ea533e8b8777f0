"""Hugging Face checkpoint -> the port's packed params (the port of
``tmac_tpu/convert/hf.py``).

Reads a HF model directory (safetensors, sharded or not), unpacks GPTQ and
AWQ tensors, ternarizes BitNet master weights or quantizes plain float
weights, and packs everything into QuantizedTensors on the device, byte
for byte the JAX package's conversion.  Supported inputs:
  * GPTQ / GPTQModel / EfficientQAT int-packed (qweight/qzeros/scales),
    bits 2-4 (bits 3 as a 2-bit and a 1-bit plane);
  * AutoAWQ "gemm" checkpoints;
  * BitNet b1.58 full-precision master weights (quant.mode "w_a8");
  * plain fp16/bf16/fp32 weights (quantized at the given QuantConfig).
Dense Llama/Qwen2 (attention biases, tied and bf16 heads), Mixtral and
Qwen2-MoE experts.  The machine with the card has no ``safetensors``
package, so the files are read with the port's own reader
(convert/checkpoint.load_safetensors).
"""

from __future__ import annotations

import dataclasses
import json
import os
from glob import glob
from typing import Any, Dict, Optional

import numpy as np
import torch

from tmac_tpu_torch.convert.bitnet import quantize_bitnet
from tmac_tpu_torch.convert.checkpoint import load_safetensors
from tmac_tpu_torch.convert.gptq import unpack_awq, unpack_gptq
from tmac_tpu_torch.models.config import ModelConfig, QuantConfig
from tmac_tpu_torch.models.llama import (_padded_ffn_width, make_head,
                                          padded_intermediate,
                                          padded_moe_intermediate)
from tmac_tpu_torch.models.moe import stack_experts
from tmac_tpu_torch.ops.packing import quantize_weights
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m


class HFReader:
    """Tensor reader over a HF model directory: the index of a sharded
    checkpoint (model.safetensors.index.json) or every *.safetensors file;
    each file memory-mapped at its first read."""

    def __init__(self, model_dir: str):
        self.dir = model_dir
        self.tensor_index: Dict[str, str] = {}
        idx = os.path.join(model_dir, "model.safetensors.index.json")
        if os.path.exists(idx):
            with open(idx) as f:
                self.tensor_index = json.load(f)["weight_map"]
        else:
            for path in sorted(glob(os.path.join(model_dir, "*.safetensors"))):
                for name in load_safetensors(path)[0]:
                    self.tensor_index[name] = os.path.basename(path)
        self._files: Dict[str, Any] = {}

    def __contains__(self, name: str) -> bool:
        return name in self.tensor_index

    def get_raw(self, name: str):
        """(numpy array, safetensors dtype name); BF16 as uint16 bits."""
        fname = self.tensor_index[name]
        if fname not in self._files:
            self._files[fname] = load_safetensors(os.path.join(self.dir, fname))
        arrays, dtypes = self._files[fname]
        return arrays[name], dtypes[name]

    def get(self, name: str) -> np.ndarray:
        """The tensor as numpy, BF16 widened exactly to float32."""
        a, dtype = self.get_raw(name)
        if dtype == "BF16":
            return (a.astype(np.uint32) << 16).view(np.float32)
        return np.array(a)

    def keys(self):
        return self.tensor_index.keys()


def read_hf_config(model_dir: str) -> dict:
    with open(os.path.join(model_dir, "config.json")) as f:
        return json.load(f)


def _rope_scaling_from_hf(hf: dict):
    """HF config.json rope_scaling -> ModelConfig.rope_scaling ("llama3",
    "linear", "yarn"; None for none or "default")."""
    rs = hf.get("rope_scaling") or None
    if not rs:
        return None
    t = rs.get("rope_type") or rs.get("type")
    if t in (None, "default"):
        return None
    if t == "linear":
        return ("linear", float(rs["factor"]))
    if t == "llama3":
        return ("llama3", float(rs["factor"]),
                int(rs.get("original_max_position_embeddings", 8192)),
                float(rs.get("low_freq_factor", 1.0)),
                float(rs.get("high_freq_factor", 4.0)))
    if t == "yarn":
        return ("yarn", float(rs["factor"]),
                int(rs.get("original_max_position_embeddings", 4096)))
    raise NotImplementedError(f"rope_scaling type {t!r}")


def model_config_from_hf(hf: dict, quant: QuantConfig,
                         name: str = "hf-model") -> ModelConfig:
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    # MoE: Mixtral (num_local_experts, renormalized top-k) or Qwen2-MoE
    # (num_experts, moe_intermediate_size, a gated shared expert, and
    # norm_topk_prob defaulting to False as in HF's Qwen2MoeConfig)
    num_experts = hf.get("num_local_experts") or hf.get("num_experts") or 0
    shared = hf.get("shared_expert_intermediate_size", 0) if num_experts else 0
    return ModelConfig(
        num_experts=num_experts,
        num_experts_per_tok=hf.get("num_experts_per_tok", 2),
        moe_intermediate_size=(hf.get("moe_intermediate_size")
                               or hf["intermediate_size"]) if num_experts else 0,
        moe_norm_topk=bool(hf.get("norm_topk_prob",
                                  hf.get("model_type") != "qwen2_moe")),
        moe_shared_intermediate_size=shared,
        moe_shared_gate=bool(shared) and hf.get("model_type") == "qwen2_moe",
        name=name,
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        rope_theta=hf.get("rope_theta", 10000.0),
        max_position_embeddings=int(hf.get("max_position_embeddings", 4096)),
        rope_scaling=_rope_scaling_from_hf(hf),
        # one global window: honoured only where it covers every layer
        # (qwen2 gates it behind use_sliding_window and max_window_layers;
        # mistral and phi-3 set it unconditionally)
        sliding_window=int(hf.get("sliding_window") or 0)
        if (hf.get("use_sliding_window", True)
            and ("max_window_layers" not in hf
                 or int(hf["max_window_layers"] or 0) == 0)) else 0,
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        attention_bias=hf.get("attention_bias", False)
        or str(hf.get("model_type", "")).startswith("qwen2"),
        quant=quant,
    )


def quant_config_from_hf(hf: dict, mode_hint: Optional[str] = None):
    """HF quantization_config -> (QuantConfig, the packed format: "gptq",
    "gptq_v2" or "awq"), or None for a float checkpoint.  Act-order GPTQ
    (desc_act) and AWQ's gemv packing are refused."""
    qc = hf.get("quantization_config")
    if qc is None:
        return None
    if qc.get("quant_method") == "awq":
        version = str(qc.get("version", "gemm")).lower()
        if version != "gemm":
            raise ValueError(f"AWQ version {version!r} unsupported (gemm only)")
        return QuantConfig(
            bits=int(qc.get("bits", qc.get("w_bit", 4))),
            group_size=int(qc.get("group_size", qc.get("q_group_size", 128))),
            zero_point=bool(qc.get("zero_point", True)),
            mode=mode_hint or "w_fp",
        ), "awq"
    if qc.get("desc_act", False):
        raise ValueError("act-order (desc_act) GPTQ checkpoints are not supported")
    return QuantConfig(
        bits=qc["bits"],
        group_size=qc["group_size"],
        zero_point=not qc.get("sym", False),
        mode=mode_hint or "w_fp",
    ), qc.get("checkpoint_format", "gptq")


def _qt_from_hf_linear(reader: HFReader, prefix: str, quant: QuantConfig,
                       fmt, k_shards: int, m_shards: int, pad_k: int = 0,
                       pad_m: int = 0, device="cuda") -> QuantizedTensor:
    """One linear layer, prefix like 'model.layers.0.self_attn.q_proj';
    fmt the packed format ('gptq', 'gptq_v2', 'awq', or True for
    gptq_v2)."""
    if f"{prefix}.qweight" in reader:
        packed = (reader.get(f"{prefix}.qweight").view(np.int32),
                  reader.get(f"{prefix}.scales"),
                  reader.get(f"{prefix}.qzeros").view(np.int32))
        if fmt == "awq":
            wq, scales, sub, bits, gs = unpack_awq(*packed)
        else:
            wq, scales, sub, bits, gs = unpack_gptq(
                *packed, gptq_v2=(fmt is True or fmt == "gptq_v2"))
        if (bits, gs) != (quant.bits, quant.group_size):
            raise ValueError(f"{prefix}: bits {bits}, group size {gs}; the "
                             f"config says {quant.bits}, {quant.group_size}")
    else:
        # float weights, HF layout (M, K) -> kernel layout (K, M)
        w = np.asarray(reader.get(f"{prefix}.weight"), dtype=np.float32).T
        if quant.mode == "w_a8":
            wq, scales, sub = quantize_bitnet(w, k_shards=k_shards)
            gs, bits = w.shape[0] // k_shards, 2
        else:
            gs = quant.group_size if quant.group_size != -1 else w.shape[0]
            wq, scales, sub = quantize_weights(w, quant.bits, gs, quant.zero_point)
            bits = quant.bits

    if pad_k and wq.shape[0] < pad_k:
        wq = np.pad(wq, ((0, pad_k - wq.shape[0]), (0, 0)))
        if scales.shape[0] > k_shards or quant.mode != "w_a8":
            gp = pad_k // gs - scales.shape[0]
            if gp > 0:
                scales = np.pad(scales, ((0, gp), (0, 0)))
                sub = np.pad(sub, ((0, gp), (0, 0)))
    if pad_m and wq.shape[1] < pad_m:
        d = pad_m - wq.shape[1]
        wq = np.pad(wq, ((0, 0), (0, d)))
        scales = np.pad(scales, ((0, 0), (0, d)))
        sub = np.pad(sub, ((0, 0), (0, d)))

    # bf16 scales for grouped modes; per-tensor (BitNet) stays f32
    grouped = quant.mode != "w_a8" and gs < wq.shape[0]
    return QuantizedTensor.from_quantized(
        wq, scales, sub, bits=bits,
        group_size=gs if quant.mode != "w_a8" else wq.shape[0] // k_shards,
        k_shards=k_shards, m_shards=m_shards,
        scale_dtype=torch.bfloat16 if grouped else torch.float32, device=device)


def _bf16(reader: HFReader, name: str, device) -> torch.Tensor:
    """A float tensor of the checkpoint as bf16 on the device (float16 and
    float32 rounded to nearest even, as the reference's jnp.asarray)."""
    return torch.from_numpy(reader.get(name).astype(np.float32)).to(
        torch.bfloat16).to(device)


def convert_hf_model(model_dir: str, quant: Optional[QuantConfig] = None,
                     tp: int = 1, gptq_v2: Optional[bool] = None,
                     name: str = "hf-model", device="cuda"):
    """HF directory -> (ModelConfig, params) on `device`.

    quant: needed for a float checkpoint; read from quantization_config
    for a packed one (its mode then taken from quant when given).  tp:
    pack for tp-way tensor parallelism (q/k/v and gate/up m-sharded, wo
    and down k-sharded, FFN widths padded to tp * group size), as
    parallel/tp.py's shard_params slices them.  gptq_v2
    overrides the checkpoint's GPTQ format (v1 stores zero points - 1)."""
    hf = read_hf_config(model_dir)
    reader = HFReader(model_dir)
    inferred = quant_config_from_hf(hf)
    fmt = None
    if inferred is not None:
        qc, fmt = inferred
        if quant is not None:
            qc = dataclasses.replace(qc, mode=quant.mode)
        quant = qc
    if quant is None:
        raise ValueError("a float checkpoint needs an explicit QuantConfig")
    if gptq_v2 is not None and fmt != "awq":
        fmt = "gptq_v2" if gptq_v2 else "gptq"
    fmt = fmt or "gptq_v2"

    cfg = model_config_from_hf(hf, quant, name=name)
    Ipad = padded_intermediate(cfg, tp)

    def lin(prefix, k_shards, m_shards, **pad):
        return _qt_from_hf_linear(reader, prefix, quant, fmt, k_shards, m_shards,
                                  device=device, **pad)

    def bf16(n):
        return _bf16(reader, n, device)

    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        at = f"{p}.self_attn"
        layer = {
            "attn_norm": bf16(f"{p}.input_layernorm.weight"),
            "mlp_norm": bf16(f"{p}.post_attention_layernorm.weight"),
            "wqkv": fuse_m([lin(f"{at}.q_proj", 1, tp), lin(f"{at}.k_proj", 1, tp),
                            lin(f"{at}.v_proj", 1, tp)]),
            "wo": lin(f"{at}.o_proj", tp, 1),
        }
        if cfg.num_experts > 0:
            # Mixtral (block_sparse_moe: router gate, experts w1/w3/w2) or
            # Qwen2-MoE (mlp.experts.{e}.gate/up/down_proj, a gated shared
            # expert); DeepSeek's grouped routing is refused
            if f"{p}.mlp.shared_experts.gate_proj.weight" in reader:
                raise NotImplementedError(
                    "DeepSeek-style grouped-routing MoE checkpoints are not "
                    "supported")
            Iep = padded_moe_intermediate(cfg, tp)
            if f"{p}.block_sparse_moe.gate.weight" in reader:
                moe, names = f"{p}.block_sparse_moe", ("w1", "w3", "w2")
            else:
                moe, names = f"{p}.mlp", ("gate_proj", "up_proj", "down_proj")
            # HF (E, H) -> (H, E), through bf16 as the reference does
            router = bf16(f"{moe}.gate.weight").float().t()
            layer["moe_router"] = router.to(torch.bfloat16).contiguous()
            gn, un, dn = names
            layer["experts_gate_up"] = stack_experts([
                fuse_m([lin(f"{moe}.experts.{e}.{gn}", 1, tp, pad_m=Iep),
                        lin(f"{moe}.experts.{e}.{un}", 1, tp, pad_m=Iep)])
                for e in range(cfg.num_experts)])
            layer["experts_down"] = stack_experts([
                lin(f"{moe}.experts.{e}.{dn}", tp, 1, pad_k=Iep)
                for e in range(cfg.num_experts)])
            if cfg.moe_shared_intermediate_size:
                Isp = _padded_ffn_width(cfg.moe_shared_intermediate_size, cfg, tp)
                se = f"{p}.mlp.shared_expert"
                layer["shared_gate_up"] = fuse_m([
                    lin(f"{se}.gate_proj", 1, tp, pad_m=Isp),
                    lin(f"{se}.up_proj", 1, tp, pad_m=Isp)])
                layer["shared_down"] = lin(f"{se}.down_proj", tp, 1, pad_k=Isp)
                sg = f"{p}.mlp.shared_expert_gate.weight"
                if cfg.moe_shared_gate and sg in reader:
                    layer["shared_gate"] = bf16(sg).reshape(-1)  # (1, H) -> (H,)
        else:
            layer["gate_up"] = fuse_m([
                lin(f"{p}.mlp.gate_proj", 1, tp, pad_m=Ipad),
                lin(f"{p}.mlp.up_proj", 1, tp, pad_m=Ipad)])
            layer["down"] = lin(f"{p}.mlp.down_proj", tp, 1, pad_k=Ipad)
        if cfg.attention_bias:
            for hf_b, ours in (("q_proj", "bq"), ("k_proj", "bk"), ("v_proj", "bv")):
                if f"{at}.{hf_b}.bias" in reader:
                    layer[ours] = bf16(f"{at}.{hf_b}.bias")
        layers.append(layer)

    params: Dict[str, Any] = {
        "embed": bf16("model.embed_tokens.weight"),
        "layers": layers,
        "final_norm": bf16("model.norm.weight"),
    }
    if not cfg.tie_word_embeddings and "lm_head.weight" in reader:
        # (V, H) through bf16, as the reference reads it, -> (H, V)
        head = bf16("lm_head.weight").float().t().cpu().numpy()
        params["lm_head"] = make_head(np.ascontiguousarray(head), cfg, device)
    return cfg, params
