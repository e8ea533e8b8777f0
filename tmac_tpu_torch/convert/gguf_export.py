"""Packed checkpoint -> gguf artifact (the llama-quantize role; the PyTorch
package's copy of ``tmac_tpu/convert/gguf_export.py``, byte for byte the
JAX package's file for the same params).

Export dequantizes each packed matrix through the dequant contract
(Wdq = scales * wq - sub, the same math qgemm executes), on the params'
device, then requantizes it into the target gguf block type (on the card
for Q4_K, Q8_0, F16 and F32, with the same bytes): llama-
quantize's semantics (dequant -> requant), so a Q4_0 -> checkpoint -> Q4_0
round trip is lossless (block boundaries at 32 divide group_size).  The
tensors are made one at a time as the writer reaches them
(convert/gguf.write_gguf, Lazy), so a model is never held as float in
host memory.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tmac_tpu_torch.convert import gguf as gg
from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, unpack_codes

WTYPE_BY_NAME = {
    "Q4_0": gg.GGML_Q4_0, "Q4_1": gg.GGML_Q4_1, "Q5_0": gg.GGML_Q5_0,
    "Q5_1": gg.GGML_Q5_1, "Q8_0": gg.GGML_Q8_0, "Q2_K": gg.GGML_Q2_K,
    "Q3_K": gg.GGML_Q3_K, "Q4_K": gg.GGML_Q4_K,
    "Q5_K": gg.GGML_Q5_K, "Q6_K": gg.GGML_Q6_K, "TQ1_0": gg.GGML_TQ1_0,
    "TQ2_0": gg.GGML_TQ2_0, "I2_S": gg.GGML_I2_S, "F16": gg.GGML_F16,
    "F32": gg.GGML_F32,
}


def _columns(qt: QuantizedTensor, c0: int, c1: int) -> torch.Tensor:
    """Padded columns [c0, c1) of a tp=1 tensor dequantized, (Kp, c1 - c0)
    f32 on its device: scales * wq - sub per k-group, in two roundings as
    the JAX package's numpy dequant."""
    cut = dataclasses.replace(
        qt, packed=qt.packed[:, c0:c1],
        packed_hi=qt.packed_hi[:, c0:c1] if qt.packed_hi is not None else None)
    w = unpack_codes(cut).float()
    Kp, G = w.shape[0], qt.scales.shape[0]
    w = w.reshape(G, Kp // G, c1 - c0)
    sc = qt.scales[:, c0:c1].float()[:, None, :]
    sb = qt.sub[:, c0:c1].float()[:, None, :]
    return (sc * w - sb).reshape(Kp, c1 - c0)


def _check_tp1(qt: QuantizedTensor) -> None:
    if qt.k_shards != 1 or qt.m_shards != 1:
        raise ValueError("export needs a tp=1 checkpoint (convert with tp=1)")


def dequant_float(qt: QuantizedTensor) -> torch.Tensor:
    """A QuantizedTensor dequantized to f32 at its logical (K, M) shape, on
    its device (tp=1)."""
    _check_tp1(qt)
    return qt.slice_m(_columns(qt, 0, qt.mdim_padded))[: qt.kdim]


def qt_to_float(qt: QuantizedTensor) -> np.ndarray:
    """Dequantize a QuantizedTensor to float32 numpy at its logical (K, M)
    shape via the dequant contract.  Requires an unsharded (tp=1) tensor."""
    return dequant_float(qt).cpu().numpy()


def split_fused(qt: QuantizedTensor, wdq):
    """Split a fuse_m tensor's dequantized (K, M) matrix back into its
    logical components ([q|k|v] or [gate|up])."""
    if qt.m_segments is None:
        return [wdq]
    out, off = [], 0
    for (Mi, _) in qt.m_segments:
        out.append(wdq[:, off:off + Mi])
        off += Mi
    return out


def _parts(qt: QuantizedTensor) -> List[tuple]:
    """(logical width, first padded column) of each fuse_m component (one
    for a plain tensor)."""
    _check_tp1(qt)
    if qt.m_segments is None:
        return [(qt.mdim, 0)]
    out, off = [], 0
    for (Mi, mspi) in qt.m_segments:
        out.append((Mi, off))
        off += mspi
    return out


def _lazy_parts(qt: QuantizedTensor) -> List[gg.Lazy]:
    """Each component of qt (K, M) as gguf's (M_i, K) f32 rows on qt's
    device (where the writer packs them), made when the writer reaches
    it, from its columns alone."""
    def make(Mi, c0):
        return lambda: _columns(qt, c0, c0 + Mi)[: qt.kdim].t().contiguous()
    return [gg.Lazy((Mi, qt.kdim), make(Mi, c0)) for Mi, c0 in _parts(qt)]


def _lazy_stacked(stacked: QuantizedTensor) -> List[gg.Lazy]:
    """Each component of a stack of E experts as gguf's 3-D (E, M_i, K)."""
    from tmac_tpu_torch.models.moe import expert_view, num_local_experts
    E = num_local_experts(stacked)

    def make(Mi, c0):
        def run():
            return torch.stack([_columns(expert_view(stacked, e), c0, c0 + Mi)[: stacked.kdim].t()
                                for e in range(E)])
        return run
    return [gg.Lazy((E, Mi, stacked.kdim), make(Mi, c0)) for Mi, c0 in _parts(stacked)]


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def export_gguf(path: str, cfg: ModelConfig, params: Dict[str, Any],
                wtype: str = "auto", ckpt_dir: Optional[str] = None,
                arch: str = "llama") -> Dict[str, Any]:
    """Write `params` as a llama.cpp-compatible gguf.

    wtype: matmul block type (WTYPE_BY_NAME key).  'auto' picks from the
    checkpoint's quant mode: ternary w_a8 -> TQ2_0, bits=8 -> Q8_0,
    bits<=2 grouped -> Q4_0 (no 2-bit legacy block type exists in
    llama.cpp), else Q4_0/Q4_1 by zero_point.  Embeddings export F16,
    norms/biases F32, output.weight Q8_0 (lossless-ish head like
    llama.cpp's high-precision head defaults).  ckpt_dir: a checkpoint
    directory whose tokenizer rides along.  Returns a summary dict.
    """
    if cfg.num_experts > 0 and arch == "llama" \
            and cfg.moe_shared_intermediate_size > 0:
        # shared-expert family: the reader keys routing behavior off the
        # architecture string (convert/gguf.model_config_from_gguf)
        arch = "qwen2moe"
    if wtype == "auto":
        if cfg.quant.mode == "w_a8":
            wtype = "TQ2_0"
        elif cfg.quant.bits == 8:
            wtype = "Q8_0"
        elif cfg.quant.bits == 4 and cfg.quant.zero_point:
            wtype = "Q4_1"
        else:
            wtype = "Q4_0"
    wt = WTYPE_BY_NAME[wtype]

    md: Dict[str, Any] = {
        "general.architecture": arch,
        "general.name": cfg.name,
        f"{arch}.embedding_length": int(cfg.hidden_size),
        f"{arch}.block_count": int(cfg.num_layers),
        f"{arch}.attention.head_count": int(cfg.num_heads),
        f"{arch}.attention.head_count_kv": int(cfg.num_kv_heads),
        f"{arch}.attention.key_length": int(cfg.head_dim),
        f"{arch}.vocab_size": int(cfg.vocab_size),
        f"{arch}.rope.freq_base": float(cfg.rope_theta),
        f"{arch}.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
        f"{arch}.context_length": int(cfg.max_position_embeddings),
    }
    if cfg.sliding_window > 0:
        md[f"{arch}.attention.sliding_window"] = int(cfg.sliding_window)
    # feed_forward_length from the actual tensors (init_params may pad the
    # configured intermediate size to the lane multiple)
    l0 = params["layers"][0]
    if cfg.num_experts > 0:
        md[f"{arch}.feed_forward_length"] = int(l0["experts_down"].kdim)
        md[f"{arch}.expert_count"] = int(cfg.num_experts)
        md[f"{arch}.expert_used_count"] = int(cfg.num_experts_per_tok)
        md[f"{arch}.expert_feed_forward_length"] = int(l0["experts_down"].kdim)
        if "shared_down" in l0:
            md[f"{arch}.expert_shared_feed_forward_length"] = int(
                l0["shared_down"].kdim)
    else:
        md[f"{arch}.feed_forward_length"] = int(l0["down"].kdim)

    rope_freqs = None
    if cfg.rope_scaling is not None:
        kind = cfg.rope_scaling[0]
        if kind in ("factors", "llama3"):
            # stored as the per-dim divisor tensor llama.cpp uses for
            # llama-3.1-style scaling (rope_freqs.weight)
            from tmac_tpu_torch.models.llama import rope_freqs as inv_freqs
            base, _ = inv_freqs(cfg.head_dim, cfg.rope_theta, None)
            scaled, _ = inv_freqs(cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)
            rope_freqs = (base / scaled).astype(np.float32)
        elif kind == "linear":
            md[f"{arch}.rope.scaling.type"] = "linear"
            md[f"{arch}.rope.scaling.factor"] = float(cfg.rope_scaling[1])
        elif kind == "yarn":
            md[f"{arch}.rope.scaling.type"] = "yarn"
            md[f"{arch}.rope.scaling.factor"] = float(cfg.rope_scaling[1])
            md[f"{arch}.rope.scaling.original_context_length"] = int(
                cfg.rope_scaling[2])

    # embedded tokenizer rides along when the checkpoint has one
    if ckpt_dir is not None:
        from tmac_tpu_torch.runtime.tokenizer import load_tokenizer
        tok = load_tokenizer(ckpt_dir)
        if tok is not None:
            md["tokenizer.ggml.model"] = tok.MODEL
            md["tokenizer.ggml.tokens"] = tok.tokens
            md["tokenizer.ggml.token_type"] = [int(t) for t in tok.token_types]
            if tok.MODEL == "llama":
                md["tokenizer.ggml.scores"] = [float(s) for s in tok.scores]
                md["tokenizer.ggml.add_space_prefix"] = bool(tok.add_space_prefix)
            else:
                md["tokenizer.ggml.merges"] = tok.merges
            if tok.bos_token_id is not None:
                md["tokenizer.ggml.bos_token_id"] = int(tok.bos_token_id)
            if tok.eos_token_id is not None:
                md["tokenizer.ggml.eos_token_id"] = int(tok.eos_token_id)
            if tok.unk_token_id is not None:
                md["tokenizer.ggml.unknown_token_id"] = int(tok.unk_token_id)
            md["tokenizer.ggml.add_bos_token"] = bool(tok.add_bos)
            if tok.chat_template:
                md["tokenizer.chat_template"] = tok.chat_template

    # gguf stores weights as (rows=out_features, cols=in_features); the
    # (K, M) layout is (in, out) -> transposed on the way out
    tensors: Dict[str, tuple] = {
        "token_embd.weight": (gg.GGML_F16, params["embed"]),
        "output_norm.weight": (gg.GGML_F32, params["final_norm"]),
    }
    if rope_freqs is not None:
        tensors["rope_freqs.weight"] = (gg.GGML_F32, rope_freqs)
    if "lm_head" in params:
        head = params["lm_head"]
        tensors["output.weight"] = (
            gg.GGML_Q8_0, _lazy_parts(head)[0] if isinstance(head, QuantizedTensor)
            else _f32(head).T)

    for i, layer in enumerate(params["layers"]):
        p = f"blk.{i}"
        tensors[f"{p}.attn_norm.weight"] = (gg.GGML_F32, layer["attn_norm"])
        tensors[f"{p}.ffn_norm.weight"] = (gg.GGML_F32, layer["mlp_norm"])
        q, k, v = _lazy_parts(layer["wqkv"])
        matmuls = [("attn_q", q), ("attn_k", k), ("attn_v", v),
                   ("attn_output", _lazy_parts(layer["wo"])[0])]
        if cfg.num_experts > 0:
            # router (H, E) -> gguf (E, H) rows
            tensors[f"{p}.ffn_gate_inp.weight"] = (
                gg.GGML_F32, _f32(layer["moe_router"]).T)
            gates, ups = _lazy_stacked(layer["experts_gate_up"])
            # llama.cpp 3-D stacked expert layout: ne=[in, out, E]
            tensors[f"{p}.ffn_gate_exps.weight"] = (wt, gates)
            tensors[f"{p}.ffn_up_exps.weight"] = (wt, ups)
            tensors[f"{p}.ffn_down_exps.weight"] = (
                wt, _lazy_stacked(layer["experts_down"])[0])
            if "shared_down" in layer:
                sg, su = _lazy_parts(layer["shared_gate_up"])
                matmuls += [("ffn_gate_shexp", sg), ("ffn_up_shexp", su),
                            ("ffn_down_shexp", _lazy_parts(layer["shared_down"])[0])]
                if "shared_gate" in layer:
                    tensors[f"{p}.ffn_gate_inp_shexp.weight"] = (
                        gg.GGML_F32, _f32(layer["shared_gate"]).reshape(1, -1))
        else:
            gate, up = _lazy_parts(layer["gate_up"])
            matmuls += [("ffn_gate", gate), ("ffn_up", up),
                        ("ffn_down", _lazy_parts(layer["down"])[0])]
        for name, w in matmuls:
            tensors[f"{p}.{name}.weight"] = (wt, w)
        for ours, gname in (("bq", "attn_q"), ("bk", "attn_k"), ("bv", "attn_v")):
            if ours in layer:
                tensors[f"{p}.{gname}.bias"] = (gg.GGML_F32, layer[ours])

    gg.write_gguf(path, md, tensors)
    return {"path": path, "wtype": wtype, "tensors": len(tensors),
            "bytes": os.path.getsize(path)}
