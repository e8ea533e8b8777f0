"""Model-level output-quality parity gate (the port's
``tmac_tpu/tools/parity.py``).

The strongest checkpoint-free proxy of the reference's llama-perplexity
gate, model-wide:

  * an INDEPENDENT f32 oracle forward in numpy (the JAX package's, copied:
    every quantized matmul a dense f32 ``x @ dequant(W)``, attention, norms,
    rope and SwiGLU recomputed from scratch), so kernel, packing and
    layout bugs all surface;
  * NMSE of the port's prefill logits (its kernels on the card: int8
    activations, a bf16 cache) against the oracle at every position;
  * per-layer and two-layer bisection (the port's layers from the oracle's
    hidden state), the full-size kernel-correctness gate;
  * tie-aware greedy agreement along the port's decode path, teacher-forced
    through the oracle, and the prompt's perplexity under both.

``model_parity`` runs the port's ``Llama`` on `device` ("cuda" unless the
caller asks for the CPU, where the kernels' plain versions run); impl
"plain" runs the plain versions on the card on purpose.  ``dense_weight``
is byte for byte the JAX package's.  Pass bars as the reference's
(tests/test_parity.py): median e2e and per-layer NMSE <= 2e-3 at test
scale, tie-aware agreement 1.0.
"""

from __future__ import annotations

import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

from tmac_tpu_torch.models.config import ModelConfig, get_preset
from tmac_tpu_torch.utils import nmse


# ---------------------------------------------------------------------------
# f32 densification
# ---------------------------------------------------------------------------

def _slice_m_np(qt, out: np.ndarray) -> np.ndarray:
    """numpy mirror of QuantizedTensor.slice_m (m-unpad + fused-segment
    reorder)."""
    lead = out.shape[:-1]
    if qt.m_segments is not None:
        o = out.reshape(*lead, qt.m_shards, -1)
        pieces, off = [], 0
        for (Mi, mspi) in qt.m_segments:
            seg = o[..., off:off + mspi][..., : Mi // qt.m_shards]
            pieces.append(seg.reshape(*lead, Mi))
            off += mspi
        return np.concatenate(pieces, axis=-1)
    if qt.mdim_padded == qt.mdim:
        return out
    ms = qt.mdim // qt.m_shards
    msp = qt.mdim_padded // qt.m_shards
    o = out.reshape(*lead, qt.m_shards, msp)[..., :ms]
    return o.reshape(*lead, qt.mdim)


def _np32(t) -> np.ndarray:
    import torch
    return t.detach().to("cpu", torch.float32).numpy()


def dense_weight(qt) -> np.ndarray:
    """(K, M) f32 dequantized dense matrix of a packed QuantizedTensor, on
    the host, byte for byte the JAX package's: the stored codes as f32
    (bits 8 signed), then ``wq * scales - sub`` per group in numpy (a
    multiply and a subtraction, each rounded), the K padding of each shard
    and the M padding dropped."""
    from tmac_tpu_torch.ops.qgemm import unpack_codes
    wq = _np32(unpack_codes(qt))
    scales, sub = _np32(qt.scales), _np32(qt.sub)
    Kp, Mp = wq.shape
    gs = qt.group_size
    w = wq.reshape(Kp // gs, gs, Mp) * scales[:, None] - sub[:, None]
    w = w.reshape(Kp, Mp)
    ks, ksp = qt._k_pad_geometry()
    if ksp != ks:  # per-shard K unpad (inverse of pad_x_for)
        w = w.reshape(qt.k_shards, ksp, Mp)[:, :ks].reshape(qt.kdim, Mp)
    return _slice_m_np(qt, w)


def dense_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Walk an init_params/converter tree -> all-f32 numpy params."""
    from tmac_tpu_torch.models.moe import expert_view, num_local_experts
    from tmac_tpu_torch.ops.qgemm import QuantizedTensor

    out: Dict[str, Any] = {
        "embed": _np32(params["embed"]),
        "final_norm": _np32(params["final_norm"]),
        "layers": [],
    }
    for layer in params["layers"]:
        dl = {
            "attn_norm": _np32(layer["attn_norm"]),
            "mlp_norm": _np32(layer["mlp_norm"]),
            "wqkv": dense_weight(layer["wqkv"]),
            "wo": dense_weight(layer["wo"]),
        }
        if "experts_gate_up" in layer:
            E = num_local_experts(layer["experts_gate_up"])
            dl["moe_router"] = _np32(layer["moe_router"])
            dl["experts_gate_up"] = [dense_weight(expert_view(layer["experts_gate_up"], e))
                                     for e in range(E)]
            dl["experts_down"] = [dense_weight(expert_view(layer["experts_down"], e))
                                  for e in range(E)]
            if "shared_gate_up" in layer:
                dl["shared_gate_up"] = dense_weight(layer["shared_gate_up"])
                dl["shared_down"] = dense_weight(layer["shared_down"])
            if "shared_gate" in layer:
                dl["shared_gate"] = _np32(layer["shared_gate"])
        else:
            dl["gate_up"] = dense_weight(layer["gate_up"])
            dl["down"] = dense_weight(layer["down"])
        for b in ("bq", "bk", "bv"):
            if b in layer:
                dl[b] = _np32(layer[b])
        out["layers"].append(dl)
    if params.get("lm_head") is not None:
        head = params["lm_head"]
        out["lm_head"] = (dense_weight(head) if isinstance(head, QuantizedTensor)
                          else _np32(head))
    return out


# ---------------------------------------------------------------------------
# independent f32 oracle forward (numpy)
# ---------------------------------------------------------------------------

def _oracle_rms(x: np.ndarray, w: np.ndarray, eps: float) -> np.ndarray:
    var = np.mean(np.square(x), axis=-1, keepdims=True)
    return x / np.sqrt(var + eps) * w


def _oracle_inv_freqs(half: int, theta: float, scaling) -> tuple:
    """INDEPENDENT reimplementation of the rope-scaling frequency math
    (models/llama._scaled_inv_freqs): the gate must catch a bug there, so
    the formulas are written out again rather than imported."""
    f = theta ** (-np.arange(half, dtype=np.float64) / half)
    if scaling is None:
        return f, 1.0
    kind = scaling[0]
    if kind == "linear":
        return f / scaling[1], 1.0
    if kind == "factors":
        return f / np.asarray(scaling[1], np.float64), 1.0
    if kind == "llama3":
        _, fac, orig, lo, hi = scaling
        wl = 2 * np.pi / f
        t = np.clip((orig / wl - lo) / (hi - lo), 0.0, 1.0)
        out = np.where(wl < orig / hi, f,
                       np.where(wl > orig / lo, f / fac,
                                (1 - t) * (f / fac) + t * f))
        return out, 1.0
    if kind == "yarn":
        _, fac, orig = scaling
        def cd(nr):  # dim = 2*half in the published formula
            return half * np.log(orig / (nr * 2 * np.pi)) / np.log(theta)
        lo_d = max(np.floor(cd(32.0)), 0.0)
        hi_d = min(np.ceil(cd(1.0)), half - 1.0)
        ramp = np.clip((np.arange(half) - lo_d) / max(hi_d - lo_d, 1e-3),
                       0.0, 1.0)
        out = (f / fac) * ramp + f * (1.0 - ramp)
        return out, 0.1 * np.log(fac) + 1.0
    raise ValueError(kind)


def _oracle_rope(x: np.ndarray, positions: np.ndarray, theta: float,
                 scaling=None) -> np.ndarray:
    """x (B, T, H, D), positions (T,) -- duplicated-half rotary convention
    (rotate_half), matching models/llama.rope; honors rope_scaling via an
    independent frequency computation."""
    D = x.shape[-1]
    half = D // 2
    freqs, tscale = _oracle_inv_freqs(half, theta, scaling)
    ang = positions[:, None].astype(np.float64) * freqs  # (T, half)
    cos = (np.concatenate([np.cos(ang), np.cos(ang)], -1)
           * tscale)[None, :, None, :].astype(np.float32)
    sin = (np.concatenate([np.sin(ang), np.sin(ang)], -1)
           * tscale)[None, :, None, :].astype(np.float32)
    rot = np.concatenate([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def oracle_forward(dense: Dict[str, Any], cfg,
                   tokens: np.ndarray,
                   collect_layer_io: Optional[list] = None) -> np.ndarray:
    """Full-causal fresh prefill in f64-accumulated f32 numpy.
    tokens (B, T) -> logits (B, T, V).

    collect_layer_io: optional list; when given, the (B, T, H) hidden
    state is appended before every layer and once after the last (L+1
    entries) -- the per-layer bisection inputs/outputs."""
    B, T = tokens.shape
    H, D = cfg.num_heads, cfg.head_dim
    KV = cfg.num_kv_heads
    rep = H // KV
    eps = cfg.rms_norm_eps
    positions = np.arange(T)

    x = dense["embed"][tokens].astype(np.float32)  # (B, T, Hd)
    for layer in dense["layers"]:
        if collect_layer_io is not None:
            collect_layer_io.append(x.copy())
        h = _oracle_rms(x, layer["attn_norm"], eps)
        qkv = h @ layer["wqkv"]
        qd, kvd = cfg.q_dim, cfg.kv_dim
        q, k, v = qkv[..., :qd], qkv[..., qd:qd + kvd], qkv[..., qd + kvd:]
        if "bq" in layer:
            q, k, v = q + layer["bq"], k + layer["bk"], v + layer["bv"]
        q = _oracle_rope(q.reshape(B, T, H, D), positions, cfg.rope_theta,
                         cfg.rope_scaling)
        k = _oracle_rope(k.reshape(B, T, KV, D), positions, cfg.rope_theta,
                         cfg.rope_scaling)
        v = v.reshape(B, T, KV, D)
        # GQA causal attention, f32
        kr = np.repeat(k, rep, axis=2)  # (B, T, H, D)
        vr = np.repeat(v, rep, axis=2)
        scores = np.einsum("bthd,bshd->bhts", q, kr) / np.sqrt(D)
        mask = positions[None, :] <= positions[:, None]  # (T, S) causal
        if cfg.sliding_window > 0:  # SWA: s visible iff p - s < window
            mask &= positions[None, :] > positions[:, None] - cfg.sliding_window
        scores = np.where(mask[None, None], scores, -np.inf)
        scores -= scores.max(-1, keepdims=True)
        p = np.exp(scores)
        p /= p.sum(-1, keepdims=True)
        attn = np.einsum("bhts,bshd->bthd", p, vr).reshape(B, T, H * D)
        x = x + attn @ layer["wo"]
        h = _oracle_rms(x, layer["mlp_norm"], eps)
        if "moe_router" in layer:
            # top-k MoE (matches models/moe.route_topk): softmax over the
            # k SELECTED logits (Mixtral, moe_norm_topk) or over ALL
            # experts with unnormalized top-k weights (Qwen2-MoE); plus
            # the optional always-on gated shared expert
            h2 = h.reshape(-1, h.shape[-1])
            rl = h2 @ layer["moe_router"]  # (N, E)
            k = cfg.num_experts_per_tok

            def _ffn(v, wgu, wdn):
                gu = v @ wgu
                ihalf = gu.shape[-1] // 2
                g, u = gu[..., :ihalf], gu[..., ihalf:]
                return ((g / (1.0 + np.exp(-g))) * u) @ wdn

            moe = np.zeros_like(h2)
            for n in range(h2.shape[0]):
                sel = np.argsort(-rl[n], kind="stable")[:k]
                if cfg.moe_norm_topk:
                    w = np.exp(rl[n, sel] - rl[n, sel].max())
                    w = w / w.sum()
                else:
                    p_all = np.exp(rl[n] - rl[n].max())
                    w = (p_all / p_all.sum())[sel]
                for j, e in enumerate(sel):
                    moe[n] += w[j] * _ffn(h2[n],
                                          layer["experts_gate_up"][e],
                                          layer["experts_down"][e])
            if "shared_gate_up" in layer:
                ys = _ffn(h2, layer["shared_gate_up"],
                          layer["shared_down"])
                if "shared_gate" in layer:
                    gate = 1.0 / (1.0 + np.exp(-(h2 @ layer["shared_gate"])))
                    ys = ys * gate[:, None]
                moe = moe + ys
            x = x + moe.reshape(x.shape)
        else:
            gu = h @ layer["gate_up"]
            ihalf = gu.shape[-1] // 2
            g, u = gu[..., :ihalf], gu[..., ihalf:]
            silu = g / (1.0 + np.exp(-g))
            x = x + (silu * u) @ layer["down"]

    if collect_layer_io is not None:
        collect_layer_io.append(x.copy())
    x = _oracle_rms(x, dense["final_norm"], eps)
    if "lm_head" in dense:
        return x @ dense["lm_head"]
    return x @ dense["embed"].T


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

def _device(device):
    import torch
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("parity runs on the card: no CUDA device (device='cpu' "
                               "for a host run)")
        device = "cuda"
    return torch.device(device)


def model_parity(cfg: ModelConfig, seed: int = 0, T: int = 24,
                 decode_steps: int = 16, impl: str = "auto",
                 tie_margin: float = 0.35, device=None) -> Dict[str, Any]:
    """Run the gate for one config: the port's Llama (impl "auto": its
    kernels; "plain": their plain versions) on `device` ("cuda" by default)
    against the f32 oracle.  Returns the reference's metrics:

    nmse            -- MEDIAN per-position prefill logits NMSE
    nmse_max        -- worst position (random-init chaos lands here)
    agree           -- raw greedy agreement along the port's decode path
    agree_tie_aware -- agreement counting near-ties (oracle top1-top2 gap
                       or oracle-vs-chosen gap < tie_margin) as agreement
    max_disagree_gap -- largest oracle logit gap on any disagreement
    layer_nmse_*    -- per-layer bisection (the port's layer from the
                       oracle's input), pair_nmse_max two-layer windows
    ppl_* / nll_delta_median -- the prompt's perplexity under both
    """
    import torch
    from tmac_tpu_torch.models.llama import KVCache, Llama, init_params
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', not {impl!r}")
    dev = _device(device)
    plain = impl == "plain"
    rng = np.random.default_rng(seed)
    params = init_params(cfg, seed=seed, device=dev)
    dense = dense_params(params)
    prompt = rng.integers(0, cfg.vocab_size, (1, T))
    tok = torch.as_tensor(prompt, device=dev)

    # --- prefill logits parity ---
    model = Llama(cfg, params, plain=plain)
    with torch.no_grad():
        cache = KVCache.create(cfg, 1, T + decode_steps, device=dev)
        logits, cache = model(tok, cache)
    got = _np32(logits)  # (1, T, V)
    layer_io: List[np.ndarray] = []
    want = oracle_forward(dense, cfg, prompt, collect_layer_io=layer_io)
    per_pos = np.array([float(nmse(want[0, t], got[0, t])) for t in range(T)])
    e_prefill = float(np.median(per_pos))
    e_max = float(per_pos.max())

    def hidden(layers, emb):
        """The port's layers from the oracle's hidden state emb (1, T, H)."""
        cfg_n = dataclasses.replace(cfg, num_layers=len(layers))
        sub = Llama(cfg_n, {"embed": params["embed"], "final_norm": params["final_norm"],
                            "layers": layers}, plain=plain)
        with torch.no_grad():
            c = KVCache.create(cfg_n, 1, T, device=dev)
            out, _ = sub(tok, c, embeds=torch.as_tensor(emb, device=dev),
                         return_hidden=True)
        return _np32(out)

    # --- per-layer bisection: the port's layer vs the oracle's from the
    # SAME (oracle) input, immune to cross-layer amplification
    layer_nmse = []
    for li, layer in enumerate(params["layers"]):
        got_l = hidden([layer], layer_io[li])
        layer_nmse.append(float(np.median(
            [float(nmse(layer_io[li + 1][0, t], got_l[0, t])) for t in range(T)])))

    # --- two-layer (handoff) windows: cross-layer integration
    L = len(params["layers"])
    pair_nmse = []
    if L >= 2:
        for li in sorted({min(w, L - 2) for w in (0, L // 4, L // 2, 3 * L // 4, L - 2)}):
            got_p = hidden(params["layers"][li:li + 2], layer_io[li])
            pair_nmse.append(float(np.median(
                [float(nmse(layer_io[li + 2][0, t], got_p[0, t])) for t in range(T)])))

    # --- decode path: the port's greedy rollout, teacher-forced oracle ---
    toks: List[int] = [int(np.argmax(got[0, -1]))]
    with torch.no_grad():
        for _ in range(decode_steps - 1):
            lg, cache = model(torch.as_tensor([[toks[-1]]], device=dev), cache)
            toks.append(int(np.argmax(_np32(lg[0, -1]))))
    full = np.concatenate([prompt, np.asarray(toks[:-1])[None]], axis=1)
    want_full = oracle_forward(dense, cfg, full)  # (1, T+steps-1, V)
    agree = tie_aware = 0
    max_gap = 0.0
    for i, t_i in enumerate(toks):
        lg = want_full[0, T - 1 + i]
        top = int(np.argmax(lg))
        srt = np.sort(lg)
        tie_gap = float(srt[-1] - srt[-2])
        if top == t_i:
            agree += 1
            tie_aware += 1
        else:
            gap = float(lg[top] - lg[t_i])
            max_gap = max(max_gap, gap)
            if gap < tie_margin or tie_gap < tie_margin:
                tie_aware += 1

    def _nll_per_pos(logits_btv: np.ndarray) -> np.ndarray:
        lg = logits_btv[0, :-1].astype(np.float64)
        lg = lg - lg.max(-1, keepdims=True)
        logp = lg - np.log(np.exp(lg).sum(-1, keepdims=True))
        return -logp[np.arange(T - 1), prompt[0, 1:]]

    npp, npo = _nll_per_pos(got), _nll_per_pos(want)
    nll_prod, nll_oracle = float(npp.mean()), float(npo.mean())
    ppl_delta = abs(np.exp(nll_prod) - np.exp(nll_oracle)) / np.exp(nll_oracle)
    n = len(toks)
    return {
        "nmse": e_prefill,
        "nmse_max": e_max,
        "agree": agree / n,
        "agree_tie_aware": tie_aware / n,
        "max_disagree_gap": max_gap,
        "ppl_prod": float(np.exp(nll_prod)),
        "ppl_oracle": float(np.exp(nll_oracle)),
        "ppl_rel_delta": float(ppl_delta),
        "nll_delta_median": float(np.median(np.abs(npp - npo))),
        "layer_nmse_median": float(np.median(layer_nmse)),
        "layer_nmse_max": float(np.max(layer_nmse)),
        "layer_nmse_argmax": int(np.argmax(layer_nmse)),
        "pair_nmse_max": float(np.max(pair_nmse)) if pair_nmse else 0.0,
        "decode_steps": n,
        "prefill_positions": T,
        "device": str(dev),
    }


GATE_CONFIGS = [
    # (label, preset, quant overrides) -- the reference benchmark matrix
    ("bitnet-3b-w1.58", "bitnet-3b", {}),
    ("llama-2-7b-w2", "llama-2-7b", {}),
    ("llama-2-7b-w4", "llama-2-7b", {"bits": 4}),
    ("llama-3-8b-w2", "llama-3-8b", {}),
    ("llama-3.1-8b-w2", "llama-3.1-8b", {}),  # llama3 rope scaling
    ("llama-3-8b-w3", "llama-3-8b", {"bits": 3}),
    ("phi-3-mini-w2", "phi-3-mini", {}),
    ("trilm-3.9b-w2", "trilm-3.9b", {}),
    ("qwen2-7b-w4", "qwen2-7b", {}),
    # MoE families: the f32 dense oracle materializes every expert (~187 GB
    # for 8x7B), so run_gate scales these rows at scale=0
    ("mixtral-8x7b-w2", "mixtral-8x7b", {}),
    ("qwen2-moe-w4", "qwen2-moe-a14b", {}),
]


def run_gate(configs=None, scale: int = 0, impl: str = "auto",
             seed: int = 0, device=None) -> List[Dict[str, Any]]:
    """The full quality table: every preset x its reference quant modes.
    scale > 0 shrinks models (tests, the card's smoke run); 0 = full size."""
    configs = configs if configs is not None else GATE_CONFIGS
    rows = []
    for label, name, quant_kw in configs:
        cfg = get_preset(name, **quant_kw)
        if scale:
            cfg = cfg.scaled(scale)
        elif cfg.num_experts > 0:
            cfg = cfg.scaled(4)
            label = f"{label}(/4)"
        t0 = time.monotonic()
        r = model_parity(cfg, seed=seed, impl=impl, device=device)
        r["preset"] = label
        r["quant"] = f"b{cfg.quant.bits}/{cfg.quant.mode}/gs{cfg.quant.group_size}"
        r["gate_seconds"] = round(time.monotonic() - t0, 1)
        rows.append(r)
        print(f"[parity] {label}: nmse={r['nmse']:.2e} "
              f"layer_nmse_max={r['layer_nmse_max']:.2e} "
              f"agree={r['agree']:.3f} "
              f"tie_aware={r['agree_tie_aware']:.3f} dppl={r['ppl_rel_delta']:.2e} "
              f"({r['gate_seconds']:.0f}s)", flush=True, file=sys.stderr)
    return rows


def format_table(rows: List[Dict[str, Any]]) -> str:
    hdr = (f"{'preset':<16} {'quant':<16} {'nmse':>10} {'layer_max':>10} "
           f"{'agree':>7} {'tie-aware':>9} {'maxgap':>7} {'dppl':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r['preset']:<16} {r['quant']:<16} {r['nmse']:>10.2e} "
            f"{r.get('layer_nmse_max', float('nan')):>10.2e} "
            f"{r['agree']:>7.2f} "
            f"{r['agree_tie_aware']:>9.2f} {r['max_disagree_gap']:>7.3f} "
            f"{r['ppl_rel_delta']:>9.2e}")
    return "\n".join(lines)
