"""Mixture-of-Experts MLP (the port of ``tmac_tpu/models/moe.py``).

The expert FFNs are the dense MLP's quantized linears, one per expert,
held as STACKED QuantizedTensors (every array with a leading E axis, the
meta describing one expert).  Routing follows Mixtral: top-k on the router
logits, softmax over the k selected logits (or, with ``norm_topk=False``,
the Qwen2-MoE form: softmax over all experts, top-k weights kept), weighted
sum of the expert outputs.  Three forms compute it (``moe_mlp``):

  * select (B=1 decode, the default there): only the k routed experts run,
    through kernel K7 (ops/cuda/expert_kernel.py), which reads the expert
    indices from device memory and only those experts' bytes -- no host
    sync, so the decode step can be captured in a CUDA graph; one call for
    every routed expert's gate_up and one for their down (grouped w_fp
    experts, or per-tensor w_a8 ones; with an act_group_size the JAX
    package leaves K7, and so does the port: a gathered copy of each
    expert through K4's ags form);
  * dense-masked (other small blocks): every expert on every token, the
    combine weights zeroing the experts not routed to;
  * capacity dispatch (prefill blocks, T > 1 and N >= 64): a one-hot
    (tokens, E, C) dispatch tensor from a cumsum, per-expert FFNs (K4L,
    K4 or K5 grouped, K3 or K1 per-tensor) on dense (C, H) blocks, and
    two einsums to gather and scatter.

The f32 matrix products (router logits, the combine) run with TF32 off on
the card (``_full_f32``), as the reference runs them at HIGHEST precision.
Under expert parallelism (``ep_axis``, parallel/ep.py) a rank holds E / ep
experts of each stack and combines only those (dense or dispatch, never
select); the caller sums the ranks' outputs.
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import Optional

import torch

from tmac_tpu_torch.ops.cuda.expert_kernel import (expert_copy,
                                                   expert_kernel_supported,
                                                   qgemm_experts,
                                                   qgemm_experts_plain)
from tmac_tpu_torch.ops.qgemm import QuantizedTensor
from tmac_tpu_torch.utils import round_up


# ---------------------------------------------------------------------------
# Stacked expert weights
# ---------------------------------------------------------------------------

def stack_experts(qts: list) -> QuantizedTensor:
    """Stack per-expert QuantizedTensors along a new leading E axis (packed
    (E, K/p, Mp), scales and sub (E, G, Mp)); the meta still describes one
    expert."""
    base = qts[0]
    for q in qts[1:]:
        assert q.bits == base.bits and q.group_size == base.group_size
        assert q.shape == base.shape and q.m_segments == base.m_segments
        assert q.k_shards == base.k_shards and q.m_shards == base.m_shards

    def stack(name):
        if getattr(base, name) is None:
            return None
        return torch.stack([getattr(q, name) for q in qts])
    return QuantizedTensor(stack("packed"), stack("packed_hi"), stack("scales"),
                           stack("sub"), base.bits, base.group_size,
                           base.k_shards, base.m_shards, base.shape,
                           base.m_segments)


def expert_view(stacked: QuantizedTensor, e: int) -> QuantizedTensor:
    """The e-th expert of a stack, as views.  e must be a Python int: an
    index held on the device would gather a copy (the select form gives it
    to kernel K7 instead)."""
    if not isinstance(e, int):
        raise TypeError(f"expert_view takes a Python int, not {type(e)}")
    hi = stacked.packed_hi[e] if stacked.packed_hi is not None else None
    return QuantizedTensor(stacked.packed[e], hi, stacked.scales[e],
                           stacked.sub[e], stacked.bits, stacked.group_size,
                           stacked.k_shards, stacked.m_shards, stacked.shape,
                           stacked.m_segments)


def num_local_experts(stacked: QuantizedTensor) -> int:
    return stacked.packed.shape[0]


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _full_f32():
    """f32 matrix products in full f32 on the card (TF32 off), as the
    reference's HIGHEST precision: routing must not depend on matmul
    rounding."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def top_k(v: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, largest
    first and the lower index first among equal values (jax.lax.top_k's
    order), deterministic on CPU and CUDA."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route_topk(x2: torch.Tensor, router: torch.Tensor, k: int,
               norm_topk: bool = True) -> torch.Tensor:
    """Top-k routing -> dense (N, E) f32 combine weights, k nonzero a row.

    x2 (N, H) tokens, router (H, E).  norm_topk=True: softmax over the k
    selected logits (Mixtral); False: softmax over all experts, the top-k
    weights kept unrenormalized (Qwen2-MoE norm_topk_prob=False)."""
    with _full_f32():
        logits = x2.float() @ router.float()
    E = router.shape[1]
    if norm_topk:
        topv, topi = top_k(logits, k)
        w = torch.softmax(topv, dim=-1)
    else:
        w, topi = top_k(torch.softmax(logits, dim=-1), k)
    onehot = topi[..., None] == torch.arange(E, device=x2.device)
    return (onehot * w[..., None]).sum(1)


def expert_capacity(n_tokens: int, cfg, capacity_factor: float = 2.0) -> int:
    """Static per-expert token capacity of the dispatch form (a multiple of
    8): expert load up to capacity_factor times uniform before dropping."""
    c = math.ceil(n_tokens * cfg.num_experts_per_tok * capacity_factor
                  / cfg.num_experts)
    return round_up(max(c, 8), 8)


# ---------------------------------------------------------------------------
# Expert FFN (the dense MLP's fusion rules)
# ---------------------------------------------------------------------------

def _expert_ffn(x2: torch.Tensor, gu_qt: QuantizedTensor,
                down_qt: QuantizedTensor, mode: str, plain: bool,
                act_gs: int = 0) -> torch.Tensor:
    """silu(x @ gate) * (x @ up) @ down on one expert; x2 (N, H) -> (N, H)
    in x2's dtype.  SwiGLU folds into down's prologue where down's K is
    unpadded (at w_a8 only for per-tensor scales, as in the JAX package);
    elsewhere silu(g) * u runs in bf16 before down, as in the dense MLP.
    act_gs: the activation group size of K4's ags form."""
    from tmac_tpu_torch.models.llama import apply_qlinear, silu_mul
    gu = apply_qlinear(x2, gu_qt, plain=plain, act_gs=act_gs, mode=mode)
    if (down_qt.kdim_padded == down_qt.kdim
            and (mode != "w_a8" or down_qt.scales.shape[0] == 1)):
        return apply_qlinear(gu, down_qt, glu=True, plain=plain, act_gs=act_gs, mode=mode)
    ihalf = down_qt.kdim
    return apply_qlinear(silu_mul(gu[..., :ihalf], gu[..., ihalf:]), down_qt,
                         plain=plain, act_gs=act_gs, mode=mode)


# ---------------------------------------------------------------------------
# The MoE MLP block
# ---------------------------------------------------------------------------

def moe_mlp(x: torch.Tensor, layer: dict, cfg, mode: Optional[str] = None,
            act_gs: int = 0, ep_axis: Optional[str] = None,
            moe_impl: str = "auto", capacity: Optional[int] = None,
            valid: Optional[torch.Tensor] = None,
            plain: bool = False) -> torch.Tensor:
    """The MoE replacement for the gate_up/down block.

    x (B, T, H) pre-norm hidden states -> the (B, T, H) expert-combined
    output, without the residual add.  mode: the quantization mode
    ("w_fp" or "w_a8"; cfg.quant.mode by default), act_gs: the activation
    group size, as the JAX package's.  moe_impl: 'dense' | 'dispatch' |
    'select' | 'auto'; auto takes dispatch for prefill blocks (T > 1 and
    N >= 64), select for one token (N == 1, unless TMAC_MOE_SELECT=0; never
    under ep), and dense otherwise.  ep_axis: (index, size), this rank's
    place on the expert-parallel axis (the JAX package's mesh axis): the
    stacks hold experts [index * E_local, (index + 1) * E_local), the
    combine weights are sliced to them, and the shared expert's output is
    divided by size, so that the sum over the ep ranks (the caller's) is
    the whole MLP's.  capacity: the dispatch form's per-expert slots
    (default expert_capacity(N)); tokens past it are dropped.  valid:
    optional (B, T) bool; rows marked False get zero combine weight, so
    they take no dispatch capacity and add nothing.  plain=True runs the
    kernels' plain versions (the card's reference)."""
    from tmac_tpu_torch.models.llama import rms_norm
    mode = mode or cfg.quant.mode
    B, T, H = x.shape
    xn = rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    x2 = xn.reshape(-1, H)
    N = x2.shape[0]

    cw = route_topk(x2, layer["moe_router"], cfg.num_experts_per_tok,
                    norm_topk=cfg.moe_norm_topk)
    if valid is not None:
        cw = cw * valid.reshape(-1, 1).to(cw.dtype)
    gu_stack: QuantizedTensor = layer["experts_gate_up"]
    down_stack: QuantizedTensor = layer["experts_down"]
    E = num_local_experts(gu_stack)
    if ep_axis is not None:
        if not (isinstance(ep_axis, tuple) and len(ep_axis) == 2
                and all(isinstance(i, int) for i in ep_axis) and 0 <= ep_axis[0] < ep_axis[1]):
            raise ValueError(f"ep_axis must be (index, size), 0 <= index < size, not {ep_axis!r}")
        index, size = ep_axis
        if E * size != cfg.num_experts:
            raise ValueError(f"{E} experts a rank over ep {size}: not {cfg.num_experts}")
        cw = cw[:, index * E:(index + 1) * E]
    else:
        assert E == cfg.num_experts, (E, cfg.num_experts)

    if moe_impl == "auto":
        if T > 1 and N >= 64:
            moe_impl = "dispatch"
        elif (N == 1 and ep_axis is None
              and os.environ.get("TMAC_MOE_SELECT", "1") == "1"):
            moe_impl = "select"
        else:
            moe_impl = "dense"

    if moe_impl == "select":
        assert N == 1 and ep_axis is None, (N, ep_axis)
        topw, topi = top_k(cw[0], cfg.num_experts_per_tok)
        acc = torch.zeros((N, H), dtype=torch.float32, device=x.device)
        if (expert_kernel_supported(gu_stack, act_gs)
                and expert_kernel_supported(down_stack, act_gs)):
            # K7: the routed indices stay on the device and the kernel reads
            # the routed experts' bytes from the stack, all k in one call;
            # down's prologue rounds the f32 gate_up output to bf16 as it
            # reads it, the down output stays f32
            kernel = qgemm_experts_plain if plain else qgemm_experts
            idx = topi.to(torch.int32)
            gu = kernel(x2, gu_stack, idx)                   # (k, N, 2I)
            ye = kernel(gu.contiguous(), down_stack, idx, glu=True)  # (k, N, H)
            for j in range(topi.shape[0]):
                acc = acc + topw[j] * ye[j]
        else:
            # outside K7's scope: a gathered copy of each routed expert
            for j in range(topi.shape[0]):
                ye = _expert_ffn(x2, expert_copy(gu_stack, topi[j]),
                                 expert_copy(down_stack, topi[j]), mode, plain, act_gs)
                acc = acc + topw[j] * ye.float()
        out = acc
    elif moe_impl == "dense":
        acc = torch.zeros((N, H), dtype=torch.float32, device=x.device)
        for e in range(E):
            ye = _expert_ffn(x2, expert_view(gu_stack, e),
                             expert_view(down_stack, e), mode, plain, act_gs)
            acc = acc + cw[:, e:e + 1] * ye.float()
        out = acc
    else:
        assert moe_impl == "dispatch", moe_impl
        C = capacity if capacity is not None else expert_capacity(N, cfg)
        sel = cw > 0.0                                         # (N, E)
        pos = torch.cumsum(sel.to(torch.int32), dim=0) - 1     # slot in expert
        keep = sel & (pos < C)
        # disp[n, e, c]: token n takes slot c of expert e.  Each (e, c)
        # selects at most one n, so the gather einsum is an exact row copy.
        disp = keep[:, :, None] & (
            pos[:, :, None] == torch.arange(C, device=x.device)[None, None, :])
        xe = torch.einsum("nec,nh->ech", disp.to(x2.dtype), x2).contiguous()
        ye = torch.stack([
            _expert_ffn(xe[e], expert_view(gu_stack, e),
                        expert_view(down_stack, e), mode, plain, act_gs)
            for e in range(E)]).float()                        # (E, C, H)
        # combine: each slot back to its token, weighted; tokens dropped by
        # overflow add nothing
        with _full_f32():
            out = torch.einsum("nec,ech->nh", disp.float() * cw[:, :, None], ye)

    if "shared_gate_up" in layer:
        # always-on shared expert (Qwen2-MoE), optionally sigmoid-gated
        ys = _expert_ffn(x2, layer["shared_gate_up"], layer["shared_down"],
                         mode, plain, act_gs).float()
        if "shared_gate" in layer:
            with _full_f32():
                gate = torch.sigmoid(x2.float() @ layer["shared_gate"].float())
            ys = ys * gate[:, None]
        if ep_axis is not None:
            # every ep rank computes it: a share of 1 / size each (a true
            # division, by a tensor, as XLA divides)
            ys = ys / torch.full((), float(ep_axis[1]), device=ys.device)
        out = out + ys
    return out.reshape(B, T, H).to(x.dtype)
