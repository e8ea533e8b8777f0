"""Carry parameters and KV caches from the JAX package into the port.

``params_from_numpy`` takes the tree with every leaf already converted by
``np.asarray``; ``pp_params_from_numpy`` the pipeline's stacked stage tree
(``stack_params_pp``'s), likewise; ``cache_from_numpy`` a KV cache's
fields.  A quantized tensor is any object or mapping with the
fields ``packed``, ``packed_hi``, ``scales``, ``sub``, ``bits``,
``group_size``, ``k_shards``, ``m_shards``, ``shape`` and ``m_segments``;
it is read by those names, never by importing the JAX package.  bf16
leaves (numpy's ``bfloat16`` from ml_dtypes) travel as uint16 bit
patterns, the convention of the JAX package's checkpoint files.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.models.llama import KVCache
from tmac_tpu_torch.ops.qgemm import QuantizedTensor

_QT_FIELDS = ("packed", "packed_hi", "scales", "sub", "bits", "group_size",
              "k_shards", "m_shards", "shape", "m_segments")


def _field(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _is_qt(obj) -> bool:
    if isinstance(obj, Mapping):
        return all(f in obj for f in _QT_FIELDS)
    return all(hasattr(obj, f) for f in _QT_FIELDS)


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(a.view(np.uint16)))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _convert(obj, device):
    if _is_qt(obj):
        hi = _field(obj, "packed_hi")
        segs = _field(obj, "m_segments")
        return QuantizedTensor(
            packed=_tensor(_field(obj, "packed"), device),
            packed_hi=_tensor(hi, device) if hi is not None else None,
            scales=_tensor(_field(obj, "scales"), device),
            sub=_tensor(_field(obj, "sub"), device),
            bits=int(_field(obj, "bits")),
            group_size=int(_field(obj, "group_size")),
            k_shards=int(_field(obj, "k_shards")),
            m_shards=int(_field(obj, "m_shards")),
            shape=tuple(int(d) for d in _field(obj, "shape")),
            m_segments=tuple(tuple(int(d) for d in s) for s in segs)
            if segs is not None else None)
    if isinstance(obj, Mapping):
        return {k: _convert(v, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_convert(v, device) for v in obj]
    return _tensor(obj, device)


def params_from_numpy(tree: Any, cfg: ModelConfig, device="cuda"):
    """The JAX params tree (numpy leaves) -> the port's params dict."""
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(f"tree has {len(tree['layers'])} layers, config "
                         f"{cfg.name} has {cfg.num_layers}")
    return _convert(tree, device)


def pp_params_from_numpy(tree: Any, cfg: ModelConfig, device="cuda"):
    """The JAX package's stack_params_pp stage tree (numpy leaves: every
    layer leaf stacked to (pp, Lp, ...) under "stages", a quantized tensor's
    arrays alike, its meta one layer's) -> the port's (parallel/pp.py's
    stack_params_pp form), for shard_params_pp."""
    for name, leaf in tree["stages"].items():
        lead = np.asarray(_field(leaf, "packed") if _is_qt(leaf) else leaf).shape[:2]
        if lead[0] * lead[1] != cfg.num_layers:
            raise ValueError(f"stage leaf {name} stacks {lead[0]} x {lead[1]} layers, config "
                             f"{cfg.name} has {cfg.num_layers}")
    return _convert(tree, device)


def cache_from_numpy(cache: Any, device="cuda") -> KVCache:
    """A JAX KVCache (an object or mapping with the fields k, v, pos and,
    for an int8 cache, k_scale and v_scale, as numpy arrays) -> the port's
    KVCache, byte for byte."""
    get = cache.get if isinstance(cache, Mapping) \
        else lambda name: getattr(cache, name, None)
    scales = {name: _tensor(get(name), device)
              for name in ("k_scale", "v_scale") if get(name) is not None}
    return KVCache(k=_tensor(_field(cache, "k"), device),
                   v=_tensor(_field(cache, "v"), device),
                   pos=_tensor(_field(cache, "pos"), device), **scales)
