"""Packed-checkpoint save/load (the port of
``tmac_tpu/convert/checkpoint.py``), in the JAX package's format, so that
each package reads what the other writes.

Format: a directory with
  config.json            {"format_version": 1, "model": the ModelConfig,
                          "tensors": per-tensor meta: a QuantizedTensor's
                          bits, group_size, k_shards, m_shards, shape and
                          m_segments; {"dtype": "bfloat16"} for a bf16
                          array outside a QuantizedTensor}
  weights.safetensors    the flat dict of arrays (packed bit-fields,
                         scales, norms, embeddings): a QuantizedTensor's
                         bf16 scales and sub with the dtype BF16, every
                         other bf16 array as its uint16 bit patterns

The machine with the card has numpy but not the ``safetensors`` package,
so the port reads and writes that format itself (save_safetensors,
load_safetensors): an 8-byte little-endian header length, a JSON header
padded with spaces to a multiple of 8 bytes, then the raw little-endian
buffers, ordered as the safetensors library orders them (by dtype, widest
first, then by name), so the files are byte for byte the library's.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict

import numpy as np
import torch

from tmac_tpu_torch.models.config import ModelConfig
from tmac_tpu_torch.ops.qgemm import QuantizedTensor

_FORMAT_VERSION = 1
WEIGHTS_FILE, CONFIG_FILE = "weights.safetensors", "config.json"

# safetensors' dtype names in the library's order of its dtype enum, and
# the numpy type each is read as (BF16 as its uint16 bit patterns)
_ORDER = ("BOOL", "U8", "I8", "I16", "U16", "F16", "BF16", "I32", "U32",
          "F32", "F64", "I64", "U64")
_READ = dict(zip(_ORDER, (np.bool_, np.uint8, np.int8, np.int16, np.uint16,
                          np.float16, np.uint16, np.int32, np.uint32,
                          np.float32, np.float64, np.int64, np.uint64)))
_NAME = {np.dtype(d): n for n, d in _READ.items() if n != "BF16"}


def save_safetensors(arrays: Dict[str, np.ndarray], path: str,
                     bf16=frozenset()) -> None:
    """Write numpy arrays as a .safetensors file (no __metadata__); the
    names in `bf16` hold bf16 values as uint16 bit patterns and are stored
    with the dtype BF16."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    dtype = {}
    for k, a in arrays.items():
        if k in bf16 and a.dtype != np.uint16:
            raise TypeError(f"{k}: bf16 travels as uint16 bits, not {a.dtype}")
        if a.dtype not in _NAME:
            raise TypeError(f"{k}: dtype {a.dtype} has no safetensors name")
        dtype[k] = "BF16" if k in bf16 else _NAME[a.dtype]
    names = sorted(arrays, key=lambda k: (-_ORDER.index(dtype[k]), k))
    header, off = {}, 0
    for k in names:
        header[k] = {"dtype": dtype[k], "shape": list(arrays[k].shape),
                     "data_offsets": [off, off + arrays[k].nbytes]}
        off += arrays[k].nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in names:
            a = arrays[k]
            f.write(np.ascontiguousarray(
                a, a.dtype.newbyteorder("<")).tobytes())


def load_safetensors(path: str):
    """A .safetensors file -> ({name: read-only numpy array, each a view
    of one memory map of the file; BF16 as uint16 bits}, {name: dtype
    name})."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    mm = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for k, info in header.items():
        b, e = info["data_offsets"]
        out[k] = mm[8 + n + b:8 + n + e].view(
            np.dtype(_READ[info["dtype"]]).newbyteorder("<")
        ).reshape(info["shape"])
    return out, {k: info["dtype"] for k, info in header.items()}


def _numpy(t: torch.Tensor):
    """A tensor as numpy, bf16 as its uint16 bits; (array, meta or None)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), \
            {"dtype": "bfloat16"}
    return t.numpy(), None


def _flatten(params, prefix="", arrays=None, meta=None, bf16=None):
    """The params tree -> ({name: array}, meta, the names stored as BF16),
    as the reference flattens it: a QuantizedTensor's bf16 scales and sub
    as BF16, every other bf16 array as uint16 with {"dtype": "bfloat16"}
    in the meta."""
    arrays = {} if arrays is None else arrays
    meta = {} if meta is None else meta
    bf16 = set() if bf16 is None else bf16
    if isinstance(params, QuantizedTensor):
        for field in ("packed", "packed_hi", "scales", "sub"):
            t = getattr(params, field)
            if t is not None:
                arrays[f"{prefix}.{field}"], m = _numpy(t)
                if m is not None:
                    bf16.add(f"{prefix}.{field}")
        meta[prefix] = {
            "bits": params.bits,
            "group_size": params.group_size,
            "k_shards": params.k_shards,
            "m_shards": params.m_shards,
            "shape": list(params.shape),
        }
        if params.m_segments is not None:
            meta[prefix]["m_segments"] = [list(s) for s in params.m_segments]
    elif isinstance(params, dict):
        for k, v in params.items():
            _flatten(v, f"{prefix}.{k}" if prefix else k, arrays, meta, bf16)
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            _flatten(v, f"{prefix}.{i}", arrays, meta, bf16)
    elif params is not None:
        arrays[prefix], m = _numpy(params)
        if m is not None:
            meta[prefix] = m
    return arrays, meta, bf16


def save_checkpoint(path: str, cfg: ModelConfig, params: Dict[str, Any]):
    os.makedirs(path, exist_ok=True)
    arrays, meta, bf16 = _flatten(params)
    save_safetensors(arrays, os.path.join(path, WEIGHTS_FILE), bf16)
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump({
            "format_version": _FORMAT_VERSION,
            "model": json.loads(cfg.to_json()),
            "tensors": meta,
        }, f, indent=1)


def load_checkpoint(path: str, device="cuda"):
    """Returns (cfg, params), the params' tensors on `device`."""
    with open(os.path.join(path, CONFIG_FILE)) as f:
        blob = json.load(f)
    if blob["format_version"] != _FORMAT_VERSION:
        raise ValueError(f"checkpoint format {blob['format_version']}, "
                         f"this reader takes {_FORMAT_VERSION}")
    cfg = ModelConfig.from_json(json.dumps(blob["model"]))
    arrays, dtypes = load_safetensors(os.path.join(path, WEIGHTS_FILE))
    meta = blob["tensors"]

    def _get(name):
        a = np.array(arrays[name])   # out of the memory map
        if dtypes[name] == "BF16" or \
                meta.get(name, {}).get("dtype") == "bfloat16":
            return torch.from_numpy(a.view(np.int16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)

    root: Dict[str, Any] = {}
    qt_prefixes = {k for k, v in meta.items() if "bits" in v}

    def _insert(tree, keys, value):
        k = keys[0]
        if k.isdigit():
            k = int(k)
        if len(keys) == 1:
            tree[k] = value
            return
        _insert(tree.setdefault(k, {}), keys[1:], value)

    done = set()
    for name in arrays:
        base = name.rsplit(".", 1)[0]
        if base in qt_prefixes:
            if base in done:
                continue
            done.add(base)
            m = meta[base]
            hi = base + ".packed_hi"
            qt = QuantizedTensor(
                packed=_get(base + ".packed"),
                packed_hi=_get(hi) if hi in arrays else None,
                scales=_get(base + ".scales"),
                sub=_get(base + ".sub"),
                bits=m["bits"],
                group_size=m["group_size"],
                k_shards=m["k_shards"],
                m_shards=m["m_shards"],
                shape=tuple(m["shape"]),
                m_segments=tuple(tuple(s) for s in m["m_segments"])
                if "m_segments" in m else None,
            )
            _insert(root, base.split("."), qt)
        else:
            _insert(root, name.split("."), _get(name))

    def _listify(tree):
        """Integer-keyed dicts (list indices) back to lists."""
        if isinstance(tree, dict):
            if tree and all(isinstance(k, int) for k in tree):
                return [_listify(tree[i]) for i in range(len(tree))]
            return {k: _listify(v) for k, v in tree.items()}
        return tree

    return cfg, _listify(root)
