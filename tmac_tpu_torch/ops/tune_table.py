"""Persisted tuning table of the port's kernels (the JAX package's
``ops/pallas/tune_table.py``, for the card).

The JAX table holds Pallas block sizes; the port has none.  What it holds
here, per card (keyed by ``torch.cuda.get_device_name``), is what the
kernels' plans otherwise take from their cost models:

  * ``decode``: the cluster size along K of the decode matmul (K1, K4;
    ``qgemm_kernel.decode_plan``);
  * ``large``: K3's tile and cluster size (``qgemm_kernel.large_plan``);
  * ``dispatch``: the grouped route from 64 rows, "chunk" (K4L) or
    "dequant" (K5) (``ops.qgemm.route``), for the in-kernel prologue
    ("fused") and for activations from outside ("float").

``tools/autotune.py`` writes it, recording a candidate only after its
output has passed its parity gate.  The plans and the route read it only
when the file exists; the repository commits none, so they follow their
cost models unless a table is made.  Lookup: ``$TMAC_TORCH_TUNE_TABLE``,
then ``<repo>/tuned/tune_table_cuda.json`` (the JAX package's
``tuned/tune_table.json`` is another file).
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Optional

_DEFAULT_PATH = Path(__file__).resolve().parents[2] / "tuned" / "tune_table_cuda.json"

_lock = threading.Lock()
_table: Optional[dict] = None
_device_key: Optional[str] = None


def table_path() -> str:
    return os.environ.get("TMAC_TORCH_TUNE_TABLE", str(_DEFAULT_PATH))


def _load() -> dict:
    """The table, read once (empty when the file does not exist)."""
    global _table
    with _lock:
        if _table is None:
            try:
                with open(table_path()) as f:
                    _table = json.load(f)
            except (OSError, json.JSONDecodeError):
                _table = {}
        return _table


def device_key() -> str:
    """The card's name (spaces as underscores), or "cpu" without one."""
    global _device_key
    if _device_key is None:
        import torch
        _device_key = (torch.cuda.get_device_name(0).replace(" ", "_")
                       if torch.cuda.is_available() else "cpu")
    return _device_key


def key(kind: str, bits: int, K: int, Mp: int, N: int, gs: int = 0, extra: str = "") -> str:
    """kind: "decode", "large" or "dispatch"; K the padded depth."""
    return f"{kind}_b{bits}_k{K}_m{Mp}_n{N}_g{gs}" + (f"_{extra}" if extra else "")


def _lookup(k: str) -> Optional[dict]:
    t = _load()
    return t.get(device_key(), {}).get(k) if t else None


def lookup_decode(bits: int, K: int, Mp: int, N: int, gs: int = 0, ags: int = 0) -> int:
    """The tuned cluster size of the decode matmul, or 0 (the plan's)."""
    e = _lookup(key("decode", bits, K, Mp, N, gs, f"a{ags}" if ags else ""))
    return int(e["ksplit"]) if e else 0


def lookup_large(bits: int, K: int, Mp: int, N: int):
    """K3's tuned (bm, bn, ksplit), or None (the plan's)."""
    e = _lookup(key("large", bits, K, Mp, N))
    return (int(e["bm"]), int(e["bn"]), int(e["ksplit"])) if e else None


def lookup_dispatch(bits: int, K: int, Mp: int, N: int, gs: int, mode: str):
    """The measured grouped route from 64 rows, "chunk" or "dequant", or
    None (the N >= 3 * group_size rule).  mode: "fused" (the in-kernel
    prologue) or "float" (activations from outside, act="auto")."""
    e = _lookup(key("dispatch", bits, K, Mp, N, gs, mode))
    return e.get("path") if e else None


def record(k: str, entry: dict, us: float) -> bool:
    """Write one result through to the table file, keep-if-better: a
    different configuration measured slower than the recorded one does not
    replace it; the same configuration refreshes its time
    (TMAC_TORCH_TUNE_OVERWRITE=1 replaces any).  Returns True if written."""
    global _table
    with _lock:
        p = table_path()
        try:
            with open(p) as f:
                t = json.load(f)
        except (OSError, json.JSONDecodeError):
            t = {}
        dev = t.setdefault(device_key(), {})
        entry = {**entry, "us": round(us, 3)}
        old = dev.get(k)
        same = old is not None and {a: b for a, b in old.items() if a != "us"} == \
            {a: b for a, b in entry.items() if a != "us"}
        if (old is not None and not same
                and os.environ.get("TMAC_TORCH_TUNE_OVERWRITE", "") != "1"
                and old.get("us", float("inf")) <= us):
            return False
        dev[k] = entry
        os.makedirs(os.path.dirname(os.path.abspath(p)), exist_ok=True)
        tmp = f"{p}.tmp.{os.getpid()}"  # atomic: a crash leaves the old table
        with open(tmp, "w") as f:
            json.dump(t, f, indent=1, sort_keys=True)
        os.replace(tmp, p)
        _table = t
        return True


def record_decode(bits, K, Mp, N, gs, ags, ksplit: int, us: float) -> bool:
    return record(key("decode", bits, K, Mp, N, gs, f"a{ags}" if ags else ""),
                  {"ksplit": int(ksplit)}, us)


def record_large(bits, K, Mp, N, bm: int, bn: int, ksplit: int, us: float) -> bool:
    return record(key("large", bits, K, Mp, N),
                  {"bm": int(bm), "bn": int(bn), "ksplit": int(ksplit)}, us)


def record_dispatch(bits, K, Mp, N, gs, mode: str, path: str, us: float) -> bool:
    return record(key("dispatch", bits, K, Mp, N, gs, mode), {"path": path}, us)


def invalidate_cache():
    """Read the file again at the next lookup (after a write, or a change
    of TMAC_TORCH_TUNE_TABLE)."""
    global _table
    with _lock:
        _table = None
