"""The port's tune table (``tmac_tpu_torch/ops/tune_table.py``) and the
plans and route that read it, on the CPU, mirroring the JAX package's
``tests/test_autotune.py``: record and lookup through a temporary path,
keep-if-better, the decode plan's cluster size, K3's tile and split and
the grouped dispatch obeying an entry (and ignoring one that does not
fit), a tuned entry changing no result, and no table in the repository."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tmac_tpu_torch.ops import tune_table
from tmac_tpu_torch.ops.cuda import qgemm_kernel as k1
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, form, qgemm, route
from tmac_tpu_torch.tools import autotune

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def table(tmp_path, monkeypatch):
    path = tmp_path / "t.json"
    monkeypatch.setenv("TMAC_TORCH_TUNE_TABLE", str(path))
    tune_table.invalidate_cache()
    yield path
    tune_table.invalidate_cache()


def test_record_and_lookup(table):
    assert tune_table.lookup_decode(2, 4096, 4096, 1, 128) == 0
    assert tune_table.record_decode(2, 4096, 4096, 1, 128, 0, 4, 12.3)
    tune_table.invalidate_cache()
    assert tune_table.lookup_decode(2, 4096, 4096, 1, 128) == 4
    assert tune_table.lookup_decode(2, 4096, 4096, 1, 128, ags=32) == 0
    tune_table.record_large(2, 3200, 8704, 256, 128, 256, 2, 40.0)
    tune_table.record_dispatch(2, 4096, 4096, 256, 128, "float", "dequant", 50.0)
    tune_table.invalidate_cache()
    assert tune_table.lookup_large(2, 3200, 8704, 256) == (128, 256, 2)
    assert tune_table.lookup_dispatch(2, 4096, 4096, 256, 128, "float") == "dequant"
    assert tune_table.lookup_dispatch(2, 4096, 4096, 256, 128, "fused") is None
    blob = json.loads(table.read_text())
    (dev,) = blob.keys()
    assert dev == tune_table.device_key()
    assert blob[dev]["decode_b2_k4096_m4096_n1_g128"] == {"ksplit": 4, "us": 12.3}


def test_keep_if_better(table, monkeypatch):
    tune_table.record_decode(2, 512, 256, 1, 128, 0, 4, 10.0)
    # a different configuration measured slower does not evict it
    assert not tune_table.record_decode(2, 512, 256, 1, 128, 0, 2, 11.0)
    # the same configuration refreshes its time
    assert tune_table.record_decode(2, 512, 256, 1, 128, 0, 4, 10.5)
    monkeypatch.setenv("TMAC_TORCH_TUNE_OVERWRITE", "1")
    assert tune_table.record_decode(2, 512, 256, 1, 128, 0, 2, 11.0)
    tune_table.invalidate_cache()
    assert tune_table.lookup_decode(2, 512, 256, 1, 128) == 2


def test_decode_plan_obeys_an_entry(table):
    """decode_plan takes the table's cluster size for its shape where it
    fits a block, and its cost model's otherwise (or for another shape)."""
    N, Kp, Mp, bits, gs = 1, 4096, 4096, 2, 128
    base = k1.decode_plan(N, Kp, Mp, bits, gs)
    other = 2 if base[0] != 2 else 4
    tune_table.record_decode(bits, Kp, Mp, N, gs, 0, other, 1.0)
    tune_table.invalidate_cache()
    assert k1.decode_plan(N, Kp, Mp, bits, gs) == (other, base[1])
    assert k1.decode_plan(2, Kp, Mp, bits, gs) == k1.decode_plan(2, Kp, Mp, bits, gs)
    # an entry more blocks than the split has units is ignored
    tune_table.record_decode(bits, 256, Mp, N, gs, 0, 8, 1.0)
    tune_table.invalidate_cache()
    assert k1.decode_plan(N, 256, Mp, bits, gs)[0] <= 256 // 4 // gs + 1


def test_large_plan_obeys_an_entry(table):
    N, Kp, Mp = 256, 3200, 8704
    base = k1.large_plan(N, Kp, Mp, 2)
    tune_table.record_large(2, Kp, Mp, N, 64, 128, 1, 1.0)
    tune_table.record_large(2, Kp, Mp, 512, 64, 96, 1, 1.0)   # no such tile: ignored
    tune_table.invalidate_cache()
    assert k1.large_plan(N, Kp, Mp, 2) == (64, 128, 1) != base
    assert k1.large_plan(512, Kp, Mp, 2) == k1.large_plan(512, Kp, Mp, 2, 132)


def _grouped(K=512, M=256, gs=128, bits=2):
    w = np.random.default_rng(0).standard_normal((K, M)).astype(np.float32)
    return QuantizedTensor.from_float(w, bits, gs, zero_point=True,
                                      scale_dtype=torch.bfloat16, device="cpu")


def test_route_obeys_a_dispatch_entry(table):
    """The grouped route from 64 rows: the fused rule takes the "fused"
    entries, act="auto" the "float" ones; without one, N >= 3 * gs."""
    qt = _grouped()
    assert route(qt, 384) == "K5" and route(qt, 200) == "K4L"
    assert form(qt, 384, "auto") == "E4" and form(qt, 200, "auto") == "E2"
    Kp, Mp = qt.kdim_padded, qt.mdim_padded
    tune_table.record_dispatch(2, Kp, Mp, 384, 128, "fused", "chunk", 1.0)
    tune_table.record_dispatch(2, Kp, Mp, 200, 128, "float", "dequant", 1.0)
    tune_table.invalidate_cache()
    assert route(qt, 384) == "K4L" and route(qt, 384, dispatch="dequant") == "K5"
    assert form(qt, 200, "auto") == "E4" and route(qt, 200, act="auto") == "K5"
    assert form(qt, 384, "auto") == "E4"      # no float entry: the N >= 3 * gs rule


def test_a_tuned_entry_changes_no_result(table):
    """The plans decide how, not what: the same output with an entry."""
    qt = _grouped()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 512)).astype(
        np.float32)).to(torch.bfloat16)
    a = qgemm(x, qt, act="fused", out_dtype=torch.float32)
    tune_table.record_decode(2, qt.kdim_padded, qt.mdim_padded, 1, 128, 0, 1, 1.0)
    tune_table.invalidate_cache()
    assert torch.equal(qgemm(x, qt, act="fused", out_dtype=torch.float32), a)


def test_candidates_are_legal():
    ks = autotune.decode_candidates(1, 4096, 4096, 2, 128, 132)
    assert ks and set(ks) <= set(k1.DECODE_SPLITS)
    for bm, bn, ks in autotune.large_candidates(256, 3200, 8704, 2):
        k1.check_large(256, 3200, 8704, 2, bm, bn, ks)
    assert (64, 128, 1) in autotune.large_candidates(256, 3200, 8704, 2)
    shapes = autotune.model_shapes(__import__(
        "tmac_tpu_torch.models.config", fromlist=["get_preset"]).get_preset("llama-2-7b"))
    assert shapes == [(4096, 12288), (4096, 4096), (4096, 22016), (11008, 4096)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            autotune.tune_shape(2, 256, 256, 1, "w_fp", 128)


def test_the_repository_commits_no_table(monkeypatch):
    """No table file at the default path: every plan and route follows its
    cost model unless a table is made."""
    monkeypatch.delenv("TMAC_TORCH_TUNE_TABLE", raising=False)
    assert not Path(tune_table.table_path()).exists()
    assert Path(tune_table.table_path()).parent == ROOT / "tuned"
