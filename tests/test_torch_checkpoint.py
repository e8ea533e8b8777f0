"""The port's checkpoint directory (tmac_tpu_torch/convert/checkpoint.py)
against the JAX package's: each package loads what the other writes, the
port's files are byte for byte the JAX package's, and the port's own
safetensors writer gives the bytes of the ``safetensors`` library (which
the machine with the card does not have)."""

import dataclasses
import json
import pathlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save

from tests.test_torch_model import _assert_tree_equal
from tmac_tpu.convert import checkpoint as jck
from tmac_tpu.models import llama as jl
from tmac_tpu.models.config import get_preset as jax_preset
from tmac_tpu_torch.convert.checkpoint import (load_checkpoint,
                                               load_safetensors,
                                               save_checkpoint,
                                               save_safetensors)
from tmac_tpu_torch.convert.from_jax import params_from_numpy
from tmac_tpu_torch.models.config import get_preset
from tmac_tpu_torch.models.llama import KVCache, Llama, init_params

torch.set_num_threads(2)

# bitnet-3b: per-tensor ternary, f32 scales; llama-2-7b W2: bf16 grouped
# scales and zero points, fused m_segments; mixtral-8x7b: stacked experts
# and a bf16 router
MODELS = ("bitnet-3b", "llama-2-7b", "mixtral-8x7b")


@pytest.fixture(scope="module", params=MODELS)
def jax_model(request):
    jcfg = jax_preset(request.param).scaled(8)
    return jcfg, jl.init_params(jcfg, seed=0)


def _port_params(jcfg, jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             get_preset(jcfg.name).scaled(8), device="cpu")


def _logits(cfg, params):
    prompt = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 8)))
    return Llama(cfg, params)(prompt, KVCache.create(cfg, 1, 16,
                                                     device="cpu"))[0]


def test_jax_checkpoint_loads_in_the_port(jax_model, tmp_path):
    jcfg, jparams = jax_model
    jck.save_checkpoint(str(tmp_path), jcfg, jparams)
    cfg, params = load_checkpoint(str(tmp_path), device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    carried = _port_params(jcfg, jparams)
    _assert_tree_equal(params, carried)
    assert torch.equal(_logits(cfg, params), _logits(cfg, carried))


def test_port_checkpoint_loads_in_jax(jax_model, tmp_path):
    jcfg, jparams = jax_model
    cfg = get_preset(jcfg.name).scaled(8)
    save_checkpoint(str(tmp_path), cfg, _port_params(jcfg, jparams))
    lcfg, loaded = jck.load_checkpoint(str(tmp_path), device_put=False)
    assert lcfg == jcfg
    got, want = jax.tree.leaves(loaded), jax.tree.leaves(jparams)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8))


def test_port_checkpoint_files_equal_jax_bytes(jax_model, tmp_path):
    """The port's init_params (byte for byte JAX's, in the same key order)
    saved by the port, against JAX's params saved by JAX."""
    jcfg, jparams = jax_model
    cfg = get_preset(jcfg.name).scaled(8)
    jck.save_checkpoint(str(tmp_path / "jax"), jcfg, jparams)
    save_checkpoint(str(tmp_path / "port"), cfg,
                    init_params(cfg, seed=0, device="cpu"))
    for name in ("weights.safetensors", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name


def test_save_load_round_trip(tmp_path):
    cfg = get_preset("llama-2-7b", bits=4).scaled(8)
    jcfg = jax_preset("llama-2-7b", bits=4).scaled(8)
    params = _port_params(jcfg, jl.init_params(jcfg, seed=1))
    save_checkpoint(str(tmp_path), cfg, params)
    lcfg, loaded = load_checkpoint(str(tmp_path), device="cpu")
    assert lcfg == cfg
    _assert_tree_equal(loaded, params)


def test_other_format_version_raises(tmp_path):
    cfg = get_preset("bitnet-3b").scaled(8)
    save_checkpoint(str(tmp_path), cfg, {"embed": torch.zeros(2, 2)})
    blob = json.loads((tmp_path / "config.json").read_text())
    blob["format_version"] = 2
    (tmp_path / "config.json").write_text(json.dumps(blob))
    with pytest.raises(ValueError, match="format"):
        load_checkpoint(str(tmp_path), device="cpu")


def _bf16_bits(rng, shape):
    return rng.standard_normal(shape).astype(ml_dtypes.bfloat16) \
        .view(np.uint16)


def _arrays(case):
    """(arrays for save_safetensors, the names stored as BF16, the same
    arrays as the library takes them)."""
    rng = np.random.default_rng(len(case))
    if case == "every_dtype":
        arrays = {f"t.{np.dtype(d).name}": (rng.standard_normal((3, 5)) * 9)
                  .astype(d) for d in (np.bool_, np.uint8, np.int8, np.int16,
                                       np.uint16, np.float16, np.int32,
                                       np.uint32, np.float32, np.float64,
                                       np.int64, np.uint64)}
        arrays["t.bf16"] = _bf16_bits(rng, (4, 3))
        bf16 = {"t.bf16"}
    elif case == "names_and_shapes":
        arrays = {n: rng.integers(0, 255, s).astype(np.uint8) for n, s in (
            ("layers.10.x", (7,)), ("layers.2.x", (2, 3)), ("layers.1.x", (1,)),
            ("empty", (0, 4)), ("b", (3, 1, 2)))}
        arrays["scalar"] = np.array(2.5, np.float32)
        bf16 = set()
    else:   # a header whose length is already a multiple of 8, and not
        arrays = {"a" * n: np.arange(n, dtype=np.int32) for n in range(1, 9)}
        bf16 = set()
    lib = {k: (v.view(ml_dtypes.bfloat16) if k in bf16 else v)
           for k, v in arrays.items()}
    return arrays, bf16, lib


@pytest.mark.parametrize("case", ["every_dtype", "names_and_shapes",
                                  "header_padding"])
def test_safetensors_bytes_equal_the_library(case, tmp_path):
    arrays, bf16, lib = _arrays(case)
    save_safetensors(arrays, str(tmp_path / "t.safetensors"), bf16)
    assert (tmp_path / "t.safetensors").read_bytes() == save(lib)


@pytest.mark.parametrize("case", ["every_dtype", "names_and_shapes",
                                  "header_padding"])
def test_load_safetensors_reads_the_library(case, tmp_path):
    arrays, bf16, lib = _arrays(case)
    path = tmp_path / "t.safetensors"
    path.write_bytes(save(lib))
    got, dtypes = load_safetensors(str(path))
    assert got.keys() == arrays.keys()
    assert {k for k, d in dtypes.items() if d == "BF16"} == bf16
    for k, a in arrays.items():
        assert got[k].dtype == a.dtype and got[k].shape == a.shape, k
        np.testing.assert_array_equal(got[k], a)
    # and the library reads what the port writes
    save_safetensors(arrays, str(path), bf16)
    back = load_file(str(path))
    for k, a in lib.items():
        assert back[k].dtype == a.dtype and back[k].tobytes() == a.tobytes()


def test_safetensors_refuses_an_unknown_dtype(tmp_path):
    with pytest.raises(TypeError, match="safetensors"):
        save_safetensors({"c": np.zeros(2, np.complex64)},
                         str(pathlib.Path(tmp_path) / "t.safetensors"))


@pytest.mark.parametrize("form", ["bits3", "tied", "bf16_head"])
def test_qwen2_forms_round_trip_byte_for_byte(form, tmp_path):
    """Qwen2-7B scaled(8) at bits 3 (lo and hi planes, the same nonzero
    q/k/v biases in both trees), also with a tied or a bf16 head:
    params_from_numpy carries JAX's tree byte for byte, both writers give
    the same bytes, and the port loads JAX's files back byte for byte."""
    from tests.test_torch_model_presets import set_biases
    extra = {"bits3": {}, "tied": dict(tie_word_embeddings=True),
             "bf16_head": dict(head_bits=16)}[form]
    cfg, jcfg = (dataclasses.replace(get("qwen2-7b", bits=3).scaled(8), **extra)
                 for get in (get_preset, jax_preset))
    jparams = jl.init_params(jcfg, seed=0)
    # the port's own tree keeps JAX's key order, which the files follow
    params = init_params(cfg, seed=0, device="cpu")
    _assert_tree_equal(params, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                 device="cpu"))
    set_biases(params, jparams, cfg)
    _assert_tree_equal(params, params_from_numpy(jax.tree.map(np.asarray, jparams), cfg,
                                                 device="cpu"))
    assert params["layers"][0]["wqkv"].packed_hi is not None
    assert ("lm_head" in params) == (form != "tied")
    jck.save_checkpoint(str(tmp_path / "jax"), jcfg, jparams)
    save_checkpoint(str(tmp_path / "port"), cfg, params)
    for name in ("weights.safetensors", "config.json"):
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    lcfg, loaded = load_checkpoint(str(tmp_path / "jax"), device="cpu")
    assert lcfg == cfg
    _assert_tree_equal(loaded, params)
