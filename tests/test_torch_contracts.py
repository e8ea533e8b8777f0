"""The PyTorch port's contracts against the JAX package: presets, packing
bytes, QuantizedTensor layout, the plain grouped matmul, and the rule that
the port imports neither jax nor tmac_tpu."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmac_tpu.models.config import PRESETS as JAX_PRESETS
from tmac_tpu.ops import packing as jpacking
from tmac_tpu.ops.qgemm import QuantizedTensor as JQT
from tmac_tpu.ops.qgemm import fuse_m as jfuse_m
from tmac_tpu.ops.qgemm import qgemm_xla
from tmac_tpu_torch.models.config import PRESETS
from tmac_tpu_torch.ops import packing
from tmac_tpu_torch.ops.qgemm import QuantizedTensor, fuse_m, qgemm, qgemm_torch

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_presets_match_field_for_field():
    assert PRESETS.keys() == JAX_PRESETS.keys()
    for name in PRESETS:
        assert dataclasses.asdict(PRESETS[name]) == \
            dataclasses.asdict(JAX_PRESETS[name]), name


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("k_shards", [1, 2])
def test_packing_bytes_match(bits, k_shards):
    rng = np.random.default_rng(bits * 10 + k_shards)
    K, M = 64, 48
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    if bits == 3:
        got, want = packing.pack_b3(wq, k_shards), jpacking.pack_b3(wq, k_shards)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(packing.unpack_b3(*got, k_shards), wq)
        return
    got = packing.pack_strided(wq, bits, k_shards)
    np.testing.assert_array_equal(got, jpacking.pack_strided(wq, bits, k_shards))
    np.testing.assert_array_equal(packing.unpack_strided(got, bits, k_shards), wq)


@pytest.mark.parametrize("zero_point", [False, True])
def test_quantize_weights_match(zero_point):
    w = np.random.default_rng(3).standard_normal((256, 40)).astype(np.float32)
    for got, want in zip(packing.quantize_weights(w, 4, 64, zero_point),
                         jpacking.quantize_weights(w, 4, 64, zero_point)):
        np.testing.assert_array_equal(got, want)
    wq, s, sub = packing.quantize_weights(w, 4, 64, zero_point)
    np.testing.assert_array_equal(packing.dequantize(wq, s, sub, 64),
                                  jpacking.dequantize(wq, s, sub, 64))


def _assert_qt_equal(t: QuantizedTensor, j: JQT):
    for f in ("bits", "group_size", "k_shards", "m_shards", "shape",
              "m_segments"):
        assert getattr(t, f) == getattr(j, f), f
    for f in ("packed", "packed_hi", "scales", "sub"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            b = np.asarray(b)
            if a.dtype == torch.bfloat16:
                a, b = a.view(torch.int16), b.view(np.int16)
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert t.kdim_padded == j.kdim_padded and t.mdim_padded == j.mdim_padded


def _args(rng, K, M, bits, gs, grouped_bf16=False):
    G = K // gs
    wq = rng.integers(0, 1 << bits, (K, M)).astype(np.uint8)
    scales = (0.5 + rng.random((G, M))).astype(np.float32)
    sub = (scales * rng.integers(0, 1 << bits, (G, M))).astype(np.float32)
    return wq, scales, sub


@pytest.mark.parametrize("bits,K,M,gs,k_shards,m_shards", [
    (2, 200, 1000, 200, 1, 1),     # per-tensor, K and M padded
    (2, 256, 256, 128, 1, 1),      # grouped
    (3, 256, 200, 64, 1, 1),       # 2+1 planes
    (4, 512, 256, 128, 2, 2),      # k- and m-sharded
    (8, 300, 500, 300, 1, 1),      # signed int8 codes + sub fold
    (2, 256, 384, 128, 2, 1),      # per-tensor rows per k-shard
])
def test_from_quantized_matches(bits, K, M, gs, k_shards, m_shards):
    rng = np.random.default_rng(K + M + bits)
    wq, scales, sub = _args(rng, K, M, bits, gs)
    if gs >= K // k_shards and k_shards > 1:
        gs = K // k_shards
        scales, sub = scales[:1].repeat(k_shards, 0), sub[:1].repeat(k_shards, 0)
    kw = dict(k_shards=k_shards, m_shards=m_shards)
    if gs < K // k_shards:
        kw_t, kw_j = dict(scale_dtype=torch.bfloat16), dict(scale_dtype=jnp.bfloat16)
    else:
        kw_t, kw_j = {}, {}
    t = QuantizedTensor.from_quantized(wq, scales, sub, bits, gs, device="cpu",
                                       **kw, **kw_t)
    j = JQT.from_quantized(wq, scales, sub, bits, gs, **kw, **kw_j)
    _assert_qt_equal(t, j)
    np.testing.assert_array_equal(t.unpack().numpy(), np.asarray(j.unpack()))


def test_from_float_and_fuse_m_match():
    """A fused wqkv whose segments are padded per segment (400 -> 512)."""
    rng = np.random.default_rng(7)
    ws = [rng.standard_normal((256, 400)).astype(np.float32) for _ in range(3)]
    t = fuse_m([QuantizedTensor.from_float(w, 2, device="cpu") for w in ws])
    j = jfuse_m([JQT.from_float(w, 2) for w in ws])
    _assert_qt_equal(t, j)
    assert t.m_segments == ((400, 512),) * 3
    out = torch.arange(2 * t.mdim_padded, dtype=torch.float32).reshape(2, -1)
    np.testing.assert_array_equal(
        t.slice_m(out).numpy(), np.asarray(j.slice_m(jnp.asarray(out.numpy()))))
    np.testing.assert_array_equal(t.unpack().numpy(), np.asarray(j.unpack()))


@pytest.mark.parametrize("bits,gs", [(2, 256), (2, 64), (4, 128), (8, 256)])
def test_qgemm_torch_matches_qgemm_xla(bits, gs):
    rng = np.random.default_rng(bits + gs)
    K, M, N = 256, 200, 3
    wq, scales, sub = _args(rng, K, M, bits, gs)
    t = QuantizedTensor.from_quantized(wq, scales, sub, bits, gs, device="cpu")
    j = JQT.from_quantized(wq, scales, sub, bits, gs)
    xi = rng.integers(-127, 128, (N, K)).astype(np.int8)
    got = qgemm_torch(torch.from_numpy(xi), t).numpy()
    want = np.asarray(qgemm_xla(jnp.asarray(xi), j))
    if gs == K:  # one scale group: every step is one rounding, exact
        np.testing.assert_array_equal(got, want)
    else:        # f32 sums over the groups, in another order
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    xf = rng.standard_normal((N, K)).astype(np.float32)
    got = qgemm(torch.from_numpy(xf), t, impl="torch").numpy()
    want = np.asarray(qgemm_xla(jnp.asarray(xf), j))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_port_imports_neither_jax_nor_tmac_tpu():
    code = ("import tmac_tpu_torch, tmac_tpu_torch.models.llama, "
            "tmac_tpu_torch.runtime.generate, "
            "tmac_tpu_torch.ops.cuda.qgemm_kernel, "
            "tmac_tpu_torch.ops.cuda.attention_kernel, "
            "tmac_tpu_torch.convert.from_jax; import sys; "
            "assert 'jax' not in sys.modules and not any("
            "m.startswith('tmac_tpu.') or m == 'tmac_tpu' for m in sys.modules)"
            ", sorted(m for m in sys.modules if 'jax' in m or 'tmac_tpu.' in m)")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_no_source_imports_jax_or_tmac_tpu():
    files = sorted((ROOT / "tmac_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "tmac_tpu"), (f, n)


def test_kernel_modules_do_not_build_on_import():
    """Importing the kernels, and running them on CPU tensors, never calls
    nvcc: the library loader stays empty and no library is built."""
    code = (
        "import torch, tmac_tpu_torch.ops.cuda.build as b\n"
        "from tmac_tpu_torch.ops.cuda import qgemm_kernel, attention_kernel\n"
        "before = set(b.BUILD_DIR.glob('*.so')) if b.BUILD_DIR.exists() else set()\n"
        "import numpy as np\n"
        "from tmac_tpu_torch.ops.qgemm import QuantizedTensor\n"
        "qt = QuantizedTensor.from_float(np.ones((64, 128), np.float32), 2,"
        " device='cpu')\n"
        "qgemm_kernel.qgemm_fused(torch.ones(1, 64), qt)\n"
        "q = torch.ones(1, 1, 1, 100); kv = torch.zeros(1, 1, 1, 8, 128)\n"
        "attention_kernel.flash_decode(q, kv, kv, torch.ones(1, dtype=torch.int32),"
        " torch.zeros(1, dtype=torch.int32))\n"
        "after = set(b.BUILD_DIR.glob('*.so')) if b.BUILD_DIR.exists() else set()\n"
        "assert not b._loaded and before == after\n"
        "assert qgemm_kernel.qgemm_fused.launches == 0\n"
        "assert attention_kernel.flash_decode.launches == 0\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
