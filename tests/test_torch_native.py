"""The port's native weight pipeline (tmac_tpu_torch/native.py, its own
build of csrc/tmac_native.cc) on the CPU: every case of
tests/test_native.py against the numpy references (skipped, as those are,
only where no compiler is present), each binding byte for byte against the
JAX package's native library on the same input, and two processes
building into one empty directory at once, both loading a whole library.
Tolerances as in tests/test_native.py: quantized codes may differ at rint
ties (a share below 1e-3, BitNet's absmean below 1e-4), scales and subs
within rtol 1e-6."""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

from tmac_tpu import native as jnative
from tmac_tpu_torch import native
from tmac_tpu_torch.ops import packing

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library not built and no g++")


def _np_pack(wq, bits, k_shards):
    """The strided pack in numpy, whatever the size thresholds."""
    p = 8 // bits
    K, M = wq.shape
    w = wq.reshape(k_shards, p, K // k_shards // p, M)
    out = np.zeros((k_shards, K // k_shards // p, M), dtype=np.uint8)
    for j in range(p):
        out |= w[:, j] << (bits * j)
    return out.reshape(K // p, M)


@pytest.mark.parametrize("bits", [1, 2, 4])
@pytest.mark.parametrize("k_shards", [1, 4])
def test_pack_strided_bitexact(bits, k_shards):
    rng = np.random.default_rng(0)
    wq = rng.integers(0, 1 << bits, (512, 384)).astype(np.uint8)
    got = native.pack_strided(wq, bits, k_shards)
    np.testing.assert_array_equal(got, _np_pack(wq, bits, k_shards))
    np.testing.assert_array_equal(native.unpack_strided(got, bits, k_shards), wq)


def _np_quantize(w, bits, gs, zero_point):
    G, M = w.shape[0] // gs, w.shape[1]
    wg = w.reshape(G, gs, M)
    qmax, mid = (1 << bits) - 1, 1 << (bits - 1)
    if zero_point:
        wmin, wmax = wg.min(1), wg.max(1)
        scales = np.maximum(wmax - wmin, 1e-8) / qmax
        wq = np.clip(np.rint((wg - wmin[:, None, :]) / scales[:, None, :]), 0, qmax)
        sub = -wmin
    else:
        scales = np.maximum(np.abs(wg).max(1), 1e-8) / mid
        wq = np.clip(np.rint(wg / scales[:, None, :]) + mid, 0, qmax)
        sub = mid * scales
    return wq.reshape(w.shape).astype(np.uint8), scales, sub


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("zero_point", [False, True])
def test_quantize_weights_matches_numpy(bits, zero_point):
    rng = np.random.default_rng(1)
    w = rng.standard_normal((512, 256)).astype(np.float32)
    wq, scales, sub = _np_quantize(w, bits, 128, zero_point)
    nwq, nscales, nsub = native.quantize_weights(w, bits, 128, zero_point)
    np.testing.assert_allclose(nscales, scales.astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(nsub, sub.astype(np.float32), rtol=1e-6)
    assert (nwq != wq).mean() < 1e-3  # rint ties at float noise


@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("v2", [False, True])
def test_gptq_unpack_bitexact(bits, v2):
    from tmac_tpu_torch.convert.gptq import _unpack_int32_fields, quantize_gptq_like
    rng = np.random.default_rng(2)
    K, M, gs = 256, 128, 64
    qweight, _, qzeros = quantize_gptq_like(
        rng.standard_normal((K, M)).astype(np.float32), bits, gs)
    ref_wq = _unpack_int32_fields(qweight.view(np.uint32).astype(np.int64), bits,
                                  axis=0)[:K].astype(np.uint8)
    np.testing.assert_array_equal(native.unpack_gptq_qweight(qweight, bits)[:K], ref_wq)
    ref_zq = _unpack_int32_fields(qzeros.view(np.uint32).astype(np.int64), bits,
                                  axis=1)[:, :M] + (0 if v2 else 1)
    got_zq = native.unpack_gptq_qzeros(qzeros, bits, add_one=not v2)[:, :M]
    np.testing.assert_array_equal(got_zq.astype(np.int64), ref_zq)


def test_bitnet_matches_numpy():
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((1024, 512)) * 0.02).astype(np.float32)
    gamma = max(float(np.mean(np.abs(w)).astype(np.float32)), 1e-8)
    ref_wq = (np.clip(np.rint(w / gamma), -1, 1) + 2).astype(np.uint8)
    wq, scales, sub = native.quantize_bitnet(w, k_shards=2)
    assert scales.shape == (2, 512) and sub.shape == (2, 512)
    np.testing.assert_allclose(scales, gamma, rtol=1e-6)
    np.testing.assert_allclose(sub, 2 * gamma, rtol=1e-6)
    assert (wq != ref_wq).mean() < 1e-4  # rint ties under f32 sum-order noise


def test_dispatch_thresholds():
    """packing's pack/unpack give the numpy result on both sides of the
    native dispatch's size threshold (2^20 codes)."""
    rng = np.random.default_rng(4)
    for shape in ((2048, 1024), (256, 128)):
        wq = rng.integers(0, 4, shape).astype(np.uint8)
        got = packing.pack_strided(wq, 2)
        np.testing.assert_array_equal(got, _np_pack(wq, 2, 1))
        np.testing.assert_array_equal(packing.unpack_strided(got, 2), wq)


def _inputs(seed=5):
    rng = np.random.default_rng(seed)
    from tmac_tpu_torch.convert.gptq import quantize_gptq_like
    qweight, _, qzeros = quantize_gptq_like(
        rng.standard_normal((256, 128)).astype(np.float32), 4, 64)
    return dict(
        wq=rng.integers(0, 4, (1024, 256)).astype(np.uint8),
        w=rng.standard_normal((1024, 256)).astype(np.float32),
        qweight=qweight, qzeros=qzeros)


@pytest.fixture(scope="module")
def reference_library(tmp_path_factory):
    """The JAX package's native module with a whole library behind it.  Its
    loader builds tmac_tpu/_lib/libtmac_native.so in place and gives up for
    the process if the load fails; under xdist every worker collects
    tests/test_native.py, whose skip mark builds at once in each, so a
    worker can load a half-written file and skip every case.  Where its
    library is not loaded, the fixture builds the same source with the
    same command (tmac_tpu/native.py's) into a temporary file of its own,
    renames it into place, points the module's loader at it and loads it
    with the module's own declarations; the module's state is restored
    after.  Only a missing compiler skips."""
    saved = jnative._LIB_PATH, jnative._lib, jnative._tried
    if jnative._lib is None:
        d = tmp_path_factory.mktemp("jax_native")
        src = str(native.SOURCE)
        part, whole = d / "building.so", d / "libtmac_native.so"
        try:
            subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread",
                            "-o", str(part), src], check=True, capture_output=True,
                           timeout=120)
        except (OSError, subprocess.SubprocessError):
            pytest.skip("the JAX package's native library cannot be built here")
        part.rename(whole)
        jnative._LIB_PATH, jnative._lib, jnative._tried = str(whole), None, False
        assert jnative.available()
    yield jnative
    jnative._LIB_PATH, jnative._lib, jnative._tried = saved


@pytest.mark.parametrize("binding", ["pack_strided", "unpack_strided",
                                     "quantize_weights", "unpack_gptq_qweight",
                                     "unpack_gptq_qzeros", "quantize_bitnet"])
def test_binding_equals_the_reference_library(binding, reference_library):
    """Each binding byte for byte the JAX package's native library's on the
    same input (the same source built by each package; the JAX side's
    library a whole one, reference_library)."""
    a = _inputs()
    args = {"pack_strided": (a["wq"], 2, 2),
            "unpack_strided": (_np_pack(a["wq"], 2, 2), 2, 2),
            "quantize_weights": (a["w"], 4, 128, True),
            "unpack_gptq_qweight": (a["qweight"], 4),
            "unpack_gptq_qzeros": (a["qzeros"], 4, True),
            "quantize_bitnet": (a["w"], 2)}[binding]
    got, want = getattr(native, binding)(*args), getattr(reference_library, binding)(*args)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Two processes build into one empty directory at once: one compiles
    under the lock and renames the library into place, the other waits and
    finds it; both load it and call it.  No temporary file is left."""
    code = textwrap.dedent(f"""
        import ctypes, sys
        sys.path.insert(0, {str(native.SOURCE.parents[1])!r})
        from tmac_tpu_torch import native
        path = native.build({str(tmp_path)!r})
        lib = native.declare(ctypes.CDLL(str(path)))
        print(lib.tmac_native_version())
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert [o.strip() for o, _ in outs] == ["1", "1"]
    left = sorted(f.name for f in tmp_path.iterdir())
    assert left == [".lock", native.library_path(tmp_path).name]
