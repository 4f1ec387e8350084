"""The port's densify wrapper and oracle against the JAX package's.

On the CPU the port's ``ops.densify`` takes its plain PyTorch version; the
JAX side runs the Pallas kernel in interpret mode, as tests/test_kernels.py
does.  Same numpy inputs on both sides.
"""
import ctypes
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.kernels import ops as jops, ref as jref    # noqa: E402
from repro_torch import bridge                        # noqa: E402
from repro_torch.kernels import build, densify as tdensify, ops, ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SHAPES = [(1, 1, 1), (7, 13, 5), (64, 100, 32), (128, 64, 128),
          (300, 1000, 257), (512, 512, 128), (33, 8, 640)]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


@pytest.mark.parametrize("n,v,d", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_densify_matches_jax(n, v, d, dtype):
    rng = np.random.default_rng(n * 1000 + v + d)
    idx = rng.integers(0, v, size=(n,)).astype(np.int32)
    j_vals = jnp.asarray(rng.standard_normal((n, d))).astype(dtype)
    t_idx = torch.from_numpy(idx)
    t_vals = bridge.array_to_tensor(np.asarray(j_vals), "cpu")
    out = ops.densify(t_idx, t_vals, (v, d))
    out_ref = ref.densify_ref(t_idx, t_vals, (v, d))
    j_out = jops.densify(jnp.asarray(idx), j_vals, (v, d))
    j_ref = jref.densify_ref(jnp.asarray(idx), j_vals, (v, d))
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert out.dtype == t_vals.dtype and tuple(out.shape) == (v, d)
    for got in (out, out_ref):
        for want in (j_out, j_ref):
            np.testing.assert_allclose(_np(got), _np(want), rtol=tol,
                                       atol=tol)


@pytest.mark.parametrize("fn", [ops.densify, ref.densify_ref])
def test_densify_drops_out_of_range(fn):
    idx = np.array([-1, 0, 5, 2, -7, 4], np.int32)   # -1, 5, -7, 4 dropped
    vals = np.arange(18, dtype=np.float32).reshape(6, 3)
    out = fn(torch.from_numpy(idx), torch.from_numpy(vals), (4, 3))
    want = jops.densify(jnp.asarray(idx), jnp.asarray(vals), (4, 3))
    np.testing.assert_allclose(out.numpy(), np.asarray(want))
    np.testing.assert_allclose(out.numpy()[[1, 3]], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_densify_sums_duplicates(dtype):
    idx = np.zeros((100,), np.int32)
    j_vals = jnp.ones((100, 8), dtype)
    out = ops.densify(torch.from_numpy(idx),
                      bridge.array_to_tensor(np.asarray(j_vals), "cpu"),
                      (4, 8))
    want = jops.densify(jnp.asarray(idx), j_vals, (4, 8))
    np.testing.assert_allclose(_np(out), _np(want))
    np.testing.assert_allclose(_np(out)[0], 100.0)
    np.testing.assert_allclose(_np(out)[1:], 0.0)


def test_plain_version_accumulates_bf16_in_f32():
    # 300 ones in bf16 would stall at 256 if added in bf16; the kernel
    # contract (repro/kernels/densify.py:77,89) accumulates in f32
    idx = torch.zeros(300, dtype=torch.int32)
    vals = torch.ones(300, 2, dtype=torch.bfloat16)
    out = tdensify.densify_plain(idx, vals, (3, 2))
    assert out.dtype == torch.bfloat16
    assert float(out[0, 0]) == 300.0


def test_kernel_path_raises_on_cpu_tensors():
    """Asked for the kernel, a CPU tensor raises: nothing falls back."""
    idx = torch.zeros(4, dtype=torch.int32)
    vals = torch.ones(4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tdensify.densify_kernel(idx, vals, (4, 8))


def test_entry_point_declares_its_c_signature(monkeypatch):
    """Pointers and the stream cross as ``c_void_p`` and sizes as
    ``int64``: left to ctypes' default, each would be cut to a C int."""
    fake = ctypes.CDLL(None)["abs"]          # any C function will do
    monkeypatch.setattr(build, "load",
                        lambda name: types.SimpleNamespace(repro_densify=fake))
    fn = tdensify._entry_point()
    # indices, values, out, workspace; n, vocab, d, workspace size; dtype
    assert fn.argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 \
        + [ctypes.c_int, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


@pytest.mark.parametrize("n, vocab, want", [
    (2048, 33708, 2 * 2048 + 3 * 33709),  # the training step's shape
    (0, 1, 6), (1, 0, 5), (35756, 33708, 2 * 35756 + 3 * 33709)])
def test_densify_workspace_is_linear_in_rows_and_vocab(n, vocab, want):
    """The kernel's int32 workspace: CSR offsets, the long-row list and
    the counts' spill (vocab + 1 each), the grouped row list and its
    sorted copy (n each) -- ~0.42 MB at the training step's shape,
    against the 138 MB f32 scratch it replaces."""
    assert tdensify.workspace_ints(n, vocab) == want
    assert 4 * tdensify.workspace_ints(2048, 33708) < 450_000


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["densify"])
    assert not any(tmp_path.iterdir())


def test_library_path_keys_on_source():
    path = build.library_path("densify")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("densify-") and path.suffix == ".so"
    assert build.library_path("densify") == path
