"""The port's SSD scan against the JAX package's.

On the CPU ``ops.ssd(impl="kernel")`` takes the kernel's plain PyTorch
version (``ssd_plain``); the JAX side runs the Pallas kernel in
interpret mode (``impl="pallas"``) and the sequential oracle
(``impl="xla"``), as tests/test_kernels.py does.  Same numpy inputs on
both sides.  Tolerance is the reference's own, 2e-5 (f32; the two
frameworks sum in other orders).
"""
import ctypes
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.kernels import ops as jops                        # noqa: E402
from repro.models import ssm as jssm                         # noqa: E402
from repro_torch.kernels import build, ops, ref             # noqa: E402
from repro_torch.kernels import ssd as tssd                 # noqa: E402
from repro_torch.models import ssm as tssm                  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SSD_CASES = [
    # b, s, h, p, n, chunk (tests/test_kernels.py)
    (1, 16, 1, 4, 4, 8),
    (2, 64, 3, 8, 4, 16),
    (2, 50, 3, 8, 4, 16),     # ragged (padding path)
    (1, 128, 2, 16, 8, 32),
]
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, s, h, p, n, a=None, dt_shift=-4.0):
    """numpy inputs in the reference's distributions: dt =
    softplus(N(0, 1) + dt_shift), a = -exp(U(0, 2.5)) unless given."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.logaddexp(0.0, rng.standard_normal((b, s, h)) + dt_shift
                      ).astype(np.float32)
    if a is None:
        a = -np.exp(rng.uniform(0.0, 2.5, h))
    a = np.asarray(a, np.float32)
    bb = rng.standard_normal((b, s, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _both(arrs):
    return ([jnp.asarray(a) for a in arrs],
            [torch.from_numpy(np.array(a)) for a in arrs])


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_kernel_impl_matches_pallas_and_oracle(b, s, h, p, n, chunk):
    j, t = _both(_inputs(b * 100 + s, b, s, h, p, n))
    y, st = ops.ssd(*t, chunk=chunk, impl="kernel")
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (b, s, h, p) and tuple(st.shape) == (b, h, n, p)
    for impl in ("pallas", "xla"):
        jy, jst = jops.ssd(*j, chunk=chunk, impl=impl)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ref_impl_matches_the_reference_oracle(b, s, h, p, n, chunk):
    j, t = _both(_inputs(b * 100 + s + 1, b, s, h, p, n))
    y, st = ops.ssd(*t, chunk=chunk, impl="ref")
    jy, jst = jops.ssd(*j, chunk=chunk, impl="xla")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_kernel_impl_matches_the_model_path():
    """The model-path case of tests/test_kernels.py: Mamba2's A in
    [1, 16]; the kernel's plain version against the reference's
    ``ssd_chunked``."""
    b, s, h, p, n, chunk = 2, 64, 4, 8, 8, 16
    arrs = _inputs(3, b, s, h, p, n,
                   a=-np.exp(np.log(np.linspace(1.0, 16.0, h))))
    j, t = _both(arrs)
    y, st = ops.ssd(*t, chunk=chunk, impl="kernel")
    jy, jst = jssm.ssd_chunked(*j, chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


@pytest.mark.parametrize("separable", [True, False])
@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES[:2] + SSD_CASES[3:])
def test_ssd_chunked_matches_the_reference(separable, b, s, h, p, n, chunk):
    j, t = _both(_inputs(b * 10 + s, b, s, h, p, n))
    y, st = tssm.ssd_chunked(*t, chunk, separable=separable)
    jy, jst = jssm.ssd_chunked(*j, chunk, separable=separable)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **TOL)


def test_extreme_decay_clip_is_active_and_matches():
    """tests/test_beyond_paper.py's extreme-decay case: dt ~ softplus(N +
    3), A in [8, 16], chunk 32, so the per-chunk decay passes the clip
    (|cum| > 60).  The port's separable form, the kernel's plain version
    and the reference's separable form agree; the diagonal survives
    (against the naive form within the reference's 5% bound)."""
    b, s, h, p, n, chunk = 1, 64, 2, 4, 4, 32
    arrs = _inputs(7, b, s, h, p, n,
                   a=-np.exp(np.log(np.linspace(8.0, 16.0, h))),
                   dt_shift=3.0)
    cum = np.cumsum((arrs[1] * arrs[2]).reshape(b, s // chunk, chunk, h),
                    axis=2)
    assert np.abs(cum).max() > tssd.CLIP
    j, t = _both(arrs)
    jy, jst = jssm.ssd_chunked(*j, chunk, separable=True)
    y, st = tssm.ssd_chunked(*t, chunk, separable=True)
    ky, kst = ops.ssd(*t, chunk=chunk, impl="kernel")
    scale = np.abs(np.asarray(jy)).max()
    for got in (y, ky):
        np.testing.assert_allclose(got.numpy() / scale,
                                   np.asarray(jy) / scale, **TOL)
    for got in (st, kst):
        np.testing.assert_allclose(got.numpy(), np.asarray(jst), **TOL)
    naive, _ = tssm.ssd_chunked(*t, chunk, separable=False)
    assert float((naive - y).abs().max()) / scale < 0.05


def test_ssd_plain_takes_bf16_inputs_as_f32():
    """bf16 x, b, c are read as f32: the same result as their f32
    upcasts."""
    x, dt, a, b, c = (torch.from_numpy(v)
                      for v in _inputs(11, 1, 32, 2, 8, 4))
    xb, bb, cb = (v.to(torch.bfloat16) for v in (x, b, c))
    y, st = tssd.ssd_plain(xb, dt, a, bb, cb, 16)
    y2, st2 = tssd.ssd_plain(xb.float(), dt, a, bb.float(), cb.float(), 16)
    assert torch.equal(y, y2) and torch.equal(st, st2)


def test_padding_keeps_the_final_state():
    """Padded rows have dt = 0: the state after them is the state after
    the real rows (the sequential oracle over the real rows alone)."""
    x, dt, a, b, c = (torch.from_numpy(v) for v in _inputs(5, 1, 37, 2, 4, 4))
    _, st = ops.ssd(x, dt, a, b, c, chunk=16, impl="kernel")
    _, st_ref = ref.ssd_ref(x[0].transpose(0, 1), dt[0].t(), a,
                            b[0].expand(2, 37, 4), c[0].expand(2, 37, 4))
    np.testing.assert_allclose(st[0].numpy(), st_ref.numpy(), **TOL)


def test_kernel_impl_refuses_to_differentiate():
    x, dt, a, b, c = (torch.from_numpy(v) for v in _inputs(0, 1, 16, 1, 4, 4))
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd(x, dt, a, b, c, chunk=8, impl="kernel")
    with torch.no_grad():
        ops.ssd(x, dt, a, b, c, chunk=8, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        ops.ssd(x, dt, a, b, c, chunk=8, impl="pallas")


def test_kernel_path_raises_on_cpu_tensors():
    """Asked for the kernel itself, CPU tensors raise: nothing falls
    back."""
    x, dt, a, b, c = (torch.from_numpy(v) for v in _inputs(0, 1, 16, 1, 4, 4))
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_kernel(x, dt, a, b, c, 8)


def test_entry_point_declares_its_c_signature(monkeypatch):
    """Pointers and the stream cross as ``c_void_p`` and strides as
    ``int64``: left to ctypes' default, a pointer would be cut to a C
    int."""
    fake = ctypes.CDLL(None)["abs"]          # any C function will do
    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(
        repro_ssd=fake))
    fn = tssd._entry_point()
    assert fn.argtypes == [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_int64] * 10 + [ctypes.c_int, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
