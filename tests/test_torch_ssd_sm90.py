"""The host side of the Hopper SSD kernel ("sm90", ``csrc/ssd_sm90.cu``)
and its numerical scheme, on the CPU.

The kernel itself runs only on the card (``chip_smoke.py`` holds it to
``ssd_plain`` there).  Here: ``_variant`` picks "sm90" or "simt" from
dtypes, widths, the chunk, alignment and strides alone; ``_override``
stands in only where it can; the ctypes entry point declares its full
signature; and a plain emulation of the kernel's arithmetic (x, B, C
exact in bf16, the f32 operand of every other product split as hi =
bf16(v), lo = bf16(v - hi), each product exact) stays within
``SCALED_TOL`` of the reference's Pallas kernel in interpret mode, on
small cases including an active clip, while one bf16 term alone does
not.  Same numpy inputs on both sides.
"""
import ctypes
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.kernels import ops as jops                        # noqa: E402
from repro_torch.kernels import build                       # noqa: E402
from repro_torch.kernels import ssd as tssd                 # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# chip_smoke.py's SSD_SCALED_TOL: relative L2 and max abs of y and of the
# final state at most 1e-4 of the reference's
SCALED_TOL = dict(rel_l2=1e-4, max_abs_frac=1e-4)
BF16 = torch.bfloat16


def _shapes(b=1, s=512, h=3, p=64, n=64, dtype=BF16):
    x = torch.zeros((b, s, h, p), dtype=dtype)
    dt = torch.zeros((b, s, h))
    a = torch.zeros((h,))
    bc = torch.zeros((b, s, 2 * n), dtype=dtype)
    return x, dt, a, bc[..., :n], bc[..., n:]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_variant_takes_the_main_path_on_sm90():
    """The prefill path's inputs: bf16 x, b and c as column views of one
    packed tensor, P = N = 64, chunk 256."""
    assert tssd._variant(*_shapes(), 256) == "sm90"


@pytest.mark.parametrize("p,n,chunk,want", [
    (16, 16, 64, "sm90"), (32, 48, 128, "sm90"), (64, 32, 192, "sm90"),
    (8, 64, 256, "simt"),      # P not a multiple of 16
    (64, 80, 256, "simt"),     # N past 64
    (64, 64, 32, "simt"),      # chunk not a multiple of 64
    (64, 64, 320, "simt"),     # chunk past 256
])
def test_variant_by_width_and_chunk(p, n, chunk, want):
    assert tssd._variant(*_shapes(p=p, n=n), chunk) == want


def test_variant_takes_f32_and_mixed_dtypes_on_simt():
    assert tssd._variant(*_shapes(dtype=torch.float32), 256) == "simt"
    x, dt, a, b, c = _shapes()
    assert tssd._variant(x, dt, a, b.float(), c.float(), 256) == "simt"
    assert tssd._variant(x.float(), dt, a, b, c, 256) == "simt"


def test_variant_needs_tma_legal_pointers_and_strides():
    x, dt, a, b, c = _shapes()
    # a base 2 bytes past 16-byte alignment
    flat = torch.zeros(x.numel() + 8, dtype=BF16)
    shifted = flat[1:1 + x.numel()].view(x.shape)
    assert shifted.data_ptr() % 16 == 2
    assert tssd._variant(shifted, dt, a, b, c, 256) == "simt"
    # b's row stride 68 elements: 136 bytes, no multiple of 16
    wide = torch.zeros((1, 512, 68), dtype=BF16)
    assert tssd._variant(x, dt, a, wide[..., :64], c, 256) == "simt"
    # a head stride that is a multiple of 16 bytes (heads of a wider x)
    wider = torch.zeros((1, 512, 6, 64), dtype=BF16)[:, :, ::2]
    assert wider.stride(2) * 2 % 16 == 0
    assert tssd._variant(wider, dt, a, b, c, 256) == "sm90"
    # one batch entry: its stride is never stepped
    one = torch.zeros((1, 512, 64), dtype=BF16).as_strided(
        (1, 512, 64), (3, 64, 1))
    assert tssd._variant(x, dt, a, one, c, 256) == "sm90"


def test_override_stands_in_only_for_the_same_inputs():
    """``_override="simt"`` may time the old kernel on inputs "sm90"
    takes; nothing may ask "sm90" to take what it cannot, or name an
    unknown variant."""
    main = _shapes()
    assert tssd._resolve(*main, 256, None) == "sm90"
    assert tssd._resolve(*main, 256, "simt") == "simt"
    assert tssd._resolve(*main, 256, "sm90") == "sm90"
    f32 = _shapes(dtype=torch.float32)
    assert tssd._resolve(*f32, 256, "simt") == "simt"
    with pytest.raises(ValueError, match="cannot take"):
        tssd._resolve(*f32, 256, "sm90")
    with pytest.raises(ValueError, match="cannot take"):
        tssd._resolve(*_shapes(p=8), 256, "sm90")
    with pytest.raises(ValueError, match="cannot take"):
        tssd._resolve(*main, 256, "mma")


def test_kernel_counts_start_at_zero_per_variant():
    tssd.reset_launches()
    assert tssd.ssd_kernel.launches == 0
    assert tssd.ssd_kernel.launches_by_variant == {"sm90": 0, "simt": 0}
    with pytest.raises(ValueError, match="CUDA"):
        tssd.ssd_kernel(*_shapes(), 256, _override="simt")
    assert tssd.ssd_kernel.launches_by_variant == {"sm90": 0, "simt": 0}


def test_sm90_entry_point_declares_its_c_signature(monkeypatch):
    """Pointers (inputs, outputs, the two scratch buffers) and the stream
    cross as ``c_void_p`` and strides as ``int64``: left to ctypes'
    default, a pointer would be cut to a C int."""
    fake = ctypes.CDLL(None)["abs"]          # any C function will do
    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(
        repro_ssd_sm90=fake))
    fn = tssd._entry_point_sm90()
    assert fn.argtypes == [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
        + [ctypes.c_int64] * 10 + [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


# ---------------------------------------------------------------------------
# the numerical scheme
# ---------------------------------------------------------------------------

def _bf16(t):
    return t.to(BF16).to(torch.float32)


def _parts(v, terms):
    """f32 ``v`` as ``terms`` bf16 values (in f32) that sum to it: hi =
    bf16(v), then bf16 of what is left, and so on."""
    out = []
    for _ in range(terms):
        out.append(_bf16(v))
        v = v - out[-1]
    return out


def _products(eq, parts, exact):
    """Sum over the split parts of one product, each in f64 (bf16 times
    bf16 is exact there), rounded once to f32."""
    return sum(torch.einsum(eq, part.double(), exact.double())
               for part in parts).float()


def split_emulation(x, dt, a, b, c, chunk, terms=2):
    """The "sm90" kernel's arithmetic in plain PyTorch: the scores C B^T
    exact in bf16; tril(C B^T) * neg * dt, the state at each chunk's start
    and B * dt * exp(cum_L - cum) split into ``terms`` bf16 parts against
    exact bf16 x or C; the state passed from chunk to chunk in f32;
    y = pos * (intra + inter) + (1 - pos neg) dt diag x."""
    bb, s, h, p = x.shape
    n, nc = b.shape[-1], s // chunk
    xc = _bf16(x).reshape(bb, nc, chunk, h, p)
    bc = _bf16(b).reshape(bb, nc, chunk, n)
    cc = _bf16(c).reshape(bb, nc, chunk, n)
    dtc = dt.reshape(bb, nc, chunk, h)
    cum = torch.cumsum(dtc * a, dim=2)                  # (B, nc, L, H)
    pos = torch.exp(cum)
    neg = torch.exp(torch.clamp(-cum, max=tssd.CLIP))
    scores = torch.einsum("bcin,bcjn->bcij", cc.double(),
                          bc.double()).float()
    tri = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    masked = torch.where(tri, scores, 0.0)
    coef = neg * dtc
    amat = masked[..., None] * coef[:, :, None, :, :]   # (B, nc, i, j, H)
    intra = _products("bcijh,bcjhp->bcihp", _parts(amat, terms), xc)
    diag = torch.diagonal(scores, dim1=2, dim2=3)       # (B, nc, L)
    w = dtc * torch.exp(cum[:, :, -1:] - cum)
    bw = bc[:, :, :, None, :] * w[..., None]            # (B, nc, L, H, N)
    upd = _products("bcjhn,bcjhp->bchnp", _parts(bw, terms), xc)
    decay = torch.exp(cum[:, :, -1])
    state = torch.zeros((bb, h, n, p))
    prev = []
    for ci in range(nc):
        prev.append(state)
        state = decay[:, ci, :, None, None] * state + upd[:, ci]
    inter = sum(torch.einsum("bcin,bchnp->bcihp", cc.double(),
                             part.double())
                for part in _parts(torch.stack(prev, 1), terms)).float()
    y = pos[..., None] * (intra + inter) \
        + ((1.0 - pos * neg) * dtc * diag[..., None])[..., None] * xc
    return y.reshape(bb, s, h, p), state


def _inputs(seed, b, s, h, p, n, a=None, dt_shift=-4.0):
    """bf16-valued x, b, c (as f32) and f32 dt, a in the distributions of
    ``chip_smoke.py``'s cases."""
    rng = np.random.default_rng(seed)
    bf = lambda shape: np.asarray(_bf16(torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))))
    x = bf((b, s, h, p))
    dt = np.logaddexp(0.0, rng.standard_normal((b, s, h)) + dt_shift
                      ).astype(np.float32)
    if a is None:
        a = -np.exp(rng.uniform(0.0, 2.5, h))
    return (x, dt, np.asarray(a, np.float32), bf((b, s, n)),
            bf((b, s, n)))


def _scaled_errors(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return (np.linalg.norm(got - want) / np.linalg.norm(want),
            np.abs(got - want).max() / np.abs(want).max())


SPLIT_CASES = [
    # name, (b, s, h, p, n, chunk), a, dt_shift
    ("small", (1, 256, 3, 16, 16, 64), None, -4.0),
    ("mamba_a_b2", (2, 256, 2, 32, 32, 128),
     -np.linspace(1.0, 16.0, 2), -4.6),
    ("clip_active", (1, 512, 2, 16, 16, 256),
     -np.linspace(8.0, 16.0, 2), 3.0),
]


@pytest.fixture(scope="module")
def pallas_results():
    """Each case's inputs and the reference's Pallas kernel (interpret
    mode) on them."""
    out = {}
    for i, (name, (b, s, h, p, n, chunk), a, shift) in enumerate(
            SPLIT_CASES):
        arrs = _inputs(20 + i, b, s, h, p, n, a=a, dt_shift=shift)
        jy, jst = jops.ssd(*[jnp.asarray(v) for v in arrs], chunk=chunk,
                           impl="pallas")
        out[name] = (arrs, chunk, np.asarray(jy), np.asarray(jst))
    return out


@pytest.mark.parametrize("name", [c[0] for c in SPLIT_CASES])
def test_two_term_split_holds_the_scaled_tolerance(pallas_results, name):
    arrs, chunk, jy, jst = pallas_results[name]
    if name == "clip_active":
        b, s, h = arrs[1].shape
        cum = np.cumsum((arrs[1] * arrs[2]).reshape(b, -1, chunk, h),
                        axis=2)
        assert np.abs(cum).max() > tssd.CLIP
    y, st = split_emulation(*[torch.from_numpy(v) for v in arrs], chunk)
    for got, want in ((y, jy), (st, jst)):
        rel, frac = _scaled_errors(got.numpy(), want)
        assert rel <= SCALED_TOL["rel_l2"], (name, rel)
        assert frac <= SCALED_TOL["max_abs_frac"], (name, frac)


def test_one_bf16_term_does_not(pallas_results):
    """Without the lo term (the f32 operands rounded to bf16) the same
    products miss the tolerance by far: the split is what holds it."""
    arrs, chunk, jy, _ = pallas_results["small"]
    y, _ = split_emulation(*[torch.from_numpy(v) for v in arrs], chunk,
                           terms=1)
    rel, frac = _scaled_errors(y.numpy(), jy)
    assert rel > 10 * SCALED_TOL["rel_l2"] and \
        frac > 10 * SCALED_TOL["max_abs_frac"]
