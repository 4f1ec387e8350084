"""The port's flash attention against the JAX package's.

On the CPU the port's ``ops.flash_attention(impl="kernel")`` takes the
kernel's plain PyTorch version; the JAX side runs the Pallas kernel in
interpret mode with 8 x 8 blocks, as tests/test_kernels.py does.  Same
numpy inputs on both sides.  Tolerances are the reference's own: 3e-5 in
f32, 3e-2 in bf16 (tests/test_kernels.py).
"""
import ctypes
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.kernels import ops as jops, ref as jref          # noqa: E402
from repro.kernels.flash_attention import (                 # noqa: E402
    flash_attention_pallas)
from repro_torch import bridge                              # noqa: E402
from repro_torch.kernels import build, ops, ref             # noqa: E402
from repro_torch.kernels import flash_attention as tflash   # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CASES = [
    # b, sq, sk, h, hkv, d, window, causal (tests/test_kernels.py)
    (2, 16, 16, 4, 2, 32, None, True),
    (1, 64, 64, 2, 2, 64, 16, True),
    (2, 8, 40, 4, 4, 32, None, True),       # decode-style alignment
    (1, 32, 32, 4, 1, 16, 8, True),         # MQA + window
    (2, 24, 24, 2, 2, 128, None, False),    # bidirectional (cross-attn)
    (1, 17, 23, 3, 3, 48, None, True),      # ragged, non-multiple shapes
]
F32 = dict(rtol=3e-5, atol=3e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _qkv(seed, b, sq, sk, h, hkv, d, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]
    j = [jnp.asarray(a).astype(dtype) for a in arrs]
    return j, [bridge.array_to_tensor(np.asarray(x), "cpu") for x in j]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,window,causal", CASES)
def test_kernel_impl_matches_pallas(b, sq, sk, h, hkv, d, window, causal):
    (jq, jk, jv), (q, k, v) = _qkv(b * 100 + sq + sk, b, sq, sk, h, hkv, d)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl="kernel")
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                impl="pallas", block_q=8, block_k=8)
    assert out.dtype == q.dtype and tuple(out.shape) == (b, sq, h, d)
    np.testing.assert_allclose(_np(out), _np(want), **F32)


def test_kernel_impl_bf16_matches_pallas():
    (jq, jk, jv), (q, k, v) = _qkv(5, 1, 16, 16, 2, 2, 32, "bfloat16")
    out = ops.flash_attention(q, k, v, impl="kernel")
    want = jops.flash_attention(jq, jk, jv, impl="pallas", block_q=8,
                                block_k=8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(want), **BF16)


@pytest.mark.parametrize("dtype,window", [("float32", None),
                                          ("bfloat16", None),
                                          ("float32", 8)])
def test_head_dim_112_matches_pallas(dtype, window):
    """zamba2-7b's head dim (3584 / 32 = 112), which the kernel takes:
    the plain version against the Pallas kernel in interpret mode, causal,
    with and without a window, f32 and bf16."""
    assert 112 in tflash.HEAD_DIMS
    (jq, jk, jv), (q, k, v) = _qkv(112, 1, 24, 24, 2, 2, 112, dtype)
    out = ops.flash_attention(q, k, v, window=window, impl="kernel")
    want = jops.flash_attention(jq, jk, jv, window=window, impl="pallas",
                                block_q=8, block_k=8)
    assert out.dtype == q.dtype and tuple(out.shape) == (1, 24, 2, 112)
    np.testing.assert_allclose(_np(out), _np(want),
                               **(F32 if dtype == "float32" else BF16))


@pytest.mark.parametrize("causal,window,q_offset,kv_len", [
    (True, None, 5, 20),       # queries aligned past the start, keys padded
    (True, 6, 8, 24),          # sliding window
    (False, None, 0, 13),      # non-causal, padded keys masked
    (True, None, -8, 24),      # causal Sq > Sk: the first rows see no key
])
def test_plain_matches_pallas_call(causal, window, q_offset, kv_len):
    """The plain version in the raw kernel's terms, (BH, S, D) as
    (BH, S, 1, D), against ``flash_attention_pallas`` itself."""
    rng = np.random.default_rng(17)
    q = rng.standard_normal((3, 16, 32)).astype(np.float32)
    k = rng.standard_normal((3, 24, 32)).astype(np.float32)
    v = rng.standard_normal((3, 24, 32)).astype(np.float32)
    want = flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, scale=0.3, block_q=8, block_k=8, q_offset=q_offset,
        kv_len=kv_len)
    out = tflash.flash_attention_plain(
        torch.from_numpy(q)[:, :, None], torch.from_numpy(k)[:, :, None],
        torch.from_numpy(v)[:, :, None], causal=causal, window=window,
        scale=0.3, q_offset=q_offset, kv_len=kv_len, block_k=8)
    np.testing.assert_allclose(_np(out[:, :, 0]), _np(want), **F32)
    if q_offset < 0:
        np.testing.assert_array_equal(_np(out[:, :-q_offset]), 0.0)


@pytest.mark.parametrize("impl,jimpl", [("ref", "xla"),
                                        ("chunked", "xla_chunked")])
@pytest.mark.parametrize("b,sq,sk,h,hkv,d,window,causal", CASES)
def test_plain_impls_match_reference(impl, jimpl, b, sq, sk, h, hkv, d,
                                     window, causal):
    (jq, jk, jv), (q, k, v) = _qkv(b * 77 + sq, b, sq, sk, h, hkv, d)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              impl=impl, block_k=8)
    want = jops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                impl=jimpl, block_k=8)
    np.testing.assert_allclose(_np(out), _np(want), **F32)


def test_attention_ref_zeroes_fully_masked_rows():
    (jq, jk, jv), (q, k, v) = _qkv(3, 1, 12, 8, 2, 2, 16)
    out = ref.attention_ref(q, k, v, causal=True)
    want = jref.attention_ref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_np(out), _np(want), **F32)
    np.testing.assert_array_equal(_np(out[:, :4]), 0.0)
    np.testing.assert_allclose(
        _np(ops.flash_attention(q, k, v, impl="kernel")), _np(want), **F32)


def test_mixed_head_dims_take_the_chunked_path():
    """MLA-style v head dim != qk head dim: the reference's pallas impl
    sends it to its chunked path; the port's kernel impl on CPU tensors
    computes it in the plain version (the CUDA kernel refuses Dv != D)."""
    rng = np.random.default_rng(9)
    q, k = (rng.standard_normal((1, 16, 2, 48)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((1, 16, 2, 32)).astype(np.float32)
    out = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              impl="kernel")
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=True)
    np.testing.assert_allclose(_np(out), _np(want), **F32)


def test_bf16_queries_with_f32_keys_promote_like_the_reference():
    """bf16 queries over f32 keys and values (the decode step given f32
    encoder states): the kernel impl and the reference's pallas impl both
    compute in f32 and return bf16."""
    (jq, _, _), (q, _, _) = _qkv(21, 2, 4, 24, 4, 4, 32, "bfloat16")
    (_, jk, jv), (_, k, v) = _qkv(22, 2, 4, 24, 4, 4, 32)
    out = ops.flash_attention(q, k, v, causal=False, impl="kernel")
    want = jops.flash_attention(jq, jk, jv, causal=False, impl="pallas",
                                block_q=8, block_k=8)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(want), **BF16)


def test_kernel_path_raises_on_cpu_tensors():
    """Asked for the kernel itself, CPU tensors raise: nothing falls
    back."""
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        tflash.flash_attention_kernel(q, q, q)


def test_kernel_impl_refuses_to_differentiate():
    q = torch.zeros(1, 8, 2, 32, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, q, q, impl="kernel")
    with torch.no_grad():
        ops.flash_attention(q, q, q, impl="kernel")


def test_entry_point_declares_its_c_signature(monkeypatch):
    """Pointers and the stream cross as ``c_void_p``, strides as
    ``int64`` and the scale as ``float``: left to ctypes' default, a
    pointer would be cut to a C int and the scale would not cross."""
    fake = ctypes.CDLL(None)["abs"]          # any C function will do
    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(
        repro_flash_attention=fake))
    fn = tflash._entry_point()
    assert fn.argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_int64] * 9 + [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float] + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def test_sm90_entry_point_declares_its_c_signature(monkeypatch):
    """The prefill kernel's entry point: ``repro_flash_attention``'s
    signature without the two dtype flags (it takes bf16 only)."""
    fake = ctypes.CDLL(None)["abs"]          # any C function will do
    monkeypatch.setattr(build, "load", lambda name: types.SimpleNamespace(
        repro_flash_attention_sm90=fake))
    fn = tflash._entry_point_sm90()
    assert fn.argtypes == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_int64] * 9 + [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_float] + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    assert fn.restype is ctypes.c_int


def _meta(shape, dtype=torch.bfloat16):
    """A tensor with real strides and no storage (data_ptr 0), so the
    main path's shapes cost no memory here."""
    return torch.empty(shape, dtype=dtype, device="meta")


def _variant_inputs(case):
    bf, f32 = torch.bfloat16, torch.float32
    if case == "prefill_d64":
        q = _meta((1, 32768, 16, 64))
        return q, q, q
    if case == "prefill_d112":
        q = _meta((1, 32768, 32, 112))
        return q, q, q
    if case == "prefill_d128":
        q = _meta((2, 256, 4, 128))
        return q, q, q
    if case == "prefill_cross":
        kv = _meta((1, 256, 16, 64))
        return _meta((1, 32768, 16, 64)), kv, kv
    if case == "gqa_4":
        kv = _meta((1, 4096, 8, 112))
        return _meta((1, 4096, 32, 112)), kv, kv
    if case == "packed_qkv_view":        # (B, S, 3, H, D)[:, :, i]
        qkv = _meta((1, 1024, 3, 16, 64))
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if case == "sq_one_tile":
        q = _meta((1, 128, 2, 64))
        return q, q, q
    if case == "sq_below_tile":
        q = _meta((1, 127, 2, 64))
        return q, q, q
    if case == "decode":
        kv = _meta((8, 256, 16, 64))
        return _meta((8, 1, 16, 64)), kv, kv
    if case == "d48":
        q = _meta((1, 4096, 2, 48))
        return q, q, q
    if case == "d32":
        q = _meta((1, 4096, 2, 32))
        return q, q, q
    if case == "f32":
        q = _meta((1, 4096, 2, 64), f32)
        return q, q, q
    if case == "bf16_q_f32_kv":
        kv = _meta((1, 4096, 2, 64), f32)
        return _meta((1, 4096, 2, 64)), kv, kv
    if case == "misaligned_pointer":     # one element into a flat buffer
        flat = _meta((4096 * 2 * 64 + 1,))
        kv = flat[1:].view(1, 4096, 2, 64)
        return _meta((1, 4096, 2, 64)), kv, kv
    if case == "stride_not_16_bytes":    # rows 65 elements apart
        k = _meta((1, 4096, 65))[..., :64].unsqueeze(2)
        return _meta((1, 4096, 1, 64)), k, k
    if case == "head_stride_not_16_bytes":
        k = _meta((1, 4096, 2, 68))[..., :64]
        return _meta((1, 4096, 2, 64)), k, k
    if case == "size_one_dims_any_stride":
        q = _meta((1, 512, 1, 64)).as_strided((1, 512, 1, 64),
                                              (3, 64, 5, 1))
        return q, q, q
    if case == "empty_keys":
        kv = _meta((1, 0, 2, 64))
        return _meta((1, 512, 2, 64)), kv, kv
    raise KeyError(case)


VARIANT_CASES = [
    ("prefill_d64", "sm90"), ("prefill_d112", "sm90"),
    ("prefill_d128", "sm90"), ("prefill_cross", "sm90"), ("gqa_4", "sm90"),
    ("packed_qkv_view", "sm90"), ("sq_one_tile", "sm90"),
    ("size_one_dims_any_stride", "sm90"),
    ("sq_below_tile", "mma"), ("decode", "mma"), ("d48", "mma"),
    ("d32", "mma"), ("misaligned_pointer", "mma"),
    ("stride_not_16_bytes", "mma"), ("head_stride_not_16_bytes", "mma"),
    ("empty_keys", "mma"),
    ("f32", "simt"), ("bf16_q_f32_kv", "simt"),
]


@pytest.mark.parametrize("case, want", VARIANT_CASES)
def test_variant_follows_dtype_head_dim_length_and_layout(case, want):
    """Which hand-written kernel takes the inputs: the TMA + wgmma
    prefill kernel for bf16 at head dims 64/112/128 with a full query
    tile and TMA-legal pointers and strides, ``flash_mma`` for the other
    bf16 inputs, ``flash_simt`` for f32 keys."""
    assert tflash._variant(*_variant_inputs(case)) == want


def test_variant_override_only_trades_sm90_for_mma():
    """The timing-only ``_override`` may run "mma" where "sm90" would
    run; any other swap is refused before anything launches."""
    q = torch.zeros(1, 256, 2, 64, dtype=torch.bfloat16)
    short = q[:, :8]
    assert tflash._resolve(q, q, q, None) == "sm90"
    assert tflash._resolve(q, q, q, "mma") == "mma"
    assert tflash._resolve(short, q, q, "mma") == "mma"
    for args, bad in (((q, q, q), "simt"), ((short, q, q), "sm90"),
                      ((q.float(), q.float(), q.float()), "mma")):
        with pytest.raises(ValueError, match="cannot take"):
            tflash._resolve(*args, bad)
    with pytest.raises(ValueError, match="CUDA"):   # device check first
        tflash.flash_attention_kernel(q, q, q, _override="simt")
    assert set(tflash.flash_attention_kernel.launches_by_variant) == {
        "sm90", "mma", "simt"}
