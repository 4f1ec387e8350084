"""The port's int8 wire with error feedback against the JAX package's.

  * ``quantize_ef_plain`` (what CPU tensors take, and what the fused
    Hopper encode is held to on the card) against the reference's
    ``ErrorFeedbackCodec(Int8Codec).encode_stateful(..., use_kernel=True)``
    (the Pallas kernel in interpret mode): q, scale and residual bitwise,
    for f32 and bf16 buffers, zero, NaN and inf buffers, and three
    successive steps of residual;
  * ``decode_sum_plain`` (the in-order sum the decode-sum kernel is held
    to) against the reference's ``sum_decoded``: bitwise for P <= 2, and
    for larger P within P f32 ulps of the sum of the decodes' magnitudes
    (the reference's reduce may add in another order);
  * the exchange's single-slot bf16 pack (the leaf handed over in its
    own dtype) against the f32 pack: the same wire, scale and residual;
  * the C entry points' ctypes signatures, the CUDA wrappers' refusal of
    CPU tensors, and the build flags and roundings the source relies on.

Same numpy inputs on both sides.
"""
import ctypes
import types

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.core import codecs as jcodecs                      # noqa: E402
from repro_torch import bridge                                 # noqa: E402
from repro_torch.core import (DistributedOptimizer,            # noqa: E402
                              ExchangeConfig, codecs)
from repro_torch.kernels import build, ops, quantize           # noqa: E402
from repro_torch.optim import adamw                            # noqa: E402
from repro_torch.tree import tree_flatten                      # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _grad(seed: int, n: int, scale: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * scale).astype(np.float32)


def _poison(case: str, n: int = 1000) -> np.ndarray:
    if case == "zeros":
        return np.zeros(n, np.float32)
    x = _grad(n, n, 3.7)
    # a NaN makes the scale NaN and every q 0 (and the residual NaN); an
    # inf makes the scale inf and inv 0
    x[[3, 500]] = (np.nan, -np.inf) if case == "nan" else (np.inf, 1.0)
    return x


def _ref_ef_steps(grads, dtype):
    """The reference's int8+ef encode over successive steps, from a zero
    residual: [(q, scale, residual)] as numpy."""
    ef = jcodecs.get_codec("int8+ef")
    state = ef.init_bucket_state(grads[0].size)
    out = []
    for g in grads:
        q, s, state = ef.encode_stateful(jnp.asarray(g).astype(dtype),
                                         state, use_kernel=True)
        out.append((np.asarray(q), np.asarray(s), np.asarray(state)))
    return out


def _port_ef_steps(grads, dtype):
    residual = torch.zeros(grads[0].size, dtype=torch.float32)
    out = []
    for g in grads:
        x = bridge.array_to_tensor(
            np.asarray(jnp.asarray(g).astype(dtype)), "cpu")
        q, s = quantize.quantize_ef_plain(x, residual)
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        assert tuple(q.shape) == (g.size,) and tuple(s.shape) == (1,)
        out.append((q.numpy(), s.numpy(), residual.numpy().copy()))
    return out


EF_CASES = {
    "three_steps_1000": [_grad(k, 1000, 3.7) for k in range(3)],
    "three_steps_4097": [_grad(10 + k, 4097, s)
                         for k, s in enumerate((1e-3, 1.0, 1e4))],
    "n1": [_grad(20 + k, 1, 2.0) for k in range(3)],
    "zeros": [_poison("zeros")] * 2,
    "nan": [_poison("nan"), _grad(30, 1000, 1.0)],
    "inf": [_poison("inf"), _grad(31, 1000, 1.0)],
}


@pytest.mark.parametrize("case", sorted(EF_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_ef_plain_matches_reference_bitwise(case, dtype):
    """q, scale and the residual after every step, bitwise (NaN where
    the reference has NaN)."""
    grads = EF_CASES[case]
    for step, (got, want) in enumerate(zip(_port_ef_steps(grads, dtype),
                                           _ref_ef_steps(grads, dtype))):
        for name, g, w in zip(("q", "scale", "residual"), got, want):
            np.testing.assert_array_equal(
                g, w, err_msg=f"{case} {dtype} step {step}: {name}")


def test_quantize_ef_plain_is_the_eager_sequence():
    """The plain version is exactly add, stateless encode, subtract the
    decode, with the residual updated in place."""
    x = torch.from_numpy(_grad(40, 777, 5.0)).to(torch.bfloat16)
    residual = torch.from_numpy(_grad(41, 777, 0.01))
    want = residual.clone()
    want.add_(x)
    wq, ws = quantize.quantize_plain(want)
    want.sub_(wq.float() * ws)
    ptr = residual.data_ptr()
    q, s = ops.quantize_int8_ef(x.reshape(7, 111), residual)
    assert residual.data_ptr() == ptr
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert torch.equal(residual, want)


def test_quantize_int8_ef_rejects_a_mismatched_residual():
    with pytest.raises(ValueError, match="residual"):
        ops.quantize_int8_ef(torch.ones(8), torch.zeros(7))
    with pytest.raises(ValueError, match="residual"):
        ops.quantize_int8_ef(torch.ones(8), torch.zeros(2, 4))


def _gathered(p: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    wire = rng.integers(-127, 128, size=(p * n,)).astype(np.int8)
    scales = (rng.random(p) * 10.0 ** rng.integers(-6, 4, size=p)
              ).astype(np.float32)
    return wire, scales


@pytest.mark.parametrize("p", [1, 2, 4])
@pytest.mark.parametrize("n", [1, 1000, 4096])
def test_decode_sum_plain_matches_reference(p, n):
    wire, scales = _gathered(p, n, 100 * p + n)
    got = ops.int8_decode_sum(torch.from_numpy(wire),
                              torch.from_numpy(scales), p).numpy()
    want = np.asarray(jcodecs.sum_decoded(
        jcodecs.get_codec("int8"), jnp.asarray(wire), jnp.asarray(scales),
        p, jnp.float32))
    assert got.dtype == np.float32 and got.shape == (n,)
    if p <= 2:
        np.testing.assert_array_equal(got, want)
    else:
        mag = (np.abs(wire.reshape(p, n).astype(np.float32))
               * scales[:, None]).sum(axis=0)
        assert np.all(np.abs(got - want) <= p * np.spacing(mag))


def test_decode_sum_adds_in_worker_order():
    """Chunk 0's decode first, then each later one: with one large and
    two cancelling small terms the order shows in the result."""
    wire = torch.tensor([1, 1, -1], dtype=torch.int8)
    scales = torch.tensor([1.0, 2.0 ** -24, 2.0 ** -24])
    got = quantize.decode_sum_plain(wire, scales, 3)
    # f32(1 + 2**-24) rounds to 1, so in order the sum is 1 - 2**-24
    assert got.item() == np.float32(1) - np.float32(2.0 ** -24)


def test_decode_sum_of_one_chunk_is_the_decode():
    wire, scales = _gathered(1, 999, 7)
    w, s = torch.from_numpy(wire), torch.from_numpy(scales)
    assert torch.equal(ops.int8_decode_sum(w, s, 1),
                       codecs.get_codec("int8").decode(w, s, torch.float32))


def test_sum_decoded_routes_int8_through_the_decode_sum(monkeypatch):
    calls = []
    real = ops.int8_decode_sum
    monkeypatch.setattr(ops, "int8_decode_sum",
                        lambda *a: calls.append(a[2]) or real(*a))
    wire, scales = _gathered(2, 64, 3)
    for name in ("int8", "int8+ef"):
        codecs.sum_decoded(codecs.get_codec(name), torch.from_numpy(wire),
                           torch.from_numpy(scales), 2, "float32")
    assert calls == [2, 2]


# ---------------------------------------------------------------------------
# the exchange: the leaf handed over in its own dtype, one fused encode
# ---------------------------------------------------------------------------

def _leaf(seed: int = 50):
    return torch.from_numpy(_grad(seed, 33 * 17, 4.0).reshape(33, 17))


@pytest.mark.parametrize("name", ["int8", "int8+ef"])
def test_single_slot_bf16_pack_gives_the_f32_packs_wire(name):
    """A single-slot bucket of a bf16 leaf packs the leaf itself; its
    encode gives the wire, scale and residual of the f32 pack."""
    bf = {"w": _leaf().to(torch.bfloat16)}
    f32 = {"w": bf["w"].to(torch.float32)}
    codec = codecs.get_codec(name)
    bufs, encoded = [], []
    for tree in (bf, f32):
        opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
            codec=name))
        plan = opt.plan(tree)
        leaves, _ = tree_flatten(tree)
        buf = plan.pack_bucket(plan.dense_buckets[0], leaves)
        state = opt.init_exchange_state(tree).bucket_states[0]
        if state != ():
            state.copy_(torch.from_numpy(_grad(51, buf.numel(), 0.01)))
        wire, scale, state = codec.encode_stateful(buf, state)
        bufs.append(buf)
        encoded.append((wire, scale, state))
    assert bufs[0].dtype == torch.bfloat16
    assert bufs[0].data_ptr() == bf["w"].data_ptr()       # no copy
    assert bufs[1].dtype == torch.float32
    for got, want in zip(encoded[0], encoded[1]):
        if isinstance(want, tuple):
            assert got == want
        else:
            assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", ["int8+ef", "bf16+ef", "int8"])
def test_multi_slot_buckets_keep_the_f32_pack(name):
    tree = {"a": _leaf().to(torch.bfloat16),
            "b": torch.ones(5, dtype=torch.bfloat16)}
    opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
        codec=name, fusion_threshold=1 << 20))
    plan = opt.plan(tree)
    assert len(plan.dense_buckets) == 1
    buf = plan.pack_bucket(plan.dense_buckets[0], tree_flatten(tree)[0])
    assert buf.dtype == torch.float32 and buf.numel() == 33 * 17 + 5


def test_int8_ef_exchange_takes_the_fused_encode(monkeypatch):
    """Under int8+ef a dense stage encodes through ``quantize_int8_ef``
    once and never through the stateless encode with an add and a
    subtraction around it; the bf16 tree's residual and output equal the
    f32 tree's."""
    calls = []
    real = ops.quantize_int8_ef
    monkeypatch.setattr(ops, "quantize_int8_ef",
                        lambda *a: calls.append(a[0].dtype) or real(*a))

    def refuse(*a):
        raise AssertionError("stateless encode on an error-feedback stage")
    monkeypatch.setattr(ops, "quantize_int8", refuse)
    results = []
    for dtype in (torch.bfloat16, torch.float32):
        tree = {"w": _leaf().to(torch.bfloat16).to(dtype)}
        opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
            codec="int8+ef"))
        state = opt.init_exchange_state(tree)
        for _ in range(3):
            out, state = opt.exchange(tree, state=state)
        results.append((out["w"].float(), state.bucket_states[0]))
    assert calls == [torch.bfloat16] * 3 + [torch.float32] * 3
    assert torch.equal(results[0][1], results[1][1])
    assert torch.equal(results[0][0],
                       results[1][0].to(torch.bfloat16).float())


# ---------------------------------------------------------------------------
# the CUDA side, as far as the CPU can check it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,want", [
    ("repro_quantize_int8",
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 4),
    ("repro_quantize_int8_ef",
     [ctypes.c_void_p, ctypes.c_int, ctypes.c_int64] + [ctypes.c_void_p] * 5),
    ("repro_int8_decode_sum",
     [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
      ctypes.c_void_p, ctypes.c_void_p]),
])
def test_entry_points_declare_their_c_signature(monkeypatch, name, want):
    """Pointers and the stream cross as ``c_void_p``, n as ``int64``:
    left to ctypes' default, each would be cut to a C int."""
    fake = ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)
    monkeypatch.setattr(build, "load", lambda lib: types.SimpleNamespace(
        **{name: fake}))
    fn = quantize._entry_point(name)
    assert fn.argtypes == want
    assert fn.restype is ctypes.c_int


def test_cuda_wrappers_refuse_cpu_tensors():
    """Asked for a kernel, a CPU tensor raises: nothing falls back."""
    with pytest.raises(ValueError, match="CUDA"):
        quantize.quantize_ef_kernel(torch.ones(8), torch.zeros(8))
    with pytest.raises(ValueError, match="CUDA"):
        quantize.decode_sum_kernel(torch.ones(8, dtype=torch.int8),
                                   torch.ones(2), 2)
    launches = (quantize.quantize_kernel.launches,
                quantize.quantize_ef_kernel.launches,
                quantize.decode_sum_kernel.launches)
    ops.quantize_int8_ef(torch.ones(8), torch.zeros(8))
    ops.int8_decode_sum(torch.ones(8, dtype=torch.int8), torch.ones(2), 2)
    assert (quantize.quantize_kernel.launches,
            quantize.quantize_ef_kernel.launches,
            quantize.decode_sum_kernel.launches) == launches


def test_source_keeps_the_references_roundings():
    """IEEE division and no fast-math reach nvcc, and the residual is
    formed with explicitly rounded operations: a plain ``c - q * s``
    would be contracted into an FMA and differ in the last bit."""
    flags = " ".join(build.NVCC_FLAGS)
    for bad in ("fast_math", "fast-math", "ftz", "prec-div=false",
                "fmad=true"):
        assert bad not in flags
    src = (build.CSRC / "quantize.cu").read_text()
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    assert ("__fsub_rn(c, __fmul_rn(static_cast<float>(q), scale))"
            in code)
    assert "__fadd_rn(c.x, u.x)" in code
    for entry in ("repro_quantize_int8(", "repro_quantize_int8_ef(",
                  "repro_int8_decode_sum("):
        assert f'extern "C" int {entry}' in code
    assert "atomicMax" not in code and "cudaMemsetAsync" not in code
