"""The port's collective backends, fp8 wires and hop codecs against the
reference (``repro.core.backend``, ``repro.core.codecs``), in-process:

  * the registries (backend names mapped: the port's ``flat`` is the
    reference's ``jax``) and the fp8 codecs;
  * ``ExchangeConfig``'s normalisation of the deprecated ``wire_dtype``
    and ``hierarchical`` spellings and every refusal;
  * the plan's accounting exactly equal to the reference's on full-width
    transformer-big's tree, for every backend x codec x mode, at flat and
    per-level worker counts;
  * the fp8 cast's bytes equal ``jnp.asarray(x).astype(...)``'s (NaN past
    e4m3fn's range, where PyTorch saturates) and the fp8 add equal
    jnp's on every pair of bytes;
  * ``encode_hop``, ``requantize`` and ``reduce_hop`` bitwise against the
    reference's with ``use_kernel=True`` (the Pallas kernel in interpret
    mode).
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config           # noqa: E402
from repro.core import backend as jbackend                     # noqa: E402
from repro.core import codecs as jcodecs                       # noqa: E402
from repro.core import exchange as jexchange                   # noqa: E402
from repro.core.exchange import ExchangeConfig as JExchangeConfig  # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.training.gradients import abstract_grad_contributions  # noqa: E402
from repro_torch.configs import get_config                     # noqa: E402
from repro_torch.core import backend, codecs, comm, exchange   # noqa: E402
from repro_torch.core.exchange import ExchangeConfig           # noqa: E402
from repro_torch.models import build_model                     # noqa: E402
from repro_torch.training.gradients import grad_contributions  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

#: the port's backend names -> the reference's
BACKENDS = {"flat": "jax", "hierarchical": "hierarchical",
            "ringsim": "ringsim"}
CODECS = ["identity", "bf16", "f16", "f8e4m3", "f8e5m2", "int8", "int8+ef"]
MODES = {"dense_reduce": dict(sparse_as_dense=True), "sparse_gather": {}}
FLAT_LEVELS = [2, 8, 64, (2, 4), (4, 16)]
HIER_LEVELS = [(2, 4), (4, 16)]
FP8 = {"f8e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
       "f8e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


def _cfg_kw(name):
    """(port kw, reference kw) of an ExchangeConfig, backends mapped."""
    if "backend" not in name:
        return name, name
    return name, dict(name, backend=BACKENDS.get(name["backend"],
                                                 name["backend"]))


# ---------------------------------------------------------------------------
# registries
# ---------------------------------------------------------------------------

def test_backend_registry_maps_onto_reference():
    assert set(backend.available_backends()) == set(BACKENDS)
    assert set(jbackend.available_backends()) == set(BACKENDS.values())
    assert isinstance(backend.get_backend(None), backend.FlatCollectives)
    assert backend.get_backend("flat").name == "flat"
    assert ExchangeConfig().backend == "flat"
    for name in BACKENDS:
        be = backend.get_backend(name)
        assert backend.get_backend(be) is be
        assert type(be).__mro__[1].__name__ in (
            "CollectiveBackend", "FlatCollectives")
    with pytest.raises(ValueError, match="unknown collective backend"):
        backend.get_backend("jax")


def test_registry_holds_the_fp8_codecs():
    port = set(codecs.available_codecs())
    assert {"identity", "bf16", "f16", "int8", "f8e4m3", "f8e5m2"} <= port
    for name in FP8:
        c, j = codecs.get_codec(name), jcodecs.get_codec(name)
        assert (c.name, c.linear, c.stateful, c.scale_bytes) == (
            j.name, j.linear, j.stateful, j.scale_bytes)
        assert c.wire_dtype("float32") == j.wire_dtype("float32")
        assert c.wire_bytes(1000, "bfloat16") == j.wire_bytes(1000,
                                                              "bfloat16")
        ef = codecs.get_codec(name + "+ef")
        assert ef.name == jcodecs.get_codec(name + "+ef").name


@pytest.mark.parametrize("name", ["bf16", "bfloat16", "f16", "fp16",
                                  "float16", "f32", "fp32", "float32",
                                  "f8e4m3", "fp8e4m3", "float8_e4m3fn",
                                  "f8e5m2", "float8_e5m2", "f4", None])
def test_canonical_dtype_and_wire_dtype_codec_match_reference(name):
    assert codecs.canonical_dtype(name) == jcodecs.canonical_dtype(name)
    if name is not None:
        assert codecs.codec_name_for_wire_dtype(name) == \
            jcodecs.codec_name_for_wire_dtype(name)
        assert codecs.get_codec(codecs.canonical_dtype(name)).name == \
            jcodecs.get_codec(jcodecs.canonical_dtype(name)).name
    with pytest.raises(ValueError, match="unknown wire dtype"):
        codecs.canonical_dtype("not-a-dtype")


def test_padded_elems_matches_reference():
    for n in (0, 1, 7, 8, 34516992, 6145):
        for p in (0, 1, 2, 3, 8, 64):
            assert codecs.padded_elems(n, p) == jcodecs.padded_elems(n, p)


# ---------------------------------------------------------------------------
# ExchangeConfig: normalisation and refusals
# ---------------------------------------------------------------------------

NORMALISED = [
    dict(wire_dtype="bf16"), dict(wire_dtype="bfloat16", codec="bf16"),
    dict(wire_dtype="float32"), dict(wire_dtype="f16"),
    dict(wire_dtype="f16", error_feedback=True),
    dict(wire_dtype="f8e4m3"), dict(codec="float16"),
    dict(hierarchical=True),
    dict(hierarchical=True, backend="hierarchical"),
    dict(backend="ringsim", reduce_scatter=True, codec="bf16"),
    dict(reduce_scatter=True, codec="f8e5m2"),
    dict(backend="hierarchical", codec="int8+ef", hierarchy_levels=3),
]


@pytest.mark.parametrize("kw", NORMALISED, ids=str)
def test_exchange_config_normalises_like_reference(kw):
    tkw, jkw = _cfg_kw(kw)
    c, j = ExchangeConfig(**tkw), JExchangeConfig(**jkw)
    assert c.codec == j.codec
    assert BACKENDS[c.backend] == j.backend
    assert (c.wire_dtype, c.hierarchical, c.error_feedback) == (
        j.wire_dtype, j.hierarchical, j.error_feedback) == (None, False,
                                                            False)
    assert (c.reduce_scatter, c.hierarchy_levels, c.dense_collective) == (
        j.reduce_scatter, j.hierarchy_levels, j.dense_collective)
    assert c.is_hierarchical == j.is_hierarchical
    canon = ExchangeConfig(codec=c.codec, backend=c.backend,
                           reduce_scatter=c.reduce_scatter,
                           hierarchy_levels=c.hierarchy_levels)
    assert c == canon and hash(c) == hash(canon)


REFUSED = [
    dict(codec="int8", reduce_scatter=True),
    dict(codec="int8+ef", reduce_scatter=True),
    dict(codec="bf16+ef", reduce_scatter=True),
    dict(codec="identity", error_feedback=True, reduce_scatter=True),
    dict(backend="hierarchical", reduce_scatter=True),
    dict(hierarchical=True, reduce_scatter=True),
    dict(hierarchical=True, backend="ringsim"),
    dict(wire_dtype="bf16", codec="f16"),
    dict(wire_dtype="bf16", codec="int8"),
    dict(wire_dtype="not-a-dtype"),
    dict(backend="nope"),
]


@pytest.mark.parametrize("kw", REFUSED, ids=str)
def test_exchange_config_refuses_like_reference(kw):
    tkw, jkw = _cfg_kw(kw)
    with pytest.raises(ValueError) as jerr:
        JExchangeConfig(**jkw)
    with pytest.raises(ValueError) as terr:
        ExchangeConfig(**tkw)
    # the same refusal: the reference's message, backend names mapped
    want = str(jerr.value).replace("'jax'", "'flat'")
    if "nope" not in str(kw):
        assert str(terr.value) == want


# ---------------------------------------------------------------------------
# accounting at full width, exactly
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def full_width_trees():
    """One worker's gradient-contribution tree for full-width
    transformer-big, batch 8 x 256, in both packages, shapes only."""
    b, s = 8, 256
    jcfg = jget_config("transformer-big")
    jmodel = jbuild_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    jbatch = {"tokens": sds((b, s), jnp.int32),
              "labels": sds((b, s), jnp.int32),
              "frontend": sds((b, jcfg.frontend.n_embeds, jcfg.d_model),
                              jnp.float32)}
    jg = abstract_grad_contributions(jmodel, jparams, jbatch,
                                     sparse_embedding=True)
    cfg = get_config("transformer-big")
    model = build_model(cfg)
    meta = dict(device="meta")
    tbatch = {"tokens": torch.empty(b, s, dtype=torch.int32, **meta),
              "labels": torch.empty(b, s, dtype=torch.int32, **meta),
              "frontend": torch.empty(b, cfg.frontend.n_embeds, cfg.d_model,
                                      **meta)}
    tg, _, _ = grad_contributions(model, model.init(**meta), tbatch,
                                  sparse_embedding=True)
    return tg, jg


def _accounting_cases():
    for be in BACKENDS:
        for codec in CODECS:
            for mode in MODES:
                for rs in (False, True):
                    linear = not codec.startswith("int8")
                    if rs and not (linear and be != "hierarchical"):
                        continue
                    yield be, codec, mode, rs


@pytest.mark.parametrize("be,codec,mode,rs", list(_accounting_cases()),
                         ids=lambda v: str(v))
def test_accounting_equals_reference_at_full_width(full_width_trees, be,
                                                   codec, mode, rs):
    tg, jg = full_width_trees
    kw = dict(codec=codec, reduce_scatter=rs, use_kernel=True, **MODES[mode])
    tplan = exchange.compile_plan(tg, ExchangeConfig(backend=be, **kw))
    jplan = jexchange.compile_plan(jg, JExchangeConfig(
        backend=BACKENDS[be], **kw))
    assert [b.collective for b in tplan.dense_buckets] == \
        [b.collective for b in jplan.dense_buckets]
    assert tplan.n_collectives == jplan.n_collectives
    stages = list(zip(tplan.schedule.stages, jplan.schedule.stages))
    assert [tplan.stage_collectives(t) for t, _ in stages] == \
        [jplan.stage_collectives(j) for _, j in stages]
    levels = HIER_LEVELS if be == "hierarchical" else FLAT_LEVELS
    for lv in levels:
        assert tplan.wire_bytes(lv) == jplan.wire_bytes(lv), lv
        assert tplan.hop_wire_bytes(lv) == jplan.hop_wire_bytes(lv), lv
        assert tplan.hlo_collectives(lv) == jplan.hlo_collectives(lv), lv
        assert tplan.buffer_bytes(lv) == jplan.buffer_bytes(lv), lv
        for t, j in stages:
            assert tplan.stage_hop_ops(t, lv) == jplan.stage_hop_ops(j, lv)
            assert tplan.stage_hop_wire_bytes(t, lv) == \
                jplan.stage_hop_wire_bytes(j, lv)
            assert sum(tplan.stage_hop_ops(t, lv)) == \
                tplan.stage_hlo_collectives(t, lv)
    if be == "hierarchical":
        for p in (2, 8):       # a hierarchical plan needs per-level counts
            with pytest.raises(ValueError, match="per-level"):
                tplan.wire_bytes(p)
            with pytest.raises(ValueError, match="per-level"):
                jplan.wire_bytes(p)


# ---------------------------------------------------------------------------
# fp8: the reference's cast and add
# ---------------------------------------------------------------------------

def _fp8_values() -> np.ndarray:
    rng = np.random.default_rng(0)
    edges = [0.0, -0.0, 1.0, -1.0, 447.0, 448.0, 449.0, 463.9, 464.0,
             464.01, 465.0, 480.0, 500.0, 1e4, 57344.0, 61439.0, 61440.0,
             61441.0, 65536.0, 1e6, 3e38, np.inf, -np.inf, np.nan,
             2.0 ** -6, 2.0 ** -7, 2.0 ** -9, 2.0 ** -10, 3 * 2.0 ** -11,
             2.0 ** -14, 2.0 ** -16, 2.0 ** -17, 1e-8, 1e-30, 1.4e-45]
    beyond = rng.uniform(448.0, 1e6, 2000) * rng.choice([-1, 1], 2000)
    parts = [np.array(edges), -np.array(edges), beyond]
    parts += [rng.standard_normal(4000) * s
              for s in (1e-5, 1e-3, 1.0, 100.0, 3e4)]
    return np.concatenate(parts).astype(np.float32)


def _same_bytes_nan_as_nan(got: np.ndarray, want: np.ndarray,
                           jdt) -> None:
    """Bytes equal, except that a NaN equals any NaN (payloads may
    differ between frameworks)."""
    gnan = np.isnan(got.view(jdt).astype(np.float32))
    wnan = np.isnan(want.view(jdt).astype(np.float32))
    np.testing.assert_array_equal(gnan, wnan)
    np.testing.assert_array_equal(got[~gnan], want[~wnan])


@pytest.mark.parametrize("src", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FP8))
def test_fp8_encode_gives_the_reference_bytes(name, src):
    tdt, jdt = FP8[name]
    x = _fp8_values()
    jx = jnp.asarray(x).astype(src)
    want = np.asarray(jx.astype(jdt)).view(np.uint8)
    tx = torch.from_numpy(x).to(getattr(torch, src))
    wire, scale = codecs.get_codec(name).encode(tx)
    assert scale is None and wire.dtype == tdt
    got = wire.view(torch.uint8).numpy()
    _same_bytes_nan_as_nan(got, want, jdt)
    # |x| past the rounding limit is NaN for e4m3fn (no inf), inf for
    # e5m2; PyTorch's plain cast saturates e4m3fn and so does not pass
    if name == "f8e4m3":
        over = np.abs(jx.astype(jnp.float32)) > 464
        assert over.sum() > 1000
        assert np.isnan(wire.to(torch.float32).numpy()[np.asarray(over)]
                        ).all()
        plain = tx.to(tdt).view(torch.uint8).numpy()
        with pytest.raises(AssertionError):
            _same_bytes_nan_as_nan(plain, want, jdt)
    # f32 NaN keeps the reference's payload too
    if src == "float32":
        nan = np.isnan(x)
        np.testing.assert_array_equal(got[nan], want[nan])


@pytest.mark.parametrize("name", sorted(FP8))
def test_fp8_add_equals_reference_on_every_pair(name):
    """The ring's in-flight add (widen, add, round back) against jnp's
    float8 add, on all 256 x 256 pairs of bytes."""
    tdt, jdt = FP8[name]
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    want = np.asarray(jnp.asarray(a.view(jdt)) + jnp.asarray(b.view(jdt))
                      ).view(np.uint8)
    got = comm.fp8_add(torch.from_numpy(a).view(tdt),
                       torch.from_numpy(b).view(tdt)).view(torch.uint8)
    _same_bytes_nan_as_nan(got.numpy(), want, jdt)


# ---------------------------------------------------------------------------
# the hop codecs against the reference's, with the kernels' paths
# ---------------------------------------------------------------------------

def _buf(seed, n, dtype=np.float32, scale=1e-2):
    return (np.random.default_rng(seed).standard_normal(n) * scale
            ).astype(dtype)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("name", ["int8", "int8+ef", "bf16", "f8e4m3",
                                  "f8e5m2+ef"])
def test_encode_hop_matches_reference(name, level):
    c, j = codecs.get_codec(name), jcodecs.get_codec(name)
    x = _buf(1, 4099)
    state = np.zeros(4099, np.float32) if c.stateful else None
    if state is not None:
        state[:] = _buf(2, 4099, scale=1e-4)
    jstate = jnp.asarray(state) if state is not None else ()
    tstate = torch.from_numpy(state.copy()) if state is not None else ()
    jw, js, jst = j.encode_hop(jnp.asarray(x), jstate, level,
                               use_kernel=True)
    tw, ts, tst = c.encode_hop(torch.from_numpy(x), tstate, level)
    if comm.is_fp8(tw.dtype):
        np.testing.assert_array_equal(tw.view(torch.uint8).numpy(),
                                      np.asarray(jw).view(np.uint8))
    else:
        np.testing.assert_array_equal(tw.to(torch.float32).numpy(),
                                      np.asarray(jw).astype(np.float32))
    if js is None:
        assert ts is None
    else:
        np.testing.assert_array_equal(ts.numpy().reshape(-1),
                                      np.asarray(js).reshape(-1))
    if state is not None:
        np.testing.assert_array_equal(
            tst.numpy(), np.asarray(jst).reshape(-1))
        if level > 0:                  # a requantize leaves the state alone
            np.testing.assert_array_equal(tst.numpy(), state)


@pytest.mark.parametrize("name", ["int8", "int8+ef"])
def test_requantize_of_a_partial_sum_matches_reference(name):
    """A hop-1 requantize encodes the f32 decode-sum of real int8 chunks
    statelessly: q and scale bitwise."""
    c, j = codecs.get_codec(name), jcodecs.get_codec(name)
    parts = [c.encode(torch.from_numpy(_buf(s, 6144)))[0:2]
             for s in range(2)]
    q = torch.cat([p[0] for p in parts])
    s = torch.cat([p[1] for p in parts])
    partial = c.reduce_hop(q, s, 2, torch.float32)
    jpartial = j.reduce_hop(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                            2, jnp.float32)
    np.testing.assert_array_equal(partial.numpy(), np.asarray(jpartial))
    tq, ts = c.requantize(partial)
    jq, js = j.requantize(jpartial, use_kernel=True)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().reshape(-1),
                                  np.asarray(js).reshape(-1))


@pytest.mark.parametrize("n_chunks", [1, 2])
@pytest.mark.parametrize("name", ["int8", "int8+ef", "bf16", "f8e4m3"])
def test_reduce_hop_matches_reference(name, n_chunks):
    c, j = codecs.get_codec(name), jcodecs.get_codec(name)
    wires, scales = [], []
    for k in range(n_chunks):
        w, s = c.encode(torch.from_numpy(_buf(10 + k, 1000, scale=3.0)))
        wires.append(w)
        scales.append(s)
    tw = torch.cat([comm._bits(w) for w in wires]).view(wires[0].dtype)
    ts = torch.cat(scales) if scales[0] is not None else None
    if comm.is_fp8(tw.dtype):
        jw = jnp.asarray(tw.view(torch.uint8).numpy()).view(FP8[name][1])
    elif tw.dtype == torch.bfloat16:
        jw = jnp.asarray(tw.to(torch.float32).numpy()).astype(jnp.bfloat16)
    else:
        jw = jnp.asarray(tw.numpy())
    js = jnp.asarray(ts.numpy()) if ts is not None else None
    got = c.reduce_hop(tw, ts, n_chunks, torch.float32)
    want = j.reduce_hop(jw, js, n_chunks, jnp.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chip_smoke_fp8_reference_is_the_reference():
    """``chip_smoke.py`` holds the card's fp8 encode to a table of bytes
    and to a plain numpy rounding (it cannot import JAX): both equal
    jnp's cast here, NaN compared as NaN."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    x = np.concatenate([np.array(list(smoke.FP8_REFERENCE_BYTES),
                                 np.float32), _fp8_values()])
    for k, (name, (_, jdt)) in enumerate(sorted(FP8.items())):
        want = np.asarray(jnp.asarray(x).astype(jdt)).view(np.uint8)
        dt = jnp.dtype(jdt).name
        table = np.array([v[k] for v in smoke.FP8_REFERENCE_BYTES.values()],
                         np.uint8)
        assert smoke.fp8_same(table, want[:len(table)], dt)
        got = smoke.fp8_reference(x, dt)
        assert smoke.fp8_same(got, want, dt)
        _same_bytes_nan_as_nan(got, want, jdt)
        bf = np.asarray(jnp.asarray(x).astype(jnp.bfloat16))
        assert smoke.fp8_same(
            smoke.fp8_reference(bf.astype(np.float32), dt),
            np.asarray(jnp.asarray(bf).astype(jdt)).view(np.uint8), dt)
