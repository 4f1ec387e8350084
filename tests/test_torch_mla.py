"""The port's MLA layer (DeepSeek-V2 multi-head latent attention) against
the JAX package's, in f32: ``init_mla``'s layout, ``mla_attention``
without a cache through the chunked and kernel impls, the absorbed
decode at the reference's three ``(cache_len, filled)`` cases of
tests/test_beyond_paper.py, a chunked (s > 1) step, a ring and a
window; and the two repairs of mixed head dims (Dv != D): the absorbed
decode against the naive one in the port, which the reference cannot
run there (its ``decode_attention`` reshapes to q's head dim), and
``decode_attention`` itself, pinned to the reference's at Dv == D.

Two configs: the reduced deepseek-v2-236b (nope 16 + rope 16 = v 32,
Dv == D) and the same with nope 32 (q·k 48, v 32: Dv != D).  Parameters
from the reference's ``init_mla`` cross through ``repro_torch.bridge``
(bitwise); inputs from a numpy seed.  Tolerance ``TOL`` (1e-5), and the
reference's own 2e-5 for absorbed against naive.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config      # noqa: E402
from repro.models import layers as JL                    # noqa: E402
from repro_torch import bridge                           # noqa: E402
from repro_torch.configs import get_config               # noqa: E402
from repro_torch.models import layers as L               # noqa: E402
from test_torch_dense import TOL, _np, _t, config_fields  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v2-236b"
ABSORB_TOL = dict(rtol=2e-5, atol=2e-5)      # tests/test_beyond_paper.py
CASES = [(8, 3), (16, 15), (4, 0)]           # (cache_len, filled)


def _cfgs(nope=None):
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    if nope is not None:
        jcfg = jcfg.with_(mla=dataclasses.replace(jcfg.mla, nope_dim=nope))
        cfg = cfg.with_(mla=dataclasses.replace(cfg.mla, nope_dim=nope))
    return jcfg, cfg


@pytest.fixture(scope="module", params=[None, 32], ids=["dv_eq_d",
                                                       "dv_ne_d"])
def mla(request):
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg, cfg = _cfgs(request.param)
    jp = JL.init_mla(jax.random.PRNGKey(1), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, cfg, tp


def _x(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _cache(cfg, b, cache_len, filled, seed, ring=False):
    rng = np.random.default_rng(seed)
    m = cfg.mla
    return {"ckv": (0.1 * rng.standard_normal((b, cache_len, m.kv_lora))
                    ).astype(np.float32),
            "kr": (0.1 * rng.standard_normal((b, cache_len, m.rope_dim))
                   ).astype(np.float32),
            "length": np.full((b,), filled, np.int32), "ring": ring}


def _jcache(c):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}


def _tcache(c):
    return {k: (_t(v) if isinstance(v, np.ndarray) else v)
            for k, v in c.items()}


def test_configs_match_reference():
    config_fields(get_config(ARCH), jget_config(ARCH))
    config_fields(get_config(ARCH).reduced(), jget_config(ARCH).reduced())
    m = get_config(ARCH).mla
    assert (m.kv_lora, m.nope_dim + m.rope_dim, m.v_dim) == (512, 192, 128)
    assert get_config(ARCH).reduced().mla.kv_lora == 32


def test_init_mla_layout_matches_reference(mla):
    jcfg, jp, cfg, tp = mla
    mine = L.init_mla(torch.Generator().manual_seed(0), cfg, "cpu")
    assert sorted(mine) == sorted(tp)
    for name in tp:
        a, b = mine[name], tp[name]
        if isinstance(b, dict):
            a, b = a["scale"], b["scale"]
        assert a.shape == b.shape and a.dtype == b.dtype, name
    assert torch.equal(mine["norm_ckv"]["scale"], torch.ones(32))


@pytest.mark.parametrize("impl,jimpl", [("chunked", "xla_chunked"),
                                        ("kernel", "pallas"),
                                        ("ref", "xla")])
def test_forward_matches_reference(mla, impl, jimpl):
    """No cache: causal attention over 2 x 13 tokens.  At Dv == D the
    kernel impl meets the Pallas kernel (interpret mode); at Dv != D
    both packages take their chunked route."""
    jcfg, jp, cfg, tp = mla
    x = _x(2, 13, cfg.d_model, 3)
    pos = np.arange(13)
    jy, jc = JL.mla_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              attn_impl=jimpl)
    y, c = L.mla_attention(tp, cfg, _t(x), _t(pos), attn_impl=impl)
    assert c is None and jc is None
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)


@pytest.mark.parametrize("cache_len,filled", CASES)
def test_absorbed_decode_matches_reference(mla, cache_len, filled):
    """The reference's three cases of tests/test_beyond_paper.py: the
    absorbed decode of one token against the reference's, output and
    cache; at Dv == D the naive decode too."""
    jcfg, jp, cfg, tp = mla
    x = _x(2, 1, cfg.d_model, 4)
    cache = _cache(cfg, 2, cache_len, filled, 5)
    pos = np.full((2, 1), filled)
    jy, jc = JL.mla_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              kv_cache=_jcache(cache), absorbed=True)
    y, c = L.mla_attention(tp, cfg, _t(x), _t(pos), kv_cache=_tcache(cache),
                           absorbed=True)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_np(c[name]), _np(jc[name]), **TOL)
    assert c["length"].tolist() == [filled + 1] * 2 and c["ring"] is False
    if cfg.mla.nope_dim + cfg.mla.rope_dim == cfg.mla.v_dim:
        jn, _ = JL.mla_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                                 kv_cache=_jcache(cache), absorbed=False)
        n, _ = L.mla_attention(tp, cfg, _t(x), _t(pos),
                               kv_cache=_tcache(cache), absorbed=False)
        np.testing.assert_allclose(_np(n), _np(jn), **TOL)


@pytest.mark.parametrize("cache_len,filled", CASES)
def test_absorbed_equals_naive_in_the_port(mla, cache_len, filled):
    """tests/test_beyond_paper.py's check, in the port and at both head
    dim layouts: at Dv != D the naive decode runs since
    ``decode_attention`` reshapes to the value head dim."""
    _, _, cfg, tp = mla
    x = _x(2, 1, cfg.d_model, 6)
    cache = _cache(cfg, 2, cache_len, filled, 7)
    pos = _t(np.full((2, 1), filled))
    a, ca = L.mla_attention(tp, cfg, _t(x), pos, kv_cache=_tcache(cache),
                            absorbed=True)
    n, cn = L.mla_attention(tp, cfg, _t(x), pos, kv_cache=_tcache(cache),
                            absorbed=False)
    np.testing.assert_allclose(_np(a), _np(n), **ABSORB_TOL)
    assert torch.equal(ca["ckv"], cn["ckv"]) and torch.equal(ca["kr"],
                                                             cn["kr"])


@pytest.mark.parametrize("ring,window", [(False, None), (False, 3),
                                         (True, 6)])
def test_chunked_ring_and_window_decode_match_reference(mla, ring, window):
    """A chunk of 3 rows (per-row causal mask), a window over a linear
    cache, and a ring of 6 slots that wraps: the absorbed step against
    the reference's; the naive one against the absorbed one."""
    jcfg, jp, cfg, tp = mla
    s = 1 if ring else 3
    x = _x(2, s, cfg.d_model, 8)
    cache = _cache(cfg, 2, 6 if ring else 10, 5, 9, ring=ring)
    cache["length"] = np.array([5, 8 if ring else 4], np.int32)
    pos = cache["length"][:, None] + np.arange(s)[None]
    jy, jc = JL.mla_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                              kv_cache=_jcache(cache), window=window)
    y, c = L.mla_attention(tp, cfg, _t(x), _t(pos), kv_cache=_tcache(cache),
                           window=window)
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(_np(c["ckv"]), _np(jc["ckv"]), **TOL)
    n, _ = L.mla_attention(tp, cfg, _t(x), _t(pos), kv_cache=_tcache(cache),
                           window=window, absorbed=False)
    np.testing.assert_allclose(_np(n), _np(y), **ABSORB_TOL)


@pytest.mark.parametrize("window,s", [(None, 1), (4, 1), (None, 3)])
def test_decode_attention_pinned_at_dv_eq_d_and_runs_at_dv_ne_d(window, s):
    """``decode_attention`` (GQA 2) equals the reference's at Dv == D.
    At Dv < D the reference raises; the port equals the reference run
    on v zero-padded to D and cut back to Dv (the padded columns get
    zero weight and so change nothing)."""
    rng = np.random.default_rng(10)
    b, c, h, kv, d = 2, 9, 4, 2, 24
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, c, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, c, kv, d)).astype(np.float32)
    length = np.array([6, 9], np.int32)
    got = L.decode_attention(_t(q), _t(k), _t(v), _t(length), window=window)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(length),
                               window=window)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    dv = 16
    got = L.decode_attention(_t(q), _t(k), _t(v[..., :dv]), _t(length),
                             window=window)
    assert tuple(got.shape) == (b, s, h, dv)
    vpad = np.concatenate([v[..., :dv], np.zeros_like(v[..., dv:])], -1)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(vpad), jnp.asarray(length),
                               window=window)
    np.testing.assert_allclose(_np(got), _np(want)[..., :dv], **TOL)
    with pytest.raises(TypeError, match="reshape"):
        JL.decode_attention(jnp.asarray(q), jnp.asarray(k),
                            jnp.asarray(v[..., :dv]), jnp.asarray(length))
