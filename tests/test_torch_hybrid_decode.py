"""The port's hybrid serving path (zamba2) against the JAX package's, on
the reduced zamba2-7b in f32: ``prefill`` and ``decode_step`` (the
Mamba2 blocks' recurrent step and the shared block's KV cache), the cache
layout and ``ServeEngine.generate``, unchanged on the hybrid cache.

Parameters cross through ``repro_torch.bridge`` (bitwise); tokens are
numpy arrays from a seed.  Logits and caches within 1e-5 (f32), cache
lengths and generated tokens exactly; the port's decode against its own
forward at the reference's 2e-4 (tests/test_decode.py).  The 5-layer
variant has a trailing Mamba2 block after the last shared block, as full
width has 3.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config      # noqa: E402
from repro.models import build_model as jbuild_model     # noqa: E402
from repro.serving import ServeEngine as JServeEngine    # noqa: E402
from repro_torch import bridge                           # noqa: E402
from repro_torch.configs import get_config               # noqa: E402
from repro_torch.models import build_model               # noqa: E402
from repro_torch.models import model as M                # noqa: E402
from repro_torch.serving import ServeEngine              # noqa: E402
from repro_torch.tree import tree_flatten                # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
SELF_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_decode.py


def _build(n_layers=None):
    jcfg = jget_config("zamba2-7b").reduced()
    tcfg = get_config("zamba2-7b").reduced()
    if n_layers is not None:
        jcfg, tcfg = jcfg.with_(n_layers=n_layers), tcfg.with_(
            n_layers=n_layers)
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jmodel, jparams, build_model(tcfg), tparams


@pytest.fixture(scope="module")
def models():
    return _build()


@pytest.fixture(scope="module")
def models5():
    return _build(n_layers=5)


def _tokens(cfg, b=2, s=40, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


@pytest.mark.parametrize("variant", ["models", "models5"])
def test_prefill_and_decode_match_reference(request, variant):
    """Prefill a 6-token prefix, then 4 teacher-forced decode steps:
    logits, the recurrent states and the shared block's KV cache."""
    jmodel, jparams, tmodel, tparams = request.getfixturevalue(variant)
    toks = _tokens(tmodel.cfg, s=10, seed=3)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t))
    jlast, jcache = jax.jit(lambda p, c, t: jmodel.prefill(p, c, t))(
        jparams, jmodel.init_cache(2, 12), jnp.asarray(toks[:, :6]))
    cache = tmodel.init_cache(2, 12, device="cpu")
    last, cache = tmodel.prefill(tparams, cache, _t(toks[:, :6]),
                                 attn_impl="kernel")
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)
    for i in range(6, 10):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]))
        assert tuple(lg.shape) == (2, tmodel.cfg.vocab)
        np.testing.assert_allclose(_np(lg), _np(jlg), **TOL,
                                   err_msg=f"step {i}")
    assert cache["length"].tolist() == np.asarray(jcache["length"]).tolist() \
        == [10, 10]
    for name in ("conv_x", "conv_bc", "ssm"):
        np.testing.assert_allclose(_np(cache["mamba"][name]),
                                   _np(jcache["mamba"][name]), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache["attn"][name]),
                                   _np(jcache["attn"][name]), **TOL)


def test_decode_matches_own_forward(models5):
    _, _, tmodel, tparams = models5
    toks = _tokens(tmodel.cfg, b=1, s=9, seed=4)
    with torch.no_grad():
        want = tmodel.head(tparams, tmodel.forward(
            tparams, {"tokens": _t(toks)}, attn_impl="kernel"))[:, -1]
    cache = tmodel.init_cache(1, 12, device="cpu")
    for i in range(toks.shape[1]):
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]))
    np.testing.assert_allclose(_np(lg), _np(want), **SELF_TOL)


def test_init_cache_layout_matches_reference(models5):
    jmodel, _, tmodel, _ = models5
    jc = jmodel.init_cache(3, 7)
    tc = tmodel.init_cache(3, 7, device="cpu")
    jl, jt = jax.tree_util.tree_flatten(jc)
    tl, tt = tree_flatten(tc)
    assert len(jl) == len(tl)
    for name in ("conv_x", "conv_bc", "ssm"):
        assert tuple(tc["mamba"][name].shape) == jc["mamba"][name].shape
        assert str(tc["mamba"][name].dtype)[6:] == str(
            jc["mamba"][name].dtype)
    for name in ("k", "v"):
        assert tuple(tc["attn"][name].shape) == jc["attn"][name].shape
    assert M._cache_len(tc) == 7
    assert M._cache_len(tmodel.init_cache(1, 5, device="cpu")) == 5


@pytest.mark.parametrize("variant", ["models", "models5"])
def test_serve_engine_tokens_equal_reference(request, variant):
    """``ServeEngine.generate`` on the hybrid cache, unchanged: greedy
    tokens equal the reference engine's exactly, with and without EOS."""
    jmodel, jparams, tmodel, tparams = request.getfixturevalue(variant)
    prompts = np.random.default_rng(7).integers(
        3, tmodel.cfg.vocab, (3, 5)).astype(np.int32)
    free = JServeEngine(jmodel, jparams, cache_len=16, eos_id=-1
                        ).generate(prompts, max_new=8)
    got = ServeEngine(tmodel, tparams, cache_len=16, eos_id=-1
                      ).generate(prompts, max_new=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, free)
    eos = int(free[0, 2])
    want = JServeEngine(jmodel, jparams, cache_len=16, eos_id=eos
                        ).generate(prompts, max_new=8)
    got = ServeEngine(tmodel, tparams, cache_len=16, eos_id=eos
                      ).generate(prompts, max_new=8)
    np.testing.assert_array_equal(got, want)
