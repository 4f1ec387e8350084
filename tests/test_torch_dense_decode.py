"""The port's dense-family forward and serving path against the JAX
package's, on the reduced llama3.2-1b, chatglm3-6b, qwen2.5-32b and
deepseek-7b in f32, with the same non-zero q/k/v biases on both sides
(tests/test_torch_dense.py's ``build``); and the reduced
seamless-m4t-large-v2's decode, cross-attending its frames, and engine.

The reference runs its flash attention as the Pallas kernel in
interpret mode (``attn_impl="pallas"``), the port its ``"kernel"`` impl
(the kernel's plain version on the CPU).  Logits and caches within 1e-5
(f32, as tests/test_torch_decode.py), cache lengths and generated tokens
exactly.
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
from repro_torch.serving import ServeEngine              # noqa: E402
from test_torch_dense import DENSE, TOL, _np, _t, build  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    return build(request.param)


def test_forward_kernel_matches_pallas(models):
    jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(1).integers(
        0, tmodel.cfg.vocab, (2, 24)).astype(np.int32)
    jh, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                           attn_impl="pallas")
    h = tmodel.forward(tparams, {"tokens": _t(toks)}, attn_impl="kernel")
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    np.testing.assert_allclose(_np(tmodel.head(tparams, h[:, -1:])),
                               _np(jmodel.head(jparams, jh[:, -1:])), **TOL)


def test_prefill_and_decode_match_reference(models):
    """A 6-token prefill, 3 decode steps, then a chunked step of 3 tokens
    with ``n_valid``: every logit row, the caches and their lengths."""
    jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(2).integers(
        0, tmodel.cfg.vocab, (2, 12)).astype(np.int32)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t))
    jlast, jcache = jax.jit(lambda p, c, t: jmodel.prefill(p, c, t))(
        jparams, jmodel.init_cache(2, 16), jnp.asarray(toks[:, :6]))
    last, cache = tmodel.prefill(tparams, tmodel.init_cache(2, 16,
                                                            device="cpu"),
                                 _t(toks[:, :6]))
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)
    for i in range(6, 9):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]))
        assert tuple(lg.shape) == (2, tmodel.cfg.vocab)
        np.testing.assert_allclose(_np(lg), _np(jlg), **TOL,
                                   err_msg=f"step {i}")
    n_valid = np.array([3, 1], np.int32)
    jlg, jcache = jmodel.decode_step(jparams, jcache, jnp.asarray(toks[:, 9:]),
                                     n_valid=jnp.asarray(n_valid))
    lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, 9:]),
                                   n_valid=_t(n_valid))
    assert tuple(lg.shape) == (2, 3, tmodel.cfg.vocab)
    np.testing.assert_allclose(_np(lg), _np(jlg), **TOL)
    assert cache["length"].tolist() == np.asarray(jcache["length"]).tolist() \
        == [12, 10]
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **TOL)


def test_serve_engine_tokens_equal_reference(models):
    jmodel, jparams, tmodel, tparams = models
    prompts = np.random.default_rng(3).integers(
        3, tmodel.cfg.vocab, (3, 5)).astype(np.int32)
    want = JServeEngine(jmodel, jparams, cache_len=16, eos_id=-1
                        ).generate(prompts, max_new=8)
    got = ServeEngine(tmodel, tparams, cache_len=16, eos_id=-1
                      ).generate(prompts, max_new=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def seamless():
    arch = "seamless-m4t-large-v2"
    jmodel = jbuild_model(jget_config(arch).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jmodel, jparams, build_model(get_config(arch).reduced()), tparams


def test_seamless_decode_with_enc_matches_reference(seamless):
    """A 5-token prefill and 3 decode steps cross-attending 16 frames
    through the kernel impl (the Pallas kernel on the reference side)."""
    jmodel, jparams, tmodel, tparams = seamless
    rng = np.random.default_rng(9)
    toks = rng.integers(0, tmodel.cfg.vocab, (2, 8)).astype(np.int32)
    enc = rng.standard_normal((2, tmodel.cfg.frontend.n_embeds,
                               tmodel.cfg.d_model)).astype(np.float32)
    jenc, tenc = jnp.asarray(enc), _t(enc)
    jlast, jcache = jax.jit(lambda p, c, t, e: jmodel.prefill(
        p, c, t, enc=e, attn_impl="pallas"))(
        jparams, jmodel.init_cache(2, 10), jnp.asarray(toks[:, :5]), jenc)
    last, cache = tmodel.prefill(tparams, tmodel.init_cache(2, 10,
                                                            device="cpu"),
                                 _t(toks[:, :5]), enc=tenc,
                                 attn_impl="kernel")
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)
    jstep = jax.jit(lambda p, c, t, e: jmodel.decode_step(
        p, c, t, enc=e, attn_impl="pallas"))
    for i in range(5, 8):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                            jenc)
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]),
                                       enc=tenc, attn_impl="kernel")
        np.testing.assert_allclose(_np(lg), _np(jlg), **TOL,
                                   err_msg=f"step {i}")
    assert cache["length"].tolist() == [8, 8]


def test_seamless_serve_engine_tokens_equal_reference(seamless):
    jmodel, jparams, tmodel, tparams = seamless
    prompts = np.random.default_rng(10).integers(
        3, tmodel.cfg.vocab, (2, 5)).astype(np.int32)
    want = JServeEngine(jmodel, jparams, cache_len=16, eos_id=-1
                        ).generate(prompts, max_new=8)
    got = ServeEngine(tmodel, tparams, cache_len=16, eos_id=-1
                      ).generate(prompts, max_new=8)
    np.testing.assert_array_equal(got, want)
