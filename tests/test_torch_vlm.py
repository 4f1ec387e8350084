"""The port's vlm family against the JAX package's, on the reduced
internvl2-1b in f32: a prefix of patch embeddings (``batch["frontend"]``)
runs ahead of the tokens without cross-attention and is dropped after
the final norm.

The reference's parameters cross through ``repro_torch.bridge``
(bitwise), with the same non-zero q/k/v biases on both sides
(tests/test_torch_dense.py's ``with_biases``).  Tolerances: hidden
states and logits within 1e-5 (f32, tests/test_torch_decode.py); loss
rtol 1e-5; gradients atol 1e-5, rtol 1e-4 (tests/test_torch_model.py);
prefill through the patch prefix against the model's own forward at the
reference's 2e-4 (tests/test_decode.py); attention against the Pallas
kernel in interpret mode at 3e-5 (tests/test_kernels.py); the engine's
greedy tokens exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.kernels import ops as jops                          # noqa: E402
from repro.serving import ServeEngine as JServeEngine          # noqa: E402
from repro.training.gradients import (                          # noqa: E402
    grad_contributions as jgrad_contributions)
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.data import make_pipeline                      # noqa: E402
from repro_torch.kernels import ops                             # noqa: E402
from repro_torch.serving import ServeEngine                     # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from test_torch_dense import (TOL, _compare_grads, _np, _t,     # noqa: E402
                              build, config_fields)

jax.config.update("jax_platform_name", "cpu")

ARCH = "internvl2-1b"
SELF_TOL = dict(rtol=2e-4, atol=2e-4)          # tests/test_decode.py


@pytest.fixture(scope="module")
def models():
    return build(ARCH)


def _batch(cfg, b=2, s=12, seed=1):
    return jmake_pipeline(cfg, b, s, seed=seed).batch_at(0)


def test_config_matches_reference():
    config_fields(get_config(ARCH), jget_config(ARCH))
    config_fields(get_config(ARCH).reduced(), jget_config(ARCH).reduced())
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.frontend.kind, cfg.frontend.n_embeds,
            cfg.frontend.cross_attention) == ("vlm", "vision", 256, False)
    red = cfg.reduced()
    assert (red.n_heads, red.n_kv_heads, red.frontend.n_embeds) == (4, 2, 16)


def test_pipeline_emits_the_prefix():
    cfg = get_config(ARCH).reduced()
    tb = make_pipeline(cfg, 2, 12, seed=1).batch_at(0)
    jb = _batch(jget_config(ARCH).reduced())
    assert sorted(tb) == sorted(jb) == ["frontend", "labels", "tokens"]
    assert tb["frontend"].shape == (2, 16, cfg.d_model)
    for k in tb:
        np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("impl,jimpl", [("kernel", "pallas"),
                                        ("chunked", "xla_chunked")])
def test_forward_drops_the_prefix(models, impl, jimpl):
    jmodel, jparams, tmodel, tparams = models
    batch = _batch(jmodel.cfg)
    jh, _ = jmodel.forward(jparams, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                           attn_impl=jimpl)
    h = tmodel.forward(tparams, {k: _t(v) for k, v in batch.items()},
                       attn_impl=impl)
    assert tuple(h.shape) == (2, 12, tmodel.cfg.d_model)
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    # the prefix changes what the tokens see
    plain = tmodel.forward(tparams, {"tokens": _t(batch["tokens"]),
                                     "frontend": torch.zeros(
                                         2, 16, tmodel.cfg.d_model)})
    assert float((plain - h).abs().max()) > 1e-3


@pytest.mark.parametrize("sparse_embedding", [False, True])
def test_loss_and_grads_match_jax(models, sparse_embedding):
    jmodel, jparams, tmodel, tparams = models
    batch = _batch(jmodel.cfg, s=16, seed=5)
    jg, jloss, jm = jgrad_contributions(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    tg, tloss, tm = grad_contributions(
        tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["tokens"]), float(jm["tokens"]))
    assert float(tm["tokens"]) == 2 * 16          # text positions only
    _compare_grads(tg, jg)


def test_prefill_with_patch_prefix(models):
    """tests/test_decode.py::test_vlm_prefill_with_patch_prefix: the
    prefill over [patches ; tokens] ends on the forward's last logits; and
    equals the reference's prefill, logits and cache."""
    jmodel, jparams, tmodel, tparams = models
    batch = _batch(jmodel.cfg, b=1, s=8, seed=3)
    toks, fe = batch["tokens"], batch["frontend"]
    h = tmodel.forward(tparams, {k: _t(v) for k, v in batch.items()})
    want = tmodel.head(tparams, h)[:, -1]
    n = fe.shape[1] + toks.shape[1]
    cache = tmodel.init_cache(1, n + 2, device="cpu")
    got, cache = tmodel.prefill(tparams, cache, _t(toks), embeds=_t(fe))
    np.testing.assert_allclose(_np(got), _np(want), **SELF_TOL)
    assert int(cache["length"][0]) == n
    jgot, jcache = jax.jit(lambda p, c, t, e: jmodel.prefill(
        p, c, t, embeds=e))(jparams, jmodel.init_cache(1, n + 2),
                            jnp.asarray(toks), jnp.asarray(fe))
    np.testing.assert_allclose(_np(got), _np(jgot), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **TOL)


def test_chunked_decode_with_input_embeds(models):
    """``decode_step(None, input_embeds=)`` with s > 1 and ``n_valid``:
    every logit row and the cache equal the reference's; then a token
    step follows on the same cache."""
    jmodel, jparams, tmodel, tparams = models
    rng = np.random.default_rng(4)
    emb = rng.standard_normal((2, 5, tmodel.cfg.d_model)).astype(np.float32)
    tok = rng.integers(0, tmodel.cfg.vocab, (2, 1)).astype(np.int32)
    n_valid = np.array([5, 3], np.int32)
    jlg, jc = jmodel.decode_step(jparams, jmodel.init_cache(2, 8), None,
                                 input_embeds=jnp.asarray(emb),
                                 n_valid=jnp.asarray(n_valid))
    lg, c = tmodel.decode_step(tparams, tmodel.init_cache(2, 8, device="cpu"),
                               None, input_embeds=_t(emb),
                               n_valid=_t(n_valid))
    assert tuple(lg.shape) == (2, 5, tmodel.cfg.vocab)
    np.testing.assert_allclose(_np(lg), _np(jlg), **TOL)
    assert c["length"].tolist() == np.asarray(jc["length"]).tolist() \
        == [5, 3]
    jlg, jc = jmodel.decode_step(jparams, jc, jnp.asarray(tok))
    lg, c = tmodel.decode_step(tparams, c, _t(tok))
    np.testing.assert_allclose(_np(lg), _np(jlg), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(c[name]), _np(jc[name]), **TOL)


def test_flash_attention_gqa7_matches_pallas():
    """internvl2-1b's attention groups (14 query heads on 2 kv heads) at
    its head dim 64: ``ops.flash_attention(impl="kernel")`` against the
    Pallas kernel in interpret mode, causal, ragged lengths."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((1, 40, 14, 64)).astype(np.float32)
    k = rng.standard_normal((1, 40, 2, 64)).astype(np.float32)
    v = rng.standard_normal((1, 40, 2, 64)).astype(np.float32)
    out = ops.flash_attention(_t(q), _t(k), _t(v), causal=True,
                              impl="kernel")
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, impl="pallas",
                                block_q=8, block_k=8)
    assert tuple(out.shape) == (1, 40, 14, 64)
    np.testing.assert_allclose(_np(out), _np(want), rtol=3e-5, atol=3e-5)


def test_serve_engine_tokens_equal_reference(models):
    """Text prompts (the engine passes no patches, as the reference's):
    greedy tokens equal the reference engine's exactly."""
    jmodel, jparams, tmodel, tparams = models
    prompts = np.random.default_rng(6).integers(
        3, tmodel.cfg.vocab, (3, 5)).astype(np.int32)
    want = JServeEngine(jmodel, jparams, cache_len=16, eos_id=-1
                        ).generate(prompts, max_new=8)
    got = ServeEngine(tmodel, tparams, cache_len=16, eos_id=-1
                      ).generate(prompts, max_new=8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)
