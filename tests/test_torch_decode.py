"""The port's forward and serving path against the JAX package's, on the
reduced transformer-big in f32.

The reference's parameters cross through ``repro_torch.bridge``
(bitwise); tokens and encoder states are numpy arrays from a seed, given
to both.  The reference runs its flash attention as the Pallas kernel in
interpret mode (``attn_impl="pallas"``), the port its ``"kernel"`` impl
(the kernel's plain version on the CPU).  Values within 1e-5 (f32; XLA
and torch sum in other orders); cache lengths and generated tokens
exactly.  The port's decode against its own forward uses the reference's
2e-4 (tests/test_decode.py).
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config      # noqa: E402
from repro.models import build_model as jbuild_model     # noqa: E402
from repro.models import layers as JL                    # noqa: E402
from repro.serving import ServeEngine as JServeEngine    # noqa: E402
from repro_torch import bridge                           # noqa: E402
from repro_torch.configs import get_config               # noqa: E402
from repro_torch.models import build_model               # noqa: E402
from repro_torch.models import layers as L               # noqa: E402
from repro_torch.serving import ServeEngine              # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
SELF_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(jget_config("transformer-big").reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    tmodel = build_model(get_config("transformer-big").reduced())
    return jmodel, jparams, tmodel, tparams


def _inputs(cfg, b=2, s=8, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    enc = rng.standard_normal((b, cfg.frontend.n_embeds, cfg.d_model)
                              ).astype(np.float32)
    return toks, enc


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_forward_kernel_matches_pallas(models):
    jmodel, jparams, tmodel, tparams = models
    toks, enc = _inputs(tmodel.cfg)
    jh, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks),
                                     "frontend": jnp.asarray(enc)},
                           attn_impl="pallas")
    h = tmodel.forward(tparams, {"tokens": _t(toks), "frontend": _t(enc)},
                       attn_impl="kernel")
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)
    np.testing.assert_allclose(_np(tmodel.head(tparams, h[:, -1:])),
                               _np(jmodel.head(jparams, jh[:, -1:])), **TOL)


def test_prefill_and_decode_with_enc_match_pallas(models):
    """Prefill a 6-token prefix, then 3 teacher-forced decode steps, all
    cross-attending the encoder states through the kernel impl."""
    jmodel, jparams, tmodel, tparams = models
    toks, enc = _inputs(tmodel.cfg, s=9, seed=2)
    jstep = jax.jit(lambda p, c, t, e: jmodel.decode_step(
        p, c, t, enc=e, attn_impl="pallas"))
    jcache = jmodel.init_cache(2, 12)
    cache = tmodel.init_cache(2, 12, device="cpu")
    jenc, tenc = jnp.asarray(enc), _t(enc)
    jlast, jpre = jax.jit(lambda p, c, t, e: jmodel.prefill(
        p, c, t, enc=e, attn_impl="pallas"))(jparams, jcache,
                                             jnp.asarray(toks[:, :6]), jenc)
    last, pre = tmodel.prefill(tparams, cache, _t(toks[:, :6]), enc=tenc,
                               attn_impl="kernel")
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)
    jcache, cache = jpre, pre
    for i in range(6, 9):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                            jenc)
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]),
                                       enc=tenc, attn_impl="kernel")
        assert tuple(lg.shape) == (2, tmodel.cfg.vocab)
        np.testing.assert_allclose(_np(lg), _np(jlg), **TOL,
                                   err_msg=f"step {i}")
    assert cache["length"].tolist() == np.asarray(jcache["length"]).tolist() \
        == [9, 9]
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **TOL)


def test_decode_matches_own_forward(models):
    _, _, tmodel, tparams = models
    toks, enc = _inputs(tmodel.cfg, b=1, seed=3)
    h = tmodel.forward(tparams, {"tokens": _t(toks), "frontend": _t(enc)})
    want = tmodel.head(tparams, h)[:, -1]
    cache = tmodel.init_cache(1, toks.shape[1] + 4, device="cpu")
    for i in range(toks.shape[1]):
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]),
                                       enc=_t(enc), attn_impl="kernel")
    np.testing.assert_allclose(_np(lg), _np(want), **SELF_TOL)
    assert int(cache["length"][0]) == toks.shape[1]


def test_chunked_prefill_with_n_valid(models):
    """tokens (B, s > 1) through one decode_step: all s logit rows match
    the reference's and the port's own sequential steps, and the length
    advances by n_valid."""
    jmodel, jparams, tmodel, tparams = models
    toks, enc = _inputs(tmodel.cfg, s=5, seed=4)
    n_valid = np.array([5, 2], np.int32)
    jlg, jc = jmodel.decode_step(jparams, jmodel.init_cache(2, 8),
                                 jnp.asarray(toks), enc=jnp.asarray(enc),
                                 n_valid=jnp.asarray(n_valid))
    lg, c = tmodel.decode_step(tparams, tmodel.init_cache(2, 8,
                                                          device="cpu"),
                               _t(toks), enc=_t(enc), n_valid=_t(n_valid))
    assert tuple(lg.shape) == (2, 5, tmodel.cfg.vocab)
    np.testing.assert_allclose(_np(lg), _np(jlg), **TOL)
    assert c["length"].tolist() == np.asarray(jc["length"]).tolist() \
        == [5, 2]
    seq = tmodel.init_cache(2, 8, device="cpu")
    for i in range(5):
        lg_i, seq = tmodel.decode_step(tparams, seq, _t(toks[:, i:i + 1]),
                                       enc=_t(enc))
        np.testing.assert_allclose(_np(lg[:, i]), _np(lg_i), **SELF_TOL)


def test_ring_buffer_window_cache(models):
    """A ring cache of ``window`` slots: each step's logits equal the
    reference's ring decode and the port's full cache under the same
    window (the long-context memory layout; no encoder states, as the
    reference's engine passes none)."""
    jmodel, jparams, tmodel, tparams = models
    toks, _ = _inputs(tmodel.cfg, b=1, s=10, seed=5)
    window = 4
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(
        p, c, t, window=window, ring=True))
    jring = jmodel.init_cache(1, window)
    ring = tmodel.init_cache(1, window, device="cpu")
    full = tmodel.init_cache(1, toks.shape[1] + 1, device="cpu")
    for i in range(toks.shape[1]):
        t = toks[:, i:i + 1]
        jlg, jring = jstep(jparams, jring, jnp.asarray(t))
        lr, ring = tmodel.decode_step(tparams, ring, _t(t), window=window,
                                      ring=True)
        lf, full = tmodel.decode_step(tparams, full, _t(t), window=window)
        np.testing.assert_allclose(_np(lr), _np(jlg), **TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(_np(lr), _np(lf), **SELF_TOL,
                                   err_msg=f"step {i}")
    np.testing.assert_allclose(_np(ring["k"]), _np(jring["k"]), **TOL)


def test_decode_attention_masks_unwritten_slots():
    q = torch.ones(1, 1, 2, 4)
    k_cache = torch.full((1, 8, 2, 4), 100.0)   # garbage in unwritten slots
    v_cache = torch.full((1, 8, 2, 4), 100.0)
    k_cache[:, :2] = 1.0
    v_cache[:, :2] = 1.0
    out = L.decode_attention(q, k_cache, v_cache,
                             length=torch.tensor([2], dtype=torch.int32))
    np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-5)
    want = JL.decode_attention(jnp.ones((1, 1, 2, 4)),
                               jnp.asarray(k_cache.numpy()),
                               jnp.asarray(v_cache.numpy()),
                               length=jnp.int32(2))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), **TOL)


def test_batched_update_clamps_at_the_end_of_the_cache():
    """A write that would run past the last slot lands on the last s
    slots, as ``dynamic_update_slice_in_dim`` clamps its start."""
    rng = np.random.default_rng(6)
    cache = rng.standard_normal((3, 6, 1, 2)).astype(np.float32)
    new = rng.standard_normal((3, 3, 1, 2)).astype(np.float32)
    pos = np.array([1, 5, 3], np.int32)           # 5 + 3 > 6: clamped to 3
    out = L._batched_update(_t(cache), _t(new), _t(pos))
    want = JL._batched_update(jnp.asarray(cache), jnp.asarray(new),
                              jnp.asarray(pos))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    np.testing.assert_array_equal(out.numpy()[1, 3:], new[1])
    np.testing.assert_array_equal(out.numpy()[1, :3], cache[1, :3])
    assert not np.array_equal(out.numpy(), cache)   # written to a copy


def test_serve_engine_tokens_equal_reference(models):
    """Greedy tokens equal the reference engine's exactly, and after
    EOS every position of a row is ``eos_id`` in both."""
    jmodel, jparams, tmodel, tparams = models
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
    assert (got[0, 2:] == eos).all()
    for row in got:
        hits = np.flatnonzero(row == eos)
        if hits.size:
            assert (row[hits[0]:] == eos).all(), row
