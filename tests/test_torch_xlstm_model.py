"""The port's ssm family (xlstm-125m) against the JAX package's, on the
reduced config in f32 (2 layers: block 0 mLSTM, block 1 sLSTM; tied
512-row embedding): parameter layout and cache, the forward, loss and
gradients (each layer's unused block gets zeros, as under the
reference's ``lax.cond``), prefill and decode, decode against the
forward as tests/test_decode.py holds the reference, a chunked (s > 1)
decode step against single steps and ``ServeEngine`` (the launcher in
tests/test_torch_xlstm_train.py).

The reference's parameters cross through ``repro_torch.bridge``
(bitwise).  Tolerances as in tests/test_torch_moe_model.py: loss rtol
1e-5; gradients atol 1e-5, rtol 1e-4; logits and states within ``TOL``
(1e-5); decode against the forward 2e-4 (the reference's); generated
tokens exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.serving import ServeEngine as JServeEngine          # noqa: E402
from repro.training.gradients import (                          # noqa: E402
    grad_contributions as jgrad_contributions)
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.models import model as M                       # noqa: E402
from repro_torch.serving import ServeEngine                     # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402
from test_torch_dense import TOL, _compare_grads, _np, _t       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm-125m"
SELF_TOL = dict(rtol=2e-4, atol=2e-4)          # tests/test_decode.py


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(jget_config(ARCH).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jmodel, jparams, build_model(get_config(ARCH).reduced()), tparams


def _tokens(vocab, b, s, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_init_and_cache_layout_match_reference(models):
    jmodel, jparams, tmodel, tparams = models
    for device in ("cpu", "meta"):
        a, ta = tree_flatten(tmodel.init(seed=0, device=device))
        b, tb = tree_flatten(tparams)
        assert ta == tb
        assert [(x.shape, x.dtype) for x in a] == \
            [(y.shape, y.dtype) for y in b]
    assert sorted(tparams) == ["embedding", "final_norm", "mlstm", "slstm"]
    assert tmodel.grad_blocks(tparams) == ("slstm", "mlstm", "final_norm",
                                           "embedding")
    jc = jmodel.init_cache(3, 7)
    tc = tmodel.init_cache(3, 7, device="cpu")
    jl, tl = jax.tree_util.tree_leaves(jc), tree_flatten(tc)[0]
    assert sorted(tc) == sorted(jc) == ["length", "mlstm", "slstm"]
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    for t, j in zip(tl, jl):
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32))
    assert M._cache_len(tc) == 1


def test_forward_matches_reference(models):
    jmodel, jparams, tmodel, tparams = models
    toks = _tokens(tmodel.cfg.vocab, 2, 20, 1)
    jh, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    for impl in ("kernel", "chunked"):       # no attention: either impl
        h, aux = tmodel.forward_aux(tparams, {"tokens": _t(toks)},
                                    attn_impl=impl)
        np.testing.assert_allclose(_np(h), _np(jh), **TOL)
        assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("sparse_embedding", [False, True])
def test_loss_and_grads_match_jax(models, sparse_embedding):
    """Loss and every gradient leaf; layer 0's sLSTM and layer 1's mLSTM
    are unused, so their slices are zeros on both sides."""
    jmodel, jparams, tmodel, tparams = models
    batch = jmake_pipeline(jmodel.cfg, 2, 16, seed=5).batch_at(0)
    jg, jloss, jm = jgrad_contributions(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    tg, tloss, tm = grad_contributions(
        tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["tokens"]), float(jm["tokens"]))
    _compare_grads(tg, jg)
    for stack, unused in (("mlstm", 1), ("slstm", 0)):
        for leaf, j in zip(tree_flatten(tg[stack])[0],
                           jax.tree_util.tree_leaves(jg[stack])):
            assert not bool(leaf[unused].any()), stack
            assert not np.asarray(j)[unused].any(), stack
            assert bool(leaf[1 - unused].any()), stack


def test_prefill_and_decode_match_reference(models):
    """A 4-token sequential prefill and 4 decode steps: logits, the
    recurrent states and lengths."""
    jmodel, jparams, tmodel, tparams = models
    toks = _tokens(tmodel.cfg.vocab, 3, 8, 2)
    jlast, jcache = jax.jit(lambda p, c, t: jmodel.prefill(p, c, t))(
        jparams, jmodel.init_cache(3, 10), jnp.asarray(toks[:, :4]))
    last, cache = tmodel.prefill(tparams, tmodel.init_cache(
        3, 10, device="cpu"), _t(toks[:, :4]))
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)
    jstep = jax.jit(jmodel.decode_step)
    for i in range(4, 8):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]))
        np.testing.assert_allclose(_np(lg), _np(jlg), **TOL,
                                   err_msg=f"step {i}")
    assert cache["length"].tolist() == [8, 8, 8]
    for t, j in zip(tree_flatten(cache)[0], jax.tree_util.tree_leaves(jcache)):
        np.testing.assert_allclose(_np(t), _np(j), **TOL)


def test_decode_matches_forward_and_chunked_step(models):
    """tests/test_decode.py::test_decode_matches_forward for the reduced
    xlstm in the port, and the same 8 tokens as one s = 8 decode step
    (all 8 logit rows)."""
    _, _, tmodel, tparams = models
    toks = _tokens(tmodel.cfg.vocab, 1, 8, 3)
    with torch.no_grad():
        want = tmodel.head(tparams, tmodel.forward(tparams,
                                                   {"tokens": _t(toks)}))
    cache = tmodel.init_cache(1, 12, device="cpu")
    for i in range(8):
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]))
    np.testing.assert_allclose(_np(lg), _np(want[:, -1]), **SELF_TOL)
    chunk, ccache = tmodel.decode_step(
        tparams, tmodel.init_cache(1, 12, device="cpu"), _t(toks))
    assert tuple(chunk.shape) == (1, 8, tmodel.cfg.vocab)
    np.testing.assert_allclose(_np(chunk), _np(want), **SELF_TOL)
    assert int(ccache["length"][0]) == 8


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
