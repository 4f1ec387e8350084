"""The port's MoE FFN against the JAX package's, on the reduced
llama4-scout-17b-a16e in f32 (4 experts of 64, top-1, one shared
expert): config fields, the grouped capacity dispatch (a dropped slot,
a zero-padded group, top-2, ``capacity_override``), the dropless path
and the gradients.

Parameters come from the reference's ``init_moe`` and cross through
``repro_torch.bridge`` (bitwise); inputs from a numpy seed.  Tolerances
as in tests/test_torch_dense.py: outputs and aux rtol/atol 1e-5;
gradients atol 1e-5, rtol 1e-4.
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
from test_torch_dense import GRAD_TOL, TOL, _np, _t, config_fields  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SCOUT = "llama4-scout-17b-a16e"


@pytest.fixture(scope="module")
def ffn():
    """(reference cfg, reference params, port cfg, port params)."""
    jcfg = jget_config(SCOUT).reduced()
    jp = JL.init_moe(jax.random.PRNGKey(3), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, jp, get_config(SCOUT).reduced(), tp


def _x(shape, seed, d, skew=None):
    x = np.random.default_rng(seed).standard_normal(shape + (d,))
    if skew is not None:            # lean the tokens towards one expert
        x = x + skew
    return x.astype(np.float32)


def _both(ffn, x, top_k=None, **kw):
    jcfg, jp, tcfg, tp = ffn
    if top_k is not None:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, top_k=top_k))
        tcfg = tcfg.with_(moe=dataclasses.replace(tcfg.moe, top_k=top_k))
    jy, jaux = JL.moe_ffn(jp, jcfg, jnp.asarray(x), **kw)
    ty, taux = L.moe_ffn(tp, tcfg, _t(x), **kw)
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    return ty, taux


def _expert_counts(ffn, x, group):
    """Tokens routed to each expert (top-1) in each group of ``group``."""
    jcfg, jp, _, _ = ffn
    xt = x.reshape(-1, x.shape[-1])
    ids = np.argmax(xt @ np.asarray(jp["router"]), axis=-1)
    return [np.bincount(ids[i:i + group], minlength=jcfg.moe.n_experts)
            for i in range(0, len(ids), group)]


def test_config_matches_reference():
    config_fields(get_config(SCOUT), jget_config(SCOUT))
    config_fields(get_config(SCOUT).reduced(), jget_config(SCOUT).reduced())
    cfg, small = get_config(SCOUT), get_config(SCOUT).reduced()
    assert (cfg.family, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.vocab, cfg.tied_embeddings, cfg.sliding_window) == (
        "moe", 5120, 40, 8, 202048, False, 8192)
    assert dataclasses.astuple(cfg.moe) == (16, 1, 8192, 1, 1.25, 0.01)
    assert (small.moe.n_experts, small.moe.top_k, small.moe.d_ff_expert,
            small.moe.n_shared) == (4, 1, 64, 1)


def test_init_layout_matches_reference(ffn):
    _, jp, tcfg, tp = ffn
    mine = L.init_moe(torch.Generator().manual_seed(0), tcfg, "cpu")
    assert sorted(mine) == sorted(jp) == sorted(tp)
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(mine[name].shape) == jp[name].shape
        assert mine[name].dtype == torch.float32
        np.testing.assert_allclose(float(mine[name].std()),
                                   float(jnp.std(jp[name])), rtol=0.1)
    assert sorted(mine["shared"]) == ["w_down", "w_gate", "w_up"]


def test_capacity_drops_a_slot(ffn):
    """One group of 256 tokens leaning towards expert 0: it gets more than
    its capacity of int(256 / 4 * 1.25) = 80 and drops the rest."""
    jcfg, jp, _, _ = ffn
    skew = 0.5 * np.asarray(jp["router"])[:, 0] * jcfg.d_model ** 0.5
    x = _x((2, 128), 1, jcfg.d_model, skew=skew)
    (counts,) = _expert_counts(ffn, x, 256)
    assert counts.max() > 80, counts
    y, _ = _both(ffn, x)
    dense, _ = _both(ffn, x, dropless=True)
    # the dropped tokens differ from the dropless output; the kept agree
    rows = (y - dense).reshape(-1, jcfg.d_model).abs().amax(dim=1)
    assert int((rows > 1e-4).sum()) == counts.max() - 80


@pytest.mark.parametrize("top_k", [1, 2])
def test_padded_group(ffn, top_k):
    """600 tokens: a group of 512 and one of 88 zero-padded by 424 rows,
    whose equal logits route them to the lowest expert ids, as
    ``jax.lax.top_k`` breaks ties; they enter the aux loss."""
    x = _x((3, 200), 2, ffn[0].d_model)
    _both(ffn, x, top_k=top_k)


def test_top2(ffn):
    x = _x((2, 40), 3, ffn[0].d_model)
    _both(ffn, x, top_k=2)
    _both(ffn, x, top_k=2, dropless=True)


@pytest.mark.parametrize("cap", [1, 3, 8])
def test_capacity_override(ffn, cap):
    """The decode path's capacity mode: one group of the step's tokens,
    ``cap`` slots an expert."""
    x = _x((8, 1), 4, ffn[0].d_model)
    _both(ffn, x, group_size=8, capacity_override=cap)


def test_dropless(ffn):
    x = _x((4, 3), 5, ffn[0].d_model)
    _both(ffn, x, dropless=True)


@pytest.mark.parametrize("dropless", [False, True])
def test_gradients(ffn, dropless):
    """d/dx and d/dparams of <y, w> + 3 aux: the router's gradient comes
    mostly from the aux term (a top-1 gate is g/g = 1)."""
    jcfg, jp, tcfg, tp = ffn
    skew = 0.3 * np.asarray(jp["router"])[:, 1] * jcfg.d_model ** 0.5
    x = _x((2, 96), 6, jcfg.d_model, skew=skew)
    w = np.random.default_rng(7).standard_normal(x.shape).astype(np.float32)

    def jf(p, xx):
        y, aux = JL.moe_ffn(p, jcfg, xx, dropless=dropless, group_size=64)
        return jnp.sum(y * w) + 3.0 * aux
    jgp, jgx = jax.grad(jf, argnums=(0, 1))(jp, jnp.asarray(x))

    leaves = {k: (v.clone().requires_grad_(True) if torch.is_tensor(v)
                  else {kk: vv.clone().requires_grad_(True)
                        for kk, vv in v.items()}) for k, v in tp.items()}
    tx = _t(x).requires_grad_(True)
    y, aux = L.moe_ffn(leaves, tcfg, tx, dropless=dropless, group_size=64)
    (torch.sum(y * _t(w)) + 3.0 * aux).backward()
    np.testing.assert_allclose(_np(tx.grad), np.asarray(jgx), **GRAD_TOL)
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(_np(leaves[name].grad),
                                   np.asarray(jgp[name]), **GRAD_TOL,
                                   err_msg=name)
    for name in ("w_gate", "w_up", "w_down"):
        np.testing.assert_allclose(_np(leaves["shared"][name].grad),
                                   np.asarray(jgp["shared"][name]),
                                   **GRAD_TOL, err_msg=name)
    assert float(leaves["router"].grad.abs().max()) > 0.0
