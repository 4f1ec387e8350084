"""The port's xLSTM blocks against the JAX package's, on the reduced
xlstm-125m in f32 (d 128, 4 heads; mLSTM inner 256, head 64; sLSTM
heads of 32, FFN 170): ``init_mlstm``/``init_slstm`` layouts and their
fixed leaves, the state inits, ``mlstm_forward`` and ``slstm_forward``
from the initial state and from a carried one (a sequence split in two
equals it whole), outputs, final states and the gradients of both
blocks.

Parameters come from the reference's ``init_*`` and cross through
``repro_torch.bridge`` (bitwise); inputs and carried states from a numpy
seed.  Tolerances as in tests/test_torch_dense.py: ``TOL`` (1e-5) for
outputs and states, ``GRAD_TOL`` for gradients.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config      # noqa: E402
from repro.models import xlstm as JX                     # noqa: E402
from repro_torch import bridge                           # noqa: E402
from repro_torch.configs import get_config               # noqa: E402
from repro_torch.models import xlstm as X                # noqa: E402
from test_torch_dense import (GRAD_TOL, TOL, _np, _t,    # noqa: E402
                              config_fields)

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm-125m"
BLOCKS = {"mlstm": (JX.init_mlstm, JX.mlstm_forward, JX.mlstm_init_state,
                    X.init_mlstm, X.mlstm_forward, X.mlstm_init_state),
          "slstm": (JX.init_slstm, JX.slstm_forward, JX.slstm_init_state,
                    X.init_slstm, X.slstm_forward, X.slstm_init_state)}


@pytest.fixture(scope="module", params=sorted(BLOCKS))
def block(request):
    """(name, reference cfg, reference params, port cfg, port params)."""
    jcfg, cfg = jget_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = BLOCKS[request.param][0](jax.random.PRNGKey(2), jcfg)
    tp = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return request.param, jcfg, jp, cfg, tp


def _u(b, s, d, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _compare_state(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **TOL,
                                   err_msg=k)


def test_config_matches_reference():
    config_fields(get_config(ARCH), jget_config(ARCH))
    config_fields(get_config(ARCH).reduced(), jget_config(ARCH).reduced())
    cfg = get_config(ARCH)
    assert cfg.family == "ssm" and cfg.tied_embeddings and cfg.d_ff == 0


def test_init_layout_and_fixed_leaves(block):
    name, jcfg, jp, cfg, tp = block
    init = BLOCKS[name][3]
    for device in ("cpu", "meta"):
        mine = init(torch.Generator(device=device).manual_seed(0)
                    if device == "cpu" else None, cfg, device)
        assert sorted(mine) == sorted(tp)
        for k, v in tp.items():
            a, b = (mine[k]["scale"], v["scale"]) if isinstance(v, dict) \
                else (mine[k], v)
            assert a.shape == b.shape and a.dtype == b.dtype, k
            assert a.device.type == device
    mine = init(torch.Generator().manual_seed(0), cfg, "cpu")
    if name == "mlstm":
        assert torch.equal(mine["bf"], tp["bf"]) and float(tp["bf"][0]) == 3
        assert torch.equal(mine["bi"], tp["bi"])
        assert mine["wi"].dtype == mine["wf"].dtype == torch.float32
    else:
        assert torch.equal(mine["b_zifo"], tp["b_zifo"])
        d = cfg.d_model
        assert float(tp["b_zifo"][2 * d:3 * d].min()) == 3.0
        assert mine["r_zifo"].dtype == torch.float32
        # N(0, 1/P) per head: the draws' spread, not the reference's
        # numbers, which come from another generator
        assert abs(float(mine["r_zifo"].std()) * (d // cfg.n_heads) ** 0.5
                   - 1.0) < 0.05


def test_init_state_matches_reference(block):
    name, jcfg, _, cfg, _ = block
    want = BLOCKS[name][2](jcfg, 3)
    got = BLOCKS[name][5](cfg, 3, "cpu")
    _compare_state(got, want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]))


@pytest.mark.parametrize("carried", [False, True])
def test_forward_matches_reference(block, carried):
    """From the initial state (``state=None``), or from a carried state:
    the first 5 of 11 steps' final state fed back for the other 6,
    against the reference and against the 11 steps whole."""
    name, jcfg, jp, cfg, tp = block
    jfwd, fwd = BLOCKS[name][1], BLOCKS[name][4]
    u = _u(2, 11, cfg.d_model, 3)
    jy, jst = jfwd(jp, jcfg, jnp.asarray(u))
    y, st = fwd(tp, cfg, _t(u))
    assert y.dtype == torch.float32 and tuple(y.shape) == u.shape
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    _compare_state(st, jst)
    if not carried:
        return
    _, jmid = jfwd(jp, jcfg, jnp.asarray(u[:, :5]))
    y1, mid = fwd(tp, cfg, _t(u[:, :5]))
    _compare_state(mid, jmid)
    jy2, jst2 = jfwd(jp, jcfg, jnp.asarray(u[:, 5:]), state=jmid)
    y2, st2 = fwd(tp, cfg, _t(u[:, 5:]), state=mid)
    np.testing.assert_allclose(_np(y2), _np(jy2), **TOL)
    _compare_state(st2, jst2)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y), **TOL)
    _compare_state(st2, st)


def test_gradients_match_reference(block):
    """d(mean(y * w))/d(params, u) through the whole recurrence (a mean,
    as the training loss is a token mean)."""
    name, jcfg, jp, cfg, tp = block
    jfwd, fwd = BLOCKS[name][1], BLOCKS[name][4]
    u = _u(2, 7, cfg.d_model, 4)
    w = _u(2, 7, cfg.d_model, 5)

    def jloss(p, x):
        return jnp.mean(jfwd(p, jcfg, x)[0] * jnp.asarray(w))
    jgp, jgu = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(u))
    leaves, treedef = jax.tree_util.tree_flatten(tp)
    leaves = [t.clone().requires_grad_(True) for t in leaves]
    x = _t(u).requires_grad_(True)
    out = fwd(jax.tree_util.tree_unflatten(treedef, leaves), cfg, x)[0]
    grads = torch.autograd.grad((out * _t(w)).mean(), leaves + [x])
    for g, jg in zip(grads[:-1], jax.tree_util.tree_leaves(jgp)):
        np.testing.assert_allclose(_np(g), _np(jg), **GRAD_TOL)
    np.testing.assert_allclose(_np(grads[-1]), _np(jgu), **GRAD_TOL)
