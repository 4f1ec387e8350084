"""The port's hybrid family (zamba2: Mamba2 blocks and one shared
attention block) against the JAX package's, on the reduced zamba2-7b in
f32.

The reference's parameters cross through ``repro_torch.bridge``
(bitwise); tokens are numpy arrays from a seed, given to both.  The
reference runs its attention as the Pallas kernel in interpret mode
(``attn_impl="pallas"``) and its SSD scan as ``ssd_chunked`` (its model
path); the port runs ``"chunked"`` (plain attention and ``ssd_chunked``)
and ``"kernel"`` (the flash attention and SSD kernels' plain versions
on the CPU).  Values within 1e-5 (f32; XLA and torch sum in other
orders); the whole forward's residual stream within ``HOST_TOL``, above
the reference's own host noise.  The reduced config
has 4 layers and ``attn_every`` 2, so no trailing Mamba2 block; the
5-layer variant has one, as full width has 3 (81 = 13 x 6 + 3).
The serving path is in tests/test_torch_hybrid_decode.py, the training
gradients in tests/test_torch_hybrid_train.py.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402
import torch.distributed as dist              # noqa: E402

from repro.configs import get_config as jget_config      # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,  # noqa: E402
                        ExchangeConfig as JExchangeConfig)
from repro.data import make_pipeline as jmake_pipeline   # noqa: E402
from repro.models import build_model as jbuild_model     # noqa: E402
from repro.models import ssm as JS                       # noqa: E402
from repro.optim import adamw as jadamw, noam_schedule as jnoam  # noqa: E402
from repro.training import (Trainer as JTrainer,          # noqa: E402
                            TrainerConfig as JTrainerConfig,
                            make_train_step as jmake_train_step)
from repro_torch import bridge                           # noqa: E402
from repro_torch.configs import get_config               # noqa: E402
from repro_torch.data import make_pipeline               # noqa: E402
from repro_torch.launch import train                     # noqa: E402
from repro_torch.models import build_model               # noqa: E402
from repro_torch.models import model as M                # noqa: E402
from repro_torch.models import ssm as S                  # noqa: E402
from repro_torch.training import (Trainer, TrainerConfig,  # noqa: E402
                                  make_train_step)
from repro_torch.tree import tree_flatten                # noqa: E402

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-5, atol=1e-5)
#: the residual stream of ``test_forward_matches_reference``.  The
#: reference's own output moves with the host's CPU: over the six
#: configurations of scripts/host_sweep_torch.py its largest spread is
#: 1.466e-5 (``models``, seq 64, between ``xla_avx2`` and ``both_sse``:
#: XLA's code for AVX2 against SSE4.2), and it needs rtol = atol 1.10e-5
#: to agree with itself (tests/_torch_host_noise.py).  So the bound is
#: twice that spread, within the reference's 2e-4 for the whole hybrid
#: model (tests/test_decode.py).
HOST_TOL = dict(rtol=3e-5, atol=3e-5)


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


def test_config_matches_reference():
    for arch in ("zamba2-7b",):
        for reduce in (False, True):
            j, t = jget_config(arch), get_config(arch)
            if reduce:
                j, t = j.reduced(), t.reduced()
            assert (t.name, t.family, t.n_layers, t.d_model, t.n_heads,
                    t.n_kv_heads, t.d_ff, t.vocab, t.resolved_head_dim,
                    t.attn_every, t.sliding_window, t.dtype,
                    t.tied_embeddings) == (
                j.name, j.family, j.n_layers, j.d_model, j.n_heads,
                j.n_kv_heads, j.d_ff, j.vocab, j.resolved_head_dim,
                j.attn_every, j.sliding_window, j.dtype, j.tied_embeddings)
            assert (t.ssm.state_dim, t.ssm.head_dim, t.ssm.expand,
                    t.ssm.conv_dim, t.ssm.chunk) == (
                j.ssm.state_dim, j.ssm.head_dim, j.ssm.expand,
                j.ssm.conv_dim, j.ssm.chunk)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_init_layout_matches_reference(models, device):
    """Same tree, shapes and dtypes as the reference's ``init``, the
    deterministic leaves (``a_log``, ``d_skip``, ``dt_bias``, norms,
    conv biases) equal; full width on meta: 6,750,840,528 parameters."""
    _, _, tmodel, tparams = models
    mine = tmodel.init(seed=0, device=device)
    a, ta = tree_flatten(mine)
    b, tb = tree_flatten(tparams)
    assert ta == tb
    for x, y in zip(a, b):
        assert x.shape == y.shape and x.dtype == y.dtype
        assert x.device.type == device
    if device == "cpu":
        for name in ("a_log", "d_skip", "dt_bias", "conv_bx", "conv_bbc"):
            np.testing.assert_allclose(_np(mine["mamba"][name]),
                                       _np(tparams["mamba"][name]),
                                       rtol=1e-6, atol=0)
        again = tmodel.init(seed=0, device="cpu")
        assert all(torch.equal(x, y) for x, y in
                   zip(a, tree_flatten(again)[0]))
    else:
        full = build_model(get_config("zamba2-7b")).init(device="meta")
        leaves = tree_flatten(full)[0]
        assert sum(t.numel() for t in leaves) == 6_750_840_528
        assert {t.dtype for t in leaves} == {torch.bfloat16, torch.float32}
        assert full["mamba"]["a_log"].dtype == torch.float32
        assert full["mamba"]["w_z"].shape == (81, 3584, 7168)


@pytest.mark.parametrize("route", ["chunked", "kernel"])
def test_mamba2_forward_per_block(models, route):
    jmodel, jparams, tmodel, tparams = models
    cfg = tmodel.cfg
    u = np.random.default_rng(2).standard_normal(
        (2, 45, cfg.d_model)).astype(np.float32)
    jfwd = jax.jit(lambda p, x: JS.mamba2_forward(p, jmodel.cfg, x))
    for i in range(cfg.n_layers):
        jp = jax.tree_util.tree_map(lambda a: a[i], jparams["mamba"])
        tp = {k: (v[i] if not isinstance(v, dict) else
                  {kk: vv[i] for kk, vv in v.items()})
              for k, v in tparams["mamba"].items()}
        want = jfwd(jp, jnp.asarray(u))
        got = S.mamba2_forward(tp, cfg, _t(u), ssd_route=route)
        np.testing.assert_allclose(_np(got), _np(want), **TOL,
                                   err_msg=f"block {i}")


_REF_FORWARD = {}


@pytest.mark.parametrize("impl", ["chunked", "kernel"])
@pytest.mark.parametrize("seq", [40, 64])        # 40: the chunk padding
@pytest.mark.parametrize("variant", ["models", "models5"])
def test_forward_matches_reference(request, variant, seq, impl):
    jmodel, jparams, tmodel, tparams = request.getfixturevalue(variant)
    toks = _tokens(tmodel.cfg, s=seq, seed=seq)
    key = (variant, seq)
    if key not in _REF_FORWARD:           # one reference run per input
        _REF_FORWARD[key] = jmodel.forward(
            jparams, {"tokens": jnp.asarray(toks)}, attn_impl="pallas")[0]
    jh = _REF_FORWARD[key]
    with torch.no_grad():
        h = tmodel.forward(tparams, {"tokens": _t(toks)}, attn_impl=impl)
    np.testing.assert_allclose(_np(h), _np(jh), **HOST_TOL)
    np.testing.assert_allclose(_np(tmodel.head(tparams, h[:, -1:])),
                               _np(jmodel.head(jparams, jh[:, -1:])), **TOL)


def test_forward_counts_kernel_launches_by_route(models5, monkeypatch):
    """``attn_impl="kernel"`` sends every Mamba2 block through ``ops.ssd``
    and the shared block through ``ops.flash_attention`` (impl
    "kernel"); ``"chunked"`` sends neither."""
    _, _, tmodel, tparams = models5
    calls = {"ssd": [], "attn": []}
    real_ssd, real_attn = S.kops.ssd, M.L.kops.flash_attention
    monkeypatch.setattr(S.kops, "ssd", lambda *a, **k: (
        calls["ssd"].append(k.get("impl")), real_ssd(*a, **k))[1])
    monkeypatch.setattr(M.L.kops, "flash_attention", lambda *a, **k: (
        calls["attn"].append(k.get("impl")), real_attn(*a, **k))[1])
    toks = _t(_tokens(tmodel.cfg, s=33))
    with torch.no_grad():
        tmodel.forward(tparams, {"tokens": toks}, attn_impl="kernel")
        assert calls == {"ssd": ["kernel"] * 5, "attn": ["kernel"] * 2}
        tmodel.forward(tparams, {"tokens": toks}, attn_impl="chunked")
    assert calls["ssd"] == ["kernel"] * 5
    assert calls["attn"] == ["kernel"] * 2 + ["chunked"] * 2


HYBRID_ARGV = ["--arch", "zamba2-7b", "--reduced", "--dist", "horovod",
               "--grad-accum", "dense_reduce", "--batch-per-worker", "2",
               "--seq-len", "16", "--warmup", "400", "--steps", "3",
               "--log-every", "1", "--device", "cpu"]


def test_launcher_trains_hybrid_like_the_reference():
    """The launcher trains the reduced zamba2 (its scan through the
    differentiable ``ssd_chunked``, as the reference trains it): three
    logged steps of finite loss.  Then the launcher's optimizer, step and
    trainer, from the reference's bridged parameters, take the reference
    trainer's three losses (rtol 1e-5, as tests/test_torch_train.py
    holds transformer-big)."""
    res = train.run(HYBRID_ARGV, log=lambda s: None)
    assert [h["step"] for h in res["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert not dist.is_initialized()

    args = train.parse_args(HYBRID_ARGV)
    jcfg = jget_config("zamba2-7b").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = JDistOpt(jadamw(jnoam(jcfg.d_model, warmup_steps=args.warmup)),
                    exchange=JExchangeConfig(sparse_as_dense=True,
                                             use_kernel=True))
    jstep = jmake_train_step(jmodel, jopt, sparse_embedding=True)
    jpipe = jmake_pipeline(jcfg, args.batch_per_worker, args.seq_len,
                           seed=args.seed)
    jres = JTrainer(jmodel, jstep, jpipe, JTrainerConfig(
        total_steps=args.steps, log_every=1)).run(
        jparams, jopt.init(jparams), log=lambda s: None)

    cfg = get_config("zamba2-7b").reduced()
    model = build_model(cfg)
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    device = train.resolve_device(args.device)
    rank, world, created = train.init_distributed(device)
    assert created and (rank, world) == (0, 1)
    try:
        opt = train.build_optimizer(args, cfg, dist.group.WORLD)
        step = make_train_step(model, opt, sparse_embedding=True)
        pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len,
                             seed=args.seed)
        meta = train.meta_worker_grads(args, model, pipe, True)
        ex_state = opt.init_exchange_state(meta, device=device)
        out = Trainer(model, step, pipe, TrainerConfig(
            total_steps=args.steps, log_every=1), device=device).run(
            params, opt.init(params), ex_state, log=lambda s: None)
    finally:
        dist.destroy_process_group()
    losses = [h["loss"] for h in out["history"]]
    jlosses = [h["loss"] for h in jres["history"]]
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
