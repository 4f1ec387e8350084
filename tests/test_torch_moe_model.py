"""The port's moe family against the JAX package's, on the reduced
llama4-scout-17b-a16e in f32: the forward and its aux loss, loss, ``ce``,
``aux`` and gradients, decode under both ``moe_mode``s, ``ServeEngine``
and the launcher; and ``Model.init``'s CPU draws pinned bitwise.

The reference's parameters cross through ``repro_torch.bridge``
(bitwise).  Tolerances as in tests/test_torch_dense.py: loss rtol 1e-5;
gradients atol 1e-5, rtol 1e-4; IndexedSlices indices exactly; logits
and caches within 1e-5; generated tokens exactly.
"""
import dataclasses
import hashlib

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402
import torch.distributed as dist              # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,    # noqa: E402
                        ExchangeConfig as JExchangeConfig)
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.optim import adamw as jadamw, noam_schedule as jnoam  # noqa: E402
from repro.serving import ServeEngine as JServeEngine          # noqa: E402
from repro.training import (Trainer as JTrainer,                # noqa: E402
                            TrainerConfig as JTrainerConfig,
                            make_train_step as jmake_train_step)
from repro.training.gradients import (                          # noqa: E402
    grad_contributions as jgrad_contributions)
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.data import make_pipeline                      # noqa: E402
from repro_torch.launch import train                            # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.serving import ServeEngine                     # noqa: E402
from repro_torch.training import (Trainer, TrainerConfig,       # noqa: E402
                                  make_train_step)
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402
from test_torch_dense import TOL, _compare_grads, _np, _t       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SCOUT = "llama4-scout-17b-a16e"


def build(cfg_change=None):
    jcfg = jget_config(SCOUT).reduced()
    cfg = get_config(SCOUT).reduced()
    if cfg_change is not None:
        jcfg = jcfg.with_(moe=dataclasses.replace(jcfg.moe, **cfg_change))
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, **cfg_change))
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jmodel, jparams, build_model(cfg), tparams


@pytest.fixture(scope="module")
def models():
    return build()


# sha256 of every leaf's bytes in flatten order, from ``Model.init(seed,
# device="cpu")`` of the reduced configs, as drawn since the CPU init
# stopped calling ATen's ``normal_`` (whose bits follow the host's vector
# ISA): ``layers.normal_f32`` maps integer draws by Marsaglia's polar
# method in exact or correctly rounded f64 arithmetic, so the same bytes
# come out under ATEN_CPU_CAPABILITY=default, avx2 and avx512
# (tests/test_torch_host_independence.py)
INIT_SHA256 = {
    ("transformer-big", 0):
        "c26ffc0cec20a8147e49ae89b936d1c7c8191a993ba507334ae86635f5e59fb6",
    ("transformer-big", 3):
        "5ea5fe720aa2e2fa2634e2c54db683e09e30ec28bb48c2c96e39b6057bc3ad05",
    ("zamba2-7b", 0):
        "755fa9817d25ce91b6767aa8bde0c93dafc2d62bd061681a23ed515575d89ffe",
    ("chatglm3-6b", 0):
        "ec5392e01b334784fe69d62b55d34b08296c8ccac74120715c1c25f85391f371",
    (SCOUT, 0):
        "360984d7514b10b0f3e927f220c3b17326a869e9efa45709e48d7536d7767c4b",
    (SCOUT, 3):
        "b2b4abea567366c8a998b18f968445f75bdd86b55b4dd565f6678fca5ac276b9",
}


@pytest.mark.parametrize("arch,seed", sorted(INIT_SHA256))
def test_cpu_init_is_bitwise_pinned(arch, seed):
    params = build_model(get_config(arch).reduced()).init(seed=seed,
                                                          device="cpu")
    h = hashlib.sha256()
    for t in tree_flatten(params)[0]:
        assert t.device.type == "cpu"
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == INIT_SHA256[(arch, seed)]


def test_init_layout_matches_reference(models):
    jmodel, jparams, tmodel, tparams = models
    for device in ("cpu", "meta"):
        mine = tmodel.init(seed=0, device=device)
        a, ta = tree_flatten(mine)
        b, tb = tree_flatten(tparams)
        assert ta == tb
        for x, y in zip(a, b):
            assert x.shape == y.shape and x.dtype == y.dtype
            assert x.device.type == device
    assert sorted(tparams["layers"]["ffn"]) == ["router", "shared",
                                                "w_down", "w_gate", "w_up"]


def test_forward_and_aux_match_reference(models):
    """The prefill step's forward through the kernel impl (the Pallas
    kernel in interpret mode on the reference side) and the plain one."""
    jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(1).integers(
        0, tmodel.cfg.vocab, (2, 24)).astype(np.int32)
    for jimpl, impl in (("pallas", "kernel"), ("xla_chunked", "chunked")):
        jh, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                                  attn_impl=jimpl)
        h, aux = tmodel.forward_aux(tparams, {"tokens": _t(toks)},
                                    attn_impl=impl)
        np.testing.assert_allclose(_np(h), _np(jh), **TOL)
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)
        np.testing.assert_allclose(
            _np(tmodel.forward(tparams, {"tokens": _t(toks)},
                               attn_impl=impl)), _np(h), rtol=0, atol=0)
    assert float(aux) > 0.0


@pytest.mark.parametrize("sparse_embedding", [False, True])
def test_loss_and_grads_match_jax(models, sparse_embedding):
    jmodel, jparams, tmodel, tparams = models
    batch = jmake_pipeline(jmodel.cfg, 2, 16, seed=5).batch_at(0)
    jg, jloss, jm = jgrad_contributions(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    tg, tloss, tm = grad_contributions(
        tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for key in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(tm["aux"]) > 0.0
    np.testing.assert_allclose(
        float(tloss), float(tm["ce"]) + 0.01 * float(tm["aux"]), rtol=1e-6)
    _compare_grads(tg, jg)
    assert float(tg["layers"]["ffn"]["router"].abs().max()) > 0.0


@pytest.mark.parametrize("moe_mode", ["dropless", "capacity"])
def test_decode_matches_reference(models, moe_mode):
    """A 4-token sequential prefill (dropless, as the reference's) and 4
    decode steps under ``moe_mode``: logits, caches and lengths."""
    jmodel, jparams, tmodel, tparams = models
    toks = np.random.default_rng(2).integers(
        0, tmodel.cfg.vocab, (3, 8)).astype(np.int32)
    jlast, jcache = jax.jit(lambda p, c, t: jmodel.prefill(p, c, t))(
        jparams, jmodel.init_cache(3, 10), jnp.asarray(toks[:, :4]))
    last, cache = tmodel.prefill(tparams, tmodel.init_cache(3, 10,
                                                            device="cpu"),
                                 _t(toks[:, :4]))
    np.testing.assert_allclose(_np(last), _np(jlast), **TOL)
    jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t,
                                                       moe_mode=moe_mode))
    for i in range(4, 8):
        jlg, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, i:i + 1]))
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]),
                                       moe_mode=moe_mode)
        assert tuple(lg.shape) == (3, tmodel.cfg.vocab)
        np.testing.assert_allclose(_np(lg), _np(jlg), **TOL,
                                   err_msg=f"step {i}")
    assert cache["length"].tolist() == [8, 8, 8]
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]), **TOL)
    with pytest.raises(ValueError, match="moe_mode"):
        tmodel.decode_step(tparams, cache, _t(toks[:, :1]), moe_mode="x")


def test_capacity_decode_drops_like_reference():
    """8 experts and a chunked step of 4 x 4 tokens: the capacity mode's
    cap = max(8, ceil(4 * 16 / 8)) = 8 of 16 tokens, so an expert that
    draws more than 8 drops; logits as the reference's, and unlike the
    dropless step's."""
    jmodel, jparams, tmodel, tparams = build({"n_experts": 8})
    # one token everywhere: attention over equal keys and values returns
    # the value at every position, so all 16 take one expert in layer 0
    toks = np.full((4, 4), 17, np.int32)
    out = {}
    for mode in ("capacity", "dropless"):
        jlg, _ = jmodel.decode_step(jparams, jmodel.init_cache(4, 4),
                                    jnp.asarray(toks), moe_mode=mode)
        lg, _ = tmodel.decode_step(tparams, tmodel.init_cache(4, 4,
                                                              device="cpu"),
                                   _t(toks), moe_mode=mode)
        assert tuple(lg.shape) == (4, 4, tmodel.cfg.vocab)
        np.testing.assert_allclose(_np(lg), _np(jlg), **TOL, err_msg=mode)
        out[mode] = _np(lg)
    assert np.abs(out["capacity"] - out["dropless"]).max() > 1e-3


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


def argv(grad_accum):
    return ["--arch", SCOUT, "--reduced", "--dist", "horovod",
            "--grad-accum", grad_accum, "--batch-per-worker", "2",
            "--seq-len", "16", "--warmup", "400", "--steps", "3",
            "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("grad_accum", ["dense_reduce", "sparse_gather"])
def test_launcher_trains_like_the_reference(models, grad_accum):
    """The launcher runs 3 logged steps with ``aux`` in each history
    entry; its optimizer, step and trainer, from the reference's bridged
    parameters, take the reference trainer's losses (rtol 1e-5)."""
    res = train.run(argv(grad_accum), log=lambda s: None)
    assert [h["step"] for h in res["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0
               for h in res["history"])
    assert not dist.is_initialized()

    jmodel, jparams, model, params = models
    args = train.parse_args(argv(grad_accum))
    jcfg = jmodel.cfg
    jopt = JDistOpt(jadamw(jnoam(jcfg.d_model, warmup_steps=args.warmup)),
                    exchange=JExchangeConfig(
                        sparse_as_dense=grad_accum == "dense_reduce",
                        use_kernel=True))
    jstep = jmake_train_step(jmodel, jopt, sparse_embedding=True)
    jpipe = jmake_pipeline(jcfg, args.batch_per_worker, args.seq_len,
                           seed=args.seed)
    jres = JTrainer(jmodel, jstep, jpipe, JTrainerConfig(
        total_steps=args.steps, log_every=1)).run(
        jparams, jopt.init(jparams), log=lambda s: None)

    cfg = model.cfg
    device = train.resolve_device(args.device)
    _, _, created = train.init_distributed(device)
    assert created
    try:
        opt = train.build_optimizer(args, cfg, dist.group.WORLD)
        step = make_train_step(model, opt, sparse_embedding=True)
        pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len,
                             seed=args.seed)
        meta = train.meta_worker_grads(args, model, pipe, True)
        ex_state = opt.init_exchange_state(meta, device=device)
        out = Trainer(model, step, pipe, TrainerConfig(
            total_steps=args.steps, log_every=1), device=device).run(
            {k: v for k, v in params.items()}, opt.init(params), ex_state,
            log=lambda s: None)
    finally:
        dist.destroy_process_group()
    for key in ("loss", "aux"):
        np.testing.assert_allclose([h[key] for h in out["history"]],
                                   [float(h[key]) for h in jres["history"]],
                                   rtol=1e-5, err_msg=key)
