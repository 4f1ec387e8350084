"""The port's MLA model (deepseek-v2-236b, family moe with ``mla``)
against the JAX package's, on the reduced config in f32 (MLA latent 32,
4 experts of 64, top-2, one shared): parameter layout and cache, the
forward and its aux loss through the kernel and chunked impls, loss and
gradients, prefill and decode (the absorbed default), decode against
the forward and the chunked prefill against sequential steps as
tests/test_decode.py holds the reference (capacity factor 4, so no
token drops), ``ServeEngine`` and 3 launcher steps of each strategy.

The reference's parameters cross through ``repro_torch.bridge``
(bitwise).  Tolerances as in tests/test_torch_moe_model.py: loss rtol
1e-5; gradients atol 1e-5, rtol 1e-4; logits and caches within
``TOL`` (1e-5); decode against the forward 2e-4 (the reference's);
generated tokens exactly.
"""
import dataclasses

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
from repro_torch.models import model as M                       # noqa: E402
from repro_torch.serving import ServeEngine                     # noqa: E402
from repro_torch.training import (Trainer, TrainerConfig,       # noqa: E402
                                  make_train_step)
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402
from test_torch_dense import TOL, _compare_grads, _np, _t       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v2-236b"
SELF_TOL = dict(rtol=2e-4, atol=2e-4)          # tests/test_decode.py


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(jget_config(ARCH).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jmodel, jparams, build_model(get_config(ARCH).reduced()), tparams


@pytest.fixture(scope="module")
def models4(models):
    """The same parameters at capacity factor 4: the forward drops no
    token (tests/test_decode.py ``_setup``)."""
    jmodel, jparams, tmodel, tparams = models

    def cap4(cfg):
        return cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                 capacity_factor=4.0))
    return (jbuild_model(cap4(jmodel.cfg)), jparams,
            build_model(cap4(tmodel.cfg)), tparams)


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
    assert sorted(tparams["layers"]["attn"]) == [
        "norm_ckv", "w_dkv", "w_kr", "w_uk", "w_uv", "wo", "wq"]
    jc = jmodel.init_cache(3, 7)
    tc = tmodel.init_cache(3, 7, device="cpu")
    assert sorted(tc) == sorted(jc) == ["ckv", "kr", "length"]
    for name in ("ckv", "kr", "length"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert str(tc[name].dtype)[6:] == str(jc[name].dtype)
    assert M._cache_len(tc) == 7


def test_forward_and_aux_match_reference(models):
    """The prefill step's forward: "kernel" against the reference's
    pallas impl (Dv == D at the reduced widths: the Pallas kernel in
    interpret mode), "chunked" against xla_chunked."""
    jmodel, jparams, tmodel, tparams = models
    toks = _tokens(tmodel.cfg.vocab, 2, 20, 1)
    for jimpl, impl in (("pallas", "kernel"), ("xla_chunked", "chunked")):
        jh, jaux = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                                  attn_impl=jimpl)
        h, aux = tmodel.forward_aux(tparams, {"tokens": _t(toks)},
                                    attn_impl=impl)
        np.testing.assert_allclose(_np(h), _np(jh), **TOL)
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)
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
    _compare_grads(tg, jg)
    for name in ("w_dkv", "w_kr", "w_uk", "w_uv"):
        assert float(tg["layers"]["attn"][name].abs().max()) > 0.0, name


def test_prefill_and_decode_match_reference(models):
    """A 4-token sequential prefill and 4 absorbed decode steps: logits,
    the compressed caches and lengths."""
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
    for name in ("ckv", "kr"):
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   **TOL)


def test_decode_matches_forward(models4):
    """tests/test_decode.py::test_decode_matches_forward for the reduced
    deepseek-v2 (one request of 8 tokens), in the port."""
    _, _, tmodel, tparams = models4
    toks = _tokens(tmodel.cfg.vocab, 1, 8, 3)
    with torch.no_grad():
        h = tmodel.forward(tparams, {"tokens": _t(toks)})
        want = tmodel.head(tparams, h)[:, -1]
    cache = tmodel.init_cache(1, 12, device="cpu")
    for i in range(8):
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]))
    np.testing.assert_allclose(_np(lg), _np(want), **SELF_TOL)
    assert int(cache["length"][0]) == 8


def test_chunked_prefill_matches_sequential(models4):
    """tests/test_decode.py::test_chunked_prefill_matches_sequential for
    the reduced deepseek-v2: one 8-token chunk through the absorbed
    decode's per-row causal mask against 8 single steps; and against the
    reference's chunk."""
    jmodel, jparams, tmodel, tparams = models4
    toks = _tokens(tmodel.cfg.vocab, 1, 8, 4)
    cache = tmodel.init_cache(1, 12, device="cpu")
    seq = []
    for i in range(8):
        lg, cache = tmodel.decode_step(tparams, cache, _t(toks[:, i:i + 1]))
        seq.append(lg)
    chunk, ccache = tmodel.decode_step(
        tparams, tmodel.init_cache(1, 12, device="cpu"), _t(toks))
    assert tuple(chunk.shape) == (1, 8, tmodel.cfg.vocab)
    assert int(ccache["length"][0]) == 8
    for i in range(8):
        np.testing.assert_allclose(_np(chunk[:, i]), _np(seq[i]),
                                   **SELF_TOL, err_msg=f"row {i}")
    jchunk, _ = jmodel.decode_step(jparams, jmodel.init_cache(1, 12),
                                   jnp.asarray(toks))
    np.testing.assert_allclose(_np(chunk), _np(jchunk), **TOL)


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
    return ["--arch", ARCH, "--reduced", "--dist", "horovod",
            "--grad-accum", grad_accum, "--batch-per-worker", "2",
            "--seq-len", "16", "--warmup", "400", "--steps", "3",
            "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("grad_accum", ["dense_reduce", "sparse_gather"])
def test_launcher_trains_like_the_reference(models, grad_accum):
    """The launcher runs 3 logged steps with ``aux`` > 0; its optimizer,
    step and trainer, from the reference's bridged parameters, take the
    reference trainer's losses and aux (rtol 1e-5)."""
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
            dict(params), opt.init(params), ex_state, log=lambda s: None)
    finally:
        dist.destroy_process_group()
    for key in ("loss", "aux"):
        np.testing.assert_allclose([h[key] for h in out["history"]],
                                   [float(h[key]) for h in jres["history"]],
                                   rtol=1e-5, err_msg=key)
