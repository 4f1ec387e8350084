"""The port's training step and launcher against the JAX package.

Three steps of ``--dist horovod --grad-accum dense_reduce`` on the reduced
config, from bridged parameters and the same batches, with the identity
wire and with ``--codec int8 --error-feedback``.  The port runs its
launcher's optimizer on a gloo world of 1; the reference runs
``make_train_step`` jitted with ``axis_name=None``.

Tolerances: losses rtol 1e-5; Adam first moments (linear in the
exchanged gradients) the gradients' atol 1e-5, rtol 1e-4; final
parameters atol 1e-5.
Adam divides by sqrt(v) + 1e-9, so an element whose gradient cancels to
the f32 noise floor (the two frameworks sum in different orders) can
take a step of the other sign: up to 2 * lr per step.  Such elements are
allowed that bound, and may be at most 0.1% of any leaf.
"""
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
from repro_torch.optim import noam_schedule                     # noqa: E402
from repro_torch.training import (Trainer, TrainerConfig,       # noqa: E402
                                  make_train_step)
from repro_torch.tree import tree_flatten                       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARGV = ["--arch", "transformer-big", "--reduced", "--dist", "horovod",
        "--grad-accum", "dense_reduce", "--batch-per-worker", "2",
        "--seq-len", "16", "--warmup", "400", "--steps", "3",
        "--log-every", "1", "--device", "cpu"]


def test_three_steps_match_reference():
    args = train.parse_args(ARGV)
    jcfg = jget_config("transformer-big").reduced()
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

    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    device = train.resolve_device(args.device)
    rank, world, created = train.init_distributed(device)
    assert created and (rank, world) == (0, 1)
    try:
        opt = train.build_optimizer(args, cfg, dist.group.WORLD)
        assert opt.exchange_config.use_kernel
        step = make_train_step(model, opt, sparse_embedding=True)
        pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len,
                             seed=args.seed)
        meta = train.meta_worker_grads(args, model, pipe, True)
        ex_state = opt.init_exchange_state(meta, device=device)
        assert all(s == () for s in ex_state.bucket_states)
        res = Trainer(model, step, pipe, TrainerConfig(
            total_steps=args.steps, log_every=1), device=device).run(
            params, opt.init(params), ex_state, log=lambda s: None)
    finally:
        dist.destroy_process_group()

    losses = [h["loss"] for h in res["history"]]
    jlosses = [h["loss"] for h in jres["history"]]
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    for t, j in zip(tree_flatten(res["opt_state"].mu)[0],
                    jax.tree_util.tree_leaves(jres["opt_state"].mu)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-4)
    lr = noam_schedule(cfg.d_model, warmup_steps=args.warmup)
    flip_bound = 2 * sum(float(lr(torch.tensor(t))) for t in (1, 2, 3))
    tl = tree_flatten(res["params"])[0]
    jl = jax.tree_util.tree_leaves(jres["params"])
    moved = 0.0
    for t, j, p0 in zip(tl, jl, tree_flatten(params)[0]):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert (diff > 1e-5).mean() <= 1e-3
        assert diff.max() <= flip_bound
        moved = max(moved, float((t - p0).abs().max()))
    assert moved > 1e-4          # the steps really updated the weights


def _flat_states(state):
    return [s for s in state.bucket_states if not isinstance(s, tuple)]


def test_three_steps_int8_error_feedback_match_reference():
    """``--codec int8 --error-feedback``: the stateful step and trainer
    against the reference's jitted stateful ``make_train_step`` and
    ``Trainer.run(exchange_state=...)``.

    Tolerances: losses rtol 1e-5 (the loss precedes each exchange, and
    the int8 wire moves the weights the same on both sides).  The two
    frameworks sum the embedding's duplicate rows in another order, so
    its f32 input to the quantiser may differ in the last bit and an
    int8 rounding may flip; a flip moves that element's EF residual by
    one quantisation step (the bucket's scale) and the next steps'
    gradients by as much.  So EF residuals and Adam first moments may
    differ, on at most 0.1% of a leaf, by up to one step, estimated as
    2.5x the reference residual's largest magnitude (which is about half
    a step); elsewhere residuals agree within 1% of that magnitude (the
    f32 noise of the gradients) and moments within atol 1e-5, rtol 1e-4.
    Parameters as in ``test_three_steps_match_reference``."""
    argv = ARGV + ["--codec", "int8", "--error-feedback"]
    args = train.parse_args(argv)
    jcfg = jget_config("transformer-big").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jopt = JDistOpt(jadamw(jnoam(jcfg.d_model, warmup_steps=args.warmup)),
                    exchange=JExchangeConfig(sparse_as_dense=True,
                                             codec="int8",
                                             error_feedback=True,
                                             use_kernel=True))
    jstep = jmake_train_step(jmodel, jopt, sparse_embedding=True)
    assert jstep.stateful_exchange
    jpipe = jmake_pipeline(jcfg, args.batch_per_worker, args.seq_len,
                           seed=args.seed)
    jbatch = {k: jnp.asarray(v) for k, v in jpipe.batch_at(0).items()}
    jg, _, _ = jgrad_contributions(jmodel, jparams, jbatch,
                                   sparse_embedding=True)
    jres = JTrainer(jmodel, jstep, jpipe, JTrainerConfig(
        total_steps=args.steps, log_every=1)).run(
        jparams, jopt.init(jparams), log=lambda s: None,
        exchange_state=jopt.init_exchange_state(jg))

    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    device = train.resolve_device(args.device)
    rank, world, created = train.init_distributed(device)
    assert created and (rank, world) == (0, 1)
    try:
        opt = train.build_optimizer(args, cfg, dist.group.WORLD)
        assert opt.exchange_config.codec == "int8+ef"
        step = make_train_step(model, opt, sparse_embedding=True)
        pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len,
                             seed=args.seed)
        meta = train.meta_worker_grads(args, model, pipe, True)
        ex_state = opt.init_exchange_state(meta, device=device)
        res = Trainer(model, step, pipe, TrainerConfig(
            total_steps=args.steps, log_every=1), device=device).run(
            params, opt.init(params), ex_state, log=lambda s: None)
    finally:
        dist.destroy_process_group()

    losses = [h["loss"] for h in res["history"]]
    jlosses = [h["loss"] for h in jres["history"]]
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)

    plan = opt.plan(meta)
    states = res["exchange_state"].bucket_states
    jstates = jres["exchange_state"].bucket_states
    assert len(states) == len(jstates) == plan.schedule.n_stages
    step_of_leaf = {}
    for stage, t, j in zip(plan.schedule.stages, states, jstates):
        j = np.asarray(j)
        half_step = float(np.abs(j).max())
        q_step = 2.5 * half_step + 1e-7
        diff = np.abs(t.numpy() - j)
        assert diff.max() <= q_step
        assert (diff > 1e-2 * half_step).mean() <= 1e-3
        assert half_step > 0                     # the residual is live
        for i in stage.leaf_ids:
            step_of_leaf[i] = q_step
    tmu = tree_flatten(res["opt_state"].mu)[0]
    jmu = jax.tree_util.tree_leaves(jres["opt_state"].mu)
    for i, (t, j) in enumerate(zip(tmu, jmu)):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert diff.max() <= step_of_leaf[i]
        assert (diff > 1e-5 + 1e-4 * np.abs(np.asarray(j))).mean() <= 1e-3
    lr = noam_schedule(cfg.d_model, warmup_steps=args.warmup)
    flip_bound = 2 * sum(float(lr(torch.tensor(t))) for t in (1, 2, 3))
    for t, j in zip(tree_flatten(res["params"])[0],
                    jax.tree_util.tree_leaves(jres["params"])):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert (diff > 1e-5).mean() <= 1e-3
        assert diff.max() <= flip_bound


def test_main_on_cpu_prints_done(capsys):
    argv = [a for a in ARGV if a != "3"]
    argv[argv.index("--steps") + 1:argv.index("--steps") + 1] = ["2"]
    assert train.main(argv) == 0
    out = capsys.readouterr().out
    assert "horovod mode: 1 workers (gloo)" in out
    assert "step 2: loss=" in out
    assert out.strip().splitlines()[-1].startswith("done: {")
    assert not dist.is_initialized()


def test_main_sparse_gather_on_cpu(capsys):
    res = train.run(["--reduced", "--grad-accum", "sparse_gather",
                     "--batch-per-worker", "2", "--seq-len", "8",
                     "--steps", "1", "--device", "cpu"])
    assert np.isfinite(res["history"][-1]["loss"])
    assert "done: {" in capsys.readouterr().out


def test_main_int8_error_feedback_on_cpu(capsys):
    res = train.run(["--reduced", "--dist", "horovod", "--codec", "int8",
                     "--error-feedback", "--batch-per-worker", "2",
                     "--seq-len", "8", "--steps", "2", "--log-every", "1",
                     "--device", "cpu"])
    assert [h["step"] for h in res["history"]] == [1, 2]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert len(res["exchange_state"].bucket_states) == 16
    out = capsys.readouterr().out
    assert "step 2: loss=" in out
    assert out.strip().splitlines()[-1].startswith("done: {")
    assert not dist.is_initialized()


def test_trainer_takes_no_default_device():
    """The trainer's batches land on the device the caller names, and a
    trainer that names none cannot be built: it never runs on the CPU
    unasked."""
    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    pipe = make_pipeline(cfg, 2, 8, seed=0)
    with pytest.raises(TypeError):
        Trainer(model, None, pipe, TrainerConfig())
    for device in ("meta", "cpu"):
        batch = Trainer(model, None, pipe, TrainerConfig(),
                        device=device).batch_at(0)
        assert {t.device.type for t in batch.values()} == {device}
    batch = Trainer(model, None, pipe, TrainerConfig(), device="cpu",
                    rank=1, world=2).batch_at(0)
    np.testing.assert_array_equal(batch["tokens"].numpy(),
                                  pipe.batch_at(0)["tokens"][1:])


def test_main_defaults_to_the_card():
    """Without ``--device`` the launcher asks for CUDA; here, with no
    card, that raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(SystemExit):
        train.main(["--reduced", "--no-such-flag", "--device", "cpu"])
