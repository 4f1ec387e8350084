"""The port's launcher trains the new configs as the JAX package's does:
three steps of ``--dist horovod --grad-accum dense_reduce`` on the
reduced llama3.2-1b (tied), chatglm3-6b (untied, q/k/v biases),
internvl2-1b (the vlm patch prefix) and seamless-m4t-large-v2
(cross-attended frames: 1024 at full width, 16 reduced).

The launcher itself runs first (three logged steps of finite loss).  Then
the launcher's optimizer, step and trainer, from the reference's bridged
parameters with the same non-zero biases on both sides
(tests/test_torch_dense.py's ``with_biases``), take the reference
trainer's three losses (rtol 1e-5, as tests/test_torch_train.py holds
transformer-big).  The untied chatglm3 has an ``lm_head`` block; its
``grad_blocks`` and the launcher plan's wait-free split equal the
reference's.
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
from repro.training.gradients import abstract_grad_contributions  # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.data import make_pipeline                      # noqa: E402
from repro_torch.launch import train                            # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training import (Trainer, TrainerConfig,       # noqa: E402
                                  make_train_step)
from test_torch_dense import with_biases                        # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def argv(arch):
    return ["--arch", arch, "--reduced", "--dist", "horovod",
            "--grad-accum", "dense_reduce", "--batch-per-worker", "2",
            "--seq-len", "16", "--warmup", "400", "--steps", "3",
            "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "chatglm3-6b",
                                  "internvl2-1b", "seamless-m4t-large-v2"])
def test_launcher_trains_like_the_reference(arch):
    res = train.run(argv(arch), log=lambda s: None)
    assert [h["step"] for h in res["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
    assert not dist.is_initialized()

    args = train.parse_args(argv(arch))
    jcfg = jget_config(arch).reduced()
    jmodel = jbuild_model(jcfg)
    p = with_biases(jmodel.init(jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, p)
    jopt = JDistOpt(jadamw(jnoam(jcfg.d_model, warmup_steps=args.warmup)),
                    exchange=JExchangeConfig(sparse_as_dense=True,
                                             use_kernel=True))
    jstep = jmake_train_step(jmodel, jopt, sparse_embedding=True)
    jpipe = jmake_pipeline(jcfg, args.batch_per_worker, args.seq_len,
                           seed=args.seed)
    jres = JTrainer(jmodel, jstep, jpipe, JTrainerConfig(
        total_steps=args.steps, log_every=1)).run(
        jparams, jopt.init(jparams), log=lambda s: None)

    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = bridge.to_torch(p, "cpu")
    assert model.grad_blocks(params) == jmodel.grad_blocks(jparams)
    assert ("lm_head" in params) == (arch == "chatglm3-6b")
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


def test_wait_free_split_with_lm_head_matches_reference():
    """``--overlap backward`` on the untied chatglm3: one bucket per top-level
    block (``lm_head`` among them) and the hooked/tail split of the plan
    equal the reference's."""
    args = train.parse_args(argv("chatglm3-6b") + ["--overlap", "backward"])
    cfg = get_config("chatglm3-6b").reduced()
    model = build_model(cfg)
    pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len)
    meta = train.meta_worker_grads(args, model, pipe, True)
    plan = train.build_optimizer(args, cfg, None).plan(meta)
    jcfg = jget_config("chatglm3-6b").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    jbatch = {k: sds((args.batch_per_worker,) + v.shape[1:], v.dtype)
              for k, v in jmake_pipeline(jcfg, 1, args.seq_len)
              .batch_at(0).items()}
    jg = abstract_grad_contributions(jmodel, jparams, jbatch,
                                     sparse_embedding=True)
    jplan = JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(
        sparse_as_dense=True, overlap="backward", use_kernel=True),
        axis_name=None).plan(jg)
    hooked = set(model.grad_blocks(model.init(device="meta")))
    assert "lm_head" in hooked
    assert plan.leaf_blocks == jplan.leaf_blocks
    assert plan.backward_block_stages(hooked) == \
        jplan.backward_block_stages(hooked)
    assert "lm_head" in plan.backward_block_stages(hooked)[0]
