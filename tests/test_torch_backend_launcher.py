"""The launcher's backend flags against the reference launcher's:

  * ``--backend hierarchical`` on a world of 1 exits with the reference's
    even-world message;
  * ``--wire-dtype bf16`` (the deprecated spelling) trains bitwise as
    ``--codec bf16``;
  * ``--reduce-scatter --codec int8`` is refused with the reference's
    message;
  * ``--backend ringsim`` and ``--reduce-scatter`` train the reduced
    transformer-big 3 steps (a gloo world of 1, bridged parameters) with
    losses equal to the reference trainer's at ``--dist local`` (rtol
    1e-5, as ``tests/test_torch_train.py``).
"""
import inspect
import re

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import numpy as np                            # noqa: E402
import torch.distributed as dist              # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,    # noqa: E402
                        ExchangeConfig as JExchangeConfig)
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.launch import train as jtrain                       # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.optim import adamw as jadamw, noam_schedule as jnoam  # noqa: E402
from repro.training import (Trainer as JTrainer,                # noqa: E402
                            TrainerConfig as JTrainerConfig,
                            make_train_step as jmake_train_step)
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.data import make_pipeline                      # noqa: E402
from repro_torch.launch import train                            # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training import (Trainer, TrainerConfig,       # noqa: E402
                                  make_train_step)
from repro_torch.tree import tree_flatten                       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARGV = ["--arch", "transformer-big", "--reduced", "--dist", "horovod",
        "--grad-accum", "dense_reduce", "--batch-per-worker", "2",
        "--seq-len", "16", "--warmup", "400", "--steps", "3",
        "--log-every", "1", "--device", "cpu"]
EVEN_WORLD = ("hierarchical backend needs an even worker count "
              "(2 emulated pods)")


def test_hierarchical_refuses_an_odd_world_like_reference():
    # the reference's literal, its implicit concatenation joined
    src = re.sub(r'"\s*\n\s*"', "", inspect.getsource(jtrain.main))
    assert f'"{EVEN_WORLD}"' in src
    with pytest.raises(SystemExit) as exc:
        train.run(ARGV + ["--backend", "hierarchical"], log=lambda s: None)
    assert str(exc.value) == EVEN_WORLD
    assert not dist.is_initialized()          # the group was torn down


def test_reduce_scatter_int8_is_refused_like_reference():
    with pytest.raises(ValueError) as jerr:
        JExchangeConfig(reduce_scatter=True, codec="int8")
    with pytest.raises(ValueError) as terr:
        train.run(ARGV + ["--reduce-scatter", "--codec", "int8"],
                  log=lambda s: None)
    assert str(terr.value) == str(jerr.value)
    assert not dist.is_initialized()


def _state(result):
    return (tree_flatten(result["params"])[0]
            + tree_flatten(result["opt_state"].mu)[0]
            + tree_flatten(result["opt_state"].nu)[0])


def test_wire_dtype_trains_bitwise_as_codec():
    argv = ARGV[:-6] + ["--steps", "2", "--log-every", "1", "--device",
                        "cpu"]
    a = train.run(argv + ["--wire-dtype", "bf16"], log=lambda s: None)
    b = train.run(argv + ["--codec", "bf16"], log=lambda s: None)
    c = train.run(argv, log=lambda s: None)
    cfg = get_config("transformer-big").reduced()
    assert train.build_optimizer(train.parse_args(
        argv + ["--wire-dtype", "bf16"]), cfg, None).exchange_config == \
        train.build_optimizer(train.parse_args(argv + ["--codec", "bf16"]),
                              cfg, None).exchange_config
    assert [h["loss"] for h in a["history"]] == \
        [h["loss"] for h in b["history"]]
    for x, y in zip(_state(a), _state(b)):
        assert torch.equal(x, y)
    # the bf16 wire is a different wire: the moments move
    assert any(not torch.equal(x, y) for x, y in zip(_state(a), _state(c)))


@pytest.fixture(scope="module")
def reference_run():
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
    return jparams, [h["loss"] for h in jres["history"]]


@pytest.mark.parametrize("flags", [["--backend", "ringsim"],
                                   ["--backend", "ringsim",
                                    "--reduce-scatter"],
                                   ["--reduce-scatter"]], ids=" ".join)
def test_backend_trains_like_reference_launcher(reference_run, flags):
    jparams, jlosses = reference_run
    args = train.parse_args(ARGV + flags)
    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    device = train.resolve_device(args.device)
    train.init_distributed(device)
    try:
        opt = train.build_optimizer(args, cfg, dist.group.WORLD)
        step = make_train_step(model, opt, sparse_embedding=True)
        pipe = make_pipeline(cfg, args.batch_per_worker, args.seq_len,
                             seed=args.seed)
        ex_state = opt.init_exchange_state(
            train.meta_worker_grads(args, model, pipe, True), device=device)
        res = Trainer(model, step, pipe, TrainerConfig(
            total_steps=args.steps, log_every=1), device=device).run(
            params, opt.init(params), ex_state, log=lambda s: None)
    finally:
        dist.destroy_process_group()
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 3
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
