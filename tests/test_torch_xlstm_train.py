"""The port's ssm family (xlstm-125m) through the launcher against the
JAX package's trainer, on the reduced config in f32: 3 logged steps of
dense_reduce and of sparse_gather from the reference's bridged
parameters take the reference trainer's losses (rtol 1e-5, as
tests/test_torch_moe_model.py), and the wait-free (``--overlap
backward``) launcher ends bitwise on the fused one's parameters (each
layer's unused block gets zero gradients through the block hook as
through autograd); and decode against the forward at 2 and 12 blocks,
in both packages.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
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
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.data import make_pipeline                      # noqa: E402
from repro_torch.launch import train                            # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training import (Trainer, TrainerConfig,       # noqa: E402
                                  make_train_step)
from repro_torch.tree import tree_flatten                       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "xlstm-125m"


@pytest.fixture(scope="module")
def models():
    jmodel = jbuild_model(jget_config(ARCH).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jmodel, jparams, build_model(get_config(ARCH).reduced()), tparams


def argv(grad_accum):
    return ["--arch", ARCH, "--reduced", "--dist", "horovod",
            "--grad-accum", grad_accum, "--batch-per-worker", "2",
            "--seq-len", "16", "--warmup", "400", "--steps", "3",
            "--log-every", "1", "--device", "cpu"]


@pytest.mark.parametrize("grad_accum", ["dense_reduce", "sparse_gather"])
def test_launcher_trains_like_the_reference(models, grad_accum):
    """The launcher runs 3 logged steps; its optimizer, step and trainer,
    from the reference's bridged parameters, take the reference
    trainer's losses (rtol 1e-5)."""
    res = train.run(argv(grad_accum), log=lambda s: None)
    assert [h["step"] for h in res["history"]] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in res["history"])
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
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [float(h["loss"]) for h in jres["history"]],
                               rtol=1e-5)


def test_wait_free_launcher_is_bitwise_fused():
    """``--overlap backward`` hooks ``mlstm`` and ``slstm`` whole; each
    stack's unused layer gets zeros through the hook as through autograd,
    so 3 steps end on the fused run's parameters bitwise."""
    fused = train.run(argv("dense_reduce"), log=lambda s: None)
    hooked = train.run(argv("dense_reduce") + ["--overlap", "backward"],
                       log=lambda s: None)
    a, b = tree_flatten(fused["params"])[0], tree_flatten(hooked["params"])[0]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert [h["loss"] for h in fused["history"]] == \
        [h["loss"] for h in hooked["history"]]


def test_depth_12_decode_parts_from_forward_in_the_reference():
    """The random xLSTM is ill-conditioned with depth: at 12 blocks of
    the reduced width the reference's own teacher-forced decode and
    forward part by more than tests/test_decode.py's 2e-4, from
    summation order alone (an mLSTM step divides by max(|q.n|,
    exp(-m)), so a block can scale a perturbation of its input by
    exp(i)); at its 2 blocks they agree within 2e-4 (tests/test_decode.py,
    and here ``test_decode_matches_forward_and_chunked_step`` of
    tests/test_torch_xlstm_model.py).  This is why chip_smoke.py holds
    full-width xlstm-125m's f32 decode to 2e-4 on its first two blocks
    and at ``PATH_TOL``'s max abs 0.25 at full depth, which the port
    meets here."""
    import jax.numpy as jnp
    toks = np.random.default_rng(0).integers(0, 512, (8, 16)).astype(
        np.int32)
    depth = 12
    jmodel = jbuild_model(jget_config(ARCH).reduced().with_(n_layers=depth))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jh, _ = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)})
    jwant = np.asarray(jmodel.head(jparams, jh))
    jstep = jax.jit(jmodel.decode_step)
    c = jmodel.init_cache(8, 16)
    rows = []
    for i in range(16):
        lg, c = jstep(jparams, c, jnp.asarray(toks[:, i:i + 1]))
        rows.append(np.asarray(lg))
    ref_gap = float(np.abs(np.stack(rows, 1) - jwant).max())
    model = build_model(get_config(ARCH).reduced().with_(n_layers=depth))
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    t = torch.from_numpy(toks)
    with torch.no_grad():
        want = model.head(params, model.forward(params, {"tokens": t}))
        c = model.init_cache(8, 16, device="cpu")
        rows = []
        for i in range(16):
            lg, c = model.decode_step(params, c, t[:, i:i + 1])
            rows.append(lg)
    gap = float((torch.stack(rows, 1) - want).abs().max())
    assert ref_gap > 2e-4 and gap < 0.25, (ref_gap, gap)
