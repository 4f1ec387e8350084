"""The port's checkpoints against the reference's
(``repro.checkpoint.checkpoint``): one npz format for both packages.

  * keys: the port's tree walker gives the reference's
    ``tree_flatten_with_path`` keys (``#i`` for sequence entries and
    ExchangeState stages, ``@name`` for NamedTuple fields, dict keys as
    they are, ``:bf16`` for bfloat16 bit patterns);
  * round trips, bf16 included, bitwise, dtype and device kept;
  * the ZeRO-1 mesh-resize guard of ``tests/test_zero1.py`` (8 -> 4
    workers on a 41-element leaf): ``check_state`` names the mesh, the
    restore names the ZeRO-1 shard, with the reference's messages;
  * a reference-written npz of ``(params, Zero1State, ExchangeState)``
    restoring into the port's template, and the reverse, bitwise;
  * the launcher's ``--checkpoint-every``/``--resume`` at a world of 1:
    stopped after step 2 and resumed, bitwise the uninterrupted 3 steps
    (zero1 with int8+ef, and the replicated step).
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.checkpoint import checkpoint as jckpt               # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,      # noqa: E402
                        ExchangeConfig as JExchangeConfig,
                        compile_plan as jcompile_plan)
from repro.optim import adamw as jadamw                        # noqa: E402
from repro.optim import zero1 as jz1                           # noqa: E402
from repro_torch import bridge                                 # noqa: E402
from repro_torch.checkpoint import (latest_step,               # noqa: E402
                                    restore_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import flatten_with_paths  # noqa: E402
from repro_torch.core import DistributedOptimizer, ExchangeConfig  # noqa: E402
from repro_torch.core import compile_plan                      # noqa: E402
from repro_torch.launch import train                           # noqa: E402
from repro_torch.optim import adamw                            # noqa: E402
from repro_torch.optim import zero1 as z1                      # noqa: E402
from repro_torch.tree import tree_flatten                      # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _np_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((12, 8)).astype(np.float32),
            "b": rng.standard_normal(37).astype(np.float32),
            "emb": {"table": rng.standard_normal((6, 4)).astype(np.float32)}}


def _states(cfg_kw, seed=0, n_workers=1, bf16_params=False):
    """The same (params, Zero1State, ExchangeState) in both packages:
    params from ``seed``, the state after one step of seeded
    gradients."""
    np_params = _np_tree(seed)
    np_grads = _np_tree(seed + 1)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jg = jax.tree_util.tree_map(jnp.asarray, np_grads)
    p = bridge.to_torch(np_params, "cpu")
    g = bridge.to_torch(np_grads, "cpu")
    if bf16_params:              # bf16 params (and so bf16 gradients)
        to_bf16 = lambda a: a.astype(jnp.bfloat16)
        jp = jax.tree_util.tree_map(to_bf16, jp)
        jg = jax.tree_util.tree_map(to_bf16, jg)
        p, g = (bridge.to_torch(jax.tree_util.tree_map(np.asarray, t),
                                "cpu") for t in (jp, jg))
    opt = DistributedOptimizer(adamw(1e-2), exchange=ExchangeConfig(
        zero1=True, **cfg_kw))
    jopt = JDistOpt(jadamw(1e-2), exchange=JExchangeConfig(zero1=True,
                                                           **cfg_kw))
    z, ex = opt.init_zero1_state(g, p), opt.init_exchange_state(g)
    p, z, ex = opt.zero1_step(g, p, z, exchange_state=ex)
    jz, jex = jopt.init_zero1_state(jg, jp), jopt.init_exchange_state(jg)
    jp, jz, jex = jopt.zero1_step(jg, jp, jz, exchange_state=jex)
    return (p, z, ex), (jp, jz, jex)


def _same(a, b) -> bool:
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a, b)


# ---------------------------------------------------------------------------
# the key scheme
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_keys_match_reference(bf16):
    t, j = _states(dict(codec="int8+ef", param_codec="int8",
                        sparse_as_dense=True), bf16_params=bf16)
    base = adamw(1e-2)
    t_tree = t + (base.init(t[0]),)
    j_tree = j + (jadamw(1e-2).init(j[0]),)
    keys = [k + (":bf16" if x.dtype == torch.bfloat16 else "")
            for k, x in flatten_with_paths(t_tree)]
    assert keys == list(jckpt._flatten_with_paths(j_tree))
    assert any(k.startswith("#1/@opt_slots/#") for k in keys)
    assert any(k.startswith("#1/@param_shards/#") for k in keys)
    assert any(k.startswith("#2/#") for k in keys)
    assert any(k.startswith("#3/@mu/emb/table") for k in keys)
    assert any(k.endswith(":bf16") for k in keys) == bf16


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

def test_round_trip_bitwise_with_bf16(tmp_path):
    (p, z, ex), _ = _states(dict(codec="int8+ef", sparse_as_dense=True),
                            bf16_params=True)
    tree = (p, z, ex, adamw(1e-2, state_dtype="bfloat16").init(p))
    path = save_checkpoint(str(tmp_path), 7, tree)
    assert path.endswith("ckpt_00000007.npz")
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore_checkpoint(
        str(tmp_path), _map_tensors(torch.zeros_like, tree))
    assert step == 7
    got, want = flatten_with_paths(restored), flatten_with_paths(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.device == b.device
        assert _same(a, b)
    assert type(restored[1]) is z1.Zero1State
    assert type(restored[2]) is type(ex)
    assert int(restored[1].step) == 1
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)
    with pytest.raises(ValueError, match="checkpoint mismatch"):
        restore_checkpoint(str(tmp_path), tree[:2])


def test_zero1_checkpoint_roundtrip_same_mesh(tmp_path):
    g = bridge.to_torch(_np_tree(1), "cpu")
    plan = compile_plan(g, ExchangeConfig(sparse_as_dense=True, zero1=True))
    state = z1.init_state(plan, adamw(1e-2), g, n_workers=8)
    state = state._replace(step=torch.tensor(5, dtype=torch.int32))
    save_checkpoint(str(tmp_path), 5, state)
    like = z1.init_state(plan, adamw(1e-2), g, n_workers=8)
    restored, step = restore_checkpoint(str(tmp_path), like)
    assert step == 5 and int(restored.step) == 5
    for (_, a), (_, b) in zip(flatten_with_paths(state),
                              flatten_with_paths(restored)):
        assert torch.equal(a, b)
    z1.check_state(plan, restored, 8)


def test_zero1_mesh_resize_fails_like_reference(tmp_path):
    """A 41-element leaf pads to 48 on 8 workers but 44 on 4: the
    plan-level guard names the mesh, the checkpoint-level guard the
    ZeRO-1 shard, each with the reference's message."""
    g41 = {"w": torch.ones(41)}
    jg41 = {"w": jnp.ones((41,), jnp.float32)}
    cfg = dict(sparse_as_dense=True, zero1=True)
    plan = compile_plan(g41, ExchangeConfig(**cfg))
    jplan = jcompile_plan(jg41, JExchangeConfig(**cfg))
    state8 = z1.init_state(plan, adamw(1e-2), g41, n_workers=8)
    jstate8 = jz1.init_state(jplan, jadamw(1e-2), jg41, n_workers=8)
    local = z1.local_state(plan, state8, 0, 8)
    jlocal = jax.tree_util.tree_map(
        lambda a: a[: a.shape[0] // 8] if np.ndim(a) else a, jstate8)
    with pytest.raises(ValueError, match="mesh") as terr:
        z1.check_state(plan, local, 4)
    with pytest.raises(ValueError, match="mesh") as jerr:
        jz1.check_state(jplan, jlocal, 4)
    assert str(terr.value) == str(jerr.value)
    save_checkpoint(str(tmp_path / "t"), 1, state8)
    jckpt.save_checkpoint(str(tmp_path / "j"), 1, jstate8)
    like4 = z1.init_state(plan, adamw(1e-2), g41, n_workers=4)
    jlike4 = jz1.init_state(jplan, jadamw(1e-2), jg41, n_workers=4)
    with pytest.raises(ValueError, match="ZeRO-1") as terr:
        restore_checkpoint(str(tmp_path / "t"), like4)
    with pytest.raises(ValueError, match="ZeRO-1") as jerr:
        jckpt.restore_checkpoint(str(tmp_path / "j"), jlike4)
    assert str(terr.value) == str(jerr.value)
    # and either package's file fails the other's template the same way
    with pytest.raises(ValueError, match="ZeRO-1"):
        restore_checkpoint(str(tmp_path / "j"), like4)


# ---------------------------------------------------------------------------
# one file, two packages
# ---------------------------------------------------------------------------

CROSS = {"int8+ef": dict(codec="int8+ef", sparse_as_dense=True),
         "param_int8": dict(param_codec="int8", sparse_as_dense=True)}


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name", sorted(CROSS))
def test_reference_file_restores_into_port_and_back(tmp_path, name, bf16):
    (p, z, ex), (jp, jz, jex) = _states(CROSS[name], bf16_params=bf16)
    jtree = (jp, jz, jex)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, jtree)
    restored, step = restore_checkpoint(
        str(tmp_path / "ref"), _map_tensors(torch.zeros_like, (p, z, ex)))
    assert step == 3
    want = jax.tree_util.tree_leaves(jtree)
    got = flatten_with_paths(restored)
    assert len(got) == len(want)
    for (_, t), j in zip(got, want):
        assert t.dtype == (torch.bfloat16 if j.dtype == jnp.bfloat16
                           else getattr(torch, str(j.dtype)))
        np.testing.assert_array_equal(bridge.tensor_to_array(t),
                                      np.asarray(j).astype(np.float32)
                                      if j.dtype == jnp.bfloat16
                                      else np.asarray(j))
    # the reverse: the port writes, the reference restores into its own
    save_checkpoint(str(tmp_path / "port"), 4, restored)
    jlike = jax.tree_util.tree_map(jnp.zeros_like, jtree)
    back, jstep = jckpt.restore_checkpoint(str(tmp_path / "port"), jlike)
    assert jstep == 4
    for a, b in zip(jax.tree_util.tree_leaves(back), want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(
            np.asarray(a).reshape(-1).view(np.uint8),
            np.asarray(b).reshape(-1).view(np.uint8))


def _map_tensors(fn, tree):
    from repro_torch.checkpoint.checkpoint import _unflatten
    return _unflatten(tree, iter([fn(t) for _, t in
                                  flatten_with_paths(tree)]))


# ---------------------------------------------------------------------------
# the trainer's resume, through the launcher
# ---------------------------------------------------------------------------

ARGV = ["--reduced", "--dist", "horovod", "--grad-accum", "dense_reduce",
        "--batch-per-worker", "2", "--seq-len", "16", "--log-every", "1",
        "--device", "cpu"]


@pytest.mark.parametrize("flags", [["--zero1", "--codec", "int8",
                                    "--error-feedback"],
                                   ["--codec", "int8", "--error-feedback"],
                                   ["--zero1", "--param-codec", "int8"]],
                         ids=" ".join)
def test_launcher_resume_bitwise(tmp_path, flags):
    quiet = lambda s: None
    whole = train.run(ARGV + flags + ["--steps", "3"], log=quiet)
    ck = ["--checkpoint-dir", str(tmp_path)]
    train.run(ARGV + flags + ck + ["--steps", "2", "--checkpoint-every",
                                   "2"], log=quiet)
    assert latest_step(str(tmp_path)) == 2
    lines = []
    resumed = train.run(ARGV + flags + ck + ["--steps", "3", "--resume"],
                        log=lines.append)
    assert "resumed from step 2" in lines
    assert [h["step"] for h in resumed["history"]] == [3]
    assert resumed["history"][0]["loss"] == whole["history"][-1]["loss"]
    got = flatten_with_paths((resumed["params"], resumed["opt_state"],
                              resumed["exchange_state"]))
    want = flatten_with_paths((whole["params"], whole["opt_state"],
                               whole["exchange_state"]))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert torch.equal(a, b)
    assert "--zero1" not in flags or isinstance(resumed["opt_state"],
                                                z1.Zero1State)
    assert tree_flatten(resumed["params"])[0]
