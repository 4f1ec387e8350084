"""The partitioned dry run (``repro_torch.launch.dryrun --mode gspmd``):
steps on meta DTensors over a ``DeviceMesh`` in a fake world.

  * the shapes of tests/test_dryrun.py::test_lower_and_compile_small_mesh
    (llama3.2-1b's train_4k and decode_32k on a (4, 2) mesh): the keys the
    unpartitioned run leaves null are numbers, the collectives DTensor
    dispatched are reported by kind and mesh dim (``CommDebugMode``'s
    count equals the recorder's), the argument bytes are the layouts'
    exact sums;
  * transformer-big's train step on (4, 2) and on the production mesh;
  * the model-axis collectives of a reduced llama3.2-1b's prefill on a
    (2, 2) mesh, one and two blocks, against a count derived here from
    the Megatron rules;
  * ``temp_bytes`` lower with remat than without;
  * ``--audit-mode gspmd`` at the reference's default arguments;
  * ``constrain_batch`` the identity on plain tensors, and on a DTensor
    the batch over the data axes, replicated over ``model``;
  * the CLI runs both gspmd flags, and a step DTensor cannot lay out
    exits 1 naming its op.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import InputShape, get_config   # noqa: E402
from repro_torch.launch import dryrun, mesh, sharding    # noqa: E402
from repro_torch.models import activation_sharding as act  # noqa: E402

SMALL_MESH = mesh.make_mesh((4, 2), ("data", "model"))
KINDS = {"all_reduce", "all_gather", "reduce_scatter", "all_to_all"}


@pytest.fixture(scope="module")
def llama_runs():
    return {shape: dryrun.run_dryrun("llama3.2-1b", shape, device="cpu",
                                     mode="gspmd", mesh_override=SMALL_MESH)
            for shape in ("train_4k", "decode_32k")}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_small_mesh_partitioned(shape, llama_runs):
    out = llama_runs[shape]
    assert out["mode"] == "dtensor" and out["n_chips"] == 8
    model = out["model_axis_collectives"]
    assert model["axes"] == ["model"] and sum(model["counts"].values()) > 0
    assert model["total_bytes"] == sum(model["bytes"].values()) > 0
    kinds = {k: v for k, v in out["collective_bytes_per_device"].items()
             if k != "data_parallel_exchange"}
    assert set(kinds) <= KINDS and set(kinds) == set(out["collective_counts"])
    assert out["collective_total_bytes"] == sum(kinds.values())
    assert out["comm_debug_counts"] == out["collective_counts"]
    data = out["data_axis_collectives"]
    for k, n in out["collective_counts"].items():
        assert n == model["counts"].get(k, 0) + data["counts"].get(k, 0)
    mem = out["memory"]
    assert mem["temp_bytes"] > 0 and mem["generated_code_bytes"] is None
    assert out["flops_global_jaxpr"] == out["flops_per_device"] * 8 > 0
    step, _ = dryrun.build_step("llama3.2-1b", shape, False, mode="gspmd",
                                mesh_override=SMALL_MESH)
    assert mem["argument_bytes"] == sum(
        sharding.shard_bytes(a, s, SMALL_MESH)
        for a, s in zip(step.args, step.arg_specs) if s is not None)
    if shape == "train_4k":
        # the exchange's entry is the plan's, as unpartitioned
        assert out["collective_bytes_per_device"][
            "data_parallel_exchange"] == float(step.plan.wire_bytes(4))
        assert data["counts"] and out["flops_global_jaxpr"] > \
            out["model_flops"]
    else:
        assert "data_parallel_exchange" not in out[
            "collective_bytes_per_device"]


@pytest.mark.parametrize("mesh_override", [SMALL_MESH, None],
                         ids=["4x2", "production"])
def test_transformer_big_train_partitioned(mesh_override):
    out = dryrun.run_dryrun("transformer-big", "train_4k", device="cpu",
                            mode="gspmd", mesh_override=mesh_override)
    n = 8 if mesh_override is not None else 256
    assert out["n_chips"] == n and out["mode"] == "dtensor"
    assert out["model_axis_collectives"]["total_bytes"] > 0
    assert out["data_axis_collectives"]["total_bytes"] > 0
    assert out["memory"]["temp_bytes"] > 0
    assert out["sharded_leaves"] > 0


def _one_block_prefill(monkeypatch, n_layers):
    cfg = get_config("llama3.2-1b").reduced().with_(n_layers=n_layers)
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    return dryrun.run_dryrun(
        "llama3.2-1b", InputShape("tiny_prefill", 16, 4, "prefill"),
        device="cpu", mode="gspmd",
        mesh_override=mesh.make_mesh((2, 2), ("data", "model")))


@pytest.mark.parametrize("n_layers", [1, 2])
def test_model_axis_collectives_follow_the_megatron_rules(monkeypatch,
                                                          n_layers):
    """The prefill step of a reduced llama3.2-1b (d 128, 4 heads, tied
    512 x 128 embedding) on a (2, 2) mesh, weights over ``model`` only.
    By the rules (launch/sharding.py): the embedding's d and the norm
    scales' d are split over ``model``; wq/wk/wv/w_gate/w_up are
    column-parallel, wo/w_down row-parallel.  So over ``model``:
      * all-gathers: each norm-scale leaf gathered whole once before
        the layers unstack (the stacked norm1 and norm2 of every block,
        and the final norm: 3 at any depth), and the looked-up rows of
        the d-split embedding (one, ``constrain_batch`` at the
        embedding);
      * all-reduces: the partial sums of each row-parallel product (wo,
        w_down: 2 a block), and of the tied head, which contracts the
        d that the table splits (1).
    Over ``data`` only the token ids cross (one all-gather of the int32
    ids: every data rank looks the whole batch up, ``layers.embed``);
    each then prefills its own batch."""
    out = _one_block_prefill(monkeypatch, n_layers)
    L = n_layers
    assert out["model_axis_collectives"]["counts"] == {
        "all_gather": 3 + 1, "all_reduce": 2 * L + 1}
    b, s, d, vocab = 4, 16, 128, 512
    assert out["data_axis_collectives"]["counts"] == {"all_gather": 1}
    assert out["data_axis_collectives"]["bytes"] == {"all_gather": b * s * 4}
    f32, local_b = 4, b // 2
    # each all-reduce moves one (local batch, s, d) residual, f32 in the
    # reduced config; the head's, the last position's logits
    assert out["model_axis_collectives"]["bytes"]["all_reduce"] == \
        2 * L * local_b * s * d * f32 + local_b * 1 * vocab * f32


def test_remat_lowers_temp_bytes(monkeypatch):
    cfg = get_config("llama3.2-1b").reduced()
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    shape = InputShape("tiny_train", 32, 8, "train")
    temp = {remat: dryrun.run_dryrun(
        "llama3.2-1b", shape, device="cpu", mode="gspmd", remat=remat,
        mesh_override=SMALL_MESH)["memory"]["temp_bytes"]
        for remat in (False, True)}
    assert 0 < temp[True] < temp[False]


def test_audit_gspmd_at_reference_defaults():
    out = dryrun.audit_exchange_gspmd(device="cpu")
    assert out["audit_mode"] == "dtensor" and out["n_workers"] == 8
    assert out["collectives_found"] and out["strategy"] == "dense_reduce"
    assert out["hlo_counts"] == out["comm_debug_counts"]
    assert out["hlo_ops"] == sum(out["hlo_counts"].values())
    assert out["collective_delta"] == out["hlo_ops"] - out["planned_hlo_ops"]
    assert out["hlo_wire_bytes"] == sum(out["hlo_bytes"].values()) > 0
    # a ring all-reduce of n bytes moves 2 (P - 1) / P x n
    assert out["wire_ratio"] == pytest.approx(2 * 7 / 8)
    for key in ("planned_n_collectives", "planned_wire_bytes",
                "predicted_comm_us", "cost_profile", "plan_table"):
        assert key in out


def test_constrain_batch_is_the_identity_on_plain_tensors():
    x = torch.randn(4, 3, 2)
    assert act.constrain_batch(x) is x
    with act.activation_sharding(("data",)):
        assert act.constrain_batch(x) is x
    assert act.logsumexp(x).equal(torch.logsumexp(x, dim=-1))
    assert act.split_heads(torch.randn(2, 3, 8), 2, 4).shape == (2, 3, 2, 4)


def test_constrain_batch_pins_a_dtensor():
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import partitioned as part
    spec = mesh.make_mesh((2, 2), ("data", "model"))
    with dryrun.fake_world(4):
        dm = mesh.device_mesh(spec, "cpu")
        x = part.as_dtensor(torch.empty(4, 8, 6, device="meta"), dm,
                            [Replicate(), Shard(2)])
        assert act.constrain_batch(x) is x        # no axes installed
        with act.activation_sharding(("data",)):
            y = act.constrain_batch(x)
            # a batch that does not divide over the data axes stays whole
            z = act.constrain_batch(part.as_dtensor(
                torch.empty(3, 8, device="meta"), dm, [Replicate(),
                                                       Shard(1)]))
    assert tuple(y.placements) == (Shard(0), Replicate())
    assert tuple(z.placements) == (Replicate(), Replicate())


def test_cli_runs_both_gspmd_flags(tmp_path, monkeypatch):
    cfg = get_config("transformer-big").reduced()
    monkeypatch.setattr(dryrun, "get_config", lambda arch: cfg)
    path = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "transformer-big", "--shape", "decode_32k",
                        "--mode", "gspmd", "--device", "cpu",
                        "--out", str(path)]) == 0
    out = json.loads(path.read_text())
    assert out["mode"] == "dtensor" and out["n_chips"] == 256
    assert out["model_axis_collectives"]["counts"]
    assert out["memory"]["temp_bytes"] > 0
    audit = tmp_path / "audit.json"
    assert dryrun.main(["--arch", "transformer-big", "--audit-exchange",
                        "--audit-mode", "gspmd", "--audit-workers", "4",
                        "--device", "cpu", "--out", str(audit)]) == 0
    a = json.loads(audit.read_text())
    assert a["audit_mode"] == "dtensor" and a["n_workers"] == 4


def test_cli_names_the_op_without_a_sharding(monkeypatch, capsys):
    def no_strategy(*args, **kwargs):
        raise NotImplementedError(
            "Operator aten.frobnicate.default does not have a sharding "
            "strategy registered.")
    monkeypatch.setattr(dryrun, "run_dryrun", no_strategy)
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                        "--mode", "gspmd", "--device", "cpu"]) == 1
    assert "aten.frobnicate.default" in capsys.readouterr().err
    with pytest.raises(NotImplementedError):      # unpartitioned: raised
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                     "--device", "cpu"])
