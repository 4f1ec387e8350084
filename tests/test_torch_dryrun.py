"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU.

  * the counterpart of tests/test_dryrun.py::
    test_lower_and_compile_small_mesh: llama3.2-1b's train_4k and
    decode_32k steps on meta tensors on a (4, 2) mesh, costed under the
    "cpu" profile; the argument and output bytes are the exact per-device
    sums of the layouts, and only the train step has collective bytes
    (its data-parallel exchange: unpartitioned, no model-axis collective
    is dispatched, so the decode step has none; the partitioned mode is
    tests/test_torch_partitioned.py's);
  * the prefill step counts the same FLOPs through the attention kernel
    route as through the chunked one (on the CPU and on meta);
  * ``audit_exchange_plan`` in a fake world of 8: the comm layer's
    collective calls equal ``plan.hlo_collectives`` and the wire
    recorder's bytes ``plan.wire_bytes``, stage by stage, for the
    identity wire, int8 with error feedback, ``--wire-dtype bf16``,
    sparse_gather and ZeRO-1;
  * the CLI: ``--out``'s keys (the reference's, where they are not
    XLA's), ``--print-hlo`` refused by name, ``--tune`` delegated.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun, mesh, sharding   # noqa: E402
from repro_torch.tree import tree_flatten               # noqa: E402

SMALL_MESH = mesh.make_mesh((4, 2), ("data", "model"))


@pytest.fixture(scope="module")
def small_mesh_runs():
    return {shape: dryrun.run_dryrun("llama3.2-1b", shape, device="cpu",
                                     profile="cpu",
                                     mesh_override=SMALL_MESH)
            for shape in ("train_4k", "decode_32k")}


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_small_mesh_roofline(shape, small_mesh_runs):
    out = small_mesh_runs[shape]
    assert out["compute_s"] > 0 and out["memory_s"] > 0
    assert out["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert out["n_chips"] == 8 and out["mesh"] == [4, 2]
    assert out["flops_per_device"] == out["flops_global_jaxpr"] / 8
    assert out["product_flops_global"] > 0.9 * out["flops_global_jaxpr"]
    assert 0 < out["useful_flops_ratio"] <= 1
    assert out["memory"]["temp_bytes"] is None
    assert out["model_axis_collectives"] is None
    if shape == "train_4k":
        assert out["collective_total_bytes"] > 0
        # 6·N·D: the counted step adds attention's quadratic products
        assert out["flops_global_jaxpr"] > out["model_flops"]
    else:
        assert out["collective_total_bytes"] == 0


def test_argument_and_output_bytes_are_the_layouts_sums(small_mesh_runs):
    step, _ = dryrun.build_step("llama3.2-1b", "train_4k", False,
                                mesh_override=SMALL_MESH)
    params, opt_state, _, batch = step.args
    p_specs, o_specs, _, b_specs = step.arg_specs
    want = sum(sharding.shard_bytes(t, s, SMALL_MESH) for t, s in
               ((params, p_specs), (opt_state, o_specs), (batch, b_specs)))
    got = small_mesh_runs["train_4k"]["memory"]
    assert got["argument_bytes"] == want
    # the step returns params and optimizer state laid out as they came
    # in, and its scalar metrics replicated
    state = want - sharding.shard_bytes(batch, b_specs, SMALL_MESH)
    assert 0 < got["output_bytes"] - state < 64
    full = sum(t.numel() * t.element_size()
               for t in tree_flatten(params)[0])
    assert sharding.shard_bytes(params, p_specs, SMALL_MESH) < full / 4


def test_prefill_counts_the_same_flops_on_both_attention_routes():
    """The reduced transformer-big's prefill step on CPU tensors: the
    attention kernel's route (its plain version here, billed as
    ``chunked_attention``) counts the chunked route's FLOPs and bytes.
    (On the card the kernel's output is contiguous where the chunked
    route's is transposed, so there the next reshape copies only the
    latter's: the bytes differ, the FLOPs do not.)"""
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.launch import flops
    from repro_torch.models import build_model
    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    b, s = 1, 64
    batch = {k: torch.from_numpy(v).contiguous() for k, v in make_pipeline(
        cfg, b, s).batch_at(0).items() if k != "labels"}

    def prefill(impl):
        h = model.forward(params, batch, attn_impl=impl)
        return model.head(params, h[:, -1:])
    with torch.no_grad():
        kernel = flops.count_fn_flops(prefill, "kernel")
        chunked = flops.count_fn_flops(prefill, "chunked")
    assert kernel == chunked
    assert kernel["product_flops"] > 0


def test_prefill_dry_run_through_the_kernel_route():
    """On meta tensors the kernel route is the chunked one."""
    runs = {impl: dryrun.run_dryrun("transformer-big", "prefill_32k",
                                    device="cpu", attn_impl=impl,
                                    mesh_override=SMALL_MESH)
            for impl in ("chunked", "kernel")}
    for key in ("flops_global_jaxpr", "product_flops_global",
                "hbm_bytes_per_device"):
        assert runs["kernel"][key] == runs["chunked"][key]
    assert runs["kernel"]["compute_s"] is None        # no profile given


AUDITS = {
    "identity": {},
    "int8+ef": dict(codec="int8", error_feedback=True),
    "wire_bf16": dict(wire_dtype="bf16"),
    "sparse_gather": dict(sparse_as_dense=False),
    "zero1": dict(zero1=True),
}


@pytest.mark.parametrize("name", list(AUDITS))
def test_audit_exchange_plan_in_a_fake_world(name):
    out = dryrun.audit_exchange_plan(n_workers=8, device="cpu",
                                     **AUDITS[name])
    assert out["audit_mode"] == "fake_pg" and out["n_workers"] == 8
    assert out["counts_match"] is True
    assert out["hlo_ops"] == out["planned_hlo_ops"] > 0
    assert out["hlo_wire_bytes"] == out["planned_wire_bytes"] > 0
    assert out["wire_ratio"] == 1.0 and out["stage_wire_exact"] is True
    assert out["schedule"]["stage_sum_matches_fused"] is True
    if name == "int8+ef":
        assert out["stateful"] and out["codec_state_bytes"] > 0
    if name == "sparse_gather":
        assert out["hlo_counts"].get("all_gather_dense", 0) > 0


def test_cli_out_keys(tmp_path, capsys):
    path = tmp_path / "dry.json"
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--device", "cpu", "--profile", "tpu",
                        "--out", str(path)]) == 0
    out = json.loads(path.read_text())
    for key in ("arch", "shape", "mesh", "axes", "flops_global_jaxpr",
                "flops_per_device", "hbm_bytes_per_device",
                "collective_bytes_per_device", "collective_total_bytes",
                "compute_s", "memory_s", "collective_s", "dominant",
                "memory", "n_chips", "n_params", "n_active", "model_flops",
                "useful_flops_ratio", "fsdp", "moe_decode", "loss_chunk"):
        assert key in out, key
    assert set(out["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "generated_code_bytes"}
    assert out["n_chips"] == 256 and out["roofline_profile"] == "tpu"
    audit = tmp_path / "audit.json"
    assert dryrun.main(["--arch", "transformer-big", "--audit-exchange",
                        "--audit-workers", "4", "--device", "cpu",
                        "--out", str(audit)]) == 0
    a = json.loads(audit.read_text())
    for key in ("counts_match", "planned_n_collectives", "planned_hlo_ops",
                "hlo_ops", "planned_wire_bytes", "hlo_wire_bytes",
                "wire_ratio", "schedule", "strategy", "cost_profile"):
        assert key in a, key
    # --mode gspmd and --audit-mode gspmd run (tests/test_torch_
    # partitioned.py); only XLA's HLO printout is refused by name
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                        "--print-hlo"]) == 2
    assert "not ported" in capsys.readouterr().err


def test_cli_tune_delegates(monkeypatch):
    from repro_torch.launch import tune
    seen = []
    monkeypatch.setattr(tune, "main", lambda argv: seen.append(argv) or 0)
    assert dryrun.main(["--arch", "transformer-big", "--tune",
                        "--audit-workers", "1", "--trials", "2",
                        "--device", "cpu"]) == 0
    assert seen == [["--arch", "transformer-big", "--audit-workers", "1",
                     "--profile", "ethernet", "--trials", "2", "--top-k",
                     "5", "--device", "cpu"]]
