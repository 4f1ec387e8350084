#!/usr/bin/env python3
"""Where the kernel path and the plain path of full-width zamba2-7b part.

    python3 scripts/hybrid_drift.py [--tokens 4096] [--out FILE]

Needs one card.  Builds zamba2-7b (weights from seed 0) and runs the
prefill forward over the first ``--tokens`` tokens of the synthetic
pipeline four ways in bf16 (SSD scan and attention each by its kernel or
by the plain path: ``ssd_chunked`` and chunked attention), then, with the
weights cast to f32, kernel path and plain path.  For each variant it
prints the relative L2 difference of the residual stream from the plain
path's after every block (81 Mamba2 blocks and 13 uses of the shared
attention block, in order) and of the last position's logits.  A bug in
one block shows as a jump at that block; rounding shows as a smooth
growth from the first block that differs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", type=int, default=4096)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("hybrid_drift: needs a card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import get_config
    from repro_torch.data import make_pipeline
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models import ssm as S
    from repro_torch.models.model import _block, _unstack
    from repro_torch.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    model = build_model(get_config("zamba2-7b"))
    params = model.init(seed=0, device="cuda")
    tokens = torch.from_numpy(make_pipeline(model.cfg, 1, args.tokens)
                              .batch_at(0)["tokens"]).cuda()

    def run(model, params, ssd_route, attn_impl):
        cfg = model.cfg
        x = L.embed(params["embedding"], tokens)
        pos = torch.arange(x.shape[1], device=x.device)
        mamba = _unstack(params["mamba"])
        segments, trailing = model._segments()
        outs = []
        for seg in segments:
            for i in seg:
                x = x + S.mamba2_forward(mamba[i], cfg, x,
                                         ssd_route=ssd_route)
                outs.append(x.float())
            x, _ = _block(params["shared_attn"], cfg, x, pos, None, None,
                          None, attn_impl)
            outs.append(x.float())
        for i in trailing:
            x = x + S.mamba2_forward(mamba[i], cfg, x, ssd_route=ssd_route)
            outs.append(x.float())
        h = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return outs, model.head(params, h[:, -1:])[:, 0].float()

    def compare(tag, got, want):
        (go, gl), (wo, wl) = got, want
        line = {"variant": tag, "device": smi, "tokens": args.tokens,
                "logits_max_abs": (gl - wl).abs().max().item(),
                "logits_rel_l2": ((gl - wl).norm() / wl.norm()).item(),
                "per_block_rel_l2": [((a - b).norm() / b.norm()).item()
                                     for a, b in zip(go, wo)],
                "residual_rms_every_6th_block": [
                    b.square().mean().sqrt().item() for b in wo[::6]]}
        print(json.dumps(line), flush=True)
        return line

    lines = []
    with torch.no_grad():
        plain = run(model, params, "chunked", "chunked")
        for tag, ssd_route, attn_impl in (
                ("bf16 both kernels", "kernel", "kernel"),
                ("bf16 SSD kernel only", "kernel", "chunked"),
                ("bf16 attention kernel only", "chunked", "kernel"),
                ("bf16 plain again", "chunked", "chunked")):
            lines.append(compare(tag, run(model, params, ssd_route,
                                          attn_impl), plain))
        del plain
        f32 = build_model(model.cfg.with_(dtype="float32"))
        params = tree_map(lambda t: t.float(), params)
        torch.cuda.empty_cache()
        plain = run(f32, params, "chunked", "chunked")
        lines.append(compare("f32 both kernels",
                             run(f32, params, "kernel", "kernel"), plain))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
