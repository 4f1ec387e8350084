"""How far the hybrid parity tests' quantities move with the host's CPU.

    PYTHONPATH=src python tests/_torch_host_noise.py [--configs a,b]
        [--out FILE]

For each configuration of ``scripts/host_sweep_torch.py`` (``native``,
``aten_avx2``, ``aten_default``, ``xla_avx2``, ``both_sse``, ``one_cpu``)
a child process computes, from the tests' own fixtures and inputs, what
``tests/test_torch_hybrid.py::test_forward_matches_reference`` and
``tests/test_torch_hybrid_decode.py::test_prefill_and_decode_match_reference``
compare: the reference's outputs and the port's.  The parent prints one
JSON line a quantity:

- ``ref_spread``: the largest |a - b| between the reference's outputs in
  any two configurations (the reference's own host noise; the two are
  ``ref_spread_between``), and
  ``ref_spread_ratio``: the largest |a - b| / (1 + |b|), the rtol = atol
  under which any two of them agree;
- ``port_spread``: the same for the port;
- ``port_vs_ref``: the largest |port - reference| in each configuration,
  and ``ratio``: the largest |port - ref| / (1 + |ref|), the rtol = atol
  that the comparison needs there.

A test's rtol = atol bound lies inside the reference's host noise when
it is below twice ``ref_spread``.  The child imports the test modules,
so this file lives beside them; it imports both packages, as the tests
do.
Takes a few minutes (``one_cpu`` the longest).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_sweep():
    """``scripts/host_sweep_torch.py`` as a module (its ``CONFIGS``,
    ``config_env`` and ``config_argv``)."""
    spec = importlib.util.spec_from_file_location(
        "host_sweep_torch", os.path.join(ROOT, "scripts",
                                         "host_sweep_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def quantities() -> dict:
    """name -> (port, reference) numpy arrays, as the two tests make
    them."""
    sys.path.insert(0, HERE)
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    import test_torch_hybrid as H
    import test_torch_hybrid_decode as HD

    out = {}
    for variant, n_layers in (("models", None), ("models5", 5)):
        jmodel, jparams, tmodel, tparams = H._build(n_layers)
        for seq in (40, 64):
            toks = H._tokens(tmodel.cfg, s=seq, seed=seq)
            jh = jmodel.forward(jparams, {"tokens": jnp.asarray(toks)},
                                attn_impl="pallas")[0]
            jlg = jmodel.head(jparams, jh[:, -1:])
            for impl in ("chunked", "kernel"):
                with torch.no_grad():
                    h = tmodel.forward(tparams, {"tokens": H._t(toks)},
                                       attn_impl=impl)
                    lg = tmodel.head(tparams, h[:, -1:])
                key = f"forward/{variant}/{seq}/{impl}"
                out[key + "/h"] = (H._np(h), H._np(jh))
                out[key + "/logits"] = (H._np(lg), H._np(jlg))

        toks = HD._tokens(tmodel.cfg, s=10, seed=3)
        jstep = jax.jit(lambda p, c, t: jmodel.decode_step(p, c, t))
        jlast, jcache = jax.jit(lambda p, c, t: jmodel.prefill(p, c, t))(
            jparams, jmodel.init_cache(2, 12), jnp.asarray(toks[:, :6]))
        cache = tmodel.init_cache(2, 12, device="cpu")
        last, cache = tmodel.prefill(tparams, cache, HD._t(toks[:, :6]),
                                     attn_impl="kernel")
        key = f"decode/{variant}"
        out[key + "/prefill"] = (HD._np(last), HD._np(jlast))
        for i in range(6, 10):
            jlg, jcache = jstep(jparams, jcache,
                                jnp.asarray(toks[:, i:i + 1]))
            lg, cache = tmodel.decode_step(tparams, cache,
                                           HD._t(toks[:, i:i + 1]))
            out[f"{key}/step{i}"] = (HD._np(lg), HD._np(jlg))
        for part, names in (("mamba", ("conv_x", "conv_bc", "ssm")),
                            ("attn", ("k", "v"))):
            for name in names:
                out[f"{key}/cache_{name}"] = (
                    HD._np(cache[part][name]), HD._np(jcache[part][name]))
    return {k: (np.asarray(a), np.asarray(b)) for k, (a, b) in out.items()}


def child(path: str) -> None:
    import numpy as np
    arrays = {}
    for key, (port, ref) in quantities().items():
        arrays[key + "#port"] = port
        arrays[key + "#ref"] = ref
    np.savez(path, **arrays)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default=None,
                    help="comma-separated configurations (default: all)")
    ap.add_argument("--out", default=None, help="write the table as JSON")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        child(args.child)
        return 0
    import numpy as np
    sweep = load_sweep()
    names = (args.configs.split(",") if args.configs else list(sweep.CONFIGS))
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            path = os.path.join(tmp, f"{name}.npz")
            proc = subprocess.run(
                sweep.config_argv(name, [sys.executable, __file__, "--child",
                                         path]),
                env=sweep.config_env(name), cwd=ROOT, capture_output=True,
                text=True)
            if proc.returncode:
                print(f"{name}: child failed\n{proc.stderr[-3000:]}",
                      file=sys.stderr)
                return 1
            with np.load(path) as z:
                runs[name] = {k: z[k].astype(np.float64) for k in z.files}
    keys = sorted({k.rsplit("#", 1)[0] for k in runs[names[0]]})
    rows = []
    for key in keys:
        refs = np.stack([runs[n][key + "#ref"] for n in names])
        ports = np.stack([runs[n][key + "#port"] for n in names])
        pairs = [(float(np.abs(refs[i] - refs[j]).max()),
                  float((np.abs(refs[i] - refs[j])
                         / (1.0 + np.abs(refs[j]))).max()), names[i], names[j])
                 for i in range(len(names)) for j in range(len(names))]
        widest = max(pairs)
        row = {"quantity": key, "ref_spread": widest[0],
               "ref_spread_between": widest[2:],
               "ref_spread_ratio": max(p[1] for p in pairs),
               "port_spread": float((ports.max(0) - ports.min(0)).max()),
               "max_abs_ref": float(np.abs(refs).max()),
               "port_vs_ref": {}, "ratio": {}}
        for i, n in enumerate(names):
            d = np.abs(ports[i] - refs[i])
            row["port_vs_ref"][n] = float(d.max())
            row["ratio"][n] = float((d / (1.0 + np.abs(refs[i]))).max())
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {"configs": names,
               "ref_spread": max(r["ref_spread"] for r in rows),
               "ref_spread_ratio": max(r["ref_spread_ratio"] for r in rows),
               "port_vs_ref": max(max(r["port_vs_ref"].values())
                                  for r in rows)}
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
