"""How stable the fault smoke's setup is at a given lr, in both packages.

    PYTHONPATH=src:tests python tests/elastic_lr_sweep.py --lr 0.05 \
        --seeds 32 --twin 17 --out sweep.json

The fault smoke's clean elastic run (the smoke llama3.2-1b at vocab 64,
d_ff 128, 2 layers, fp32; 4 workers of 4 sequences of 16 tokens;
``easgd`` tau 4, alpha 0.5, on ``ar``, quorum 2; momentum SGD without
weight decay; 48 steps) from each of ``--seeds`` initial draws, on the
CPU, as a 2 x 2: JAX's ``elastic_train`` (4 forced host devices, in its
own subprocess) and the port's (4 gloo slot processes), each from JAX's
draw and from the port's draw of every seed. For the seeds in ``--twin``
JAX also runs from the port's draw nudged by one ulp: how far fp32
rounding alone carries the run. Then the two packages' init
distributions: a two-sample KS test of every leaf's values and a
Mann-Whitney test of its spectral norm over the draws.

Prints each run's first, largest and last loss, and a line a cell of
the 2 x 2: how many runs spike (largest loss above 1.1 x the first) and
how many end above 2. This is a study, not a test: pytest does not
collect it. About 20 minutes at 32 seeds.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SMOKE = dict(vocab_size=64, d_ff=128, num_layers=2, dtype="float32")

_JAX = r"""
import json, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from repro.configs import get_smoke_config
from repro.data.synthetic import LMTokenSource
from repro.fault.elastic import elastic_train
from repro.models import build_model
from repro.optim import constant, sgd_momentum
from repro.train.engine import TrainPlan
from elastic_lr_sweep import SMOKE, summary

out, lr, seeds, twins = sys.argv[1], float(sys.argv[2]), int(sys.argv[3]), \
    json.loads(sys.argv[4])
model = build_model(get_smoke_config("llama3.2-1b").with_overrides(**SMOKE))
src = LMTokenSource(64, 16, seed=0)
plan = TrainPlan(algo="easgd", tau=4, alpha=0.5, exchanger="ar", quorum=2)


def run(p0, seed):
    m = dataclasses.replace(model, init=lambda key: p0)
    _, r = elastic_train(m, sgd_momentum(weight_decay=0.0), constant(lr),
                         lambda step, k: src.batch(4 * k, step), plan=plan,
                         num_workers=4, num_steps=48, seed=seed,
                         print_fn=None, devices=jax.devices()[:4])
    return summary(r.losses)


def stack(tmpl, layers):
    # the port's per-layer trees -> JAX's stacked segment
    if isinstance(tmpl, dict):
        return {k: stack(v, [l[k] for l in layers]) for k, v in tmpl.items()}
    if isinstance(tmpl, (list, tuple)):
        return [stack(v, [l[i] for l in layers]) for i, v in enumerate(tmpl)]
    out = np.stack(layers)
    assert out.shape == tmpl.shape, (out.shape, tmpl.shape)
    return jnp.asarray(out)


res = {}
for s in range(seeds):
    jd = model.init(jax.random.key(s))
    with open(os.path.join(out, f"jax_draw{s}.pkl"), "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, jd), f)
    with open(os.path.join(out, f"port_draw{s}.pkl"), "rb") as f:
        pd = pickle.load(f)
    assert len(jd["blocks"]) == 1
    pj = {k: jnp.asarray(v) for k, v in pd.items() if k != "layers"}
    pj["blocks"] = [stack(jd["blocks"][0], pd["layers"])]
    res[f"jax_loop/jax_draw/{s}"] = run(jd, s)
    res[f"jax_loop/port_draw/{s}"] = run(pj, s)
    if s in twins:
        res[f"jax_loop/port_draw_ulp/{s}"] = run(jax.tree.map(
            lambda x: jnp.nextafter(x, jnp.inf), pj), s)
    print(s, {k: v for k, v in res.items() if k.endswith(f"/{s}")},
          flush=True)
with open(os.path.join(out, "jax.json"), "w") as f:
    json.dump(res, f)
"""


def summary(losses) -> dict:
    x = np.asarray(losses, dtype=np.float64)
    return {"first": float(x[0]), "max": float(np.nanmax(x))
            if np.isfinite(x).any() else float("nan"),
            "final": float(x[-1]), "losses": [float(v) for v in x]}


def _smoke_models():
    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    return build_model(get_smoke_config("llama3.2-1b").with_overrides(
        **SMOKE), torch.device("cpu"))


def _port_rank(rank, k, out, lr, seeds):
    """One of the 4 gloo slots: the port's clean run from both draws of
    every seed (JAX's draws are read from the JAX subprocess's files)."""
    import dataclasses

    import torch

    from repro_torch.bridge import decoder_params_from_jax
    from repro_torch.fault.elastic import elastic_train
    from repro_torch.fault.smoke import smoke_setup
    from repro_torch.optim import constant
    from repro_torch.train.engine import TrainPlan
    from repro_torch.tree import tree_map

    model, opt, _, batch_fn = smoke_setup(torch.device("cpu"))
    plan = TrainPlan(algo="easgd", tau=4, alpha=0.5, exchanger="ar",
                     quorum=2)
    res = {}
    for s in range(seeds):
        with open(os.path.join(out, f"jax_draw{s}.pkl"), "rb") as f:
            jd = decoder_params_from_jax(pickle.load(f))
        for draw, m in (
                ("port_draw", model),
                ("jax_draw", dataclasses.replace(
                    model, init=lambda *a, p=jd: tree_map(torch.clone, p)))):
            _, r = elastic_train(m, opt, constant(lr), batch_fn, plan=plan,
                                 num_workers=4, num_steps=48, seed=s,
                                 print_fn=None)
            res[f"port_loop/{draw}/{s}"] = summary(r.losses)
    if rank == 0:
        with open(os.path.join(out, "port.json"), "w") as f:
            json.dump(res, f)


def init_distributions(out: str, seeds: int) -> list:
    """Per leaf with spread: the KS p of its values and the Mann-Whitney p
    of its spectral norm, JAX's draws against the port's."""
    from scipy import stats

    import torch

    from repro_torch.bridge import decoder_params_from_jax
    from repro_torch.tree import leaves

    def jax_draw(s):
        with open(os.path.join(out, f"jax_draw{s}.pkl"), "rb") as f:
            return [t.numpy() for t in leaves(decoder_params_from_jax(
                pickle.load(f)))]

    J = [jax_draw(s) for s in range(seeds)]
    model = _smoke_models()
    P = [[t.numpy() for t in leaves(model.init(
        torch.Generator().manual_seed(s)))] for s in range(seeds)]
    rows = []
    for i, leaf in enumerate(J[0]):
        if leaf.std() == 0:
            continue
        ks = stats.ks_2samp(np.concatenate([d[i].ravel() for d in J]),
                            np.concatenate([d[i].ravel() for d in P]))
        norm = lambda d: np.linalg.norm(d[i].reshape(d[i].shape[0], -1), 2)
        mw = stats.mannwhitneyu([norm(d) for d in J], [norm(d) for d in P])
        rows.append(dict(leaf=i, shape=list(leaf.shape),
                         ks_p=float(ks.pvalue), spectral_p=float(mw.pvalue)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--seeds", type=int, default=32)
    ap.add_argument("--twin", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None, help="a JSON of every run")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.launch.train import run_ranks
    from repro_torch.tree import tree_map

    with tempfile.TemporaryDirectory() as td:
        model = _smoke_models()
        for s in range(args.seeds):
            p = model.init(torch.Generator().manual_seed(s))
            with open(os.path.join(td, f"port_draw{s}.pkl"), "wb") as f:
                pickle.dump(tree_map(lambda t: t.numpy(), p), f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(ROOT / "src"), str(ROOT / "tests")]))
        subprocess.run([sys.executable, "-c", _JAX, td, str(args.lr),
                        str(args.seeds), json.dumps(args.twin)], env=env,
                       check=True)
        run_ranks(_port_rank, 4, (td, args.lr, args.seeds))
        res = {**json.load(open(os.path.join(td, "jax.json"))),
               **json.load(open(os.path.join(td, "port.json")))}
        dists = init_distributions(td, args.seeds)
    print(f"lr {args.lr}, {args.seeds} seeds, 48 steps:")
    for cell in ("jax_loop/jax_draw", "jax_loop/port_draw",
                 "port_loop/jax_draw", "port_loop/port_draw"):
        runs = {int(k.rsplit("/", 1)[1]): v for k, v in res.items()
                if k.rsplit("/", 1)[0] == cell}
        spike = sorted(s for s, v in runs.items()
                       if not v["max"] <= 1.1 * v["first"])
        high = sorted(s for s, v in runs.items() if not v["final"] <= 2.0)
        print(f"  {cell}: spike {len(spike)}/{len(runs)} {spike}; "
              f"final > 2 {len(high)}/{len(runs)} {high}; finals "
              + json.dumps({s: round(runs[s]["final"], 4)
                            for s in sorted(runs)}))
    for k, v in sorted(res.items()):
        if "ulp" in k:
            print(f"  {k}: max {v['max']:.4f} final {v['final']:.4f}")
    print("init distributions, JAX's draws vs the port's (p values): "
          + json.dumps([(r["leaf"], round(r["ks_p"], 3),
                         round(r["spectral_p"], 3)) for r in dists]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"runs": res, "init": dists}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
