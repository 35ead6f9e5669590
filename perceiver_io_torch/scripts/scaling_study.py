"""Scaling-law mini-study: a ladder of Perceiver AR byte CLMs on the
python-source corpus, each run's validation curve as a CSV, then the
compute-optimal frontier and its power-law fits.

Port of ``perceiver_io_tpu/scripts/scaling_study.py``. Each rung trains
through ``scripts/convergence.py``'s ``_fit`` on the in-image python-source
corpus (``data/text/synthetic.py``'s ``python_source_corpus``) and exports
``(step, tokens, train_flops, val_loss)``; ``refit`` takes, at every
recorded FLOPs budget, the size with the lowest interpolated validation
loss and fits ``training/scaling.py``'s laws to those points (Chinchilla
"Approach 1" in shape; with four rungs a demonstration of the whole
pipeline, re-fittable from the written files).

    python3 -m perceiver_io_torch.scripts.scaling_study [--out convergence_torch/scaling] [--device cpu]
    python3 -m perceiver_io_torch.scripts.scaling_study --refit convergence_torch/scaling

Training runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import csv
import json
import os

import numpy as np

from perceiver_io_torch.training.scaling import bootstrap_exponents, fit_scaling_law, fit_scaling_law_free

# (name, num_channels, num_layers): a ~16x parameter range. seq/latents/batch
# stay fixed so token throughput per step is constant across the ladder and
# FLOPs differences come from model size alone.
LADDER = (
    ("xs", 48, 1),
    ("s", 80, 2),
    ("m", 128, 2),
    ("l", 192, 3),
)
SEQ_LEN = 256
BATCH = 8


def _run_one(name: str, channels: int, layers: int, steps: int, out_dir: str, device=None) -> dict:
    """Train one rung for ``steps`` steps (``_fit``'s schedule, lr 2e-3,
    warmup at most 100, 12 evals) on ``min(steps, 3000)`` batches of the
    corpus and 150k validation tokens; write ``run_<name>.csv`` and return
    the rung's record for ``runs.json``."""
    from perceiver_io_torch.data.text.synthetic import SyntheticTextDataModule
    from perceiver_io_torch.models.core.config import CausalSequenceModelConfig
    from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
    from perceiver_io_torch.scripts.convergence import _causal_lm_steps, _fit
    from perceiver_io_torch.training.flops import PerceiverARFlops

    data = SyntheticTextDataModule(
        source="python_source", seq_len=SEQ_LEN, batch_size=BATCH,
        n_train_tokens=min(steps, 3000) * BATCH * SEQ_LEN, n_val_tokens=150_000,
    )
    data.setup()
    config = CausalSequenceModelConfig(
        vocab_size=data.effective_vocab_size, max_seq_len=SEQ_LEN,
        max_latents=SEQ_LEN // 2, num_channels=channels, num_heads=max(channels // 32, 2),
        num_self_attention_layers=layers, cross_attention_dropout=0.0,
    )
    model = CausalSequenceModel(config, device=device, seed=0)
    history, n_params = _fit(model, data, steps, lr=2e-3, monitor="loss", monitor_mode="min", warmup_cap=100,
                             **_causal_lm_steps(config.max_latents))

    flops_per_step = PerceiverARFlops(config, SEQ_LEN).train_flops_per_step(BATCH)
    rows = []
    for h in history:
        if "val_loss" in h:
            step = int(h["step"])
            rows.append({
                "step": step,
                "tokens": step * BATCH * SEQ_LEN,
                "train_flops": step * flops_per_step,
                "val_loss": float(h["val_loss"]),
            })
    csv_path = os.path.join(out_dir, f"run_{name}.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["step", "tokens", "train_flops", "val_loss"])
        w.writeheader()
        w.writerows(rows)
    return {"name": name, "params": int(n_params), "channels": channels, "layers": layers,
            "flops_per_step": flops_per_step, "csv": os.path.basename(csv_path),
            "best_val_loss": min(r["val_loss"] for r in rows) if rows else None}


def refit(out_dir: str) -> dict:
    """Re-derive the compute-optimal frontier and the law from ``out_dir``'s
    ``runs.json`` and CSVs, write them to ``out_dir/law.json`` and return
    them; no training."""

    with open(os.path.join(out_dir, "runs.json")) as f:
        runs = json.load(f)
    curves = {}
    for run in runs:
        with open(os.path.join(out_dir, run["csv"])) as f:
            curves[run["name"]] = [
                {k: float(v) for k, v in row.items()} for row in csv.DictReader(f)
            ]

    # frontier: at each recorded FLOPs budget, the (size, tokens) achieving the
    # lowest interpolated val loss
    budgets = sorted({r["train_flops"] for rows in curves.values() for r in rows})
    frontier = []
    for c in budgets:
        best = None
        for run in runs:
            rows = curves[run["name"]]
            if not rows:  # header-only CSV (run recorded no eval points)
                continue
            xs = [r["train_flops"] for r in rows]
            if c < xs[0] or c > xs[-1]:
                continue  # only budgets inside this run's observed range
            loss = float(np.interp(c, xs, [r["val_loss"] for r in rows]))
            tokens = float(np.interp(c, xs, [r["tokens"] for r in rows]))
            if best is None or loss < best["val_loss"]:
                best = {"train_flops": c, "val_loss": loss, "params": run["params"],
                        "tokens": tokens, "size": run["name"]}
        if best is not None:
            frontier.append(best)

    # identification analysis: a frontier point is INTERIOR when >= 2 runs'
    # observed FLOPs ranges cover its budget and the winner is NOT the largest
    # covering model — those points (not range endpoints) pin the exponent
    ranges = {}
    for run in runs:
        rows = curves[run["name"]]
        if rows:
            ranges[run["name"]] = (rows[0]["train_flops"], rows[-1]["train_flops"], run["params"])
    interior = []
    for p in frontier:
        covering = [n for n, (lo, hi, _) in ranges.items() if lo <= p["train_flops"] <= hi]
        if len(covering) >= 2 and p["params"] < max(ranges[n][2] for n in covering):
            interior.append({**p, "competing": covering})

    cols = ([p["train_flops"] for p in frontier], [p["params"] for p in frontier],
            [p["tokens"] for p in frontier])
    law_assumed = fit_scaling_law(*cols)
    law_free = fit_scaling_law_free(*cols)
    cis = bootstrap_exponents(*cols)

    def _in_ci(ci, x):
        return None if ci is None else bool(ci[0] <= x <= ci[1])

    result = {
        "frontier": frontier,
        # the headline: exponents fitted from the frontier (Approach-1
        # style), their uncertainty in the bootstrap CIs below
        "law_free": {"a": law_free.a, "b": law_free.b, "k_n": law_free.k_n, "k_d": law_free.k_d},
        "law_free_str": str(law_free),
        "exponent_ci95": cis,
        # coefficients under assumed C^0.5 exponents (Chinchilla Approach-2
        # style): a prior from the literature, not a finding of this study;
        # prior_supported_by_data records whether each assumed exponent
        # falls inside the free fit's bootstrap CI
        "law_assumed_prior": {"a": law_assumed.a, "b": law_assumed.b,
                              "k_n": law_assumed.k_n, "k_d": law_assumed.k_d},
        "law_assumed_prior_str": str(law_assumed),
        "prior_supported_by_data": {
            "a_0.5_in_ci95": _in_ci(cis.get("a_ci95"), law_assumed.a),
            "b_0.5_in_ci95": _in_ci(cis.get("b_ci95"), law_assumed.b),
        },
        "interior_points": interior,
        "n_interior_points": len(interior),
        "identification_note": (
            "exponents are identified by interior frontier points (budgets where a "
            "smaller model beats larger ones whose observed range also covers the "
            "budget); points outside every smaller model's range are extrapolation"
        ),
    }
    with open(os.path.join(out_dir, "law.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(str(law_free))
    print(f"exponent 95% CIs: a {cis['a_ci95']}, b {cis['b_ci95']}; "
          f"{len(interior)} interior frontier points")
    return result


def _write_readme(out_dir: str, runs: list) -> None:
    lines = [
        "# Scaling-law mini-study (PyTorch port)",
        "",
        "Trained by `perceiver_io_torch` on the python-source byte corpus, with no",
        "network access; the method is `perceiver_io_torch/scripts/scaling_study.py`",
        "(per-run validation CSVs and laws fitted by `training/scaling.py`).",
        "",
        "| run | params | channels | layers | best val loss (nats/byte) |",
        "|-----|--------|----------|--------|---------------------------|",
    ]
    for r in runs:
        best = "n/a" if r["best_val_loss"] is None else f"{r['best_val_loss']:.4f}"
        lines.append(f"| {r['name']} | {r['params']:,} | {r['channels']} | {r['layers']} | {best} |")
    lines += [
        "",
        "Re-fit the law from these CSVs (no training needed):",
        "",
        "```",
        f"python3 -m perceiver_io_torch.scripts.scaling_study --refit {out_dir}",
        "```",
        "",
        "`law.json` leads with `law_free`: exponents estimated from the",
        "frontier, with bootstrap 95% CIs in `exponent_ci95`; that is the",
        "study's finding. `law_assumed_prior` (coefficients under assumed",
        "C^0.5 exponents, Chinchilla Approach-2 style) is a prior from the",
        "literature, kept for comparison; `prior_supported_by_data` records",
        "whether each assumed exponent falls inside the free fit's CI.",
        "`interior_points` lists the frontier points that identify the",
        "exponent: budgets where a smaller model beats larger ones whose",
        "observed FLOPs range also covers the budget. Extend the cheap rungs",
        "(`--only xs,s --steps N`) to widen the overlap.",
    ]
    with open(os.path.join(out_dir, "README.md"), "w") as f:
        f.write("\n".join(lines) + "\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="convergence_torch/scaling")
    ap.add_argument("--steps", type=int, default=1200, help="training steps per ladder run")
    ap.add_argument("--device", default=None, help="the card by default")
    ap.add_argument("--refit", metavar="DIR", help="only re-fit the law from DIR's CSVs")
    ap.add_argument("--only", help="comma-separated rung names to (re)run, merging into the "
                                  "existing runs.json, e.g. --only xs,s --steps 9600 extends "
                                  "the cheap rungs so their FLOPs ranges overlap the large ones")
    args = ap.parse_args(argv)

    if args.refit:
        refit(args.refit)
        return

    os.makedirs(args.out, exist_ok=True)
    selected = set(args.only.split(",")) if args.only else {n for n, _, _ in LADDER}
    unknown = selected - {n for n, _, _ in LADDER}
    if unknown:
        raise SystemExit(f"unknown ladder rungs {sorted(unknown)}; expected from {[n for n, _, _ in LADDER]}")
    runs_path = os.path.join(args.out, "runs.json")
    runs = []
    if args.only and os.path.exists(runs_path):
        with open(runs_path) as f:
            runs = [r for r in json.load(f) if r["name"] not in selected]
    for name, channels, layers in LADDER:
        if name not in selected:
            continue
        print(json.dumps({"scaling_run": name, "channels": channels, "layers": layers, "steps": args.steps}))
        runs.append(_run_one(name, channels, layers, args.steps, args.out, args.device))
        runs.sort(key=lambda r: r["params"])
        with open(runs_path, "w") as f:
            json.dump(runs, f, indent=1)
    _write_readme(args.out, runs)
    refit(args.out)


if __name__ == "__main__":
    main()
