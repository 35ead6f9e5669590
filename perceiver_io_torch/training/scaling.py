"""Chinchilla-style scaling-law fitting for Perceiver AR (numpy only).

Port of ``perceiver_io_tpu/training/scaling.py``: with the exponent fixed,
the linear-space least-squares coefficient has a closed form (the objective
scipy's ``curve_fit`` minimises; linear-space residuals weight the
largest-compute runs most), and with the exponent free a log-log linear
regression. With ``training.flops.PerceiverARFlops`` it serves the scaling
study (``scripts/scaling_study.py``): FLOPs per run, the fits
N_opt = k_n * C^a and D_opt = k_d * C^b over the frontier, and their
bootstrap intervals.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np


@dataclass
class ScalingLaw:
    a: float
    b: float
    k_n: float
    k_d: float

    def n_opt(self, flops) -> np.ndarray:
        """Compute-optimal parameter count at a FLOPs budget."""
        return self.k_n * np.asarray(flops, float) ** self.a

    def d_opt(self, flops) -> np.ndarray:
        """Compute-optimal training-token count at a FLOPs budget."""
        return self.k_d * np.asarray(flops, float) ** self.b

    def __str__(self):
        return f"N_opt = {self.k_n:.4f} * C ** {self.a:.2f}\nD_opt = {self.k_d:.4f} * C ** {self.b:.2f}"


def fit_power_law(xs: Sequence[float], ys: Sequence[float], m: float) -> float:
    """Least-squares fit of k in y = k * x**m (fixed exponent m): the minimizer
    of sum (y - k x^m)^2 is k = sum(y x^m) / sum(x^2m)."""
    xs = np.asarray(xs, float) ** m
    ys = np.asarray(ys, float)
    return float((ys * xs).sum() / (xs * xs).sum())


def fit_scaling_law(
    flops_arr: Sequence[float],
    params_arr: Sequence[float],
    tokens_arr: Sequence[float],
    a: float = 0.5,
    b: float = 0.5,
) -> ScalingLaw:
    """Fit compute-optimal coefficients from observed (FLOPs, params, tokens)
    triples of IsoFLOP-optimal runs; ``a``/``b`` are the assumed exponents
    (0.5/0.5 = Chinchilla Approach-2 defaults)."""
    return ScalingLaw(
        a=a,
        b=b,
        k_n=fit_power_law(flops_arr, params_arr, m=a),
        k_d=fit_power_law(flops_arr, tokens_arr, m=b),
    )


def fit_power_law_free(xs: Sequence[float], ys: Sequence[float]) -> tuple:
    """Log-log least squares of y = k * x**m with the EXPONENT free: returns
    (k, m). This is Chinchilla Approach-1 style estimation (the reference's
    laws.py fits with scipy curve_fit; in log space the same objective is an
    ordinary linear regression, scipy-free)."""
    lx = np.log(np.asarray(xs, float))
    ly = np.log(np.asarray(ys, float))
    m, c = np.polyfit(lx, ly, 1)
    return float(np.exp(c)), float(m)


def fit_scaling_law_free(
    flops_arr: Sequence[float],
    params_arr: Sequence[float],
    tokens_arr: Sequence[float],
) -> ScalingLaw:
    """``fit_scaling_law`` with the exponents ESTIMATED from the frontier
    rather than assumed — the honest headline when the data identify them."""
    k_n, a = fit_power_law_free(flops_arr, params_arr)
    k_d, b = fit_power_law_free(flops_arr, tokens_arr)
    return ScalingLaw(a=a, b=b, k_n=k_n, k_d=k_d)


def bootstrap_exponents(
    flops_arr: Sequence[float],
    params_arr: Sequence[float],
    tokens_arr: Sequence[float],
    n_boot: int = 2000,
    seed: int = 0,
) -> dict:
    """Percentile 95% CIs for the freely-fitted exponents, bootstrapped over
    frontier points. Wide intervals are the point: they record how weakly a
    small ladder identifies the exponent instead of overstating a clean 0.50."""
    flops = np.asarray(flops_arr, float)
    params = np.asarray(params_arr, float)
    tokens = np.asarray(tokens_arr, float)
    rng = np.random.default_rng(seed)
    n = len(flops)
    a_s, b_s = [], []
    for _ in range(n_boot):
        idx = rng.integers(0, n, n)
        if np.unique(flops[idx]).size < 2:
            continue  # degenerate resample: exponent unidentifiable
        _, a = fit_power_law_free(flops[idx], params[idx])
        _, b = fit_power_law_free(flops[idx], tokens[idx])
        a_s.append(a)
        b_s.append(b)
    if not a_s:
        # every resample was degenerate (single frontier point or a single
        # distinct FLOPs value): the exponent is unidentifiable, which is an
        # answer, not an error — keep --refit runnable on minimal ladders
        return {"a_ci95": None, "b_ci95": None, "n_boot_effective": 0,
                "note": "exponent unidentifiable: fewer than 2 distinct "
                        "train-FLOPs values on the frontier"}
    lo, hi = 2.5, 97.5
    return {
        "a_ci95": [float(np.percentile(a_s, lo)), float(np.percentile(a_s, hi))],
        "b_ci95": [float(np.percentile(b_s, lo)), float(np.percentile(b_s, hi))],
        "n_boot_effective": len(a_s),
    }
