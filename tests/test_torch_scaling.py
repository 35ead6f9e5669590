"""Port parity: the scaling-law fits (``training/scaling.py``) and the
scaling study (``scripts/scaling_study.py``) against the JAX package's on
the same inputs."""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch

import perceiver_io_torch.scripts.scaling_study as tstudy
import perceiver_io_torch.training.scaling as tsc
import perceiver_io_tpu.scripts.scaling_study as jstudy
import perceiver_io_tpu.training.scaling as jsc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """This file's runs are as fast on two intra-op threads as on all of
    them, and fewer threads leave the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _frontier(seed, n=7, noise=0.1):
    """Seeded (flops, params, tokens) points near N = 0.3 C^0.45, D = 1.7 C^0.55."""
    rs = np.random.RandomState(seed)
    flops = np.sort(10 ** rs.uniform(15, 21, n))
    params = 0.3 * flops ** 0.45 * np.exp(rs.normal(0, noise, n))
    tokens = 1.7 * flops ** 0.55 * np.exp(rs.normal(0, noise, n))
    return flops, params, tokens


def _close(a, b):
    """Equal to 1e-12, relative, through dicts, lists and dataclasses' fields."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    else:
        assert a == b


FITS = {
    "fit_power_law": lambda m, f, p, t: m.fit_power_law(f, p, 0.45),
    "fit_scaling_law": lambda m, f, p, t: vars(m.fit_scaling_law(f, p, t)),
    "fit_scaling_law_assumed": lambda m, f, p, t: vars(m.fit_scaling_law(f, p, t, a=0.4, b=0.6)),
    "fit_power_law_free": lambda m, f, p, t: m.fit_power_law_free(f, t),
    "fit_scaling_law_free": lambda m, f, p, t: vars(m.fit_scaling_law_free(f, p, t)),
    "bootstrap_exponents": lambda m, f, p, t: m.bootstrap_exponents(f, p, t, n_boot=300, seed=3),
    "bootstrap_degenerate": lambda m, f, p, t: m.bootstrap_exponents(f[:1], p[:1], t[:1], n_boot=20),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fit", list(FITS))
def test_fits_match_jax(fit, seed):
    points = _frontier(seed)
    _close(FITS[fit](tsc, *points), FITS[fit](jsc, *points))


def test_law_prints_and_predicts_as_jax():
    points = _frontier(2)
    mine, theirs = tsc.fit_scaling_law_free(*points), jsc.fit_scaling_law_free(*points)
    assert str(mine) == str(theirs)
    _close(list(mine.n_opt([1e18, 1e20])), list(theirs.n_opt([1e18, 1e20])))
    _close(list(mine.d_opt([1e18, 1e20])), list(theirs.d_opt([1e18, 1e20])))


def test_refit_of_the_recorded_study_matches_jax(tmp_path, capsys):
    """refit on two copies of the recorded JAX study writes the same law.json
    (to 1e-12); the recorded folder itself is never written."""
    src = os.path.join(REPO, "convergence", "scaling")
    mine_dir, theirs_dir = tmp_path / "mine", tmp_path / "theirs"
    shutil.copytree(src, mine_dir)
    shutil.copytree(src, theirs_dir)
    mine, theirs = tstudy.refit(str(mine_dir)), jstudy.refit(str(theirs_dir))
    _close(mine, theirs)
    _close(json.load(open(mine_dir / "law.json")), json.load(open(theirs_dir / "law.json")))
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 6 and printed[:3] == printed[3:]


def test_run_one_matches_jax(tmp_path, monkeypatch):
    """One 2-step rung ("xs") on the CPU: the same CSV columns and rows'
    steps, tokens and FLOPs, the same parameter count and FLOPs a step (the
    JAX rung's fit replaced by a shape-only count, as in
    test_torch_convergence_clm)."""
    import perceiver_io_tpu.scripts.convergence as jconv
    from test_torch_convergence_clm import shape_only_fit

    monkeypatch.setattr(jconv, "_fit", shape_only_fit)
    name, channels, layers = tstudy.LADDER[0]
    assert tstudy.LADDER == jstudy.LADDER and (tstudy.SEQ_LEN, tstudy.BATCH) == (jstudy.SEQ_LEN, jstudy.BATCH)
    (tmp_path / "mine").mkdir()
    (tmp_path / "theirs").mkdir()
    mine = tstudy._run_one(name, channels, layers, 2, str(tmp_path / "mine"), device="cpu")
    theirs = jstudy._run_one(name, channels, layers, 2, str(tmp_path / "theirs"))
    assert {k: v for k, v in mine.items() if k != "best_val_loss"} == \
        {k: v for k, v in theirs.items() if k != "best_val_loss"}

    def rows(d):
        with open(tmp_path / d / mine["csv"]) as f:
            return list(csv.DictReader(f))

    a, b = rows("mine"), rows("theirs")
    assert list(a[0]) == list(b[0]) == ["step", "tokens", "train_flops", "val_loss"]
    assert [(r["step"], r["tokens"], r["train_flops"]) for r in a] == [(r["step"], r["tokens"], r["train_flops"])
                                                                        for r in b]
    assert all(np.isfinite(float(r["val_loss"])) for r in a)


def test_study_main_writes_runs_readme_and_law(tmp_path, monkeypatch, capsys):
    """main over a stubbed ladder: runs.json sorted by size, the README's
    table, law.json from refit; --only merges into runs.json."""
    def fake_run(name, channels, layers, steps, out_dir, device=None):
        with open(os.path.join(out_dir, f"run_{name}.csv"), "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["step", "tokens", "train_flops", "val_loss"])
            for s in range(1, 4):
                w.writerow([s * steps, s * steps * 2048, s * steps * channels * 1e9, 4.0 - 0.1 * s * channels / 48])
        return {"name": name, "params": channels * 100, "channels": channels, "layers": layers,
                "flops_per_step": channels * 1e9, "csv": f"run_{name}.csv", "best_val_loss": 1.0}

    monkeypatch.setattr(tstudy, "_run_one", fake_run)
    tstudy.main(["--out", str(tmp_path), "--steps", "10", "--device", "cpu"])
    runs = json.load(open(tmp_path / "runs.json"))
    assert [r["name"] for r in runs] == ["xs", "s", "m", "l"]
    assert "| l | 19,200 | 192 | 3 | 1.0000 |" in open(tmp_path / "README.md").read()
    assert "law_free" in json.load(open(tmp_path / "law.json"))
    tstudy.main(["--out", str(tmp_path), "--steps", "20", "--only", "xs"])
    assert [r["name"] for r in json.load(open(tmp_path / "runs.json"))] == ["xs", "s", "m", "l"]
    with pytest.raises(SystemExit, match="unknown ladder rungs"):
        tstudy.main(["--out", str(tmp_path), "--only", "xxl"])
