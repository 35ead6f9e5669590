"""Port parity: ``scripts/convergence.py``'s causal-LM tasks (``run_clm``,
``run_audio_markov``), its task table, its markdown renderer and its
supervisor against the JAX package's."""

import glob
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import perceiver_io_torch.scripts.convergence as tconv
import perceiver_io_tpu.scripts.convergence as jconv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """This file's runs are as fast on two intra-op threads as on all of
    them, and fewer threads leave the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def shape_only_fit(model, eval_model, data, steps, lr, make_train_step, make_eval_step, monitor, monitor_mode,
                   init_fn, **kwargs):
    """The JAX package's ``_fit`` without compiling or training (the JAX
    task's own data, config and result code run around it): the parameter
    count from ``init_fn``'s shapes, and a train and an eval line each step."""
    shapes = jax.eval_shape(init_fn)
    history = [line for step in range(1, steps + 1) for line in ({"step": step, "loss": 1.0},
                                                                  {"step": step, "val_loss": 1.0})]
    return history, sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))


RUNS = {
    "clm_markov": (lambda: tconv.run_clm("markov", 2, "clm_markov", device="cpu"),
                   lambda: jconv.run_clm("markov", 2, "clm_markov", profile="cpu")),
    "clm_pysrc": (lambda: tconv.run_clm("python_source", 2, "clm_pysrc", device="cpu"),
                  lambda: jconv.run_clm("python_source", 2, "clm_pysrc", profile="cpu")),
    "audio_markov": (lambda: tconv.run_audio_markov(2, device="cpu"), lambda: jconv.run_audio_markov(2, profile="cpu")),
}


@pytest.mark.parametrize("task", list(RUNS))
def test_causal_lm_task_matches_jax(task, monkeypatch):
    """Two steps on the CPU profile: the same result keys, parameter count,
    target and analytic floor as the JAX task (its fit replaced by
    shape_only_fit), an eval at each step, finite losses."""
    mine = RUNS[task][0]()
    monkeypatch.setattr(jconv, "_fit", shape_only_fit)
    theirs = RUNS[task][1]()
    assert sorted(mine) == sorted(theirs)
    for key in ("task", "model_params", "target", "entropy_floor_nats", "profile"):
        assert mine.get(key) == theirs.get(key), key
    assert mine["profile"] == "cpu"
    assert [h["step"] for h in mine["history"] if "val_loss" in h] == [1, 2]
    assert all(np.isfinite(h["val_loss"]) for h in mine["history"] if "val_loss" in h)
    assert mine["achieved_val_ce_nats"] > 0 and mine["met"] == (task == "clm_pysrc")


def test_task_table_matches_jax():
    assert list(tconv.TASKS) == list(jconv.TASKS)


@pytest.mark.parametrize("task", ["clm_markov_sharded", "clm_markov_5m"])
def test_production_task_alone_exits_naming_the_mesh(task, tmp_path):
    with pytest.raises(SystemExit, match="fsdp"):
        tconv.main(["--task", task, "--out", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="mesh"):
        tconv.TASKS[task](2, "cpu")


def test_task_all_skips_the_production_tasks(tmp_path, monkeypatch, capsys):
    ran = []

    def fake(name):
        def run(steps, device=None):
            ran.append(name)
            return {"task": name, "model_params": 1, "target": {"metric": "val_loss", "value": None,
                                                                "provenance": "stub"}, "met": True, "history": []}
        return run

    monkeypatch.setattr(tconv, "TASKS", {name: fake(name) for name in tconv.TASKS})
    tconv.main(["--task", "all", "--out", str(tmp_path), "--device", "cpu"])
    assert ran == [n for n in jconv.TASKS if n not in ("clm_markov_sharded", "clm_markov_5m")]
    out = capsys.readouterr().out
    assert "skipping clm_markov_sharded" in out and "skipping clm_markov_5m" in out
    assert sorted(os.listdir(tmp_path)) == sorted([f"{n}.json" for n in ran] + ["CONVERGENCE.md"])


def test_render_sections_match_jax(tmp_path):
    """The port's markdown of a copy of the recorded results has the JAX
    renderer's sections, line for line (the preamble is the port's own)."""
    for path in glob.glob(os.path.join(REPO, "convergence", "*.json")):
        shutil.copy(path, tmp_path)
    jconv.render(str(tmp_path), str(tmp_path / "jax.md"))
    tconv.render(str(tmp_path))

    def sections(path):
        text = open(path).read()
        return text[text.index("\n## "):].splitlines()

    mine = sections(tmp_path / "CONVERGENCE.md")
    assert mine == sections(tmp_path / "jax.md")
    assert sum(line.startswith("## ") for line in mine) == len(glob.glob(os.path.join(REPO, "convergence", "*.json")))


def test_supervise_kills_a_stalled_child_and_retries(tmp_path, monkeypatch, capfd):
    """A 0.2 s stall window makes every child (silent while it imports
    torch) look stalled: 3 attempts killed, then exit code 1."""
    monkeypatch.setenv("PERCEIVER_IO_TORCH_SUPERVISE_STALL_S", "0.2")
    rc = tconv._supervise(["--task", "clm_markov", "--steps", "2", "--device", "cpu", "--out", str(tmp_path),
                           "--supervise"])
    assert rc == 1
    out = capfd.readouterr().out
    assert out.count("killing wedged attempt") == 3 and "3 attempts all wedged" in out


def test_supervise_returns_a_childs_own_exit_code(tmp_path, capfd):
    rc = tconv._supervise(["--task", "no_such_task", "--out", str(tmp_path)])
    assert rc == 2 and "invalid choice" in capfd.readouterr().out


def test_main_writes_result_and_markdown(tmp_path, capsys):
    tconv.main(["--task", "clm_markov", "--steps", "2", "--device", "cpu", "--out", str(tmp_path)])
    result = json.load(open(tmp_path / "clm_markov.json"))
    assert result["task"] == "clm_markov" and result["profile"] == "cpu" and len(result["history"]) >= 2
    assert "## clm_markov" in open(tmp_path / "CONVERGENCE.md").read()
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert any(p.get("task") == "clm_markov" and "history" not in p for p in printed)
