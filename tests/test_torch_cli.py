"""Port parity: the dataclass CLI (``perceiver_io_torch/utils/cli.py``) and the
task CLIs (``scripts/text/clm.py``, ``scripts/audio/symbolic.py``,
``scripts/vision/image_classifier.py``) against the JAX package's: the same
values parsed, the same dataclasses built from one argv, the same model
sizes and FLOPs printed; and the CLM CLI's resume, bit for bit."""

import dataclasses
import enum
import io
import json
from contextlib import redirect_stdout
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perceiver_io_torch.scripts.audio.symbolic as tsym
import perceiver_io_torch.scripts.text.clm as tclm
import perceiver_io_torch.utils.cli as tcli
import perceiver_io_tpu.utils.cli as jcli
from perceiver_io_torch.data.text.common import Task as TTask
from perceiver_io_torch.data.text.common import TextDataModule as TTextDataModule
from perceiver_io_torch.training.trainer import make_causal_lm_train_step
from perceiver_io_tpu.data.text.common import Task as JTask


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """This file's runs are as fast on two intra-op threads as on all of
    them, and fewer threads leave the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Color(enum.Enum):
    red = 1
    blue = 2


PARSE_CASES = [
    ("7", Optional[int]),
    ("none", Optional[int]),
    ("null", Optional[str]),
    ("true", bool),
    ("No", bool),
    ("1", bool),
    ("blue", _Color),
    ("data=8", Dict[str, int]),
    ("data=2,fsdp=4", Dict[str, int]),
    ("(28,28,1)", Tuple[int, ...]),
    ("0.5,1.5", List[float]),
    ("[3]", List[int]),
    ("0.25", float),
    ("12", int),
    ("bytes", str),
    ("3", None),
    ("2.5", None),
    ("text", None),
]


@pytest.mark.parametrize("text,annotation", PARSE_CASES)
def test_parse_value_matches_jax(text, annotation):
    mine, theirs = tcli._parse_value(text, annotation), jcli._parse_value(text, annotation)
    assert mine == theirs and type(mine) is type(theirs)


def test_parse_value_task_enum_matches_jax():
    assert tcli._parse_value("clm", TTask).name == jcli._parse_value("clm", JTask).name == "clm"


def _plain(value):
    """A built dataclass as plain values: enums by name, nested dataclasses as dicts."""
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, enum.Enum):
        return value.name
    if isinstance(value, (list, tuple)):
        return type(value)(_plain(v) for v in value)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    return value


def _groups(pkg):
    """(group name, dataclass, defaults, argv, link) for each group, built from ``pkg``."""
    trainer = __import__(f"{pkg}.training.fit", fromlist=["TrainerConfig"]).TrainerConfig
    flags = __import__(f"{pkg}.scripts.common", fromlist=["OptimizerFlags"]).OptimizerFlags
    clm = __import__(f"{pkg}.models.text.clm", fromlist=["CausalLanguageModelConfig"]).CausalLanguageModelConfig
    sam = __import__(f"{pkg}.models.audio.symbolic", fromlist=["SymbolicAudioModelConfig"]).SymbolicAudioModelConfig
    enc = __import__(f"{pkg}.models.vision.image_classifier", fromlist=["ImageEncoderConfig"]).ImageEncoderConfig
    return {
        "trainer": (trainer, dict(max_steps=20000, checkpoint_dir="ckpts/clm"),
                    ["--trainer.max_steps=12", "--trainer.mesh_axes=seq=1", "--trainer.monitor_mode=max",
                     "--trainer.async_checkpoint=false", "--trainer.eval_every=3"], None),
        "optimizer": (flags, dict(lr=2e-4, warmup_steps=200, schedule="cosine", max_grad_norm=0.5),
                      ["--optimizer.lr=0.003", "--optimizer.max_grad_norm=none", "--optimizer.freeze_encoder=yes"],
                      None),
        "model": (clm, dict(max_latents=512, num_channels=512, num_self_attention_layers=8),
                  ["--model.num_heads=4", "--model.vocab_size=999", "--model.remat_policy=dots_saveable",
                   "--model.cross_attention_dropout=0.25"], {"vocab_size": 262, "max_seq_len": 4096}),
        "audio": (sam, dict(max_latents=2048, num_channels=768, output_norm=True, abs_pos_emb=False),
                  ["--audio.num_self_attention_layers=3", "--audio.activation_checkpointing=true"],
                  {"vocab_size": 389, "max_seq_len": 6144}),
        "encoder": (enc, dict(num_frequency_bands=32, dropout=0.1),
                    ["--encoder.num_self_attention_blocks=3", "--encoder.first_cross_attention_layer_shared=false"],
                    {"image_shape": (28, 28, 1)}),
    }


@pytest.mark.parametrize("group", ["trainer", "optimizer", "model", "audio", "encoder"])
def test_cli_build_matches_jax(group):
    built = []
    for pkg, cli_mod in (("perceiver_io_torch", tcli), ("perceiver_io_tpu", jcli)):
        cls, defaults, argv, link = _groups(pkg)[group]
        cli = cli_mod.CLI(argv=argv)
        cli.add_group(group, cls, defaults)
        built.append(_plain(cli.build(group, cli.parse(), link=link)))
    assert built[0] == built[1]


def test_cli_registers_every_field_as_a_flag():
    from perceiver_io_torch.models.text.clm import CausalLanguageModelConfig
    from perceiver_io_torch.training.fit import TrainerConfig

    for cls in (TrainerConfig, CausalLanguageModelConfig, TTextDataModule):
        cli = tcli.CLI(argv=[])
        cli.add_group("g", cls)
        flags = {a.dest for a in cli.parser._actions if a.dest.startswith("g.")}
        assert flags == {f"g.{f.name}" for f in dataclasses.fields(cls)}


@pytest.mark.parametrize("module", [
    "perceiver_io_torch.scripts.text.clm",
    "perceiver_io_torch.scripts.audio.symbolic",
    "perceiver_io_torch.scripts.vision.image_classifier",
    "perceiver_io_torch.scripts.convergence",
    "perceiver_io_torch.scripts.scaling_study",
])
def test_task_cli_help_exits_zero(module, capsys):
    main = __import__(module, fromlist=["main"]).main
    with pytest.raises(SystemExit) as e:
        main(["--help"])
    assert e.value.code == 0
    assert "usage" in capsys.readouterr().out


class ToyTextDataModule(TTextDataModule):
    """In-memory text source (the JAX CLI test's toy module, on the port's base)."""

    TRAIN = ["the quick brown fox jumps over the lazy dog. " * 20] * 8
    VALID = ["hello world, this is a validation text. " * 20] * 2

    def load_source_dataset(self):
        return {"train": self.TRAIN, "valid": self.VALID}


def test_clm_cli_kill_and_resume(tmp_path, monkeypatch):
    """--resume continues a stopped CLM run exactly: 4 steps, stop, resume to
    8 gives the uninterrupted 8-step run's losses, printed and in every bit
    (the parameters, optimizer moments, dropout generator and the
    mid-epoch data position all restore)."""
    record = []

    def recording(model, tx, **kw):
        step = make_causal_lm_train_step(model, tx, **kw)

        def train_step(state, batch):
            state, metrics = step(state, batch)
            record.append((state.step, float(metrics["loss"])))
            return state, metrics

        return train_step

    monkeypatch.setattr(tclm, "WikiTextDataModule", ToyTextDataModule)
    monkeypatch.setattr(tclm, "make_causal_lm_train_step", recording)
    common = [
        f"--data.dataset_dir={tmp_path}/data", "--data.max_seq_len=32", "--data.batch_size=2",
        "--model.max_latents=8", "--model.num_channels=16", "--model.num_heads=2",
        "--model.num_self_attention_layers=1", "--model.cross_attention_dropout=0.0",
        "--trainer.log_every=1", "--trainer.eval_every=1000", "--optimizer.warmup_steps=2",
        # a cosine horizon depends on max_steps, which the stopped and full runs disagree on
        "--optimizer.schedule=constant",
    ]

    def run(argv):
        del record[:]
        out = io.StringIO()
        with redirect_stdout(out):
            tclm.main(common + argv, device="cpu")
        printed = {line["step"]: line["loss"] for line in map(json.loads, filter(None, out.getvalue().splitlines()))
                   if "loss" in line and "step" in line}
        return printed, dict(record)

    full, full_bits = run([f"--trainer.checkpoint_dir={tmp_path}/full", "--trainer.max_steps=8"])
    assert sorted(full) == list(range(1, 9))
    part, part_bits = run([f"--trainer.checkpoint_dir={tmp_path}/killed", "--trainer.max_steps=4"])
    assert sorted(part) == list(range(1, 5)) and all(part_bits[s] == full_bits[s] for s in part_bits)
    resumed, resumed_bits = run([f"--trainer.checkpoint_dir={tmp_path}/killed", "--trainer.max_steps=8",
                                 "--resume"])
    assert sorted(resumed) == list(range(5, 9))
    assert all(resumed[s] == full[s] for s in resumed)
    assert all(float.hex(resumed_bits[s]) == float.hex(full_bits[s]) for s in resumed_bits)


def _sized(cls, vocab):
    """``cls`` (a script's data group) with its fields and flags, no data,
    and the vocabulary the script links into the model."""

    @dataclasses.dataclass
    class Sized(cls):
        def __post_init__(self):
            pass

        @property
        def vocab_size(self):
            return vocab

        def prepare_data(self):
            pass

        def setup(self):
            pass

    return Sized


def _port_sizes(module, data_attr, vocab, argv, monkeypatch):
    """The size lines ``module.main`` prints before training, on the CPU."""
    monkeypatch.setattr(module, data_attr, _sized(getattr(module, data_attr), vocab))
    monkeypatch.setattr(module, "run_fit", lambda *a, **k: None)
    out = io.StringIO()
    with redirect_stdout(out):
        module.main(argv, device="cpu")
    return {k: v for ln in out.getvalue().splitlines() for k, v in json.loads(ln).items()}


def _jax_sizes(config, batch_size):
    """The JAX script's model_params (``model.init``'s leaves, by shape only)
    and its trainer fields."""
    from perceiver_io_tpu.models.core.perceiver_ar import CausalSequenceModel
    from perceiver_io_tpu.training.flops import PerceiverARFlops

    model = CausalSequenceModel(config=config, deterministic=False)
    x = jnp.zeros((2, config.max_seq_len), jnp.int32)
    shapes = jax.eval_shape(lambda: model.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
                                               x, prefix_len=config.max_seq_len - config.max_latents))
    flops = PerceiverARFlops(config, config.max_seq_len, config.cross_attention_dropout)
    return {"model_params": sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes)),
            "tokens_per_batch": flops.tokens_per_step(batch_size),
            "flops_per_step": flops.train_flops_per_step(batch_size)}


SIZE_CASES = {
    "clm_small": ("clm", ["--data.max_seq_len=64", "--data.batch_size=3", "--model.max_latents=16",
                          "--model.num_channels=32", "--model.num_heads=2", "--model.num_self_attention_layers=2"]),
    "clm_30m": ("clm", []),
    "symbolic_small": ("symbolic", ["--data.max_seq_len=96", "--data.min_seq_len=32", "--data.batch_size=2",
                                    "--model.max_latents=32", "--model.num_channels=48",
                                    "--model.num_self_attention_layers=2"]),
    "symbolic_134m": ("symbolic", []),
}


@pytest.mark.parametrize("case", list(SIZE_CASES))
def test_cli_sizes_match_jax(case, monkeypatch, tmp_path):
    """The printed model_params, tokens_per_batch and flops_per_step equal
    what the JAX script's recipe gives for the same flags, small and at the
    defaults (the 30.7M CLM, the 134M GiantMIDI model)."""
    import perceiver_io_tpu.scripts.audio.symbolic as jsym
    import perceiver_io_tpu.scripts.text.clm as jclm
    from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModelConfig
    from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig

    which, argv = SIZE_CASES[case]
    argv = argv + [f"--data.dataset_dir={tmp_path}"]
    if which == "clm":
        mine = _port_sizes(tclm, "WikiTextDataModule", 262, argv, monkeypatch)
        data_defaults, model_defaults, cls, vocab = jclm.DATA_DEFAULTS, jclm.MODEL_DEFAULTS, CausalLanguageModelConfig, 262
    else:
        mine = _port_sizes(tsym, "GiantMidiPianoDataModule", 389, argv, monkeypatch)
        data_defaults, model_defaults, cls, vocab = jsym.DATA_DEFAULTS, jsym.MODEL_DEFAULTS, SymbolicAudioModelConfig, 389
    cli = jcli.CLI(argv=argv)
    cli.add_group("model", cls, model_defaults)
    cli.parser.add_argument("--data.max_seq_len", type=int, default=data_defaults["max_seq_len"])
    cli.parser.add_argument("--data.batch_size", type=int, default=data_defaults["batch_size"])
    cli.parser.add_argument("--data.min_seq_len")
    cli.parser.add_argument("--data.dataset_dir")
    args = cli.parse()
    config = cli.build("model", args, link={"vocab_size": vocab, "max_seq_len": getattr(args, "data.max_seq_len")})
    theirs = _jax_sizes(config, getattr(args, "data.batch_size"))
    assert {k: mine[k] for k in theirs} == theirs
    assert mine["peak_flops"] is None  # no card here, so the fit loop reports no MFU
