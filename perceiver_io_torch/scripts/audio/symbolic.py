"""Symbolic audio (MIDI) model training CLI (GiantMIDI-Piano).

Port of ``perceiver_io_tpu/scripts/audio/symbolic.py``: the 134M recipe
(max_seq_len 6144, 2048 latents, 768 channels in 8 heads of 96, 18 layers,
output norm, no absolute position embedding, dropouts 0.1, activation
checkpointing, batch 8, bf16 compute). It prints the model's parameter
count, then the tokens a batch and the FLOPs a step that the fit loop's MFU
reads.

    python3 -m perceiver_io_torch.scripts.audio.symbolic --data.dataset_dir=.cache/giantmidi

``main(argv, device)``: ``device`` None is the card; pass ``"cpu"`` to run
on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from perceiver_io_torch.data.audio.datasets import GiantMidiPianoDataModule
from perceiver_io_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig
from perceiver_io_torch.scripts.common import OptimizerFlags, build_tx, run_fit, size_report
from perceiver_io_torch.training.fit import TrainerConfig
from perceiver_io_torch.training.trainer import TrainState, make_causal_lm_eval_step, make_causal_lm_train_step
from perceiver_io_torch.utils.cli import CLI

DATA_DEFAULTS = dict(
    dataset_dir=".cache/giantmidi", max_seq_len=6144, min_seq_len=2048, padding_side="left", batch_size=8
)
MODEL_DEFAULTS = dict(
    max_latents=2048,
    num_channels=768,
    num_heads=8,
    num_self_attention_layers=18,
    cross_attention_dropout=0.1,
    post_attention_dropout=0.1,
    residual_dropout=0.1,
    output_norm=True,
    output_bias=False,
    abs_pos_emb=False,
    activation_checkpointing=True,
)
OPT_DEFAULTS = dict(lr=2e-4, warmup_steps=500, schedule="cosine", max_grad_norm=0.5)


def main(argv=None, device=None):
    cli = CLI(description="Train a Perceiver AR symbolic audio model", argv=argv)
    cli.add_group("data", GiantMidiPianoDataModule, DATA_DEFAULTS)
    cli.add_group("model", SymbolicAudioModelConfig, MODEL_DEFAULTS)
    cli.add_group("optimizer", OptimizerFlags, OPT_DEFAULTS)
    cli.add_group("trainer", TrainerConfig, dict(max_steps=100000, checkpoint_dir="ckpts/sam"))
    cli.add_bool_flag("resume", help="continue from <checkpoint_dir>/last (state + exact data position)")
    args = cli.parse()

    data = cli.build("data", args)
    data.prepare_data()
    data.setup()

    config = cli.build("model", args, link={"vocab_size": data.vocab_size, "max_seq_len": data.max_seq_len})
    trainer_cfg = cli.build("trainer", args)
    opt = cli.build("optimizer", args)

    model = SymbolicAudioModel(config, device=device, dtype=torch.bfloat16, seed=0)
    trainer_cfg = dataclasses.replace(trainer_cfg, **size_report(model, data.batch_size))
    tx = build_tx(opt, trainer_cfg.max_steps)
    return run_fit(
        trainer_cfg,
        TrainState.create(model, tx, seed=0),
        make_causal_lm_train_step(model, tx, max_latents=config.max_latents),
        data,
        eval_step=make_causal_lm_eval_step(model, max_latents=config.max_latents),
        resume=args.resume,
    )


if __name__ == "__main__":
    main()
