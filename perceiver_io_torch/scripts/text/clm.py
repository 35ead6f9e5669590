"""Causal language model training CLI (WikiText-103-raw, UTF-8 bytes).

Port of ``perceiver_io_tpu/scripts/text/clm.py``: the 30.7M recipe
(max_seq_len 4096, 512 latents, 512 channels in 8 heads of 64, 8 layers,
prefix dropout 0.5, batch 20, bf16 compute), AdamW under a cosine schedule,
and after each eval one sampled continuation of ``--sample_prompt``
through ``TextGenerationPipeline``'s direct ``generate()`` path. It prints
the model's parameter count, then the tokens a batch and the FLOPs a step
that the fit loop's MFU reads.

    python3 -m perceiver_io_torch.scripts.text.clm --data.dataset_dir=.cache/wikitext \\
        --trainer.max_steps=20000

``main(argv, device)``: ``device`` None is the card; pass ``"cpu"`` to run
on the CPU.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from perceiver_io_torch.data.text.common import Task
from perceiver_io_torch.data.text.datasets import WikiTextDataModule
from perceiver_io_torch.generation.generate import GenerationConfig
from perceiver_io_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_torch.pipelines import TextGenerationPipeline
from perceiver_io_torch.scripts.common import OptimizerFlags, build_tx, run_fit, size_report
from perceiver_io_torch.training.fit import TrainerConfig
from perceiver_io_torch.training.trainer import TrainState, make_causal_lm_eval_step, make_causal_lm_train_step
from perceiver_io_torch.utils.cli import CLI

DATA_DEFAULTS = dict(
    dataset_dir=".cache/wikitext",
    tokenizer="bytes",
    max_seq_len=4096,
    task=Task.clm,
    padding_side="left",
    random_train_shift=True,
    batch_size=20,
)
MODEL_DEFAULTS = dict(
    max_latents=512,
    num_channels=512,
    num_self_attention_layers=8,
    cross_attention_dropout=0.5,
    post_attention_dropout=0.0,
)
OPT_DEFAULTS = dict(lr=2e-4, warmup_steps=200, schedule="cosine", max_grad_norm=0.5)
SAMPLE = GenerationConfig(max_new_tokens=128, do_sample=True, top_k=40)


def main(argv=None, device=None):
    cli = CLI(description="Train a Perceiver AR causal language model", argv=argv)
    cli.add_group("data", WikiTextDataModule, DATA_DEFAULTS)
    cli.add_group("model", CausalLanguageModelConfig, MODEL_DEFAULTS)
    cli.add_group("optimizer", OptimizerFlags, OPT_DEFAULTS)
    cli.add_group("trainer", TrainerConfig, dict(max_steps=20000, checkpoint_dir="ckpts/clm"))
    cli.add_flag("sample_prompt", default="A man", help="prompt used for per-eval sample generation")
    cli.add_bool_flag("resume", help="continue from <checkpoint_dir>/last (state + exact data position)")
    args = cli.parse()

    data = cli.build("data", args)
    data.prepare_data()
    data.setup()

    config = cli.build("model", args, link={"vocab_size": data.vocab_size, "max_seq_len": data.max_seq_len})
    trainer_cfg = cli.build("trainer", args)
    opt = cli.build("optimizer", args)

    model = CausalLanguageModel(config, device=device, dtype=torch.bfloat16, seed=0)
    trainer_cfg = dataclasses.replace(trainer_cfg, **size_report(model, data.batch_size))
    tx = build_tx(opt, trainer_cfg.max_steps)

    def on_eval(state, metrics):
        # one sampled continuation each eval, in eval mode (no dropout)
        was_training = model.training
        model.eval()
        try:
            text = TextGenerationPipeline(model, tokenizer=data.tokenizer)(args.sample_prompt, num_latents=1,
                                                                           config=SAMPLE)
        finally:
            model.train(was_training)
        print(json.dumps({"sample": text[:200]}))

    return run_fit(
        trainer_cfg,
        TrainState.create(model, tx, seed=0),
        make_causal_lm_train_step(model, tx, max_latents=config.max_latents),
        data,
        eval_step=make_causal_lm_eval_step(model, max_latents=config.max_latents),
        on_eval=on_eval,
        resume=args.resume,
    )


if __name__ == "__main__":
    main()
