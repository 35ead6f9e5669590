"""Image classifier training CLI (MNIST).

Port of ``perceiver_io_tpu/scripts/vision/image_classifier.py``: the 907K
Perceiver IO with repeated cross-attention (2 unshared cross-attention
layers, 3 unshared blocks of 3 self-attention layers, 32 latents of 128
channels, dropout 0.1), AdamW at 1e-3 under a constant schedule, evaluated
every 500 steps and monitored on accuracy. It prints the model's parameter
count.

    python3 -m perceiver_io_torch.scripts.vision.image_classifier --trainer.max_steps=15000

``main(argv, device)``: ``device`` None is the card; pass ``"cpu"`` to run
on the CPU. The image data is read from a local MNIST copy
(``MNISTDataModule``; nothing is downloaded).
"""

from __future__ import annotations

import json

from perceiver_io_torch.data.vision.mnist import MNISTDataModule
from perceiver_io_torch.models.core.config import ClassificationDecoderConfig
from perceiver_io_torch.models.vision.image_classifier import (ImageClassifier, ImageClassifierConfig,
                                                               ImageEncoderConfig)
from perceiver_io_torch.scripts.common import OptimizerFlags, build_tx, run_fit
from perceiver_io_torch.training.fit import TrainerConfig
from perceiver_io_torch.training.trainer import TrainState, make_classifier_eval_step, make_classifier_train_step
from perceiver_io_torch.utils.cli import CLI

ENCODER_DEFAULTS = dict(
    num_frequency_bands=32,
    num_cross_attention_layers=2,
    num_cross_attention_heads=1,
    num_self_attention_blocks=3,
    num_self_attention_layers_per_block=3,
    num_self_attention_heads=8,
    first_cross_attention_layer_shared=False,
    first_self_attention_block_shared=False,
    dropout=0.1,
    init_scale=0.1,
)
DECODER_DEFAULTS = dict(num_output_query_channels=128, num_cross_attention_heads=1, dropout=0.1, init_scale=0.1)
TRAINER_DEFAULTS = dict(max_steps=15000, eval_every=500, checkpoint_dir="ckpts/img_clf", monitor="acc",
                        monitor_mode="max")


def main(argv=None, device=None):
    cli = CLI(description="Train a Perceiver IO image classifier on MNIST", argv=argv)
    cli.add_group("data", MNISTDataModule, dict(batch_size=128))
    cli.add_group("encoder", ImageEncoderConfig, ENCODER_DEFAULTS)
    cli.add_group("decoder", ClassificationDecoderConfig, DECODER_DEFAULTS)
    cli.add_group("optimizer", OptimizerFlags, dict(lr=1e-3, warmup_steps=500, schedule="constant"))
    cli.add_group("trainer", TrainerConfig, TRAINER_DEFAULTS)
    cli.add_bool_flag("resume", help="continue from <checkpoint_dir>/last (state + exact data position)")
    args = cli.parse()

    data = cli.build("data", args)
    data.prepare_data()
    data.setup()

    encoder = cli.build("encoder", args, link={"image_shape": data.image_shape})
    decoder = cli.build("decoder", args, link={"num_classes": data.num_classes})
    config = ImageClassifierConfig(encoder=encoder, decoder=decoder, num_latents=32, num_latent_channels=128)
    trainer_cfg = cli.build("trainer", args)
    opt = cli.build("optimizer", args)

    model = ImageClassifier(config, device=device, seed=0)
    print(json.dumps({"model_params": sum(p.numel() for p in model.parameters())}))
    tx = build_tx(opt, trainer_cfg.max_steps)
    return run_fit(
        trainer_cfg,
        TrainState.create(model, tx, seed=0),
        make_classifier_train_step(model, tx),
        data,
        eval_step=make_classifier_eval_step(model),
        resume=args.resume,
    )


if __name__ == "__main__":
    main()
