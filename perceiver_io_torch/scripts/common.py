"""Shared training-script machinery: optimizer flags, warm starts, the fit runner.

Port of ``perceiver_io_tpu/scripts/common.py`` (``OptimizerFlags``,
``build_tx`` with ``freeze_encoder``, ``load_encoder_params``, ``run_fit``
with ``resume``) and ``size_report``, the model size and FLOPs lines the
causal-LM scripts print (``scripts/text/clm.py``, ``scripts/audio/symbolic.py``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn

from perceiver_io_torch.training.checkpoint import load_pytree
from perceiver_io_torch.training.fit import Trainer, TrainerConfig
from perceiver_io_torch.training.flops import PerceiverARFlops, detect_peak_flops
from perceiver_io_torch.training.lrs import constant_with_warmup, cosine_with_warmup
from perceiver_io_torch.training.trainer import AdamW, TrainState, build_optimizer


@dataclass
class OptimizerFlags:
    lr: float = 1e-3
    weight_decay: float = 0.0
    warmup_steps: int = 500  # in optimizer-update units (not micro-batches)
    schedule: str = "cosine"  # "cosine" | "constant"
    min_fraction: float = 0.0
    max_grad_norm: Optional[float] = None
    accumulate_steps: int = 1  # micro-batches per optimizer update
    freeze_encoder: bool = False  # classifier fine-tuning: freeze the encoder's parameters


def build_tx(flags: OptimizerFlags, max_steps: int) -> AdamW:
    """The schedule advances once per optimizer update: with accumulation,
    k micro-batches make one update, so its horizon is max_steps / k."""
    updates = max(1, max_steps // max(1, flags.accumulate_steps))
    if flags.schedule == "cosine":
        schedule = cosine_with_warmup(flags.lr, updates, flags.warmup_steps, min_fraction=flags.min_fraction)
    elif flags.schedule == "constant":
        schedule = constant_with_warmup(flags.lr, flags.warmup_steps)
    else:
        raise ValueError(f"unknown schedule '{flags.schedule}'")
    freeze_filter = (lambda path: "encoder" in path) if flags.freeze_encoder else None
    return build_optimizer(schedule, weight_decay=flags.weight_decay, max_grad_norm=flags.max_grad_norm,
                           freeze_filter=freeze_filter, accumulate_steps=flags.accumulate_steps)


def size_report(model: nn.Module, batch_size: int) -> dict:
    """Print the causal-LM ``model``'s parameter count as ``{"model_params":
    n}``, then the latent tokens a batch and the training FLOPs a step
    (``PerceiverARFlops`` at the full sequence, the prefix dropout counted)
    and the card's peak, one JSON line each. Returns the three as
    ``TrainerConfig`` fields, from which the fit loop logs tokens/s and
    MFU (no MFU without a known card)."""
    config = model.config
    print(json.dumps({"model_params": sum(p.numel() for p in model.parameters())}))
    flops = PerceiverARFlops(config, config.max_seq_len, config.cross_attention_dropout)
    fields = dict(tokens_per_batch=flops.tokens_per_step(batch_size),
                  flops_per_step=flops.train_flops_per_step(batch_size), peak_flops=detect_peak_flops())
    print(json.dumps(fields))
    return fields


def load_encoder_params(checkpoint_dir: str, target: nn.Module) -> nn.Module:
    """Copy the encoder's entries (``encoder.*``) of a checkpoint's model into
    ``target``'s parameters in place: the encoder-only warm start of a
    classifier from another model's checkpoint (a ``TrainState``'s, or a
    bare state dict's). Shapes must match; a mismatch, or an encoder entry
    the target lacks, raises ``ValueError``. Returns ``target``."""
    tree = load_pytree(checkpoint_dir)
    prefix = "model/" if any(k.startswith("model/") for k in tree) else ""
    source = {k[len(prefix):]: v for k, v in tree.items() if k.startswith(prefix + "encoder.")}
    if not source:
        raise ValueError(f"checkpoint {checkpoint_dir} holds no encoder entries")
    want = dict(target.state_dict())
    for name, v in source.items():
        if name not in want:
            raise ValueError(f"encoder entry {name} of the checkpoint is not in the target model")
        if tuple(v.shape) != tuple(want[name].shape):
            raise ValueError(f"encoder shape mismatch at {name}: {tuple(v.shape)} vs {tuple(want[name].shape)}")
    with torch.no_grad():
        for name, v in source.items():
            want[name].copy_(v)
    return target


def run_fit(trainer_cfg: TrainerConfig, state: TrainState, train_step: Callable, data_module,
            eval_step: Optional[Callable] = None, on_eval: Optional[Callable] = None, resume: bool = False,
            log_fn: Optional[Callable[[str], None]] = None) -> TrainState:
    """``Trainer(trainer_cfg).fit`` over ``data_module``'s loaders (the
    validation loader only with an ``eval_step``). ``resume=True`` continues
    a killed or finished run from ``checkpoint_dir``: the newest valid
    checkpoint (``restore_latest_valid``: ``last``, or ``last.prev`` when a
    kill tore ``last``) restored into ``state`` in place (parameters,
    optimizer moments and accumulation, step, the dropout generator), the
    loader's exact position from that checkpoint's iterator sidecar when the
    loader is stateful, and ``initial_best`` from ``best_metric.json`` when
    it monitors the same metric: the run goes on from the next unseen batch,
    bit for bit."""
    trainer = Trainer(trainer_cfg) if log_fn is None else Trainer(trainer_cfg, log_fn)
    train_loader_fn = data_module.train_dataloader
    initial_best = None
    ckpt_dir = trainer_cfg.checkpoint_dir
    if resume and ckpt_dir:
        if os.path.isdir(ckpt_dir) and any(os.path.isdir(os.path.join(ckpt_dir, n)) for n in os.listdir(ckpt_dir)):
            if callable(state):
                state = state()
            state, info = Trainer.restore_latest_valid(ckpt_dir, state)
            if info["iterator_path"]:
                loader = data_module.train_dataloader()
                if hasattr(loader, "load_state_dict"):
                    Trainer.restore_iterator(info["iterator_path"], loader)
                    train_loader_fn = lambda: loader
            best_path = os.path.join(ckpt_dir, "best_metric.json")
            if os.path.exists(best_path):
                with open(best_path) as f:
                    best = json.load(f)
                if best.get("monitor") == trainer_cfg.monitor:  # comparable only for the same metric
                    initial_best = float(best["value"])
            trainer.log(json.dumps({"resumed_from_step": int(state.step), "checkpoint": info["name"],
                                    "validated": info["validated"], "skipped": info["skipped"],
                                    "best": initial_best,
                                    **{k: info[k] for k in ("load_s", "verify_s", "restore_s") if k in info}}))
        else:
            trainer.log(json.dumps({"resume": f"no checkpoint in {ckpt_dir}; starting fresh"}))
    return trainer.fit(state, train_step, train_loader_fn=train_loader_fn, eval_step=eval_step,
                       eval_loader_fn=data_module.val_dataloader if eval_step else None, on_eval=on_eval,
                       initial_best=initial_best)
