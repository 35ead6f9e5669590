"""Convergence runner: a learning curve and a task-level quality check, on
the card by default.

Port of ``perceiver_io_tpu/scripts/convergence.py``'s fit helper (``_fit``:
``Trainer.fit`` with optax's ``chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(0, lr, min(warmup_cap, steps // 4),
steps)))``, written out in ``build_fit_tx``), its tasks, the markdown
renderer and the relaunching supervisor:

- ``optical_flow_epe`` (``run_optical_flow_epe``): a small optical-flow
  model trained on synthetic rigid-motion pairs, then judged by its
  endpoint error through the whole ``OpticalFlowPipeline`` on larger unseen
  pairs against the zero-flow baseline. The flow train and eval steps
  (``make_flow_train_step``, ``make_flow_eval_step``) are the JAX task's
  step closures; the 41M model's training step in ``chip_smoke.py`` and
  ``profile_flow.py`` is the same function.
- ``digits_glyphs``, ``digits_glyphs_hard`` and ``digits_sklearn``
  (``run_digits``): the MNIST recipe's image classifier (907K parameters)
  on rendered 28 x 28 digits, and a smaller one on scikit-learn's 8 x 8
  scans, each against the 0.98 validation accuracy bar (the hard tier
  against its linear-probe baseline, ``_linear_probe_acc``). The baseline
  needs scikit-learn, imported when it runs: without it the result's
  ``baseline_val_acc`` is None and ``baseline`` says why.

- ``clm_markov`` and ``clm_pysrc`` (``run_clm``): a Perceiver AR byte CLM
  on the order-2 Markov corpus, whose conditional entropy is computed
  analytically (the one corpus with an exact loss target: met when the
  validation CE is within 0.05 nats of it), and on the installed
  site-packages' python source (real text, no floor: the curve and the
  final bits a byte are recorded). ``clm_markov_sharded`` and
  ``clm_markov_5m`` train the same recipe over a data(2) x fsdp(4) mesh,
  which the port does not have yet (ROADMAP A5): ``main`` skips them under
  ``--task all`` and exits with a message when asked for one alone.
- ``audio_markov`` (``run_audio_markov``): ``SymbolicAudioModel`` with the
  GiantMIDI recipe's architecture knobs on ragged left-padded Markov
  "MIDI event" windows, against the same kind of analytic floor.

Each task has two size profiles, as in the JAX package: ``"gpu"`` (the JAX
package's ``"tpu"`` sizes) when it runs on the card, ``"cpu"`` (the small
sizes) on the CPU; the floor is a property of the data, so the target is
exact in both.

    python3 -m perceiver_io_torch.scripts.convergence --task clm_markov [--steps N] [--device cpu]
    python3 -m perceiver_io_torch.scripts.convergence --render --out convergence_torch

writes ``<out>/<task>.json`` (default ``convergence_torch/``) with the whole
eval history, prints the result without its history as one JSON line, and
renders ``<out>/CONVERGENCE.md`` from every result in ``<out>``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from perceiver_io_torch.models.core.perceiver_ar import resolve_device
from perceiver_io_torch.training.fit import Trainer, TrainerConfig
from perceiver_io_torch.training.lrs import cosine_with_warmup
from perceiver_io_torch.training.trainer import (AdamW, TrainState, _apply, make_causal_lm_eval_step,
                                                make_causal_lm_train_step, trainable)

ADAMW_WEIGHT_DECAY = 1e-4  # optax.adamw's default, which the JAX task keeps


def build_fit_tx(lr: float, steps: int, warmup_cap: int = 500) -> AdamW:
    """``_fit``'s optimizer: clipping at global norm 1.0, then AdamW (optax's
    default weight decay 1e-4) under a linear warmup from 0 over
    ``min(warmup_cap, steps // 4)`` updates and a cosine decay to 0 at
    ``steps`` (optax's ``warmup_cosine_decay_schedule``)."""
    schedule = cosine_with_warmup(lr, steps, min(warmup_cap, steps // 4))
    return AdamW(schedule, weight_decay=ADAMW_WEIGHT_DECAY, max_grad_norm=1.0)


def _fit(model, data, steps: int, lr: float, make_train_step: Callable, make_eval_step: Callable, monitor: str,
         monitor_mode: str, warmup_cap: int = 500, return_state: bool = False, on_eval: Optional[Callable] = None,
         log_fn: Optional[Callable[[str], None]] = None):
    """Train ``model`` (which holds its parameters) on ``data``'s loaders
    through ``Trainer.fit`` for ``steps`` steps, evaluating and logging 12
    times. Returns (history, parameter count[, final state])."""
    tx = build_fit_tx(lr, steps, warmup_cap)
    state = TrainState.create(model, tx)
    n_params = sum(p.numel() for p in trainable(model))
    eval_every = max(steps // 12, 1)
    config = TrainerConfig(max_steps=steps, eval_every=eval_every, log_every=eval_every, monitor=monitor,
                           monitor_mode=monitor_mode)
    trainer = Trainer(config) if log_fn is None else Trainer(config, log_fn)
    final = trainer.fit(state, make_train_step(model, tx), data.train_dataloader,
                        eval_step=make_eval_step(model), eval_loader_fn=data.val_dataloader, on_eval=on_eval)
    if return_state:
        return trainer.history, n_params, final
    return trainer.history, n_params


def _linear_probe_acc(splits, cap: int = 10_000) -> float:
    """Validation accuracy of multinomial logistic regression on raw pixels
    (at most ``cap`` training images): the trivial baseline that says how
    hard a digit tier is. Imports scikit-learn."""
    from sklearn.linear_model import LogisticRegression

    (tr_x, tr_y), (va_x, va_y) = splits
    tr = tr_x[:cap].reshape(min(len(tr_x), cap), -1).astype(np.float32) / 255.0
    va = va_x.reshape(len(va_x), -1).astype(np.float32) / 255.0
    clf = LogisticRegression(max_iter=300).fit(tr, tr_y[:cap])
    return float(clf.score(va, va_y))


def run_digits(source: str, steps: int, task_name: str = "", device=None,
               log_fn: Optional[Callable[[str], None]] = None) -> Dict:
    """Image-classifier convergence on local digits, the JAX task's recipe:
    ``glyphs`` and ``glyphs_hard`` train the MNIST recipe's architecture
    (907K parameters, 2 unshared cross-attention layers, 3 unshared blocks of
    3 layers, 32 latents of 128 channels, dropout 0.1) on 20,000 rendered
    digits at batch 128; ``sklearn_digits`` a smaller one on the 8 x 8 scans
    at batch 64. AdamW at 1e-3 under ``_fit``'s schedule, evaluated 12
    times; ``achieved`` is the best validation accuracy. ``met``: at least
    0.98, or for ``glyphs_hard`` above the linear-probe baseline (None when
    the baseline could not run). ``device`` defaults to the card; float32."""
    from perceiver_io_torch.data.vision.synthetic import SyntheticDigitsDataModule
    from perceiver_io_torch.models.core.config import ClassificationDecoderConfig
    from perceiver_io_torch.models.vision.image_classifier import (ImageClassifier, ImageClassifierConfig,
                                                                   ImageEncoderConfig)
    from perceiver_io_torch.training.trainer import make_classifier_eval_step, make_classifier_train_step

    if source in ("glyphs", "glyphs_hard"):
        data = SyntheticDigitsDataModule(source=source, n_train=20_000, n_val=2_000, batch_size=128)
        enc_kw = dict(num_frequency_bands=32, num_cross_attention_layers=2, num_cross_attention_heads=1,
                      num_self_attention_blocks=3, num_self_attention_layers_per_block=3,
                      num_self_attention_heads=8, first_cross_attention_layer_shared=False,
                      first_self_attention_block_shared=False, dropout=0.1, init_scale=0.1)
        num_latents, num_latent_channels = 32, 128
    else:
        data = SyntheticDigitsDataModule(source="sklearn_digits", batch_size=64)
        enc_kw = dict(num_frequency_bands=12, num_cross_attention_layers=1, num_cross_attention_heads=1,
                      num_self_attention_blocks=2, num_self_attention_layers_per_block=2,
                      num_self_attention_heads=4, dropout=0.1, init_scale=0.1)
        num_latents, num_latent_channels = 16, 64
    data.setup()
    baseline = "multinomial logistic regression on raw pixels (10k train cap)"
    try:
        baseline_acc = _linear_probe_acc(data._load_splits())
    except ImportError as e:
        baseline_acc, baseline = None, f"{baseline}: not run ({e})"

    encoder = ImageEncoderConfig(image_shape=data.image_shape, **enc_kw)
    decoder = ClassificationDecoderConfig(num_classes=10, num_output_query_channels=128,
                                          num_cross_attention_heads=1, dropout=0.1, init_scale=0.1)
    config = ImageClassifierConfig(encoder=encoder, decoder=decoder, num_latents=num_latents,
                                   num_latent_channels=num_latent_channels)
    model = ImageClassifier(config, device=device, seed=0)
    history, n_params = _fit(model, data, steps, lr=1e-3, make_train_step=make_classifier_train_step,
                             make_eval_step=make_classifier_eval_step, monitor="acc", monitor_mode="max",
                             log_fn=log_fn)
    accs = [h["val_acc"] for h in history if "val_acc" in h]
    achieved = max(accs) if accs else None
    if source == "glyphs_hard":
        target = {"metric": "val_acc", "value": None,
                  "provenance": "difficulty-calibration tier (occlusion + heavy warps + "
                                "distractors); MET = model beats the linear-probe baseline"}
        met = None if baseline_acc is None else bool(achieved is not None and achieved > baseline_acc)
    else:
        target = {"metric": "val_acc", "value": 0.98,
                  "provenance": "reference MNIST bar, docs/training-examples.md:144-150 (0.98160)"}
        met = bool(accs and max(accs) >= 0.98)
    return {
        "task": task_name or f"digits_{source}",
        "model_params": n_params,
        "target": target,
        "achieved": achieved,
        "baseline_val_acc": baseline_acc,
        "baseline": baseline,
        "met": met,
        "history": history,
    }


def make_flow_train_step(model, tx: AdamW, scale: float):
    """The optical-flow train step: the mean squared error of the model's
    flow against ``flow / scale`` (the pipeline multiplies the model's
    output by ``scale``), with the model in training mode and its dropout
    seeded from ``state.generator``. Returns ``train_step(state, batch) ->
    (state, {"loss": ...})``; batch tensors live on the model's device."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if state.tx is not tx or state.model is not model:
            raise ValueError("the state was created for another model or optimizer than this step")
        model.train()
        pred = model(batch["x"], generator=state.generator)
        loss = torch.mean((pred - batch["flow"] / scale) ** 2)
        grads = torch.autograd.grad(loss, trainable(model), materialize_grads=True)
        return state, _apply(state, loss, list(grads), {"loss": loss.detach()}, False)

    return train_step


def make_flow_eval_step(model, scale: float):
    """``eval_step(batch) -> {"loss", "epe"}`` in eval mode under
    ``torch.inference_mode()``: the train step's loss and the mean endpoint
    error in pixels, ``|model * scale - flow|``."""

    def eval_step(batch: Dict[str, torch.Tensor]):
        was_training = model.training
        model.eval()
        try:
            with torch.inference_mode():
                pred = model(batch["x"])
        finally:
            model.train(was_training)
        return {"loss": torch.mean((pred - batch["flow"] / scale) ** 2),
                "epe": torch.mean(torch.linalg.vector_norm(pred * scale - batch["flow"], dim=-1))}

    return eval_step


def run_optical_flow_epe(steps: int, device=None, log_fn: Optional[Callable[[str], None]] = None) -> Dict:
    """Task-level optical-flow quality: train a small OpticalFlow model on
    patch-sized pairs under analytically known rigid motion
    (``SyntheticFlowDataModule``), keep the parameters of its best
    validation loss, then report the endpoint error through the whole
    pipeline (patching, the model, the flow scale, border-weighted blending)
    on larger unseen pairs against the zero-flow baseline (the mean true
    displacement). ``met``: the pipeline's EPE under half the baseline. The
    probe's choices (encoder init scale 0.25, decoder rescale 1.0, the
    decoder's attention residual and widening 4, sub-2-pixel motion) are the
    JAX task's, which records why each is needed at this scale. ``device``
    defaults to the card; float32 throughout."""
    from perceiver_io_torch.data.vision.synthetic import SyntheticFlowDataModule, make_flow_pair
    from perceiver_io_torch.models.vision.optical_flow import (OpticalFlow, OpticalFlowConfig,
                                                               OpticalFlowDecoderConfig, OpticalFlowEncoderConfig)
    from perceiver_io_torch.pipelines import OpticalFlowPipeline

    shape, scale = (32, 48), 20
    max_shift, max_rot = 1.25, 1.5
    data = SyntheticFlowDataModule(image_shape=shape, batch_size=16, flow_scale_factor=scale,
                                   max_shift=max_shift, max_rot_deg=max_rot)
    data.setup()
    enc = OpticalFlowEncoderConfig(
        image_shape=shape, num_patch_input_channels=27, num_patch_hidden_channels=32,
        num_frequency_bands=16, num_cross_attention_heads=1, num_self_attention_heads=4,
        num_self_attention_layers_per_block=4, num_self_attention_blocks=1, init_scale=0.25,
    )
    dec = OpticalFlowDecoderConfig(
        image_shape=shape, num_cross_attention_qk_channels=64, num_cross_attention_v_channels=64,
        num_cross_attention_heads=1, cross_attention_residual=True, cross_attention_widening_factor=4,
        rescale_factor=1.0,
    )
    cfg = OpticalFlowConfig(encoder=enc, decoder=dec, num_latents=128, num_latent_channels=64)
    model = OpticalFlow(cfg, device=device, seed=0)

    # the judged EPE comes from the parameters of the best validation loss,
    # not from whatever the cosine tail left
    best = {"loss": float("inf"), "params": None}

    def track_best(state, val):
        if float(val["loss"]) < best["loss"]:
            best["loss"] = float(val["loss"])
            best["params"] = {k: v.detach().clone() for k, v in state.model.state_dict().items()}

    history, n_params, _ = _fit(
        model, data, steps, lr=2e-3,
        make_train_step=lambda m, tx: make_flow_train_step(m, tx, scale),
        make_eval_step=lambda m: make_flow_eval_step(m, scale),
        monitor="loss", monitor_mode="min", warmup_cap=150, return_state=True, on_eval=track_best,
        log_fn=log_fn,
    )
    if best["params"] is not None:
        model.load_state_dict(best["params"])
    model.eval()

    # the pipeline's EPE on unseen pairs larger than a patch: a grid of 4
    # overlapping patches a pair, blended
    rng = np.random.default_rng(12345)
    pairs, truths = [], []
    for _ in range(8):
        f1, f2, flow = make_flow_pair(rng, (48, 72), max_shift=max_shift, max_rot_deg=max_rot)
        pairs.append((f1, f2))
        truths.append(flow)
    truths = np.stack(truths)
    pipe = OpticalFlowPipeline(model, patch_size=shape, patch_min_overlap=8, flow_scale_factor=scale,
                               micro_batch_size=4)
    pred = pipe(pairs)
    epe = float(np.linalg.norm(pred - truths, axis=-1).mean())
    zero_epe = float(np.linalg.norm(truths, axis=-1).mean())

    epes = [h["val_epe"] for h in history if "val_epe" in h]
    return {
        "task": "optical_flow_epe",
        "model_params": n_params,
        "target": {"metric": "val_epe", "value": None,
                   "provenance": f"analytic rigid-motion flow (shift <={max_shift}px, rot <={max_rot}deg); MET = "
                                 "full-pipeline EPE < 0.5 x the zero-flow baseline on unseen larger-than-patch "
                                 "images (4-patch grid, blended)"},
        "achieved": epe,
        "full_pipeline_epe_px": epe,
        "zero_flow_baseline_epe_px": zero_epe,
        "patch_level_val_epe_best": min(epes) if epes else None,
        "met": bool(epe < 0.5 * zero_epe),
        "history": history,
    }


def _profile(device) -> str:
    """The size profile of a run on ``device``: ``"gpu"`` on the card (the
    JAX package's ``"tpu"`` sizes), ``"cpu"`` otherwise."""
    return "gpu" if resolve_device(device).type == "cuda" else "cpu"


def _causal_lm_steps(max_latents: int):
    """``_fit``'s step makers for a causal LM over ``max_latents`` latents."""
    return dict(make_train_step=lambda m, tx: make_causal_lm_train_step(m, tx, max_latents=max_latents),
                make_eval_step=lambda m: make_causal_lm_eval_step(m, max_latents=max_latents))


def run_clm(source: str, steps: int, task_name: str = "", profile: str = "", production: bool = False,
            size: str = "", device=None, log_fn: Optional[Callable[[str], None]] = None) -> Dict:
    """Perceiver AR byte CLM convergence, the JAX task's recipe: ``markov``
    trains on a never-repeating order-2 Markov stream sized to the step
    budget (batch 16; the 5m tier 8) and validates on fixed windows;
    ``python_source`` on the python-source corpus (2M / 200k tokens on the
    cpu profile, 8M / 400k on the gpu profile at sequence 1024, batch 8).
    Sequence 256 (cpu) or 512, latents half the sequence, 128 channels in 4
    heads and 2 layers (cpu) or 256 in 8 heads and 4 layers, no prefix
    dropout, float32, AdamW at 2e-3 under ``_fit``'s schedule (warmup at
    most 150). ``production`` (the sharded tasks) needs a data x fsdp mesh
    the port does not have (ROADMAP A5) and raises. ``device`` defaults to
    the card; ``profile`` defaults to the device's."""
    from perceiver_io_torch.data.text.synthetic import SyntheticTextDataModule
    from perceiver_io_torch.models.core.config import CausalSequenceModelConfig
    from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel

    if production:
        raise NotImplementedError("the production tasks train over a data(2) x fsdp(4) mesh; the port has no "
                                  "data or fsdp mesh axes yet (ROADMAP A5)")
    profile = profile or _profile(device)
    small = profile == "cpu"
    seq = 256 if small else 512
    if source == "markov":
        batch = 8 if size == "5m" else 16
        data = SyntheticTextDataModule(source="markov", seq_len=seq, batch_size=batch,
                                       n_train_tokens=steps * batch * (seq + 1),
                                       n_val_tokens=50_000 if small else 100_000,
                                       vocab_size=32 if small else 64)
    else:
        data = SyntheticTextDataModule(source="python_source", seq_len=seq if small else 1024, batch_size=8,
                                       n_train_tokens=2_000_000 if small else 8_000_000,
                                       n_val_tokens=200_000 if small else 400_000)
    data.setup()
    if size == "5m":
        dims = dict(num_channels=256, num_heads=8, num_self_attention_layers=8)
    else:
        dims = dict(num_channels=128 if small else 256, num_heads=4 if small else 8,
                    num_self_attention_layers=2 if small else 4)
    config = CausalSequenceModelConfig(vocab_size=data.effective_vocab_size, max_seq_len=data.seq_len,
                                       max_latents=data.seq_len // 2, cross_attention_dropout=0.0, **dims)
    model = CausalSequenceModel(config, device=device, seed=0)
    history, n_params = _fit(model, data, steps, lr=2e-3, monitor="loss", monitor_mode="min", warmup_cap=150,
                             log_fn=log_fn, **_causal_lm_steps(config.max_latents))
    losses = [h["val_loss"] for h in history if "val_loss" in h]
    achieved = min(losses) if losses else None
    out = {
        "task": task_name or f"clm_{source}",
        "model_params": n_params,
        "achieved_val_ce_nats": achieved,
        "history": history,
        "profile": profile,
    }
    if source == "markov":
        floor = float(data.entropy_floor)
        out["target"] = {"metric": "val_loss", "value": floor, "tolerance_nats": 0.05,
                         "provenance": "analytic conditional entropy of the order-2 Markov corpus"}
        out["met"] = bool(achieved is not None and achieved <= floor + 0.05)
        out["entropy_floor_nats"] = floor
        out["gap_nats"] = None if achieved is None else achieved - floor
    else:
        out["target"] = {"metric": "val_loss", "value": None,
                         "provenance": "no analytic floor for real text; curve recorded"}
        out["bits_per_byte"] = None if achieved is None else achieved / float(np.log(2.0))
        out["met"] = achieved is not None
    return out


def run_audio_markov(steps: int, profile: str = "", device=None,
                     log_fn: Optional[Callable[[str], None]] = None) -> Dict:
    """The audio family's convergence run, the JAX task's recipe: the same
    kind of analytic floor as ``clm_markov``, through ``SymbolicAudioModel``
    with the GiantMIDI recipe's knobs (output norm, no output bias, no
    absolute position embedding), ragged left-padded windows and pad-masked
    labels. Sequence 256 / 128 latents (cpu) or 512 / 256, batch 16, fresh
    chains each epoch (one epoch is the step budget), 256 validation chains;
    128 channels in 4 heads and 2 layers (cpu) or 256 in 8 and 4; float32,
    AdamW at 2e-3. ``device`` defaults to the card."""
    from perceiver_io_torch.data.audio.synthetic import SyntheticMidiDataModule
    from perceiver_io_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig

    profile = profile or _profile(device)
    small = profile == "cpu"
    seq, latents, batch = (256, 128, 16) if small else (512, 256, 16)
    data = SyntheticMidiDataModule(seq_len=seq, max_latents=latents, batch_size=batch,
                                   n_train_chains=steps * batch, n_val_chains=256, vocab_size=32 if small else 64)
    data.setup()
    config = SymbolicAudioModelConfig(
        vocab_size=data.model_vocab_size, max_seq_len=seq, max_latents=latents,
        num_channels=128 if small else 256, num_heads=4 if small else 8,
        num_self_attention_layers=2 if small else 4, cross_attention_dropout=0.0,
        output_norm=True, output_bias=False, abs_pos_emb=False,
    )
    model = SymbolicAudioModel(config, device=device, seed=0)
    history, n_params = _fit(model, data, steps, lr=2e-3, monitor="loss", monitor_mode="min", warmup_cap=150,
                             log_fn=log_fn, **_causal_lm_steps(latents))
    losses = [h["val_loss"] for h in history if "val_loss" in h]
    achieved = min(losses) if losses else None
    floor = float(data.entropy_floor)
    return {
        "task": "audio_markov",
        "model_params": n_params,
        "profile": profile,
        "achieved_val_ce_nats": achieved,
        "target": {"metric": "val_loss", "value": floor, "tolerance_nats": 0.05,
                   "provenance": "analytic conditional entropy of the order-2 Markov event corpus "
                                 "(ragged left-padded windows, pad-masked labels)"},
        "met": bool(achieved is not None and achieved <= floor + 0.05),
        "entropy_floor_nats": floor,
        "gap_nats": None if achieved is None else achieved - floor,
        "history": history,
    }


# the JAX package's task table, in its order (render's section order);
# each entry takes (steps, device): steps 0 or None is the task's default
TASKS = {
    "digits_glyphs": lambda steps, device=None: run_digits("glyphs", steps or 3000, "digits_glyphs", device),
    "digits_glyphs_hard": lambda steps, device=None: run_digits("glyphs_hard", steps or 3000, "digits_glyphs_hard",
                                                                device),
    "digits_sklearn": lambda steps, device=None: run_digits("sklearn_digits", steps or 2000, "digits_sklearn",
                                                            device),
    "clm_markov": lambda steps, device=None: run_clm("markov", steps or 2000, "clm_markov", device=device),
    "clm_markov_sharded": lambda steps, device=None: run_clm("markov", steps or 4000, "clm_markov_sharded",
                                                             profile="cpu", production=True, device=device),
    "clm_markov_5m": lambda steps, device=None: run_clm("markov", steps or 3000, "clm_markov_5m", profile="cpu",
                                                        production=True, size="5m", device=device),
    "clm_pysrc": lambda steps, device=None: run_clm("python_source", steps or 2000, "clm_pysrc", device=device),
    "audio_markov": lambda steps, device=None: run_audio_markov(steps or 2500, device=device),
    "optical_flow_epe": lambda steps, device=None: run_optical_flow_epe(steps or 2500, device),
}
PRODUCTION_TASKS = ("clm_markov_sharded", "clm_markov_5m")


def _spark(values, width=44):
    """ASCII curve: min..max scaled to 8 glyph levels."""
    if not values:
        return ""
    glyphs = "▁▂▃▄▅▆▇█"
    if len(values) > width:
        idx = np.linspace(0, len(values) - 1, width).round().astype(int)
        values = [values[i] for i in idx]
    lo, hi = min(values), max(values)
    span = (hi - lo) or 1.0
    return "".join(glyphs[int((v - lo) / span * 7)] for v in values)


def _section(r: Dict) -> str:
    """One task's markdown section from its recorded result."""
    hist = r.get("history", [])
    metric = r["target"]["metric"]  # the tasks always write val_acc / val_loss / val_epe
    curve = [h[metric] for h in hist if metric in h]
    lines = [f"## {r['task']}", ""]
    lines.append(f"- model params: {r['model_params']:,}" + (f" (profile: {r['profile']})" if r.get("profile") else ""))
    tgt = r["target"]
    if tgt["value"] is not None:
        lines.append(f"- target: {tgt['metric']} {'>=' if 'acc' in tgt['metric'] else '<='} {tgt['value']:.5g}"
                     + (f" (+{tgt['tolerance_nats']} nats tolerance)" if "tolerance_nats" in tgt else "")
                     + f" — {tgt['provenance']}")
    else:
        lines.append(f"- target: none ({tgt['provenance']})")
    ach = r.get("achieved", r.get("achieved_val_ce_nats"))
    ach_s = "n/a (no eval points recorded)" if ach is None else f"{ach:.5g}"
    lines.append(f"- achieved: {ach_s} — **{'MET' if r.get('met') else 'NOT MET'}**")
    if r.get("baseline_val_acc") is not None:
        lines.append(f"- trivial baseline: {r['baseline_val_acc']:.5g} ({r.get('baseline', 'linear probe')})")
    if r.get("zero_flow_baseline_epe_px") is not None:
        lines.append(f"- full-pipeline EPE: {r['full_pipeline_epe_px']:.4g} px vs zero-flow "
                     f"baseline {r['zero_flow_baseline_epe_px']:.4g} px "
                     f"(patch-level best val EPE {r['patch_level_val_epe_best']:.4g} px)")
    if r.get("execution_path"):
        ep = r["execution_path"]
        lines.append(f"- execution path: mesh {ep['mesh']}, {ep['parallel_mode']}; {ep['dtype']}; "
                     f"remat {ep['remat_policy']}; fused_qkv {ep['fused_qkv']}")
    if r.get("entropy_floor_nats") is not None:
        lines.append(f"- analytic floor: {r['entropy_floor_nats']:.5g} nats; gap: {r['gap_nats']:.4g} nats")
    if r.get("bits_per_byte") is not None:
        lines.append(f"- bits/byte: {r['bits_per_byte']:.4g}")
    if curve:
        lines.append(f"- eval curve ({len(curve)} points, first {curve[0]:.4g} → best "
                     f"{(max if 'acc' in metric else min)(curve):.4g}): `{_spark(curve)}`")
    return "\n".join(lines)


def render(out_dir: str, md_path: str = "") -> None:
    """Write ``md_path`` (default ``<out_dir>/CONVERGENCE.md``) from the
    results ``<out_dir>/<task>.json`` recorded there, in ``TASKS``' order,
    one section a task in the JAX package's format."""
    md_path = md_path or os.path.join(out_dir, "CONVERGENCE.md")
    sections = []
    for name in TASKS:
        path = os.path.join(out_dir, f"{name}.json")
        if os.path.exists(path):
            with open(path) as f:
                sections.append(_section(json.load(f)))
    doc = [
        "# Convergence evidence (PyTorch port)",
        "",
        "Learning curves per model family, trained by `perceiver_io_torch` with no",
        "network access. The data sources and the analytic loss targets live in",
        "`perceiver_io_torch/data/{vision,text,audio}/synthetic.py`; rerun a curve",
        "with `python3 -m perceiver_io_torch.scripts.convergence --task <name>`",
        "(on the card; `--device cpu` for the small CPU profile) and regenerate",
        "this file with `--render`. Each result's `profile` says which sizes ran:",
        "`gpu` (the card) or `cpu`.",
        "",
        "The `clm_markov` run is the strongest correctness statement: its corpus",
        "has an analytically computed conditional entropy, so the validation CE",
        "target is exact, and reaching it checks the model, the loss, the",
        "optimizer, the data pipeline and the eval loop end to end.",
        "",
        *sections,
        "",
    ]
    with open(md_path, "w") as f:
        f.write("\n".join(doc))
    print(f"wrote {md_path}")


def _supervise(argv) -> int:
    """Relaunch-until-progress wrapper, as the JAX package's: run this module
    (``argv`` without ``--supervise``) as a child, forward its output, and
    kill it when it prints nothing for the stall window (1200 s, or
    ``PERCEIVER_IO_TORCH_SUPERVISE_STALL_S``), up to 3 attempts; returns 1
    when all three stalled. A child that exits on its own returns its exit
    code, without a retry."""
    import subprocess
    import sys
    import time

    child_argv = [a for a in argv if a != "--supervise"]
    cmd = [sys.executable, "-u", "-m", "perceiver_io_torch.scripts.convergence", *child_argv]
    stall_s = float(os.environ.get("PERCEIVER_IO_TORCH_SUPERVISE_STALL_S", "1200"))
    for attempt in (1, 2, 3):
        # a binary pipe: a non-blocking text stream raises when nothing is buffered
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        os.set_blocking(proc.stdout.fileno(), False)

        def drain():
            chunk = proc.stdout.read()
            if chunk:
                print(chunk.decode(errors="replace"), end="", flush=True)
                return True
            return False

        last_output = time.time()
        stalled = False
        while True:
            if drain():
                last_output = time.time()
            if proc.poll() is not None:
                drain()
                break
            if time.time() - last_output > stall_s:
                print(f"[supervise] no output for {stall_s:.0f}s — killing wedged attempt {attempt}", flush=True)
                proc.kill()
                proc.wait()
                drain()  # whatever the child had buffered before it stalled
                stalled = True
                break
            time.sleep(0.2)
        proc.stdout.close()
        if not stalled:
            return proc.returncode
    print("[supervise] 3 attempts all wedged", flush=True)
    return 1


def main(argv=None) -> None:
    # allow_abbrev=False: _supervise forwards argv minus the literal
    # "--supervise"; an abbreviation surviving into the child would recurse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    p.add_argument("--task", default="all", choices=[*TASKS, "all"])
    p.add_argument("--steps", type=int, default=0, help="0 = the task's default")
    p.add_argument("--out", default="convergence_torch")
    p.add_argument("--device", default=None, help="the card by default; cpu runs the small profile")
    p.add_argument("--render", action="store_true", help="regenerate <out>/CONVERGENCE.md from recorded results")
    p.add_argument("--supervise", action="store_true",
                   help="relaunch a child that prints nothing for the stall window (see _supervise)")
    args = p.parse_args(argv)
    if args.supervise:
        import sys

        raise SystemExit(_supervise(argv if argv is not None else sys.argv[1:]))
    if args.render:
        render(args.out)
        return
    names = list(TASKS) if args.task == "all" else [args.task]
    for name in PRODUCTION_TASKS:
        if name in names:
            msg = (f"{name} trains over a data(2) x fsdp(4) mesh; the port has no data or fsdp mesh axes "
                   "yet (ROADMAP A5)")
            if args.task != "all":
                raise SystemExit(msg)
            names.remove(name)
            print(f"skipping {name}: {msg}")
    os.makedirs(args.out, exist_ok=True)
    for name in names:
        result = TASKS[name](args.steps, args.device)
        with open(os.path.join(args.out, f"{name}.json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps({k: v for k, v in result.items() if k != "history"}))
        render(args.out)


if __name__ == "__main__":
    main()
