"""Inference pipelines: text generation, optical flow, symbolic audio.

Port of ``perceiver_io_tpu/pipelines.py``. The pipelines hold a port model
(its weights are its own, so there is no ``params`` field) and run on the
model's device:
  - ``TextGenerationPipeline``: prompt text -> generated text through
    ``generate()`` or, for a batch of prompts, the ``ServingEngine``;
  - ``OpticalFlowPipeline``: frame pairs -> patch features -> the model,
    micro-batched -> distance-weighted blending of the patches' flows
    (optionally rendered to RGB);
  - ``SymbolicAudioPipeline``: MIDI -> event tokens -> ``generate()`` -> MIDI,
    optionally rendered to WAV by a ``fluidsynth`` subprocess.
Where the JAX pipelines take a PRNG key and fold it with the prompt's index,
these take an integer ``seed`` and give prompt ``i`` the seed ``seed + i``
(ROADMAP C19); greedy output does not depend on it.
"""

from __future__ import annotations

import dataclasses
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from perceiver_io_torch.data.text.tokenizer import get_tokenizer
from perceiver_io_torch.data.vision.optical_flow import OpticalFlowProcessor, render_optical_flow
from perceiver_io_torch.generation.generate import GenerationConfig, generate


@dataclass
class TextGenerationPipeline:
    """Prompt text -> generated text for CausalSequenceModel-family models.

    Single prompts (or ``use_engine=False``) run the one-shot ``generate()``
    path on left-padded prompts. Multi-prompt batches route through the
    continuous-batching ``ServingEngine`` when ``num_latents`` is not passed
    (any explicit value, including 1, pins the direct path) and the
    generation config is servable (no beams, contrastive search or chunked
    speculation): requests of different prompt lengths decode together, EOS'd
    prompts free their slot early, and later calls reuse the one engine (its
    decode graph and pools) whatever the batch. The engine's canonical form
    pads every prompt to the full model window with ``num_latents =
    max_latents``, so engine-path output corresponds to ``generate()`` on
    that canonical padding rather than on the batch-max padding of the
    direct path."""

    model: torch.nn.Module
    tokenizer: Union[str, object] = "bytes"
    engine_slots: Optional[int] = None  # None: one slot per prompt of the first batch (2 to 8)
    # prompts are always LEFT-padded: causal LMs decode from the end of the
    # window, which left padding keeps aligned for every prompt

    def __post_init__(self):
        self._tokenizer = get_tokenizer(self.tokenizer) if isinstance(self.tokenizer, str) else self.tokenizer
        # ONE engine for the pipeline's lifetime, sized at first use; batches
        # larger than its slots queue (the scheduler multiplexes slots)
        self._engine_inst = None

    def _engine(self, first_batch: int):
        from perceiver_io_torch.serving import ServingEngine

        if self._engine_inst is None:
            num_slots = self.engine_slots or min(max(first_batch, 2), 8)
            self._engine_inst = ServingEngine(self.model, num_slots=num_slots)
        return self._engine_inst

    def _generate_via_engine(self, seqs, config: GenerationConfig, seed: int) -> List[List[int]]:
        # the engine left-pads its canonical form with config.pad_token_id;
        # keep that aligned with the tokenizer's pad id (the direct path's
        # padding) or pad-position embeddings would differ between the paths
        if config.pad_token_id != self._tokenizer.pad_token_id:
            config = dataclasses.replace(config, pad_token_id=self._tokenizer.pad_token_id)
        engine = self._engine(len(seqs))
        handles = [engine.submit(s, config=config, seed=seed + i) for i, s in enumerate(seqs)]
        engine.run_until_drained()
        # the pipeline gates lengths and config before routing here and its
        # engine has no queue bound or deadline, so every handle must have
        # completed; a non-ok handle would mean returning the bare prompt as
        # if generation succeeded
        bad = [h for h in handles if not h.ok]
        if bad:
            raise RuntimeError(
                "engine did not complete "
                f"{[(h.request_id, h.status.value, h.finish_reason) for h in bad]}"
            )
        return [h.output_ids for h in handles]

    def __call__(
        self,
        prompts: Union[str, Sequence[str]],
        num_latents: Optional[int] = None,
        seed: int = 0,
        use_engine: Optional[bool] = None,
        **generation_kwargs,
    ) -> Union[str, List[str]]:
        single = isinstance(prompts, str)
        texts = [prompts] if single else list(prompts)
        tok = self._tokenizer
        seqs = [tok.encode(t) for t in texts]

        config = generation_kwargs.pop("config", None)
        if config is None:
            config = GenerationConfig(**generation_kwargs)
        elif generation_kwargs:
            raise ValueError("pass either config or keyword options, not both")
        from perceiver_io_torch.serving.engine import _engine_compatible

        # prompt lengths outside the engine's admissible range (empty, or
        # longer than the window) are gated HERE so a mid-batch submit can
        # never fail after earlier requests were already queued on the
        # shared engine
        engine_ok = (
            len(seqs) > 1
            and num_latents is None
            and all(0 < len(s) <= self.model.max_seq_len for s in seqs)
            and _engine_compatible(config) is None
        )
        if use_engine is None:
            use_engine = engine_ok
        elif use_engine and not engine_ok:
            reason = _engine_compatible(config) or (
                "an explicit num_latents pins generate() (the engine decodes with max_latents)"
                if num_latents is not None
                else f"empty prompt or prompt longer than the window ({self.model.max_seq_len})"
                if not all(0 < len(s) <= self.model.max_seq_len for s in seqs)
                else "single prompt"
            )
            raise ValueError(
                "use_engine=True requires a batch of > 1 prompts, default "
                f"num_latents, and an engine-servable config (reason: {reason})"
            )
        if use_engine:
            outputs = self._generate_via_engine(seqs, config, seed)
            decoded = [tok.decode([t for t in out if t != tok.pad_token_id]) for out in outputs]
            return [prompt + cont for prompt, cont in zip(texts, decoded)]

        n = max(len(s) for s in seqs)
        ids = np.full((len(seqs), n), tok.pad_token_id, np.int64)
        pad = np.ones((len(seqs), n), bool)
        for i, s in enumerate(seqs):  # left padding
            ids[i, n - len(s):] = s
            pad[i, n - len(s):] = False
        device = self.model.device
        out = generate(self.model, torch.from_numpy(ids), num_latents=1 if num_latents is None else num_latents,
                       pad_mask=torch.from_numpy(pad), generator=torch.Generator(device).manual_seed(seed),
                       config=config)
        decoded = [tok.decode([t for t in row[n:].tolist() if t != tok.pad_token_id]) for row in out.cpu()]
        results = [prompt + cont for prompt, cont in zip(texts, decoded)]
        return results[0] if single else results


@dataclass
class OpticalFlowPipeline:
    """Frame pairs (H, W, 3) -> dense flow fields (N, H, W, 2) in float32
    (or (N, H, W, 3) uint8 with ``render``). The model runs under
    ``torch.inference_mode()`` on its own device, ``micro_batch_size``
    patches a call."""

    model: torch.nn.Module
    patch_size: Tuple[int, int] = (368, 496)
    patch_min_overlap: int = 20
    flow_scale_factor: int = 20
    micro_batch_size: int = 1

    def __post_init__(self):
        self.processor = OpticalFlowProcessor(self.patch_size, self.patch_min_overlap, self.flow_scale_factor)

    def _forward(self, x: np.ndarray) -> np.ndarray:
        device = next(self.model.parameters()).device
        with torch.inference_mode():
            flow = self.model(torch.from_numpy(np.ascontiguousarray(x)).to(device))
        return flow.float().cpu().numpy()

    def __call__(self, image_pairs: Sequence[Tuple[np.ndarray, np.ndarray]], render: bool = False) -> np.ndarray:
        flow = self.processor.process(self._forward, list(image_pairs), batch_size=self.micro_batch_size)
        if render:
            return np.stack([render_optical_flow(f) for f in flow])
        return flow


@dataclass
class SymbolicAudioPipeline:
    """MIDI (a file, an ``SMF`` document, ``Note`` records or event tokens)
    -> continued MIDI through a SymbolicAudioModel's ``generate()``;
    optional WAV rendering through fluidsynth (a subprocess)."""

    model: torch.nn.Module

    def __call__(
        self,
        midi: object,
        num_latents: int = 1,
        max_prompt_tokens: Optional[int] = None,
        seed: int = 0,
        output_midi_path: Optional[str] = None,
        render_wav_path: Optional[str] = None,
        soundfont_path: Optional[str] = None,
        return_notes: bool = False,
        **generation_kwargs,
    ):
        """``midi`` may be a .mid path (parsed by ``smf.read_smf``), an
        ``smf.SMF`` or pretty_midi-shaped document, a sequence of
        ``midi_processor.Note`` records, a sequence of event-token ints or a
        numpy token array (e.g. ``encode_midi_file`` output). The prompt is
        its last ``max_prompt_tokens`` tokens. With ``return_notes=True`` the
        return value is plain ``Note`` records; otherwise an ``smf.SMF``
        document, written to ``output_midi_path`` when given."""
        from perceiver_io_torch.data.audio.midi_processor import (
            Note,
            decode_midi,
            decode_notes,
            encode_midi,
            encode_notes,
        )

        if isinstance(midi, (str, Path)):
            from perceiver_io_torch.data.audio.smf import read_smf

            midi = read_smf(str(midi))
        if isinstance(midi, np.ndarray):
            midi = midi.tolist()
        if isinstance(midi, (list, tuple)):
            if midi and all(isinstance(n, Note) for n in midi):
                tokens = encode_notes(list(midi))
            elif all(isinstance(t, (int, np.integer)) for t in midi):
                tokens = list(midi)
            else:
                raise TypeError(
                    "midi sequence must be all midi_processor.Note records or all int event tokens"
                )
        else:
            tokens = encode_midi(midi)
        if max_prompt_tokens is not None:
            tokens = tokens[-max_prompt_tokens:]
        prompt = torch.tensor(tokens, dtype=torch.long)[None]
        generator = torch.Generator(self.model.device).manual_seed(seed)
        out = generate(self.model, prompt, num_latents=num_latents, generator=generator, **generation_kwargs)
        out_tokens = out[0].tolist()
        if output_midi_path is not None or render_wav_path is not None:
            generated = decode_midi(out_tokens, file_path=output_midi_path)
            if render_wav_path is not None:
                self.render_wav(generated, render_wav_path, soundfont_path)
            if not return_notes:
                return generated
        if return_notes:
            return decode_notes(out_tokens)
        return decode_midi(out_tokens)

    @staticmethod
    def render_wav(midi, wav_path: str, soundfont_path: Optional[str] = None) -> None:
        """Render MIDI to WAV with the ``fluidsynth`` program (a subprocess;
        raises if it is missing or fails)."""
        with tempfile.NamedTemporaryFile(suffix=".mid") as f:
            midi.write(f.name)
            cmd = ["fluidsynth", "-ni", "-F", wav_path]
            if soundfont_path:
                cmd.insert(1, soundfont_path)
            cmd.append(f.name)
            subprocess.run(cmd, check=True, capture_output=True)
