"""Port parity: ``TextGenerationPipeline`` and ``SymbolicAudioPipeline``
(``perceiver_io_torch/pipelines.py``) and the two aliases
(``models/text/clm``, ``models/audio/symbolic``) against the JAX package's,
in float64 on converted weights: the same greedy text on the engine path and
on the direct path, the same continued MIDI (notes and file bytes), and JAX
parameters loaded into each alias through ``convert_jax.py``.

Engine prompts are at least ``max_latents`` tokens long (ROADMAP C1)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_torch import pipelines as tpipe
from perceiver_io_torch.convert_jax import load_jax_params
from perceiver_io_torch.data.audio import midi_processor as tmp
from perceiver_io_torch.data.audio import smf as tsmf
from perceiver_io_torch.generation.generate import generate
from perceiver_io_torch.models.audio.symbolic import SymbolicAudioModel, SymbolicAudioModelConfig
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
from perceiver_io_tpu import pipelines as jpipe
from perceiver_io_tpu.data.audio import midi_processor as jmp
from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModel as JaxSymbolicAudioModel
from perceiver_io_tpu.models.audio.symbolic import SymbolicAudioModelConfig as JaxSymbolicAudioModelConfig
from perceiver_io_tpu.models.text.clm import CausalLanguageModel as JaxCausalLanguageModel
from perceiver_io_tpu.models.text.clm import CausalLanguageModelConfig as JaxCausalLanguageModelConfig

TEXT = dict(vocab_size=262, max_seq_len=32, max_latents=8, num_channels=32, num_heads=2,
            num_self_attention_layers=2, cross_attention_dropout=0.0, init_scale=0.5)
AUDIO = dict(vocab_size=389, max_seq_len=48, max_latents=12, num_channels=32, num_heads=2,
             num_self_attention_layers=1, cross_attention_dropout=0.0, init_scale=0.5, abs_pos_emb=False)
PROMPTS = ["def forward(self, x):", "import numpy as np", "return torch.cat([a, b])", "class Model(nn.Module):"]


def _alias_pair(jax_cls, jax_cfg_cls, port_cls, port_cfg_cls, kw, seed=0):
    jm = jax_cls(config=jax_cfg_cls(**kw), param_dtype=jnp.float64)
    params = jax.jit(jm.init, static_argnames="prefix_len")(jax.random.PRNGKey(seed),
                                                             jnp.zeros((1, kw["max_latents"]), jnp.int32),
                                                             prefix_len=2)
    tm = port_cls(port_cfg_cls(**kw), device="cpu", param_dtype=torch.float64, seed=seed + 1)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def text_pair(x64_module):
    return _alias_pair(JaxCausalLanguageModel, JaxCausalLanguageModelConfig, CausalLanguageModel,
                       CausalLanguageModelConfig, TEXT, seed=3)


@pytest.fixture(scope="module")
def audio_pair(x64_module):
    return _alias_pair(JaxSymbolicAudioModel, JaxSymbolicAudioModelConfig, SymbolicAudioModel,
                       SymbolicAudioModelConfig, AUDIO, seed=4)


@pytest.fixture(scope="module")
def x64_module():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("kind", ["clm", "symbolic"])
def test_aliases_load_jax_params_and_give_jaxs_logits(x64_module, kind):
    """At the default init scale (logits of order 1), as the port's other
    float64 inference parity tests run."""
    classes = ((JaxCausalLanguageModel, JaxCausalLanguageModelConfig, CausalLanguageModel, CausalLanguageModelConfig)
               if kind == "clm" else
               (JaxSymbolicAudioModel, JaxSymbolicAudioModelConfig, SymbolicAudioModel, SymbolicAudioModelConfig))
    cfg = dict(TEXT if kind == "clm" else AUDIO, init_scale=0.02)
    jm, params, tm = _alias_pair(*classes, cfg, seed=5)
    assert isinstance(tm, CausalSequenceModel)
    x = np.random.RandomState(1).randint(0, cfg["vocab_size"], (2, cfg["max_seq_len"]))
    want = np.asarray(jm.apply(params, jnp.asarray(x), prefix_len=8))
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), 8).numpy()
    np.testing.assert_allclose(got, want, atol=5e-8, rtol=1e-7)


@pytest.mark.parametrize("case", ["engine", "engine_eos", "direct_num_latents", "direct_single", "direct_forced"])
def test_text_generation_pipeline_matches_jax(text_pair, case):
    jm, params, tm = text_pair
    kw = dict(max_new_tokens=6)
    prompts, call = PROMPTS, {}
    if case == "engine_eos":
        kw["eos_token_id"] = 2
    elif case == "direct_num_latents":
        call["num_latents"] = 3
    elif case == "direct_single":
        prompts = PROMPTS[0]
    elif case == "direct_forced":
        call["use_engine"] = False
    port = tpipe.TextGenerationPipeline(tm)
    theirs = jpipe.TextGenerationPipeline(jm, params)
    got = port(prompts, **call, **kw)
    want = theirs(prompts, **call, **kw)
    assert got == want
    if case.startswith("engine"):
        assert port._engine_inst is not None and port._engine_inst.num_slots == 4
        assert port(prompts[:2], **kw) == theirs(prompts[:2], **kw)  # the same engine again, a smaller batch
    else:
        assert port._engine_inst is None


def test_text_engine_path_is_generate_on_the_canonical_padding(text_pair):
    """JAX's stated contract: engine output = generate() on the prompt
    left-padded to the full window with num_latents = max_latents."""
    _, _, tm = text_pair
    pipe = tpipe.TextGenerationPipeline(tm)
    out = pipe(PROMPTS, max_new_tokens=5)
    tok = pipe._tokenizer
    window = tm.max_seq_len
    for prompt, text in zip(PROMPTS, out):
        ids = tok.encode(prompt)
        x = torch.full((1, window), tok.pad_token_id, dtype=torch.long)
        x[0, window - len(ids):] = torch.tensor(ids)
        pad = torch.ones(1, window, dtype=torch.bool)
        pad[0, window - len(ids):] = False
        tokens = generate(tm, x, num_latents=tm.max_latents, pad_mask=pad, max_new_tokens=5)[0, window:].tolist()
        assert text == prompt + tok.decode([t for t in tokens if t != tok.pad_token_id])


def test_text_pipeline_refuses_what_jax_refuses(text_pair):
    jm, params, tm = text_pair
    for call in (dict(num_latents=2, use_engine=True), dict(use_engine=True, num_beams=2)):
        with pytest.raises(ValueError) as got:
            tpipe.TextGenerationPipeline(tm)(PROMPTS, max_new_tokens=2, **call)
        with pytest.raises(ValueError) as want:
            jpipe.TextGenerationPipeline(jm, params)(PROMPTS, max_new_tokens=2, **call)
        assert str(got.value) == str(want.value)


def _melody(mod, seed=0):
    rs = np.random.RandomState(seed)
    notes, t = [], 0.0
    for _ in range(12):
        t += float(rs.choice([0.0, 0.1, 0.25]))
        notes.append(mod.Note(int(rs.randint(48, 84)), int(rs.randint(30, 120)), round(t, 2),
                              round(t + float(rs.choice([0.1, 0.3, 0.6])), 2)))
    pedal = [mod.ControlChange(64, 127, 0.2), mod.ControlChange(64, 0, 0.9)]
    return notes, pedal


@pytest.mark.parametrize("form", ["path", "smf", "notes", "tokens", "array"])
def test_symbolic_audio_pipeline_matches_jax(audio_pair, tmp_path, form):
    jm, params, tm = audio_pair
    tnotes, tpedal = _melody(tmp)
    jnotes, jpedal = _melody(jmp)
    path = tmp_path / "prompt.mid"
    tsmf.write_smf(path, tnotes, tpedal)
    tokens = tmp.encode_notes(tnotes, tpedal)
    port_in, jax_in = {
        "path": (path, str(path)),
        "smf": (tsmf.read_smf(path), tsmf.read_smf(path)),
        "notes": (tnotes, jnotes),
        "tokens": (tokens, tokens),
        "array": (np.asarray(tokens, np.int16), np.asarray(tokens, np.int16)),
    }[form]
    kw = dict(num_latents=6, max_prompt_tokens=AUDIO["max_seq_len"] - 8, max_new_tokens=8)
    got = tpipe.SymbolicAudioPipeline(tm)(port_in, output_midi_path=str(tmp_path / "port.mid"), **kw)
    want = jpipe.SymbolicAudioPipeline(jm, params)(jax_in, output_midi_path=str(tmp_path / "jax.mid"), **kw)
    assert [dataclasses.astuple(n) for n in got.notes] == [dataclasses.astuple(n) for n in want.notes]
    assert (tmp_path / "port.mid").read_bytes() == (tmp_path / "jax.mid").read_bytes()
    notes = tpipe.SymbolicAudioPipeline(tm)(port_in, return_notes=True, **kw)
    assert [dataclasses.astuple(n) for n in notes] == [dataclasses.astuple(n) for n in got.notes]


def test_symbolic_audio_pipeline_equals_generate_on_the_prompt(audio_pair):
    _, _, tm = audio_pair
    notes, pedal = _melody(tmp, seed=2)
    tokens = tmp.encode_notes(notes, pedal)[-30:]
    out = generate(tm, torch.tensor(tokens)[None], num_latents=1, max_new_tokens=6)[0].tolist()
    got = tpipe.SymbolicAudioPipeline(tm)(tokens, return_notes=True, max_new_tokens=6)
    assert [dataclasses.astuple(n) for n in got] == [dataclasses.astuple(n) for n in tmp.decode_notes(out)]


def test_render_wav_fails_as_jaxs_does_without_fluidsynth(tmp_path, monkeypatch):
    """The WAV render is a fluidsynth subprocess in both packages; where the
    program is missing both raise the same error."""
    monkeypatch.setenv("PATH", str(tmp_path))  # no fluidsynth on this PATH
    doc = tsmf.SMF(notes=_melody(tmp)[0])
    with pytest.raises(FileNotFoundError) as got:
        tpipe.SymbolicAudioPipeline.render_wav(doc, str(tmp_path / "out.wav"))
    with pytest.raises(FileNotFoundError) as want:
        jpipe.SymbolicAudioPipeline.render_wav(doc, str(tmp_path / "out.wav"))
    assert type(got.value) is type(want.value)
