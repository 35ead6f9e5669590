"""Port parity of training: perceiver_io_torch's causal-LM loss, gradients,
train step, optimizer, schedules, FLOPs model and synthetic data against the
JAX package, in float64 on the same weights and numpy inputs.

Tolerances and why:
- the JAX package casts logits to float32 for the cross-entropy and takes
  attention scores and the softmax in float32 even under x64, so a float64
  loss carries float32 roundings: losses within rtol 1e-6, gradients within
  atol 1e-6 x the tree's largest gradient (measured up to ~2e-8 relative);
- a flash-gated model (heads of 64) runs the port's plain flash attention
  in float64 where the JAX package (no splash on the CPU) rounds scores to
  float32: the same limits hold;
- trajectories: AdamW normalises each step, so float32-level differences in
  the gradients stay at that level: per-step losses within rtol 1e-6; the
  final parameters within atol 1e-6, a thousandth of one update's size
  (3e-3): the normalised step turns float32 noise in a near-zero gradient
  component into a parameter change of up to ~4e-8 (measured);
- schedules: the JAX package evaluates them in float32 (the cosine of a
  float32 argument): rtol 1e-5;
- the FLOPs model is the same Python arithmetic: equal; the data module is
  the same numpy calls: bit for bit.
Prefix dropout gets the same random draws in both packages: the test
replaces ``jax.random.uniform``/``bernoulli`` and the port's
``prefix_dropout_draws`` (the JAX package is not edited).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_support import FLAVOURS, SMALL, build_pair, left_pad_mask, tokens

import perceiver_io_torch.models.core.perceiver_ar as tpar
from perceiver_io_torch.convert_jax import jax_params_to_state_dict
from perceiver_io_torch.data.text.synthetic import SyntheticTextDataModule
from perceiver_io_torch.models.core.config import CausalSequenceModelConfig, flagship_455m_config
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.ops import flash as fl
from perceiver_io_torch.training import losses as tl
from perceiver_io_torch.training import lrs as tlrs
from perceiver_io_torch.training.flops import PerceiverARFlops, mfu
from perceiver_io_torch.training.trainer import (TrainState, build_optimizer, make_causal_lm_eval_step,
                                                 make_causal_lm_train_step, trainable)
from perceiver_io_tpu.data.text.synthetic import SyntheticTextDataModule as JaxData
from perceiver_io_tpu.models.core.config import CausalSequenceModelConfig as JaxConfig
from perceiver_io_tpu.models.core.perceiver_ar import CausalSequenceModel as JaxModel
from perceiver_io_tpu.training import losses as jl
from perceiver_io_tpu.training import lrs as jlrs
from perceiver_io_tpu.training import trainer as jtr
from perceiver_io_tpu.training.flops import PerceiverARFlops as JaxFlops
from perceiver_io_tpu.training.flops import mfu as jax_mfu

LOSS_RTOL = 1e-6
GRAD_REL = 1e-6
# heads of 64 channels, 128 latents over 256 tokens: every attention call of
# the uncached forward passes flash_supported
FLASH_SHAPE = dict(SMALL, max_seq_len=256, max_latents=128, num_channels=128, num_heads=2, abs_pos_emb=False,
                   num_self_attention_rotary_layers=-1)


def _batch(b, n, pads=None, seed=0):
    x = tokens(b, n, seed=seed)
    pad = None if pads is None else left_pad_mask(b, n, pads)
    if pad is not None:
        x = np.where(pad, 0, x)
    return x, np.roll(x, -1, axis=1), pad


def _jax_loss_and_grads(jm, params, x, labels, pad, prefix_len, rngs=None):
    labels = jnp.where(jnp.asarray(pad), jl.IGNORE_INDEX, labels) if pad is not None else jnp.asarray(labels)
    labels = labels[:, prefix_len:]

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(x), prefix_len=prefix_len,
                          pad_mask=None if pad is None else jnp.asarray(pad), rngs=rngs)
        return jl.cross_entropy(logits, labels)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads))


def _port_loss_and_grads(tm, x, labels, pad, prefix_len, generator=None):
    tm.train()
    labels = torch.from_numpy(labels).long()
    pad_t = None if pad is None else torch.from_numpy(pad)
    if pad_t is not None:
        labels = labels.masked_fill(pad_t, tl.IGNORE_INDEX)
    logits = tm(torch.from_numpy(x).long(), prefix_len, pad_mask=pad_t, generator=generator)
    loss = tl.cross_entropy(logits, labels[:, prefix_len:])
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, trainable(tm))
    return loss.item(), dict(zip(names, grads))


def _same_grads(got, want):
    assert set(got) == set(want)
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=GRAD_REL * scale,
                                   err_msg=name)


@pytest.fixture(scope="module", params=sorted(FLAVOURS))
def pair(request, x64):
    return build_pair(FLAVOURS[request.param])


@pytest.mark.parametrize("pads", [None, [0, 3]], ids=["unpadded", "left_padded"])
def test_loss_and_gradient_tree_match_jax(pair, pads):
    jm, params, tm = pair
    x, labels, pad = _batch(2, 16, pads)
    want_loss, want_grads = _jax_loss_and_grads(jm, params, x, labels, pad, prefix_len=4)
    loss, grads = _port_loss_and_grads(tm, x, labels, pad, prefix_len=4)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    _same_grads(grads, want_grads)


@pytest.fixture(scope="module")
def flash_pair(x64):
    return build_pair(FLASH_SHAPE, seed=3)


def _count_flash(monkeypatch):
    calls = {"forward": 0, "backward": 0}
    fwd, bwd = fl._forward_plain, fl._backward_plain

    def counted(name, fn):
        def run(*args):
            calls[name] += 1
            return fn(*args)
        return run

    monkeypatch.setattr(fl, "_forward_plain", counted("forward", fwd))
    monkeypatch.setattr(fl, "_backward_plain", counted("backward", bwd))
    return calls


def test_flash_gated_model_matches_jax(flash_pair, monkeypatch):
    """Every attention call of this model's forward takes the plain flash
    route (1 cross-attention + 2 self-attention calls, forward and
    backward), and the loss and gradients match the JAX package's masked
    softmax."""
    jm, params, tm = flash_pair
    x, labels, pad = _batch(2, 256, [0, 40], seed=4)
    want_loss, want_grads = _jax_loss_and_grads(jm, params, x, labels, pad, prefix_len=128)
    calls = _count_flash(monkeypatch)
    loss, grads = _port_loss_and_grads(tm, x, labels, pad, prefix_len=128)
    assert calls == {"forward": 3, "backward": 3}
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    _same_grads(grads, want_grads)


@pytest.mark.parametrize("mode", ["gather", "mask"])
@pytest.mark.parametrize("pads", [None, [0, 3]], ids=["unpadded", "left_padded"])
def test_prefix_dropout_with_the_same_draws_matches_jax(x64, monkeypatch, mode, pads):
    """The 30M flavour with cross-attention dropout 0.5 in training mode;
    both packages get the same uniform draws (gather: the top half of the
    prefix kept) or Bernoulli drops (mask)."""
    cfg = dict(FLAVOURS["30m"], cross_attention_dropout=0.5, cross_attention_dropout_mode=mode)
    _, params, tm = build_pair(cfg, seed=1)
    jm = JaxModel(config=JaxConfig(**cfg), deterministic=False, param_dtype=jnp.float64)
    prefix_len = 4
    u = np.random.RandomState(7).rand(2, prefix_len)
    drops = u < 0.5
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape, *a, **k: jnp.asarray(u))
    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape, *a, **k: jnp.asarray(drops))
    monkeypatch.setattr(tpar, "prefix_dropout_draws",
                        lambda m, rate, shape, generator, device: torch.from_numpy(u if m == "gather" else drops))
    x, labels, pad = _batch(2, 16, pads, seed=2)
    want_loss, want_grads = _jax_loss_and_grads(jm, params, x, labels, pad, prefix_len,
                                                rngs={"dropout": jax.random.PRNGKey(0)})
    loss, grads = _port_loss_and_grads(tm, x, labels, pad, prefix_len)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_RTOL)
    _same_grads(grads, want_grads)
    tm.eval()
    with torch.no_grad():  # the draws took effect: eval mode (no dropout) gives another loss
        no_drop = tl.cross_entropy(tm(torch.from_numpy(x).long(), prefix_len), torch.from_numpy(labels).long()[:, prefix_len:])
    assert pads is not None or abs(no_drop.item() - loss) > 1e-6


STEPS = 5


def _trajectory_batches():
    batches = []
    rs = np.random.RandomState(42)
    for i in range(STEPS * 2):
        x = rs.randint(1, 9, (3, 16)).astype(np.int32)
        pad = np.zeros((3, 16), bool)
        if i % 2:
            pad[0, :3] = True  # left pads inside the prefix
            x[pad] = 0
        batches.append((x, np.roll(x, -1, 1), pad))
    return batches


@pytest.mark.parametrize("accumulate", [1, 2])
def test_train_step_trajectory_matches_jax(x64, accumulate):
    """make_causal_lm_train_step with clipping (triggered) and a cosine
    warm-up schedule: STEPS optimizer updates (x accumulate micro-batches),
    per-step losses and the final parameters against the JAX factories."""
    cfg = FLAVOURS["30m"]
    jm, params, tm = build_pair(cfg, seed=5)
    max_latents = cfg["max_latents"]
    sched = dict(training_steps=STEPS, warmup_steps=2)
    jtx = jtr.build_optimizer(jlrs.cosine_with_warmup(3e-3, **sched), weight_decay=0.01, max_grad_norm=0.5,
                              accumulate_steps=accumulate)
    jstate = jtr.TrainState.create(params, jtx)
    jstep = jax.jit(jtr.make_causal_lm_train_step(jm, jtx, max_latents=max_latents))
    ttx = build_optimizer(tlrs.cosine_with_warmup(3e-3, **sched), weight_decay=0.01, max_grad_norm=0.5,
                          accumulate_steps=accumulate)
    tstate = TrainState.create(tm, ttx)
    tstep = make_causal_lm_train_step(tm, ttx, max_latents=max_latents)
    want, got = [], []
    for x, labels, pad in _trajectory_batches()[: STEPS * accumulate]:
        jstate, jm_metrics = jstep(jstate, {"input_ids": jnp.asarray(x), "labels": jnp.asarray(labels),
                                            "pad_mask": jnp.asarray(pad)})
        tstate, tm_metrics = tstep(tstate, {"input_ids": torch.from_numpy(x), "labels": torch.from_numpy(labels),
                                            "pad_mask": torch.from_numpy(pad)})
        want.append(float(jm_metrics["loss"]))
        got.append(tm_metrics["loss"].item())
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0] - 0.05  # the run descends
    assert tstate.step == STEPS * accumulate and tstate.opt_state.count == STEPS
    final = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, jstate.params))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), final[name], rtol=0, atol=1e-6, err_msg=name)

    jeval = jtr.make_causal_lm_eval_step(jm, max_latents=max_latents)
    teval = make_causal_lm_eval_step(tm, max_latents=max_latents)
    x, labels, pad = _trajectory_batches()[1]
    w = jeval(jstate.params, {"input_ids": jnp.asarray(x), "labels": jnp.asarray(labels),
                              "pad_mask": jnp.asarray(pad)})
    g = teval({"input_ids": torch.from_numpy(x), "labels": torch.from_numpy(labels), "pad_mask": torch.from_numpy(pad)})
    np.testing.assert_allclose(g["loss"].item(), float(w["loss"]), rtol=LOSS_RTOL)
    assert int(g["count"]) == int(w["count"]) == 3 * max_latents


def test_optimizer_schedule_and_clipping_follow_optax(x64):
    """The first update has learning rate 0 under warmup (the schedule reads
    the count before it increments), and clipping scales by max / norm only
    when the norm reaches max."""
    p = [torch.ones(3, dtype=torch.float64)]
    tx = build_optimizer(tlrs.constant_with_warmup(1.0, warmup_steps=2), max_grad_norm=1.0)
    st = tx.init(p)
    tx.update_(p, [torch.full((3,), 5.0, dtype=torch.float64)], st)
    assert torch.equal(p[0], torch.ones(3, dtype=torch.float64)) and st.count == 1
    g = [torch.tensor([3.0, 4.0, 0.0], dtype=torch.float64)]  # norm 5: clipped to norm 1
    tx2 = build_optimizer(1.0, max_grad_norm=1.0)
    st2 = tx2.init(p)
    tx2._inner_update_([p[0].clone()], g, st2)
    torch.testing.assert_close(g[0], torch.tensor([0.6, 0.8, 0.0], dtype=torch.float64))
    small = [torch.tensor([0.3, 0.4, 0.0], dtype=torch.float64)]  # norm 0.5: untouched
    tx2._inner_update_([p[0].clone()], small, st2)
    torch.testing.assert_close(small[0], torch.tensor([0.3, 0.4, 0.0], dtype=torch.float64))


def test_skip_nonfinite_updates_keeps_the_state_on_a_nan_batch(x64):
    cfg = FLAVOURS["30m"]
    _, _, tm = build_pair(cfg, seed=6)
    tx = build_optimizer(1e-2, max_grad_norm=1.0)
    state = TrainState.create(tm, tx)
    step = make_causal_lm_train_step(tm, tx, cfg["max_latents"], skip_nonfinite_updates=True)
    x, labels, _ = _batch(2, 16, seed=3)
    batch = {"input_ids": torch.from_numpy(x), "labels": torch.from_numpy(labels)}
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    poison = tm.output_adapter.register_forward_hook(lambda m, args, out: out * float("nan"))
    state, metrics = step(state, batch)
    poison.remove()
    assert torch.isnan(metrics["loss"]) and metrics["skipped_nonfinite"].item() == 1.0
    assert state.step == 1 and state.opt_state.count == 0
    assert all(torch.equal(v, before[k]) for k, v in tm.state_dict().items())
    assert all(not m.any() for m in state.opt_state.mu + state.opt_state.nu)
    state, metrics = step(state, batch)
    assert metrics["skipped_nonfinite"].item() == 0.0 and torch.isfinite(metrics["loss"])
    assert state.step == 2 and state.opt_state.count == 1
    assert not torch.equal(tm.state_dict()["ar.cross_attention.mlp.dense_1.weight"],
                           before["ar.cross_attention.mlp.dense_1.weight"])


@pytest.mark.parametrize("policy", [None, "dots_with_no_batch_dims_saveable"])
def test_activation_checkpointing_gives_the_same_gradients(x64, policy):
    """Residual and attention dropout 0.1 and gather prefix dropout, masks
    from one generator seed: the gradients with per-layer checkpointing equal
    those without (the recompute redraws each layer's masks from its seed)."""
    cfg = dict(FLAVOURS["flagship"], residual_dropout=0.1, post_attention_dropout=0.1, cross_attention_dropout=0.5)
    _, _, plain = build_pair(cfg, seed=7)
    remat = CausalSequenceModel(CausalSequenceModelConfig(**cfg, activation_checkpointing=True, remat_policy=policy),
                                device="cpu", param_dtype=torch.float64)
    remat.load_state_dict(plain.state_dict())
    x, labels, pad = _batch(2, 16, [0, 2], seed=8)
    results = [_port_loss_and_grads(m, x, labels, pad, 4, generator=torch.Generator().manual_seed(11))
               for m in (plain, remat)]
    assert results[0][0] == results[1][0]
    for name, g in results[0][1].items():
        torch.testing.assert_close(results[1][1][name], g, atol=1e-13, rtol=0, msg=name)
    plain.eval()
    with torch.no_grad():
        no_drop = tl.cross_entropy(plain(torch.from_numpy(x).long(), 4, torch.from_numpy(pad)),
                                   torch.from_numpy(labels).long()[:, 4:].masked_fill(torch.from_numpy(pad)[:, 4:], -100))
    assert abs(no_drop.item() - results[0][0]) > 1e-6  # the masks were drawn


def test_checkpointed_flash_layers_recompute_their_forward(flash_pair, monkeypatch):
    """Under checkpointing each self-attention layer's flash forward runs
    again in the backward: 1 + 2L forwards, 1 + L backwards."""
    _, _, tm = flash_pair
    remat = CausalSequenceModel(CausalSequenceModelConfig(**FLASH_SHAPE, activation_checkpointing=True,
                                                          remat_policy="dots_with_no_batch_dims_saveable"),
                                device="cpu", param_dtype=torch.float64)
    remat.load_state_dict(tm.state_dict())
    calls = _count_flash(monkeypatch)
    x, labels, pad = _batch(2, 256, seed=9)
    loss, grads = _port_loss_and_grads(remat, x, labels, pad, 128)
    assert calls == {"forward": 1 + 2 * 2, "backward": 1 + 2}
    want_loss, want_grads = _port_loss_and_grads(tm, x, labels, pad, 128)
    assert loss == want_loss
    for name, g in want_grads.items():
        torch.testing.assert_close(grads[name], g, atol=1e-13, rtol=0, msg=name)


def test_unported_training_knobs_and_policies_raise():
    cfg = dict(SMALL)
    model = CausalSequenceModel(CausalSequenceModelConfig(**cfg, pipeline_axis="pipe"), device="cpu")
    model.eval()  # inference ignores it
    with pytest.raises(NotImplementedError, match="not ported"):
        model.train()
    # sequence parallelism is ported: the model trains (under a mesh, see test_torch_sequence_parallel.py)
    CausalSequenceModel(CausalSequenceModelConfig(**cfg, sequence_parallel_axis="seq"), device="cpu").train()
    # every JAX remat policy and offloading are ported (tests/test_torch_remat.py); offloading keeps
    # the JAX package's checks
    for policy in ("dots_saveable", "everything_saveable", "checkpoint_dots"):
        CausalSequenceModel(CausalSequenceModelConfig(**cfg, activation_checkpointing=True, remat_policy=policy),
                            device="cpu").train()
    CausalSequenceModel(CausalSequenceModelConfig(**cfg, activation_checkpointing=True, activation_offloading=True),
                        device="cpu").train()
    with pytest.raises(ValueError, match="requires activation_checkpointing=True"):
        CausalSequenceModel(CausalSequenceModelConfig(**cfg, activation_offloading=True), device="cpu")
    with pytest.raises(ValueError, match="composes with remat_policy"):
        CausalSequenceModel(CausalSequenceModelConfig(**cfg, activation_checkpointing=True, activation_offloading=True,
                                                      remat_policy="dots_saveable"), device="cpu")
    with pytest.raises(ValueError, match="unknown remat_policy"):
        CausalSequenceModel(CausalSequenceModelConfig(**cfg, activation_checkpointing=True, remat_policy="bogus"),
                            device="cpu")
    with pytest.raises(ValueError, match="activation_checkpointing is False"):
        CausalSequenceModel(CausalSequenceModelConfig(**cfg, remat_policy="dots_with_no_batch_dims_saveable"),
                            device="cpu")
    # the fit loop's field whose JAX machinery waits for A5 (checkpoint_dir, checkpoint_every,
    # metrics_jsonl and the rest are ported: tests/test_torch_train_resilience.py; telemetry and
    # profile_dir: tests/test_torch_obs.py)
    from perceiver_io_torch.training.fit import Trainer, TrainerConfig

    with pytest.raises(NotImplementedError, match="not ported yet"):
        Trainer(TrainerConfig(pipeline_axis="pipe"))
    for field in (dict(telemetry=True), dict(profile_dir="trace")):
        assert Trainer(TrainerConfig(**field), log_fn=lambda line: None).telemetry is None  # set by fit()
    model = CausalSequenceModel(CausalSequenceModelConfig(**cfg), device="cpu")
    model.train()
    with pytest.raises(ValueError, match="eval mode"):
        model.prefill(torch.zeros(1, 6, dtype=torch.long), 2, model.init_cache(1))


@pytest.mark.parametrize("seed", range(6))
def test_losses_match_jax(seed):
    rs = np.random.RandomState(seed)
    shape = [(4, 7, 11), (2, 3, 5, 9), (16, 64)][seed % 3]
    logits = (rs.randn(*shape) * (1 + seed)).astype(np.float32)
    labels = rs.randint(0, shape[-1], shape[:-1])
    labels[rs.rand(*shape[:-1]) < 0.3] = -100
    if seed == 5:
        labels[:] = -100  # nothing valid: CE and accuracy are 0
    jlog, jlab = jnp.asarray(logits), jnp.asarray(labels)
    tlog, tlab = torch.from_numpy(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(tl.cross_entropy(tlog, tlab).item(), float(jl.cross_entropy(jlog, jlab)), rtol=1e-6)
    assert tl.valid_count(tlab).item() == int(jl.valid_count(jlab))
    np.testing.assert_allclose(tl.accuracy(tlog, tlab).item(), float(jl.accuracy(jlog, jlab)), rtol=1e-7)


@pytest.mark.parametrize("kw", [dict(training_steps=100, warmup_steps=10), dict(training_steps=50),
                                dict(training_steps=30, warmup_steps=5, num_cycles=1.5, min_fraction=0.1),
                                dict(training_steps=10, warmup_steps=20)])
def test_schedules_match_jax(kw):
    steps = range(0, kw["training_steps"] + 25)
    np.testing.assert_allclose([tlrs.cosine_with_warmup(2e-4, **kw)(s) for s in steps],
                               [float(jlrs.cosine_with_warmup(2e-4, **kw)(s)) for s in steps], rtol=1e-5, atol=1e-12)
    w = kw.get("warmup_steps", 0)
    np.testing.assert_allclose([tlrs.constant_with_warmup(1e-3, w)(s) for s in steps],
                               [float(jlrs.constant_with_warmup(1e-3, w)(s)) for s in steps], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("seq_len,dropout", [(1024, 0.0), (4096, 0.5), (512, 0.0), (300, 0.25)])
def test_flops_model_matches_jax(seq_len, dropout):
    for base in (flagship_455m_config(), CausalSequenceModelConfig(vocab_size=262, max_seq_len=4096)):
        t = PerceiverARFlops(base, seq_len, dropout)
        j = JaxFlops(JaxConfig(**dataclasses.asdict(base)), seq_len, dropout)
        assert t.forward_flops_per_latent() == j.forward_flops_per_latent()
        assert t.train_flops_per_step(16) == j.train_flops_per_step(16)
        assert t.tokens_per_step(8) == j.tokens_per_step(8)
        assert mfu(1e5, t, 16, 989.4e12) == jax_mfu(1e5, j, 16, 989.4e12)


def test_synthetic_markov_data_matches_jax_bit_for_bit():
    kw = dict(seq_len=64, batch_size=4, n_train_tokens=2048, n_val_tokens=512, seed=3)
    mine, theirs = SyntheticTextDataModule(**kw), JaxData(**kw)
    mine.setup()
    theirs.setup()
    assert mine.entropy_floor == theirs.entropy_floor
    a, b = mine.train_dataloader(), theirs.train_dataloader()
    for _ in range(2):  # two epochs: fresh windows each
        for x, y in zip(a, b, strict=True):
            for key in ("input_ids", "labels"):
                np.testing.assert_array_equal(x[key], y[key])
    for x, y in zip(mine.val_dataloader(), theirs.val_dataloader(), strict=True):
        np.testing.assert_array_equal(x["input_ids"], y["input_ids"])
    # the python_source corpus: the same windows as the JAX module's over the same installed files
    kw = dict(source="python_source", seq_len=64, batch_size=4, n_train_tokens=4096, n_val_tokens=1024)
    mine, theirs = SyntheticTextDataModule(**kw), JaxData(**kw)
    mine.setup()
    theirs.setup()
    for x, y in zip(mine.train_dataloader(), theirs.train_dataloader(), strict=True):
        for key in ("input_ids", "labels"):
            np.testing.assert_array_equal(x[key], y[key])
