"""Port parity: Perceiver IO optical-flow training (the flow train step of
perceiver_io_torch.scripts.convergence, the encoder's and decoder's dropout
generators and activation checkpointing, ``_fit``'s optimizer,
``SyntheticFlowDataModule`` and ``run_optical_flow_epe``) against the JAX
package on the same numpy inputs and converted weights.

Tolerance: float64, atol 5e-8 plus numpy's default rtol 1e-7 (ROADMAP C2, as
tests/test_torch_perceiver_io.py holds inference). The data module's arrays
must agree bit for bit. Dropout masks come from torch generators, whose bits
are not JAX's (as ROADMAP C7 says of the ring): the dropout tests hold the
port to its own seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import perceiver_io_torch.ops.attention as tattn
import perceiver_io_torch.ops.flash as fl
from perceiver_io_torch.convert_jax import jax_params_to_state_dict, load_jax_params
from perceiver_io_torch.data.vision import synthetic as tsyn
from perceiver_io_torch.models.core import modules as tmod
from perceiver_io_torch.models.vision.optical_flow import backend as tof
from perceiver_io_torch.scripts import convergence as tconv
from perceiver_io_torch.training.trainer import TrainState, build_optimizer
from perceiver_io_tpu.data.vision import synthetic as jsyn
from perceiver_io_tpu.models.vision.optical_flow import backend as jof
from perceiver_io_tpu.scripts import convergence as jconv

SCALE = 20.0
# a flow model whose decoder (one 512-channel head, 256 pixel queries over
# 128 latents) and self-attention (one 256-channel head over 128 latents)
# pass the flash gate, so its train step runs B1a and B1b at wide heads
WIDE = dict(
    encoder=dict(image_shape=(16, 16), num_patch_input_channels=3, num_patch_hidden_channels=16,
                 num_frequency_bands=4, num_cross_attention_heads=1, num_self_attention_heads=1,
                 num_self_attention_layers_per_block=2),
    decoder=dict(image_shape=(16, 16), num_cross_attention_heads=1, num_cross_attention_qk_channels=512,
                 num_cross_attention_v_channels=512, cross_attention_residual=False),
    num_latents=128, num_latent_channels=256)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """This file's tests run as fast on two intra-op threads as on all of
    them, and fewer threads leave the cores to the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_epe_result():
    """The JAX package's ``run_optical_flow_epe(4)``, whose keys the port's
    must return (a fixture, so its run and the port's are timed apart)."""
    return jconv.run_optical_flow_epe(4)


def _configs(spec, activation_checkpointing=False, dropout=0.0):
    enc, dec = dict(spec["encoder"], dropout=dropout), dict(spec["decoder"], dropout=dropout)
    kw = dict(num_latents=spec["num_latents"], num_latent_channels=spec["num_latent_channels"],
              activation_checkpointing=activation_checkpointing)
    jcfg = jof.OpticalFlowConfig(encoder=jof.OpticalFlowEncoderConfig(**enc),
                                 decoder=jof.OpticalFlowDecoderConfig(**dec), **kw)
    tcfg = tof.OpticalFlowConfig(encoder=tof.OpticalFlowEncoderConfig(**enc),
                                 decoder=tof.OpticalFlowDecoderConfig(**dec), **kw)
    return jcfg, tcfg


def _batch(spec, b=2, seed=1):
    h, w = spec["encoder"]["image_shape"]
    c = spec["encoder"]["num_patch_input_channels"]
    rs = np.random.RandomState(seed)
    return {"x": rs.randn(b, 2, c, h, w), "flow": rs.randn(b, h, w, 2) * 3.0}


def _pair(spec):
    """(JAX model, its float64 params, the port's float64 model with the same weights)."""
    jcfg, tcfg = _configs(spec)
    jm = jof.OpticalFlow(config=jcfg, deterministic=False, param_dtype=jnp.float64)
    h, w = spec["encoder"]["image_shape"]
    c = spec["encoder"]["num_patch_input_channels"]
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 2, c, h, w), jnp.float64))
    tm = tof.OpticalFlow(tcfg, device="cpu", param_dtype=torch.float64)
    load_jax_params(tm, jax.tree_util.tree_map(np.asarray, params))
    return jm, params, tm


def _jax_loss_fn(jm, batch):
    x, flow = jnp.asarray(batch["x"]), jnp.asarray(batch["flow"])

    def loss_fn(p):  # the JAX task's train-step loss
        pred = jm.apply(p, x, rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean((pred - flow / SCALE) ** 2)

    return loss_fn


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _captured_step(tm):
    """The port's flow train step with an optimizer that records the
    gradients it is handed and moves nothing."""
    tx = build_optimizer(0.0)
    grads = []
    tx.update_ = lambda params, g, opt_state: grads.append([t.detach().clone() for t in g])
    return TrainState.create(tm, tx), tconv.make_flow_train_step(tm, tx, SCALE), grads


def test_flow_train_step_matches_jax_with_the_wide_head_on_the_flash_function(x64, monkeypatch):
    """One train step at a wide-head config: the loss and every gradient leaf
    (JAX's gradient tree mapped through the converter) as the JAX package's
    value_and_grad; the 512-channel decoder head and the 256-channel
    self-attention go through ops/flash.py's Function forward and backward
    (B1b's plain version on the CPU)."""
    jm, params, tm = _pair(WIDE)
    batch = _batch(WIDE)
    want_loss, want_grads = jax.jit(jax.value_and_grad(_jax_loss_fn(jm, batch)))(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))

    forward_widths, backward_widths = [], []
    real_splash, real_backward = tattn.splash_mha, fl._backward_plain
    monkeypatch.setattr(tattn, "splash_mha", lambda q, *a, **kw: forward_widths.append(q.shape[-1])
                        or real_splash(q, *a, **kw))
    monkeypatch.setattr(fl, "_backward_plain", lambda q, *a: backward_widths.append(q.shape[-1])
                        or real_backward(q, *a))
    state, step, grads = _captured_step(tm)
    _, metrics = step(state, _torch_batch(batch))
    assert sorted(forward_widths) == [256, 256, 512] and sorted(backward_widths) == [256, 256, 512]
    np.testing.assert_allclose(float(metrics["loss"]), float(want_loss), atol=5e-8)
    names = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert set(names) == set(want) and len(grads) == 1
    for name, g in zip(names, grads[0]):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-8, err_msg=name)


def test_three_fit_steps_match_optax(x64):
    """Three updates of ``_fit``'s optimizer (``build_fit_tx``: clipping at
    global norm 1.0, AdamW with optax's default weight decay, the warmup-
    cosine schedule; 8 planned steps, so the warmup is 2 updates and the
    first has learning rate 0) against optax's chain on the JAX gradients:
    each step's loss and every parameter after the third."""
    jm, params, tm = _pair(WIDE)
    batch = _batch(WIDE, seed=2)
    lr, steps, warmup_cap = 2e-3, 8, 150
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, min(warmup_cap, steps // 4), steps)))
    opt_state = tx.init(params)
    loss_and_grad = jax.jit(jax.value_and_grad(_jax_loss_fn(jm, batch)))
    want_losses = []
    for _ in range(3):
        loss, grads = loss_and_grad(params)
        want_losses.append(float(loss))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    ttx = tconv.build_fit_tx(lr, steps, warmup_cap)
    state = TrainState.create(tm, ttx)
    step = tconv.make_flow_train_step(tm, ttx, SCALE)
    got_losses = [float(step(state, _torch_batch(batch))[1]["loss"]) for _ in range(3)]
    np.testing.assert_allclose(got_losses, want_losses, atol=5e-8)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    for name, p in tm.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=5e-8, err_msg=name)


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["no_dropout", "dropout"])
def test_activation_checkpointing_gives_the_same_gradients(x64, monkeypatch, dropout):
    """With activation checkpointing the encoder's cross-attention layer
    and the decoder's run twice in a train step (their forward and their
    recompute, which redraws the same dropout masks from its seed); loss and
    gradients equal the step's without checkpointing, element for element
    within 1e-12, from the same state seed."""
    _, plain_cfg = _configs(WIDE, dropout=dropout)
    _, remat_cfg = _configs(WIDE, activation_checkpointing=True, dropout=dropout)
    plain = tof.OpticalFlow(plain_cfg, device="cpu", param_dtype=torch.float64, seed=3)
    remat = tof.OpticalFlow(remat_cfg, device="cpu", param_dtype=torch.float64, seed=4)
    remat.load_state_dict(plain.state_dict())
    batch = _torch_batch(_batch(WIDE, seed=3))
    cross_runs = []
    real = tmod._seeded_cross_layer
    monkeypatch.setattr(tmod, "_seeded_cross_layer", lambda layer, *a: cross_runs.append(layer) or real(layer, *a))
    results = {}
    for name, model in (("plain", plain), ("remat", remat)):
        cross_runs.clear()
        state, step, grads = _captured_step(model)
        _, metrics = step(state, batch)
        results[name] = (float(metrics["loss"]), grads[0])
        encoder_runs = sum(layer is model.encoder.cross_attn_1 for layer in cross_runs)
        assert (encoder_runs, len(cross_runs) - encoder_runs) == ((2, 2) if name == "remat" else (1, 1))
    assert results["plain"][0] == pytest.approx(results["remat"][0], abs=1e-12)
    for a, b in zip(results["plain"][1], results["remat"][1]):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)


def test_dropout_masks_come_from_the_state_seed():
    """With dropout 0.2 in the encoder and decoder, a train step from a
    state seeded 0 gives the same loss twice; seeded 1, another loss; in
    eval mode (the eval step) no mask is drawn."""
    _, tcfg = _configs(WIDE, dropout=0.2)
    tm = tof.OpticalFlow(tcfg, device="cpu", seed=5)
    batch = {k: v.float() for k, v in _torch_batch(_batch(WIDE, seed=4)).items()}
    tx = build_optimizer(0.0)
    step = tconv.make_flow_train_step(tm, tx, SCALE)
    losses = [float(step(TrainState.create(tm, tx, seed=s), batch)[1]["loss"]) for s in (0, 0, 1)]
    assert losses[0] == losses[1] and losses[0] != losses[2]
    evaluate = tconv.make_flow_eval_step(tm, SCALE)
    assert float(evaluate(batch)["loss"]) == float(evaluate(batch)["loss"])


def test_synthetic_flow_data_module_is_the_jax_packages():
    """For the same seed and sizes the port's data module holds the JAX
    package's arrays bit for bit, and its loaders yield the same batches in
    the same order: two training epochs (each its own shuffle) and the
    validation set."""
    kw = dict(image_shape=(16, 24), batch_size=4, n_train=24, n_val=10, max_shift=1.25, max_rot_deg=1.5,
              flow_scale_factor=20, seed=3)
    got, want = tsyn.SyntheticFlowDataModule(**kw), jsyn.SyntheticFlowDataModule(**kw)
    got.setup()
    want.setup()
    for split in ("_train", "_val"):
        for a, b in zip(getattr(got, split), getattr(want, split)):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    assert got._train[0].shape == (24, 2, 27, 16, 24) and got._train[1].shape == (24, 16, 24, 2)
    for loaders in ((got.train_dataloader(), want.train_dataloader()), (got.train_dataloader(),
                                                                      want.train_dataloader()),
                    (got.val_dataloader(), want.val_dataloader())):
        batches = list(zip(*loaders, strict=True))
        assert batches
        for a, b in batches:
            assert a.keys() == b.keys() == {"x", "flow"}
            for key in a:
                np.testing.assert_array_equal(a[key], b[key])


def test_run_optical_flow_epe_returns_the_jax_keys(jax_epe_result):
    """``run_optical_flow_epe(4)`` on the CPU returns the JAX task's keys
    (and its target's), for a model with the same number of parameters, a
    history of the same lines, finite errors and a boolean ``met``."""
    got = tconv.run_optical_flow_epe(4, device="cpu", log_fn=lambda line: None)
    want = jax_epe_result
    assert sorted(got) == sorted(want) and sorted(got["target"]) == sorted(want["target"])
    assert got["task"] == want["task"] == "optical_flow_epe"
    assert got["model_params"] == want["model_params"]
    assert [sorted(line) for line in got["history"]] == [sorted(line) for line in want["history"]]
    assert isinstance(got["met"], bool)
    for key in ("achieved", "full_pipeline_epe_px", "zero_flow_baseline_epe_px", "patch_level_val_epe_best"):
        assert np.isfinite(got[key]), key
    assert got["zero_flow_baseline_epe_px"] == pytest.approx(want["zero_flow_baseline_epe_px"], rel=1e-6)
    assert list(tconv.TASKS) == list(jconv.TASKS)
