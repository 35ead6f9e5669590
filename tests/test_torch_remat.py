"""Port parity: every JAX remat policy and activation offloading
(``perceiver_io_torch/models/core/modules.py:remat_plan`` and
``offload.py``) against the JAX package's ``_remat_policy``.

- Loss and gradients of ``CausalSequenceModel`` and of a Perceiver IO
  encoder + decoder (the optical-flow model) under each setting equal the JAX
  package's under the same setting, in float64 on converted weights, within
  ROADMAP C2's atol 5e-8 + rtol 1e-7.
- With dropout (masks from the port's own seeds) the port's gradients under
  each setting equal its gradients without checkpointing bit for bit.
- What each policy saves, read through a dispatch mode around the backward:
  the matrix products the recompute runs again, and the set offloading moves
  to the host, which is ``dots_with_no_batch_dims_saveable``'s.
- The validation errors are JAX's, message for message.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_support import FLAVOURS, build_pair, tokens
from torch.utils._python_dispatch import TorchDispatchMode

from perceiver_io_torch.convert_jax import jax_params_to_state_dict, load_jax_params
from perceiver_io_torch.models.core import modules as tmod
from perceiver_io_torch.models.core import offload
from perceiver_io_torch.models.core.config import CausalSequenceModelConfig
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.models.vision.optical_flow import backend as tof
from perceiver_io_tpu.models.core import modules as jmod
from perceiver_io_tpu.models.core.config import CausalSequenceModelConfig as JaxConfig
from perceiver_io_tpu.models.core.perceiver_ar import CausalSequenceModel as JaxModel
from perceiver_io_tpu.models.vision.optical_flow import backend as jof

# (activation_checkpointing, remat_policy, activation_offloading)
SETTINGS = {
    "no_checkpoint": (False, None, False),
    "full_recompute": (True, None, False),
    **{name: (True, name, False) for name in tmod.REMAT_POLICIES},
    "offload": (True, None, True),
    "offload_dots_with_no_batch_dims": (True, "dots_with_no_batch_dims_saveable", True),
}
LAYERS = 2
CAUSAL = dict(FLAVOURS["flagship"], num_self_attention_layers=LAYERS)
FLOW = dict(
    encoder=dict(image_shape=(8, 8), num_patch_input_channels=3, num_patch_hidden_channels=8,
                 num_frequency_bands=2, num_cross_attention_heads=1, num_self_attention_heads=2,
                 num_self_attention_layers_per_block=LAYERS),
    decoder=dict(image_shape=(8, 8), num_cross_attention_heads=1, num_cross_attention_qk_channels=16,
                 num_cross_attention_v_channels=16, cross_attention_residual=False),
    num_latents=16, num_latent_channels=32)


def _knobs(setting):
    ac, policy, off = SETTINGS[setting]
    return dict(activation_checkpointing=ac, remat_policy=policy, activation_offloading=off)


def _close(got, want):
    np.testing.assert_allclose(got, want, atol=5e-8, rtol=1e-7)


def _port_grads(model, loss_fn):
    model.train()
    loss = loss_fn(model)
    names = [n for n, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.item(), dict(zip(names, grads))


# ------------------------------------------------------------ causal model
def _causal_batch(seed=3):
    x = tokens(2, CAUSAL["max_seq_len"], seed=seed)
    return x, np.roll(x, -1, axis=1)


def _causal_port_loss(x, labels, prefix_len=4, generator=None):
    def loss_fn(model):
        # a float64 cross-entropy in both packages (the training losses round to float32)
        logits = model(torch.from_numpy(x).long(), prefix_len, generator=generator)
        return -torch.log_softmax(logits, -1).gather(-1, torch.from_numpy(labels).long()[:, prefix_len:, None]).mean()
    return loss_fn


def _causal_jax(setting, x, labels, prefix_len=4):
    _, params, tm = build_pair(CAUSAL, seed=5)
    jm = JaxModel(config=JaxConfig(**CAUSAL, **_knobs(setting)), param_dtype=jnp.float64)

    def loss_fn(p):
        logits = jm.apply(p, jnp.asarray(x), prefix_len=prefix_len)
        return -jnp.take_along_axis(jax.nn.log_softmax(logits), jnp.asarray(labels)[:, prefix_len:, None], -1).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, grads)), tm


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_causal_model_matches_jax_under_each_setting(x64, setting):
    x, labels = _causal_batch()
    want_loss, want, plain = _causal_jax(setting, x, labels)
    model = CausalSequenceModel(CausalSequenceModelConfig(**CAUSAL, **_knobs(setting)), device="cpu",
                                param_dtype=torch.float64)
    model.load_state_dict(plain.state_dict())
    loss, grads = _port_grads(model, _causal_port_loss(x, labels))
    _close(loss, want_loss)
    assert set(grads) == set(want)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-8, rtol=1e-7, err_msg=name)


DROPOUT = dict(CAUSAL, residual_dropout=0.1, post_attention_dropout=0.1, cross_attention_dropout=0.5)


@pytest.mark.parametrize("setting", sorted(set(SETTINGS) - {"no_checkpoint"}))
def test_causal_gradients_equal_the_uncheckpointed_bit_for_bit(setting):
    """With attention, residual and prefix dropout drawn from one seed."""
    x, labels = _causal_batch(seed=4)
    results = []
    for knobs in (_knobs("no_checkpoint"), _knobs(setting)):
        model = CausalSequenceModel(CausalSequenceModelConfig(**DROPOUT, **knobs), device="cpu",
                                    param_dtype=torch.float64, seed=2)
        results.append(_port_grads(model, _causal_port_loss(x, labels, generator=torch.Generator().manual_seed(9))))
    assert results[0][0] == results[1][0]
    for name, g in results[0][1].items():
        assert torch.equal(results[1][1][name], g), name


# ------------------------------------------------------------ perceiver io
def _flow_configs(setting, dropout=0.0):
    enc, dec = dict(FLOW["encoder"], dropout=dropout), dict(FLOW["decoder"], dropout=dropout)
    kw = dict(num_latents=FLOW["num_latents"], num_latent_channels=FLOW["num_latent_channels"], **_knobs(setting))
    return (jof.OpticalFlowConfig(encoder=jof.OpticalFlowEncoderConfig(**enc),
                                  decoder=jof.OpticalFlowDecoderConfig(**dec), **kw),
            tof.OpticalFlowConfig(encoder=tof.OpticalFlowEncoderConfig(**enc),
                                  decoder=tof.OpticalFlowDecoderConfig(**dec), **kw))


def _flow_batch(seed=1):
    rs = np.random.RandomState(seed)
    return rs.randn(2, 2, 3, 8, 8), rs.randn(2, 8, 8, 2)


def _flow_port_loss(x, flow, generator=None):
    def loss_fn(model):
        return torch.mean((model(torch.from_numpy(x), generator=generator) - torch.from_numpy(flow)) ** 2)
    return loss_fn


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_perceiver_io_matches_jax_under_each_setting(x64, setting):
    jcfg, tcfg = _flow_configs(setting)
    jm = jof.OpticalFlow(config=jcfg, param_dtype=jnp.float64)
    x, flow = _flow_batch()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x[:1]))

    def loss_fn(p):
        return jnp.mean((jm.apply(p, jnp.asarray(x)) - jnp.asarray(flow)) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = jax_params_to_state_dict(jax.tree_util.tree_map(np.asarray, want_grads))
    model = tof.OpticalFlow(tcfg, device="cpu", param_dtype=torch.float64)
    load_jax_params(model, jax.tree_util.tree_map(np.asarray, params))
    loss, grads = _port_grads(model, _flow_port_loss(x, flow))
    _close(loss, float(want_loss))
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=5e-8, rtol=1e-7, err_msg=name)


@pytest.mark.parametrize("setting", sorted(set(SETTINGS) - {"no_checkpoint"}))
def test_perceiver_io_gradients_equal_the_uncheckpointed_bit_for_bit(setting):
    x, flow = _flow_batch(seed=2)
    results = []
    for s in ("no_checkpoint", setting):
        model = tof.OpticalFlow(_flow_configs(s, dropout=0.2)[1], device="cpu", param_dtype=torch.float64, seed=3)
        results.append(_port_grads(model, _flow_port_loss(x, flow, generator=torch.Generator().manual_seed(4))))
    assert results[0][0] == results[1][0]
    for name, g in results[0][1].items():
        assert torch.equal(results[1][1][name], g), name


# ------------------------------------------------------- what is saved
class _Count(TorchDispatchMode):
    OPS = {torch.ops.aten.mm.default: "mm", torch.ops.aten.addmm.default: "mm", torch.ops.aten.bmm.default: "bmm",
           torch.ops.aten.baddbmm.default: "bmm"}

    def __init__(self):
        super().__init__()
        self.counts = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.OPS:
            self.counts[self.OPS[func]] += 1
        return func(*args, **(kwargs or {}))


def _backward_products(setting):
    """The matrix products run during the backward (its own and the
    recompute's), and what offloading moved."""
    model = CausalSequenceModel(CausalSequenceModelConfig(**CAUSAL, **_knobs(setting)), device="cpu",
                                param_dtype=torch.float64, seed=1)
    model.train()
    x, labels = _causal_batch()
    offload.reset_stats()
    loss = _causal_port_loss(x, labels)(model)
    with _Count() as mode:
        loss.backward()
    return mode.counts, dict(offload.STATS)


# per self-attention layer: q, k, v, output and the MLP's two Dense products;
# the masked softmax's scores and weighted sum are batched. The recompute
# stops early (non-reentrant checkpoint) once the backward has what it reads:
# the MLP's last product is not read, so it is neither recomputed nor restored
DENSE, BATCHED = 6, 2
READ = DENSE - 1
RECOMPUTED = {
    "no_checkpoint": (0, 0), "everything_saveable": (0, 0),
    "full_recompute": (READ, BATCHED), "nothing_saveable": (READ, BATCHED),
    "dots_saveable": (0, 0), "checkpoint_dots": (0, 0),
    "dots_with_no_batch_dims_saveable": (0, BATCHED), "checkpoint_dots_with_no_batch_dims": (0, BATCHED),
    "offload": (0, BATCHED), "offload_dots_with_no_batch_dims": (0, BATCHED),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_each_policy_recomputes_what_jax_would(setting):
    base, _ = _backward_products("no_checkpoint")
    counts, stats = _backward_products(setting)
    mm, bmm = RECOMPUTED[setting]
    assert (counts["mm"] - base["mm"], counts["bmm"] - base["bmm"]) == (mm * LAYERS, bmm * LAYERS)
    if SETTINGS[setting][2]:  # offloading: the unbatched products went to the host and came back
        assert (stats["offloaded"], stats["restored"]) == (DENSE * LAYERS, READ * LAYERS)
        assert stats["d2h_bytes"] > stats["h2d_bytes"] > 0
    else:
        assert stats["offloaded"] == 0


def test_offloaded_set_is_the_no_batch_dims_policys_saved_set():
    """The tensors offloading moves are exactly the outputs that
    ``dots_with_no_batch_dims_saveable`` keeps: same ops, shapes and values."""
    kept = []

    class Keep(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func in tmod._SAVED_DOTS:
                kept.append(out.detach().clone())
            return out

    moved = []
    real_put = offload._Store.put
    try:
        offload._Store.put = lambda self, out: moved.append(out.detach().clone()) or real_put(self, out)
        x, labels = _causal_batch()
        for setting in ("dots_with_no_batch_dims_saveable", "offload"):
            model = CausalSequenceModel(CausalSequenceModelConfig(**CAUSAL, **_knobs(setting)), device="cpu",
                                        param_dtype=torch.float64, seed=1)
            model.train()
            plan = model.ar.self_attention.remat
            if setting == "offload":
                _causal_port_loss(x, labels)(model).backward()
            else:
                context = plan.context_fn

                def spy():
                    forward, recompute = context()
                    return _Stack(forward, Keep()), recompute

                model.ar.self_attention.remat = tmod.RematPlan(True, spy)
                _causal_port_loss(x, labels)(model).backward()
    finally:
        offload._Store.put = real_put
    assert len(moved) == len(kept) == DENSE * LAYERS
    for a, b in zip(moved, kept):
        assert a.shape == b.shape and torch.equal(a, b)


class _Stack:
    """Two dispatch modes entered as one context (the inner second)."""

    def __init__(self, outer, inner):
        self.modes = (outer, inner)

    def __enter__(self):
        for m in self.modes:
            m.__enter__()
        return self

    def __exit__(self, *exc):
        for m in reversed(self.modes):
            m.__exit__(*exc)


# ------------------------------------------------------------ validation
@pytest.mark.parametrize("case", [
    dict(name=None, activation_checkpointing=False, activation_offloading=True),
    dict(name="dots_saveable", activation_checkpointing=True, activation_offloading=True),
    dict(name="everything_saveable", activation_checkpointing=True, activation_offloading=True),
    dict(name="bogus", activation_checkpointing=True, activation_offloading=False),
    dict(name="dots_saveable", activation_checkpointing=False, activation_offloading=False),
], ids=["offload_without_checkpoint", "offload_dots", "offload_everything", "unknown", "policy_without_checkpoint"])
def test_validation_errors_are_jaxs(case):
    with pytest.raises(ValueError) as want:
        jmod._remat_policy(case["name"], case["activation_checkpointing"], case["activation_offloading"])
    with pytest.raises(ValueError) as got:
        tmod.remat_plan(case["name"], case["activation_checkpointing"], case["activation_offloading"])
    assert str(got.value) == str(want.value)


def test_models_raise_jaxs_errors_at_construction():
    with pytest.raises(ValueError, match="requires activation_checkpointing=True"):
        CausalSequenceModel(CausalSequenceModelConfig(**CAUSAL, activation_offloading=True), device="cpu")
    with pytest.raises(ValueError, match="composes with remat_policy"):
        tof.OpticalFlow(_flow_configs("offload")[1].__class__(
            **{**_flow_configs("offload")[1].__dict__, "remat_policy": "dots_saveable"}), device="cpu")
    # Perceiver IO without checkpointing: the encoder's blocks and the decoder refuse offloading, as JAX's do
    with pytest.raises(ValueError, match="requires activation_checkpointing=True"):
        tof.OpticalFlow(_flow_configs("offload")[1].__class__(
            **{**_flow_configs("offload")[1].__dict__, "activation_checkpointing": False}), device="cpu")
