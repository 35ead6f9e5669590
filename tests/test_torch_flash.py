"""Port parity: perceiver_io_torch.ops.flash (the plain version of kernels
B1a/B1b and the autograd Function's CPU route) against the JAX package's
``splash_mha`` in Pallas interpret mode, at tests/test_flash.py's shapes
(B=1, H=2, D=64, 128 queries x 256 keys), in float32, and the forward and
gradients at the wide heads (D = 192, 256, 512) that the optical-flow
decoder needs; and the bf16 CUDA kernels' roundings, emulated in plain
PyTorch (the forward's P; the backward's P and dS, with its tiling and, at
the wide heads, its query splits), against the plain version's limits; and
the float32 forward's and backward's three TF32 products (their tiling read
from csrc/flash_forward_f32.cu and csrc/flash_backward_f32.cu, and a model of
the tensor cores' truncating float32 sums) against the float64 plain
version.

Tolerances: the forward within atol 2e-5, as the JAX package's own tests
hold splash against its XLA formulation; dq, dk and dv against ``jax.grad``
through the same interpreted splash within atol 2e-5 (float32 sums taken in
another order; gradients here are of order 0.1-1). The Function's CPU route
(FlashAttention-2's recomputed backward) is pinned to autograd of the plain
version in float64 (``gradcheck``, and atol 1e-12 on the gradients).
"""

import inspect
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from perceiver_io_torch.ops import flash as fl
from perceiver_io_tpu.ops.flash import flash_supported as jax_flash_supported
from perceiver_io_tpu.ops.flash import splash_mha as jax_splash_mha

B, H, D = 1, 2, 64
ATOL = 2e-5
KERNEL_SOURCE = Path(fl.__file__).resolve().parent.parent / "csrc" / "flash_backward_mma.cu"
WIDE_KERNEL_SOURCE = KERNEL_SOURCE.with_name("flash_backward_wide.cu")
WIDE_FORWARD_SOURCE = KERNEL_SOURCE.with_name("flash_forward_wide.cu")
F32_FORWARD_SOURCE = KERNEL_SOURCE.with_name("flash_forward_f32.cu")
F32_BACKWARD_SOURCE = KERNEL_SOURCE.with_name("flash_backward_f32.cu")
SMEM_PER_BLOCK = 232_448  # the most dynamic shared memory an H100 block may have


@pytest.fixture
def two_torch_threads():
    """The kernel emulations run thousands of small products, as fast on two
    intra-op threads as on all of them; fewer threads leave the cores to
    the suite's other workers. The parity tests against JAX keep the
    default threads (their float32 sums in another order can pass atol)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qkv():
    rs = np.random.RandomState(0)
    q, k, v = (rs.randn(B, H, n, D).astype(np.float32) * 0.3 for n in (128, 256, 256))
    do = rs.randn(B, H, 128, D).astype(np.float32)
    return q, k, v, do


MASKS = {
    "causal": (True, None),
    "full": (False, None),
    "key_pad": (True, 32),
}


def _pad(n_pad):
    return None if n_pad is None else np.arange(256)[None, :] < n_pad


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_plain_forward_matches_interpreted_splash(qkv, mask):
    q, k, v, _ = qkv
    causal, n_pad = MASKS[mask]
    pad = _pad(n_pad)
    want = jax_splash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pad_mask=None if pad is None else jnp.asarray(pad), causal=causal, interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = fl.flash_attention_reference(t(q), t(k), t(v), pad_mask=t(pad), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    routed = fl.splash_mha(t(q), t(k), t(v), pad_mask=t(pad), causal=causal)  # the Function's CPU route
    np.testing.assert_allclose(routed.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("mask", sorted(MASKS))
def test_gradients_match_interpreted_splash(qkv, mask):
    q, k, v, do = qkv
    causal, n_pad = MASKS[mask]
    pad = _pad(n_pad)
    jpad = None if pad is None else jnp.asarray(pad)

    def loss(q, k, v):
        return jnp.sum(jax_splash_mha(q, k, v, pad_mask=jpad, causal=causal, interpret=True) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for route in (fl.splash_mha, fl.flash_attention_reference):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = route(*leaves, pad_mask=None if pad is None else torch.from_numpy(pad), causal=causal)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=f"{route.__name__} {name}")
    if pad is not None:  # pad keys: exact-zero gradients
        assert not got[1][:, :, :n_pad].any() and not got[2][:, :, :n_pad].any()


def test_flash_supported_predicate():
    """The cases of tests/test_flash.py's predicate test: the port's gate is
    structural (no backend condition), so the supported case holds here."""
    ok = dict(num_qk_channels_per_head=64, num_v_channels_per_head=64, n_q=512, n_k=2304,
              has_dropout=False, has_cache=False)
    assert fl.flash_supported(**ok)
    for bad in ({"has_cache": True}, {"has_dropout": True}, {"num_v_channels_per_head": 128}, {"n_k": 2305},
                {"num_qk_channels_per_head": 48}):
        assert not fl.flash_supported(**{**ok, **bad})
        assert not jax_flash_supported(**{**ok, **bad})
    # the flagship's shapes, and the kernels' head-width limit (the forward
    # takes every multiple of 64 up to 512, as the JAX gate does below it)
    assert fl.flash_supported(128, 128, 512, 1024, False, False)
    assert fl.flash_supported(128, 128, 512, 512, False, False)
    assert fl.flash_supported(256, 256, 512, 512, False, False)
    assert not fl.flash_supported(64, 64, 64, 512, False, False)  # fewer than 128 queries


WIDE_PADS = {"no_pads": None, "key_pads": [0, 45]}


@pytest.mark.parametrize("pads", sorted(WIDE_PADS))
@pytest.mark.parametrize("d", [192, 256, 512])
def test_plain_forward_matches_interpreted_splash_at_wide_heads(d, pads):
    """The plain forward (and the Function's CPU route) against interpreted
    splash at the head widths of B1a's wide kernel, full mask (the
    Perceiver IO calls are non-causal), without and with padding keys."""
    rs = np.random.RandomState(d)
    q, k, v = (rs.randn(2, 1, n, d).astype(np.float32) * s for n, s in ((128, d**-0.5), (256, 1.0), (256, 1.0)))
    pad = None if WIDE_PADS[pads] is None else np.arange(256)[None, :] < np.array(WIDE_PADS[pads])[:, None]
    want = jax_splash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          pad_mask=None if pad is None else jnp.asarray(pad), causal=False, interpret=True)
    t = lambda a: None if a is None else torch.from_numpy(a)
    for route in (fl.flash_attention_reference, fl.splash_mha):
        got = route(t(q), t(k), t(v), pad_mask=t(pad), causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, err_msg=route.__name__)


@pytest.mark.parametrize("case", ["no_pads", "key_pads", "causal"])
@pytest.mark.parametrize("d", [192, 256, 512])
def test_gradients_match_interpreted_splash_at_wide_heads(d, case):
    """dq, dk and dv of the Function's CPU route (B1b's plain version) and of
    the plain forward's autograd against ``jax.grad`` through interpreted
    splash at the wide heads B1b now takes, at the wide forward test's
    shapes (128 queries over 256 keys): full mask without and with padding
    keys, and causal; within the file's atol 2e-5 (dO scaled by D**-0.5
    keeps the gradients of order 0.1-1, as at D 64), pad keys' gradients
    exact zeros."""
    rs = np.random.RandomState(d + 1)
    q, k, v = (rs.randn(2, 1, n, d).astype(np.float32) * s for n, s in ((128, d**-0.5), (256, 1.0), (256, 1.0)))
    do = rs.randn(2, 1, 128, d).astype(np.float32) * d**-0.5  # dP = dO V^T of order 1, as at D 64
    pads = WIDE_PADS["key_pads"] if case == "key_pads" else None
    pad = None if pads is None else np.arange(256)[None, :] < np.array(pads)[:, None]
    causal = case == "causal"
    jpad = None if pad is None else jnp.asarray(pad)

    def loss(q, k, v):
        return jnp.sum(jax_splash_mha(q, k, v, pad_mask=jpad, causal=causal, interpret=True) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for route in (fl.splash_mha, fl.flash_attention_reference):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = route(*leaves, pad_mask=None if pad is None else torch.from_numpy(pad), causal=causal)
        got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=f"{route.__name__} {name}")
        if pad is not None:
            at = torch.from_numpy(pad)[:, None, :, None].expand_as(got[1])
            assert not got[1][at].any() and not got[2][at].any()


def test_flash_supported_at_wide_heads(monkeypatch):
    """Heads up to MAX_HEAD_DIM = 512 take the flash kernels, forward and
    backward (the flow decoder's 182,528 x 2,048 at 512 channels among
    them); 576 does not. There is no gradient condition any more (B1b takes
    every width B1a takes), so the port's gate has the JAX gate's signature
    and, shape by shape, its verdict with the TPU backend's condition met,
    except for the 512 cap."""
    import perceiver_io_tpu.ops.flash as jflash

    monkeypatch.setattr(jflash.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jflash.jax, "device_count", lambda: 1)
    assert fl.MAX_HEAD_DIM == 512
    jax_params = list(inspect.signature(jax_flash_supported).parameters)
    assert list(inspect.signature(fl.flash_supported).parameters) == jax_params[:6]
    assert fl.flash_supported(512, 512, 182_528, 2048, False, False)
    assert not fl.flash_supported(576, 576, 256, 128, False, False)
    for d in (64, 128, 192, 256, 320, 384, 448, 512, 576):
        for n_q, n_k in ((512, 512), (256, 128), (182_528, 2048), (64, 512)):
            want = jax_flash_supported(d, d, n_q, n_k, False, False) and d <= fl.MAX_HEAD_DIM
            assert fl.flash_supported(d, d, n_q, n_k, False, False) == want, (d, n_q, n_k)
    assert not fl.flash_supported(512, 256, 512, 512, False, False)  # one width for q, k and v
    assert not jax_flash_supported(512, 256, 512, 512, False, False)


def test_a_wide_head_that_records_gradients_takes_the_masked_softmax(monkeypatch):
    """At the attention call site a 256-channel head no longer takes the
    masked softmax when the forward records gradients: it goes through the
    flash Function with or without them, as a 64-channel head does. Its
    output, and the gradients of the input and of every parameter, equal
    those of the masked softmax, which the same call takes with the gate
    shut."""
    import perceiver_io_torch.ops.attention as attn

    calls = []
    real, gate = attn.splash_mha, attn.flash_supported
    monkeypatch.setattr(attn, "splash_mha", lambda q, *a, **kw: calls.append(q.shape[-1]) or real(q, *a, **kw))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 128, 256, generator=g)
    do = torch.randn(1, 128, 256, generator=g)
    for heads, d in ((1, 256), (4, 64)):
        mha = attn.MultiHeadAttention(heads, 256, 256, device="cpu")
        for prm in mha.parameters():
            torch.nn.init.normal_(prm, std=0.05, generator=g)
        calls.clear()
        with torch.no_grad():
            want = mha(x, x)[0]
        assert calls == [d]
        grads = {}
        for route, open_gate in (("flash", gate), ("masked_softmax", lambda *a: False)):
            monkeypatch.setattr(attn, "flash_supported", open_gate)
            calls.clear()
            xg = x.clone().requires_grad_()
            out = mha(xg, xg)[0]
            assert calls == ([d] if route == "flash" else [])
            torch.testing.assert_close(out.detach(), want, atol=1e-5, rtol=0)
            grads[route] = torch.autograd.grad(out, [xg, *mha.parameters()], do)
        monkeypatch.setattr(attn, "flash_supported", gate)
        for a, b in zip(grads["flash"], grads["masked_softmax"]):
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("causal,pads", [(True, None), (False, [0, 3]), (True, [2, 9])],
                         ids=["causal", "full_padded", "causal_with_blind_rows"])
def test_function_cpu_route_gradcheck(causal, pads):
    """float64 gradcheck of the autograd Function's CPU route (its backward
    is FlashAttention-2's, not autograd's; fast mode: the Jacobian checked
    along random directions, which keeps it quick with several workers), and
    its forward and gradients equal to the plain version's autograd ones
    element by element."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 2, n, 8, dtype=torch.float64, generator=g, requires_grad=True) for n in (5, 9, 9))
    pad = None if pads is None else torch.arange(9)[None, :] < torch.tensor(pads)[:, None]
    fn = lambda q, k, v: fl.splash_mha(q, k, v, pad_mask=pad, causal=causal)
    assert torch.autograd.gradcheck(fn, (q, k, v), fast_mode=True)
    do = torch.randn(2, 2, 5, 8, dtype=torch.float64, generator=g)
    got = torch.autograd.grad(fn(q, k, v), (q, k, v), do)
    want = torch.autograd.grad(fl.flash_attention_reference(q, k, v, pad_mask=pad, causal=causal), (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-12, rtol=0)


def test_a_query_that_sees_no_key_gets_zeros():
    """Every key of row 1 is padding: its outputs, its lse and every
    gradient through it are exact zeros (never NaN), on both routes."""
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 2, n, 16, generator=g, requires_grad=True) for n in (4, 6, 6))
    pad = torch.tensor([[False] * 6, [True] * 6])
    do = torch.randn(2, 2, 4, 16, generator=g)
    for route in (fl.splash_mha, fl.flash_attention_reference):
        out = route(q, k, v, pad_mask=pad, causal=True)
        dq, dk, dv = torch.autograd.grad(out, (q, k, v), do)
        assert (out[1] == 0).all() and torch.isfinite(out).all()
        assert (dq[1] == 0).all() and (dk[1] == 0).all() and (dv[1] == 0).all()
        assert torch.isfinite(dq).all() and dq[0].abs().sum() > 0
    _, lse = fl._forward_plain(q, k, v, pad, True)
    assert torch.isneginf(lse[1]).all() and torch.isfinite(lse[0]).all()


def _bf16_kernel_arithmetic(q, k, v, pad, causal, split_p, tile=64, s_split=None):
    """The bf16 forward's arithmetic (csrc/flash_forward_mma.cu, or with
    ``_wide_forward_design``'s tile and split csrc/flash_forward_wide.cu)
    in plain float32 PyTorch: ``tile``-key tiles, S = Q K^T in float32 (with
    ``s_split``, as the wide kernel's two consumers make it: the partial
    over channels [0, s_split) plus the partial over [s_split, D)), the
    online softmax, P rounded to bf16 in one term or split into two (hi +
    lo) before the P V product, and the sum l of the unrounded p. Returns
    (o, lse) in float32."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    b, h, nq, d = q.shape
    visible = fl._visibility(nq, k.shape[2], pad, causal, q.device)
    m = torch.full((b, h, nq), float("-inf"))
    l, acc = torch.zeros(b, h, nq), torch.zeros(b, h, nq, d)
    for k0 in range(0, k.shape[2], tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        if s_split is None:
            s = torch.einsum("bhqd,bhkd->bhqk", qf, kt)
        else:
            s = (torch.einsum("bhqd,bhkd->bhqk", qf[..., :s_split], kt[..., :s_split])
                 + torch.einsum("bhqd,bhkd->bhqk", qf[..., s_split:], kt[..., s_split:]))
        s = s.masked_fill(~visible[..., k0:k0 + tile], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha, p = torch.exp(m - m_use), torch.exp(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vt
        if split_p:
            pv = pv + (p - hi).bfloat16().float() @ vt
        acc, m = acc * alpha[..., None] + pv, m_new
    o = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return o, torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))


def _wide_forward_design(d):
    """csrc/flash_forward_wide.cu's design at head width d, read from the
    source: its key tile and stages, each consumer's 64-channel boxes of S's
    contraction and of the output's columns, the P terms its P V product
    takes without and with kSplitP, and its shared-memory bytes
    (``smem_bytes`` evaluated at these tiles)."""
    src = WIDE_FORWARD_SOURCE.read_text()

    def body(name):
        return re.search(rf"constexpr \w+ {name}\((?:int c)?\) \{{(?:\s*//[^\n]*)?\s*return ([^;]+);", src).group(1)

    def ternary(expr, env):  # ``a ? x : b ? y : z`` over integer C expressions of D (and c)
        for cond, value in re.findall(r"([^?:]+)\?([^:]+):", expr + ":"):
            if eval(cond.replace("/", "//"), {}, env):
                return eval(value.replace("/", "//"), {}, env)
        return eval(expr.rsplit(":", 1)[1].replace("/", "//"), {}, env)

    tile, stages = ternary(body("key_tile"), {"D": d}), ternary(body("stages"), {"D": d})
    s_boxes = [ternary(body("s_boxes"), {"D": d, "c": c}) for c in (0, 1)]
    o_boxes = [ternary(body("o_boxes"), {"D": d, "c": c}) for c in (0, 1)]
    smem = body("smem_bytes")
    for word, value in (("sizeof(bf16)", 2), ("sizeof(float)", 4), ("sizeof(uint64_t)", 8), ("kBQ", 64),
                        ("stages<D>()", stages), ("key_tile<D>()", tile), ("D", d)):
        smem = smem.replace(word, str(value))
    # the P V product: P's hi term always, its lo term only under kSplitP
    lo = re.search(r"if constexpr \(kSplitP\) Wgmma<kON>::rs\(acc, p\.lo\[kk\], dv\);", src)
    return dict(tile=tile, stages=stages, s_boxes=s_boxes, o_boxes=o_boxes, smem=eval(" ".join(smem.split())),
                p_terms={False: 1, True: 2 if lo else 1})


def _wide_arithmetic(q, k, v, pad, causal, split_p):
    """``_bf16_kernel_arithmetic`` with csrc/flash_forward_wide.cu's design at q's head width."""
    design = _wide_forward_design(q.shape[-1])
    return _bf16_kernel_arithmetic(q, k, v, pad, causal, design["p_terms"][split_p] == 2, tile=design["tile"],
                                   s_split=64 * design["s_boxes"][0])


@pytest.mark.parametrize("d", [192, 256, 320, 384, 448, 512])
def test_wide_forward_design_fits_the_card(d):
    """Each width of csrc/flash_forward_wide.cu, read from the source: its
    shared memory (Q, its stages of K and V, the double-buffered S
    exchange, the mbarriers and 1 KB of alignment slack) fits the 232,448
    bytes a block may have, and equals the header's table; the consumers'
    boxes cover D once each way, each wgmma N (64 x output boxes) a
    multiple of 8 no wider than 256; a half tile (the multicast box) is a
    whole number of 8-row swizzle atoms; P takes one term, two with
    kSplitP."""
    design = _wide_forward_design(d)
    assert design["smem"] <= SMEM_PER_BLOCK
    row = re.search(rf"//   D {d}: (\d+)-key tiles, (\d) stages, ([\d,]+) bytes", WIDE_FORWARD_SOURCE.read_text())
    assert (int(row.group(1)), int(row.group(2)), int(row.group(3).replace(",", ""))) == (
        design["tile"], design["stages"], design["smem"])
    assert sum(design["s_boxes"]) == sum(design["o_boxes"]) == d // 64 and min(design["s_boxes"]) >= 1
    assert all(64 * n <= 256 for n in design["o_boxes"])
    assert design["tile"] // 2 % 8 == 0 and design["stages"] >= 2
    assert design["p_terms"] == {False: 1, True: 2}


@pytest.mark.usefixtures("two_torch_threads")
def test_rounding_budget_of_the_bf16_forward():
    """Why the bf16 kernel's P may be split into two bf16 terms (kSplitP),
    at a narrow ring-block shape (2, 2, 128 x 320, D 64, one row's keys
    left-padded): with one term the output, cast to bf16, stays within B1's
    bf16 limit (0.03 x RMS + one bf16 step), but the float32 output moves by
    more than B5's 1e-4; with two terms the output and lse stay within 1e-4.
    The same split keeps B1b's dq (whose delta = rowsum(dO * O) reads the
    float32 output) far closer to autograd's than one term does, so B1a
    splits P whenever its output will be differentiated."""
    rs = np.random.RandomState(0)
    b, h, nq, nk, d = 2, 2, 128, 320, 64
    q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5).bfloat16()
    k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)).bfloat16() for _ in range(2))
    do = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32)).bfloat16()
    pad = torch.arange(nk)[None, :] < torch.tensor([0, 70])[:, None]
    want_o, want_lse = fl._forward_plain(q, k, v, pad, False)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want_dq = torch.autograd.grad(fl.flash_attention_reference(*leaves, pad_mask=pad), leaves, do)[0].float()

    def b1_limit(y):
        return 0.03 * y.pow(2).mean().sqrt() + 2.0**-7 * y.abs()

    one_o, one_lse = _bf16_kernel_arithmetic(q, k, v, pad, False, split_p=False)
    two_o, two_lse = _bf16_kernel_arithmetic(q, k, v, pad, False, split_p=True)
    assert ((one_o.bfloat16().float() - want_o).abs() <= b1_limit(want_o)).all()
    assert (one_o - want_o).abs().max() > 1e-4
    torch.testing.assert_close(two_o, want_o, atol=1e-4, rtol=0)
    torch.testing.assert_close(two_lse, want_lse, atol=1e-4, rtol=0)
    dq = {}
    for split_p, o, lse in ((False, one_o, one_lse), (True, two_o, two_lse)):
        dq[split_p] = fl._backward_plain(q, k, v, pad, False, o, lse, do)[0].float()
        assert ((dq[split_p] - want_dq).abs() <= b1_limit(want_dq)).all()
    assert (dq[True] - want_dq).abs().max() * 4 <= (dq[False] - want_dq).abs().max()


@pytest.mark.usefixtures("two_torch_threads")
def test_rounding_budget_of_the_bf16_forward_at_512_channels():
    """The wide kernel (csrc/flash_forward_wide.cu) at the flow decoder's
    head: its key tile and S split read from the source (32-key tiles, S as
    two 256-channel partials), P in one bf16 term (an inference forward) within
    B1's bf16 limit of the plain output once cast to bf16, and two terms
    within 1e-4 of the float32 output and lse, at 256 queries over 2,048
    keys with one row's keys left-padded."""
    rs = np.random.RandomState(5)
    b, h, nq, nk, d = 2, 1, 256, 2048, 512
    q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5).bfloat16()
    k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)).bfloat16() for _ in range(2))
    pad = torch.arange(nk)[None, :] < torch.tensor([0, 300])[:, None]
    want_o, want_lse = fl._forward_plain(q, k, v, pad, False)
    limit = 0.03 * want_o.pow(2).mean().sqrt() + 2.0**-7 * want_o.abs()
    one_o, _ = _wide_arithmetic(q, k, v, pad, False, split_p=False)
    two_o, two_lse = _wide_arithmetic(q, k, v, pad, False, split_p=True)
    assert ((one_o.bfloat16().float() - want_o).abs() <= limit).all()
    torch.testing.assert_close(two_o, want_o, atol=1e-4, rtol=0)
    torch.testing.assert_close(two_lse, want_lse, atol=1e-4, rtol=0)


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [192, 256, 512])
def test_wide_forward_emulation_within_b1_limits(d, causal):
    """The wide kernel's arithmetic (its tile, S split and P terms read from
    csrc/flash_forward_wide.cu) against the plain version at a ragged,
    left-padded shape (200 queries over 300 keys, one row's first 120 keys
    padding; causal, that row's first 20 queries see no key): one-term P, the output cast
    to bf16, within B1's bf16 limit (0.03 x RMS plus one bf16 step); two-term
    P, the float32 output and lse within 1e-4; rows that see no key exact
    zeros and -inf."""
    rs = np.random.RandomState(d + causal)
    b, h, nq, nk = 2, 1, 200, 300
    q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5).bfloat16()
    k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)).bfloat16() for _ in range(2))
    pad = torch.arange(nk)[None, :] < torch.tensor([0, 120])[:, None]
    want_o, want_lse = fl._forward_plain(q, k, v, pad, causal)
    limit = 0.03 * want_o.pow(2).mean().sqrt() + 2.0**-7 * want_o.abs()
    one_o, _ = _wide_arithmetic(q, k, v, pad, causal, split_p=False)
    two_o, two_lse = _wide_arithmetic(q, k, v, pad, causal, split_p=True)
    assert ((one_o.bfloat16().float() - want_o).abs() <= limit).all()
    torch.testing.assert_close(two_o, want_o, atol=1e-4, rtol=0)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(two_lse), finite) and finite.all() != causal
    torch.testing.assert_close(two_lse[finite], want_lse[finite], atol=1e-4, rtol=0)
    assert (one_o[~finite] == 0).all() and (two_o[~finite] == 0).all()


def test_wide_forward_emulation_matches_interpreted_splash():
    """The wide kernel's arithmetic at D 320 (an odd box count: S split 128
    + 192 channels, 32-key tiles) against JAX's splash in interpret mode on
    the same bf16-valued inputs, causal with padding keys: one-term P cast
    to bf16 within B1's bf16 limit of splash's output, two-term P within
    1e-4."""
    rs = np.random.RandomState(3)
    d = 320
    q, k, v = (rs.randn(2, 1, n, d).astype(np.float32) * s for n, s in ((128, d**-0.5), (256, 1.0), (256, 1.0)))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    pad = np.arange(256)[None, :] < np.array([0, 45])[:, None]
    want = torch.from_numpy(np.array(jax_splash_mha(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                                                    pad_mask=jnp.asarray(pad), causal=True, interpret=True)))
    assert _wide_forward_design(d)["s_boxes"] == [2, 3]
    one_o, _ = _wide_arithmetic(q, k, v, torch.from_numpy(pad), True, split_p=False)
    two_o, _ = _wide_arithmetic(q, k, v, torch.from_numpy(pad), True, split_p=True)
    limit = 0.03 * want.pow(2).mean().sqrt() + 2.0**-7 * want.abs()
    assert ((one_o.bfloat16().float() - want).abs() <= limit).all()
    torch.testing.assert_close(two_o, want, atol=1e-4, rtol=0)


def _kernel_terms(x, terms):
    """x as the kernel feeds it to a product: float32 unrounded (terms=0),
    rounded to bf16 once (1), or as hi + lo bf16 terms (2)."""
    if terms == 0:
        return x
    hi = x.bfloat16().float()
    return hi if terms == 1 else hi + (x - hi).bfloat16().float()


def _wide_tiles(d):
    """csrc/flash_backward_wide.cu's tiles at head width d, read from the
    source: the dK/dV pass's resident key rows (kDkdvKeys) and streamed
    query rows (kDkdvCols), the dQ pass's query rows (kDqRows) and streamed
    key rows (kDqKeys); both passes pair neighbouring blocks in a cluster
    (kClusterBlocks). The dQ pass multiplies the dS the dK/dV pass wrote, so
    its key tiles are the dK/dV pass's key blocks."""
    src = WIDE_KERNEL_SOURCE.read_text()
    return dict(rows=_constant(src, "kDkdvKeys"), cols=_constant(src, "kDkdvCols"),
                dq_rows=_constant(src, "kDqRows"), dq_cols=_constant(src, "kDqKeys"),
                pair=_constant(src, "kClusterBlocks"))


def _constant(src, name):
    """``constexpr int name = value;`` of the source, value a number or
    another such constant's name."""
    value = re.search(rf"constexpr int {name} = (\w+);", src).group(1)
    return int(value) if value.isdigit() else _constant(src, value)


def _by_width(src, name, d):
    """A ``constexpr int name<D>()`` of the source whose body is ``return D <=
    a ? x : D <= b ? y : z;`` (or a plain number), at head width d."""
    body = re.search(rf"{name}\(\) \{{\s*return ([^;]+);", src).group(1)
    for bound, value in re.findall(r"D <= (\d+) \? (\d+) :", body):
        if d <= int(bound):
            return int(value)
    return int(body.rsplit(":", 1)[-1])


def _wide_backward_design(d):
    """csrc/flash_backward_wide.cu's budget at head width d, read from the
    source: each pass's stages and shared-memory bytes (``dkdv_smem_bytes``
    and ``dq_smem_bytes`` evaluated at its tiles), each consumer's output
    boxes (``out_boxes``), the float32 accumulators a thread of consumer 0
    holds (an m64nN wgmma keeps N / 2 a thread: dK/dV's dK^T and dV^T over
    its boxes, and its S and dP over half the block's keys; dQ's over its
    boxes), and the setmaxnreg registers of the producer and the consumers."""
    src = WIDE_KERNEL_SOURCE.read_text()
    tiles = _wide_tiles(d)
    stages = {"dkdv": _by_width(src, "dkdv_stages", d), "dq": _by_width(src, "dq_stages", d)}
    body = re.search(r"out_boxes\(int c\) \{\s*return c == 0 \? ([^:]+) : ([^;]+);", src)
    boxes = [eval(e.replace("D", str(d)).replace("/", "//")) for e in body.groups()]

    def smem(name):
        expr = re.search(rf"constexpr size_t {name}_smem_bytes\(\) \{{[^\n]*\n\s*return ([^;]+);", src).group(1)
        for word, value in (("sizeof(bf16)", 2), ("sizeof(uint64_t)", 8), ("dkdv_stages<D>()", stages["dkdv"]),
                            ("dq_stages<D>()", stages["dq"]), ("kDkdvKeys", tiles["rows"]),
                            ("kDkdvCols", tiles["cols"]), ("kDqKeys", tiles["dq_cols"]),
                            ("kTerms", _constant(src, "kTerms")), ("D", d)):
            expr = expr.replace(word, str(value))
        return eval(" ".join(expr.replace("/", "//").split()))

    accumulators = {"dkdv": 2 * boxes[0] * tiles["rows"] // 2 + 2 * (tiles["rows"] // 2) // 2,
                    "dq": 64 * boxes[0] // 2}
    return dict(stages=stages, smem={"dkdv": smem("dkdv"), "dq": smem("dq")}, boxes=boxes,
                accumulators=accumulators, producer_regs=_constant(src, "kProducerRegs"),
                consumer_regs=_constant(src, "kConsumerRegs"))


def _bf16_backward_arithmetic(q, k, v, pad, causal, o, lse, do, terms, rows=128, cols=None, dq_rows=None,
                              dq_cols=None, splits=1, pair=1):
    """The bf16 backward's arithmetic (csrc/flash_backward_mma.cu, or with
    ``_wide_tiles`` and ``splits`` csrc/flash_backward_wide.cu) in plain
    float32 PyTorch: delta = rowsum(dO * O) from the float32 O; the dK/dV
    pass over ``rows``-key blocks and ``cols``-query tiles from each block's
    causal bound on, its query range cut into ``splits`` ranges of whole
    tiles whose float32 partial sums are added in split order; the dQ pass
    over ``dq_rows``-query blocks and the ``dq_cols``-key tiles up to
    theirs (by default flash_backward_mma.cu's: 128-row blocks, tiles of 64
    rows, 32 at D 128); with ``pair`` blocks in a cluster, each dK/dV block
    streams from the pair's first tile (the tiles before its own add exact
    zeros) and each dQ block's tiles stop at its own bound; P and dS go into
    their products in ``terms`` bf16 terms (0: unrounded); pad keys' dK and
    dV are zeros. Returns (dq, dk, dv) in float32, before the kernel's cast
    to bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    b, h, nq, d = q.shape
    nk = k.shape[2]
    off = nk - nq
    cols = cols or (32 if d == 128 else 64)
    dq_rows, dq_cols = dq_rows or rows, dq_cols or cols
    visible = fl._visibility(nq, nk, pad, causal, q.device)
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    delta = (dof * o.float()).sum(-1)

    def p_ds(qs, ks):
        s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, qs], kf[:, :, ks])
        p = torch.where(visible[:, :, qs, ks], torch.exp(s - lse_safe[:, :, qs, None]), torch.zeros_like(s))
        dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, qs], vf[:, :, ks])
        return p, p * (dp - delta[:, :, qs, None])

    dq, dk, dv = torch.zeros(b, h, nq, d), torch.zeros(b, h, nk, d), torch.zeros(b, h, nk, d)
    split_len = -(-(-(-nq // cols)) // splits) * cols
    for k0 in range(0, nk, rows):
        ks = slice(k0, k0 + rows)
        for q_lo in range(0, split_len * splits, split_len):
            part_k, part_v = torch.zeros(b, h, len(range(nk)[ks]), d), torch.zeros(b, h, len(range(nk)[ks]), d)
            pair_k0 = k0 // (rows * pair) * (rows * pair)  # the cluster's first key
            q_begin = max(q_lo, max(0, pair_k0 - off) // cols * cols) if causal else q_lo
            for q0 in range(q_begin, min(nq, q_lo + split_len), cols):
                qs = slice(q0, q0 + cols)
                p, ds = p_ds(qs, ks)
                part_v += torch.einsum("bhqk,bhqd->bhkd", _kernel_terms(p, terms), dof[:, :, qs])
                part_k += torch.einsum("bhqk,bhqd->bhkd", _kernel_terms(ds, terms), qf[:, :, qs])
            dk[:, :, ks] += part_k
            dv[:, :, ks] += part_v
    for q0 in range(0, nq, dq_rows):
        qs = slice(q0, q0 + dq_rows)
        k_end = min(nk, max(0, off + q0 + min(dq_rows, nq - q0))) if causal else nk
        for k0 in range(0, k_end, dq_cols):
            ks = slice(k0, k0 + dq_cols)
            dq[:, :, qs] += torch.einsum("bhqk,bhkd->bhqd", _kernel_terms(p_ds(qs, ks)[1], terms), kf[:, :, ks])
    if pad is not None:
        dk, dv = (t.masked_fill(pad[:, None, :, None], 0.0) for t in (dk, dv))
    return dq, dk, dv


@pytest.mark.usefixtures("two_torch_threads")
def test_bf16_backward_emulation_without_rounding_is_the_plain_backward():
    """The emulation's tiling (causal starts and ends, ragged tiles, key
    blocks that are all padding) changes nothing but the order of float32
    sums: unrounded, it equals B1b's plain version within 1e-5, at a ragged,
    left-padded, causal shape whose first queries see no key."""
    rs = np.random.RandomState(3)
    b, h, nq, nk = 2, 2, 200, 150
    for d in (64, 128):
        q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5)
        k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)) for _ in range(2))
        do = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32))
        pad = torch.arange(nk)[None, :] < torch.tensor([0, 140])[:, None]
        o, lse = fl._forward_plain(q, k, v, pad, True)
        assert torch.isneginf(lse).any()  # rows that see no key
        got = _bf16_backward_arithmetic(q, k, v, pad, True, o, lse, do, terms=0)
        want = fl._backward_plain(q, k, v, pad, True, o, lse, do)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


@pytest.mark.usefixtures("two_torch_threads")
def test_rounding_budget_of_the_bf16_backward():
    """Why the bf16 backward feeds P and dS to their products as two bf16
    terms (kTerms = 2 in csrc/flash_backward_mma.cu). With two, dq, dk and
    dv (cast to bf16) stay within B1's bf16 limit (0.03 x RMS + one bf16
    step) of autograd's gradients of the plain version, at a causal
    self-attention at flagship width (its first rows see one or a few keys)
    and at a left-padded cross-attention. With one, the padded rows' few-key
    queries put dv (P's rounding) and dk (dS's) past it: their terms are
    large and their sums small."""
    terms = int(re.search(r"constexpr int kTerms = (\d+);", KERNEL_SOURCE.read_text()).group(1))
    assert terms == 2
    rs = np.random.RandomState(0)

    def b1_limit(y):
        return 0.03 * y.pow(2).mean().sqrt() + 2.0**-7 * y.abs()

    worst = {}
    for name, (b, h, nq, nk, d, pads) in {"self_attention": (4, 10, 512, 512, 128, None),
                                          "padded_cross": (4, 2, 256, 1152, 64, [0, 7, 300, 1000])}.items():
        q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5).bfloat16()
        k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)).bfloat16() for _ in range(2))
        do = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32)).bfloat16()
        pad = None if pads is None else torch.arange(nk)[None, :] < torch.tensor(pads)[:, None]
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(fl.flash_attention_reference(*leaves, pad_mask=pad, causal=True), leaves, do)
        o, lse = fl._forward_plain(q, k, v, pad, True)
        for n_terms in (1, terms):
            got = _bf16_backward_arithmetic(q, k, v, pad, True, o, lse, do, n_terms)
            for key, x, y in zip(("dq", "dk", "dv"), got, want):
                y = y.float()
                worst[name, n_terms, key] = ((x.bfloat16().float() - y).abs() / b1_limit(y)).max().item()
    assert all(worst[name, terms, key] <= 1 for name in ("self_attention", "padded_cross")
               for key in ("dq", "dk", "dv")), worst
    assert worst["padded_cross", 1, "dv"] > 1.5 and worst["padded_cross", 1, "dk"] > 1.5, worst


@pytest.mark.usefixtures("two_torch_threads")
def test_bf16_backward_emulation_of_the_wide_tiling_is_the_plain_backward():
    """The wide kernel's tiling (64- or 32-key blocks, 32-query tiles, the
    query range in 3 splits summed in split order; 64-query blocks over 64-,
    32- or 16-key tiles) changes nothing but the order of float32 sums:
    unrounded it equals B1b's plain version within 1e-5, at a ragged,
    left-padded, causal shape whose first queries see no key."""
    rs = np.random.RandomState(4)
    b, h, nq, nk = 2, 1, 200, 150
    for d in (256, 512):
        q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5)
        k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)) for _ in range(2))
        do = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5)
        pad = torch.arange(nk)[None, :] < torch.tensor([0, 140])[:, None]
        o, lse = fl._forward_plain(q, k, v, pad, True)
        assert torch.isneginf(lse).any()  # rows that see no key
        got = _bf16_backward_arithmetic(q, k, v, pad, True, o, lse, do, 0, splits=3, **_wide_tiles(d))
        want = fl._backward_plain(q, k, v, pad, True, o, lse, do)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, atol=1e-5, rtol=0)


@pytest.mark.usefixtures("two_torch_threads")
def test_rounding_budget_of_the_bf16_backward_at_512_channels():
    """The wide kernel (kTerms = 2 in csrc/flash_backward_wide.cu) at the
    flow decoder's head: with its tiling and its dK/dV pass in 3 query
    splits, P and dS in two bf16 terms keep dq, dk and dv (cast to bf16)
    within B1's bf16 limit (0.03 x RMS + one bf16 step) of autograd's
    gradients of the plain version, full mask, 256 queries over 1,024 keys
    with one row's keys left-padded."""
    terms = int(re.search(r"constexpr int kTerms = (\d+);", WIDE_KERNEL_SOURCE.read_text()).group(1))
    assert terms == 2
    rs = np.random.RandomState(6)
    b, h, nq, nk, d = 2, 1, 256, 1024, 512
    q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5).bfloat16()
    k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)).bfloat16() for _ in range(2))
    do = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32)).bfloat16()
    pad = torch.arange(nk)[None, :] < torch.tensor([0, 300])[:, None]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fl.flash_attention_reference(*leaves, pad_mask=pad), leaves, do)
    o, lse = fl._forward_plain(q, k, v, pad, False)
    got = _bf16_backward_arithmetic(q, k, v, pad, False, o, lse, do, terms, splits=3, **_wide_tiles(d))
    for key, x, y in zip(("dq", "dk", "dv"), got, want):
        y = y.float()
        limit = 0.03 * y.pow(2).mean().sqrt() + 2.0**-7 * y.abs()
        assert ((x.bfloat16().float() - y).abs() <= limit).all(), key


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [192, 256, 512])
def test_wide_backward_emulation_within_b1_limits(d, causal):
    """The wide backward's arithmetic (csrc/flash_backward_wide.cu's tiles
    and cluster pairs read from the source, the dK/dV pass over 3 query
    splits, P and dS in two bf16 terms, the dQ pass multiplying that dS by
    K over the dK/dV pass's key blocks) against autograd of the plain
    version at a ragged, left-padded shape (200 queries over 300 keys, one
    row's first 120 keys padding; causal, that row's first queries see no
    key): dq, dk and dv cast to bf16 within B1's bf16 limit (0.03 x RMS plus
    one bf16 step); pad keys' dk and dv, and the blind queries' dq, exact
    zeros."""
    rs = np.random.RandomState(10 * d + causal)
    b, h, nq, nk = 2, 1, 200, 300
    q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5).bfloat16()
    k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)).bfloat16() for _ in range(2))
    do = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32)).bfloat16()
    pad = torch.arange(nk)[None, :] < torch.tensor([0, 120])[:, None]
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fl.flash_attention_reference(*leaves, pad_mask=pad, causal=causal), leaves, do)
    o, lse = fl._forward_plain(q, k, v, pad, causal)
    got = _bf16_backward_arithmetic(q, k, v, pad, causal, o, lse, do, 2, splits=3, **_wide_tiles(d))
    for key, x, y in zip(("dq", "dk", "dv"), got, want):
        y = y.float()
        limit = 0.03 * y.pow(2).mean().sqrt() + 2.0**-7 * y.abs()
        assert ((x.bfloat16().float() - y).abs() <= limit).all(), key
    at = pad[:, None, :, None].expand_as(got[1])
    assert (got[1][at] == 0).all() and (got[2][at] == 0).all()
    blind = torch.isneginf(lse)
    assert blind.any() == causal and (got[0][blind] == 0).all()


def test_wide_backward_emulation_matches_interpreted_splash():
    """The wide backward's arithmetic at D 320 (an odd box count) against
    ``jax.grad`` through JAX's splash in interpret mode on the same
    bf16-valued inputs, causal with padding keys, 128 queries over 256 keys:
    dq, dk and dv with P and dS in two bf16 terms, cast to bf16, within B1's
    bf16 limit of splash's gradients."""
    rs = np.random.RandomState(13)
    d = 320
    q, k, v = (rs.randn(2, 1, n, d).astype(np.float32) * s for n, s in ((128, d**-0.5), (256, 1.0), (256, 1.0)))
    q, k, v = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    do = torch.from_numpy(rs.randn(2, 1, 128, d).astype(np.float32)).bfloat16()
    pad = np.arange(256)[None, :] < np.array([0, 45])[:, None]

    def loss(q, k, v):
        out = jax_splash_mha(q, k, v, pad_mask=jnp.asarray(pad), causal=True, interpret=True)
        return jnp.sum(out * jnp.asarray(do.float().numpy()))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    o, lse = fl._forward_plain(q, k, v, torch.from_numpy(pad), True)
    got = _bf16_backward_arithmetic(q, k, v, torch.from_numpy(pad), True, o, lse, do, 2, splits=2, **_wide_tiles(d))
    for key, x, w in zip(("dq", "dk", "dv"), got, want):
        y = torch.from_numpy(np.array(w))
        limit = 0.03 * y.pow(2).mean().sqrt() + 2.0**-7 * y.abs()
        assert ((x.bfloat16().float() - y).abs() <= limit).all(), key


def test_wide_backward_splits_fill_the_card():
    """The wide dK/dV pass's query splits: the flow decoder at 2 patches
    (64 key tiles of 32 rows a patch) gets 9 on 132 SMs, 1,152 blocks of one
    an SM (8.7 waves); 1 patch 17; a short query range is never cut below 4
    query tiles a split; an odd key-tile count is padded to whole clusters.
    The wrapper's tiles are the kernel source's at every width."""
    for d in range(192, fl.MAX_HEAD_DIM + 1, 64):
        tiles = _wide_tiles(d)
        assert (fl._WIDE_KEY_ROWS, fl._WIDE_QUERY_ROWS, fl._WIDE_CLUSTER) == (
            tiles["rows"], tiles["cols"], tiles["pair"]), d
    assert [_wide_tiles(d)["dq_cols"] for d in (192, 512)] == [32, 32]
    assert fl.wide_backward_splits(2, 182_528, 2048, 512, 132) == 9
    assert fl.wide_backward_splits(1, 182_528, 2048, 512, 132) == 17
    assert fl.wide_backward_splits(1, 128, 256, 512, 132) == 1
    assert fl.wide_backward_splits(2, 300, 200, 256, 132) == 2
    assert fl.wide_backward_splits(1, 4096, 2048, 256, 132) == 16
    assert fl.wide_backward_splits(1, 4096, 2016, 256, 132) == 16  # 63 key tiles, padded to 64


@pytest.mark.parametrize("d", [192, 256, 320, 384, 448, 512])
def test_wide_backward_design_fits_the_card(d):
    """Each width of csrc/flash_backward_wide.cu, read from the source: both
    passes' shared memory (dK/dV: K and V of the block's keys, its stages of
    Q and dO, the double-buffered P^T and dS^T terms; dQ: its stages of
    dS^T terms and K; the mbarriers and 1 KB of alignment slack) fits the
    232,448 bytes a block may have and equals the header's table, as do the
    stages and consumer 0's accumulators; those stay well within the
    consumers' setmaxnreg registers (at least 64 left for addresses, masks
    and the P and dS terms), and the producer's and consumers' registers fit
    the SM's 65,536; the output boxes cover D, each wgmma N (64 x boxes in
    dQ, the 32 keys in dK/dV, 16 in its scores) a multiple of 8 no wider than
    256; a multicast half of a streamed tile is a whole number of 8-row
    swizzle atoms."""
    design, tiles = _wide_backward_design(d), _wide_tiles(d)
    row = re.search(rf"//   D {d}: dK/dV (\d) stages?, ([\d,]+) bytes, (\d+) \+ (\d+) \+ (\d+) accumulators; "
                    rf"dQ (\d) stages, ([\d,]+) bytes, (\d+) accumulators", WIDE_KERNEL_SOURCE.read_text())
    n = [int(x.replace(",", "")) for x in row.groups()]
    assert n[:2] == [design["stages"]["dkdv"], design["smem"]["dkdv"]]
    assert n[5:7] == [design["stages"]["dq"], design["smem"]["dq"]]
    assert [sum(n[2:5]), n[7]] == [design["accumulators"]["dkdv"], design["accumulators"]["dq"]]
    for name in ("dkdv", "dq"):
        assert design["smem"][name] <= SMEM_PER_BLOCK and design["stages"][name] >= 1
        assert design["accumulators"][name] + 64 <= design["consumer_regs"], name
    assert 128 * design["producer_regs"] + 256 * design["consumer_regs"] <= 65_536
    assert sum(design["boxes"]) == d // 64 and min(design["boxes"]) >= 1 and 64 * max(design["boxes"]) <= 256
    assert tiles["rows"] % 16 == 0 and tiles["rows"] <= 256 and tiles["dq_cols"] == tiles["rows"]
    assert tiles["cols"] // 2 % 8 == 0 and tiles["dq_cols"] // 2 % 8 == 0


def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: 0x1000 added to
    the float32 word's magnitude bits, the low 13 bits cleared (to nearest,
    ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2**31, dtype=torch.int32)
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def _f32_forward_design(d):
    """csrc/flash_forward_f32.cu's design at head width d, read from the
    source: whether its two consumers split D (else each owns 64 of the
    block's rows), the block's query rows, the key tile, the ring's slabs,
    a slab's bytes and the shared-memory bytes (``smem_bytes`` evaluated
    at these), the order of its 32-channel slabs in a tile, and whether
    both products (S's slab and P V's) start each slab's first slice in a
    fresh accumulator of their own (``mma3(part[..], .., kk == 0)``)."""
    src = F32_FORWARD_SOURCE.read_text()

    def body(name):
        return re.search(rf"constexpr \w+ {name}\((?:int i)?\) \{{(?:\s*//[^\n]*)?\s*return ([^;]+);", src).group(1)

    split = eval(body("split_d").replace("D", str(d)))
    env = {"split_d<D>()": split, "kBox": 32, "sizeof(float)": 4, "sizeof(uint64_t)": 8, "D": d}

    def value(name):
        expr = body(name)
        for word in sorted(env, key=len, reverse=True):
            expr = expr.replace(word, str(env[word]))
        expr = re.sub(r"\(?(\w+) \? ([^:()]+) : ([^()]+?)\)?$", r"(\2 if \1 else \3)", " ".join(expr.split()))
        return eval(expr.replace("/", "//"))

    env["block_rows<D>()"] = rows = value("block_rows")
    env["key_tile<D>()"] = tile = value("key_tile")
    chain = body("stages")  # D <= a ? x : D <= b ? y : ... : z
    stages = next((int(x) for bound, x in re.findall(r"D <= (\d+)\s*\? (\d+)\s*:", chain) if d <= int(bound)),
                  int(chain.rsplit(":", 1)[-1]))
    env["stages<D>()"] = stages
    env["slab_bytes<D>()"] = slab = value("slab_bytes")
    smem = " ".join(body("smem_bytes").split())
    for word in sorted(env, key=len, reverse=True):
        smem = smem.replace(word, str(env[word]))
    smem = re.sub(r"\((True|False) \? ([^:]+) : 0\)", lambda m: f"({m.group(2)} if {m.group(1)} else 0)", smem)
    box = re.search(r"slab_box\(int i\) \{\s*return split_d<D>\(\) \? ([^:]+) : i;", src).group(1)
    order = [eval(box.replace("D / 64", str(d // 64)).replace("/", "//"), {}, {"i": i}) if split else i
             for i in range(d // 32)]
    def choice(name):  # ``return D >= a ? x : y;`` or a number, at d
        expr = body(name)
        cond = re.fullmatch(r"\s*D >= (\d+) \? (\d+) : (\d+)\s*", expr)
        return (int(cond.group(2)) if d >= int(cond.group(1)) else int(cond.group(3))) if cond else int(expr)

    return dict(split=split, rows=rows, tile=tile, stages=stages, slab=slab, smem=eval(smem), order=order,
                q_sets=choice("q_sets"), fresh=len(re.findall(r"mma3<\w+>\(part\[[^;]*, kk == 0\);", src)) == 2,
                pv_parts=choice("pv_parts"), consumer_regs=_constant(src, "kConsumerRegs"),
                producer_regs=_constant(src, "kProducerRegs"))


def _rz(x64):
    """float64 to float32 rounded toward zero."""
    x32 = x64.float()
    over = x32.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def _tensor_core_products(acc, a, b, terms=3):
    """acc (.., M, N) float32 + a (.., M, K) b (.., N, K)^T as the kernel's
    wgmma products of k = 8 slices, lo hi, hi lo, hi hi (with terms=1 hi hi
    alone), each into acc, in a model of the tensor cores' float32 sums: a
    wgmma's 8 products and acc added exactly, then truncated to float32
    (toward zero, as they are)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    pairs = [(a_hi, b_hi)] if terms == 1 else [(_tf32(a - a_hi), b_hi), (a_hi, _tf32(b - b_hi)), (a_hi, b_hi)]
    for k0 in range(0, a.shape[-1], 8):
        sl = slice(k0, k0 + 8)
        for x, y in pairs:
            products = x[..., :, None, sl].double() * y[..., None, :, sl].double()
            acc = _rz(acc.double() + products.sum(-1))
    return acc


def _f32_kernel_arithmetic(q, k, v, pad, causal, terms=3, fresh=None):
    """csrc/flash_forward_f32.cu's arithmetic in PyTorch, its design read
    from the source: key tiles of its width, those whose keys are all
    padding skipped, S and P V from TF32 terms in _tensor_core_products'
    model of the tensor cores' truncating sums, the mask, the online softmax
    in float32. With fresh (by default read from the source), each
    32-channel slab of S starts from zero and is added, rounded, to its
    consumer's S (with split D the two consumers' partials over the halves
    of D then added), and each tile's P V starts from zero and is added to
    O's rescaled rows in one rounding (a fused multiply-add); else (the
    one-chain control) S runs as one chain of truncating sums over the
    consumer's channels and O accumulates in the tensor cores over every
    key. Returns (o, lse) in float32."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    design = _f32_forward_design(d)
    tile, fresh = design["tile"], design["fresh"] if fresh is None else fresh
    halves = [(0, d // 2), (d // 2, d)] if design["split"] else [(0, d)]
    visible = fl._visibility(nq, nk, pad, causal, q.device)
    m = torch.full((b, h, nq), float("-inf"))
    l, acc = torch.zeros(b, h, nq), torch.zeros(b, h, nq, d)
    for k0 in range(0, nk, tile):
        keys = slice(k0, k0 + tile)
        if pad is not None and bool(pad[:, keys].all()):
            continue  # every key of the tile is padding: the kernel never loads it
        kt, vt = k[:, :, keys], v[:, :, keys]
        s = torch.zeros(b, h, nq, kt.shape[2])
        for lo, hi in halves:
            part = torch.zeros_like(s)
            for c0 in range(lo, hi, 32):
                slab = slice(c0, c0 + 32)
                if fresh:
                    part = part + _tensor_core_products(torch.zeros_like(s), q[..., slab], kt[..., slab], terms)
                else:
                    part = _tensor_core_products(part, q[..., slab], kt[..., slab], terms)
            s = s + part
        s = s.masked_fill(~visible[..., keys], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
        alpha, p = torch.exp(m - m_use), torch.exp(s - m_use[..., None])
        l = l * alpha + p.sum(-1)
        if fresh:
            pv = _tensor_core_products(torch.zeros_like(acc), p, vt.transpose(-1, -2), terms)
            acc = (acc.double() * alpha.double()[..., None] + pv.double()).float()
        else:
            acc = _tensor_core_products(acc * alpha[..., None], p, vt.transpose(-1, -2), terms)
        m = m_new
    o = acc / torch.where(l > 0, l, torch.ones_like(l))[..., None]
    return o, torch.where(l > 0, m + torch.log(l), torch.full_like(l, float("-inf")))


# The float32-class limit: the kernel's error against the float64 plain
# version at most this many times the plain float32 version's. On an H100
# the kernel read 0.44-0.93 x, its first build (one chain of truncating sums
# over D and every key) 6.13-8.69 x, one TF32 term 250-2,000 x.
F32_CLASS_FACTOR = 4
F32_CASES = {  # name: (batch, heads, queries, keys, left pads of the keys per row, causal)
    "padded_causal_ragged": (2, 1, 100, 150, [0, 70], True),  # row 1: the first 20 queries see no key
    "ring_block_all_pad_row": (3, 1, 70, 150, [0, 150, 90], False),
}


def _f32_errors(d, case, terms):
    """Max |o - o64| of the kernel's emulated arithmetic and of the plain
    float32 version, against the plain version in float64, and the
    emulation's lse error: inputs at the scale the models give (queries
    scaled by D^-1/2, unit keys and values)."""
    b, h, nq, nk, pads, causal = F32_CASES[case]
    rs = np.random.RandomState(d + nk)
    q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5)
    k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)) for _ in range(2))
    pad = torch.arange(nk)[None, :] < torch.tensor(pads)[:, None]
    want_o, want_lse = fl._forward_plain(q.double(), k.double(), v.double(), pad, causal)
    plain_o = fl._forward_plain(q, k, v, pad, causal)[0]
    emu_o, emu_lse = _f32_kernel_arithmetic(q, k, v, pad, causal, terms)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(emu_lse), finite) and not finite.all()
    assert (emu_o[~finite] == 0).all()
    return ((emu_o.double() - want_o).abs().max().item(), (plain_o.double() - want_o).abs().max().item(),
            (emu_lse[finite].double() - want_lse[finite]).abs().max().item())


def test_tf32_rounding_is_cvt_rna():
    """The emulation's TF32 rounding: 10 explicit mantissa bits, to nearest
    with ties away from zero, in both signs; a split's hi + lo within 2^-22
    of x."""
    x = torch.tensor([1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-10 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 3.0e-30])
    assert _tf32(x).tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-9, -(1.0 + 2.0**-10), 1.0, _tf32(x[5:]).item()]
    y = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32))
    hi = _tf32(y)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all() and ((y - hi).abs() <= 2.0**-11 * y.abs()).all()
    assert ((hi + _tf32(y - hi) - y).abs() <= 2.0**-22 * y.abs()).all()


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("case", sorted(F32_CASES))
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 512])
def test_f32_forward_emulation_is_float32_class(d, case):
    """csrc/flash_forward_f32.cu's arithmetic (three TF32 products in the
    model of truncating tensor-core sums, its tiles, slabs and S split read
    from the source) against the float64 plain version, at
    a ragged, left-padded, causal shape and at a ring block (no causal mask)
    with a row whose keys are all padding (exact zeros, lse = -inf): the
    output within 1e-4 and within F32_CLASS_FACTOR x the plain float32
    version's own error, the lse within 1e-4."""
    err, plain_err, lse_err = _f32_errors(d, case, terms=3)
    assert err <= 1e-4 and lse_err <= 1e-4
    assert err <= F32_CLASS_FACTOR * plain_err, (err, plain_err)


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("d", [64, 512])
def test_one_tf32_term_is_not_float32_class(d):
    """The negative control: the same arithmetic with one TF32 product (hi
    hi) in place of three is more than F32_CLASS_FACTOR x the plain float32
    version's error from float64."""
    err, plain_err, _ = _f32_errors(d, "padded_causal_ragged", terms=1)
    assert err > F32_CLASS_FACTOR * plain_err, (err, plain_err)


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("d", [128, 512])
def test_f32_forward_truncating_sums_need_fresh_accumulators(d):
    """Why the kernel gives each slab of S and each tile's P V a fresh
    accumulator: in a model of the tensor cores' truncating float32 sums,
    with them the output stays within 3 x the plain float32 version's error
    from float64 (1,024 keys); one chain of sums over D and over every key
    is more than 6 x, past F32_CLASS_FACTOR."""
    rs = np.random.RandomState(d)
    nq, nk = 16, 1024
    q = torch.from_numpy(rs.randn(1, 1, nq, d).astype(np.float32) * d**-0.5)
    k, v = (torch.from_numpy(rs.randn(1, 1, nk, d).astype(np.float32)) for _ in range(2))
    want = fl._forward_plain(q.double(), k.double(), v.double(), None, False)[0]
    plain = (fl._forward_plain(q, k, v, None, False)[0].double() - want).abs().max().item()
    assert _f32_forward_design(d)["fresh"]
    fresh = (_f32_kernel_arithmetic(q, k, v, None, False)[0].double() - want).abs().max().item()
    chain = (_f32_kernel_arithmetic(q, k, v, None, False, fresh=False)[0].double() - want).abs().max().item()
    assert fresh <= 3 * plain and chain > 6 * plain > F32_CLASS_FACTOR * plain, (fresh / plain, chain / plain)


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 448, 512])
def test_f32_forward_design_fits_the_card(d):
    """Each width of csrc/flash_forward_f32.cu, read from the source: its
    shared memory (Q in float32, the ring's slabs, the double-buffered S
    exchange when the consumers split D, the mbarriers and 1 KB of alignment
    slack) fits the 232,448 bytes a block may have and equals the header's
    table; a consumer's float32 accumulators (O over its columns, and either
    S with two slabs' own accumulators and its register sets of Q slices, or
    P as hi and lo terms with P V's slab accumulators) leave at least 48 of
    its setmaxnreg registers, and the warpgroups' registers fit the SM's
    65,536; a tile's slabs are each 32-channel box once, the two
    consumers' alternating when they split D; the ring holds at least the
    two slabs a consumer may hold at once, for each consumer; a multicast
    half of a box is a whole number of 8-row swizzle atoms."""
    design = _f32_forward_design(d)
    assert design["smem"] <= SMEM_PER_BLOCK
    row = re.search(rf"//   D {d}: (\d+) query rows, (\d+)-key tiles, (\d+) slabs, ([\d,]+) bytes",
                    F32_FORWARD_SOURCE.read_text())
    assert [int(x.replace(",", "")) for x in row.groups()] == [design["rows"], design["tile"], design["stages"],
                                                               design["smem"]]
    assert design["slab"] == 2 * design["tile"] * 128
    assert design["split"] == (d > 128) and design["rows"] == (64 if design["split"] else 128)
    columns = d // 2 if design["split"] else d
    acc, s = 64 * columns // 128, 64 * design["tile"] // 128
    q_regs = 8 * design["q_sets"]  # 8 a slice: 4 hi and 4 lo
    s_parts = 1 if design["q_sets"] == 1 else 2  # the slabs' own S accumulators
    scores = acc + s + s_parts * s + q_regs  # O, S, the slabs' own S accumulators, Q's sets
    products = acc + design["tile"] + 16 * design["pv_parts"]  # O, P as tile / 8 slices x 2 terms x 4, the parts
    assert max(scores, products) + 48 <= design["consumer_regs"]
    assert 128 * design["producer_regs"] + 256 * design["consumer_regs"] <= 65_536
    # a slab's S accumulator is reused two slabs on, by when its slices must have completed
    assert 1 <= design["q_sets"] <= 5
    assert sorted(design["order"]) == list(range(d // 32))
    if design["split"]:
        assert [b < d // 64 for b in design["order"]] == [i % 2 == 0 for i in range(d // 32)]
    assert design["stages"] >= 4 and design["tile"] // 2 % 8 == 0 and 32 // 2 % 8 == 0


def test_f32_scratch_and_alignment_checks():
    """The float32 forward's scratch: K's two terms at Nk keys, V^T's at Nk
    rounded up to 8 (a ragged ring block's 150 keys take 152); a q that is
    not 16-byte aligned (TMA's tensor map needs it) is refused with its name."""
    assert fl.f32_scratch_floats(6, 2048, 512) == 2 * 6 * 512 * (2048 + 2048)
    assert fl.f32_scratch_floats(3, 150, 64) == 2 * 3 * 64 * (150 + 152)
    assert fl.f32_scratch_floats(1, 8, 64) == 2 * 64 * 16
    shifted = torch.zeros(2 * 128 * 64 + 1)[1:].view(1, 2, 128, 64)
    with pytest.raises(ValueError, match="16-byte aligned tensors; q is not"):
        fl._check_aligned({"q": shifted}, "forward")


def test_wrapper_checks_shapes():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match=r"\(B, H, Nk, D\)"):
        fl.splash_mha(q, torch.zeros(1, 3, 4, 8), torch.zeros(1, 3, 4, 8))
    with pytest.raises(ValueError, match="pad_mask"):
        fl.splash_mha(q, q, q, pad_mask=torch.zeros(1, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="share a dtype"):
        fl.splash_mha(q, q.double(), q)


# ------------------------------------------------ B1b in float32 (TF32 x 3)
def _f32_backward_design(d):
    """csrc/flash_backward_f32.cu's design at head width d, read from the
    source: the dK/dV pass's key block, query tile, the queries a fresh dV^T
    / dK^T accumulator sums, the k = 8 slices a fresh accumulator of S or dP
    sums, its ring slots and their bytes, and its
    shared memory (``dkdv_smem`` evaluated at these); the dQ pass's query
    rows, key tile, slots, slot bytes and shared memory (``dq_smem``); the
    setmaxnreg registers of the producer and the consumers."""
    src = F32_BACKWARD_SOURCE.read_text()
    design = dict(key_block=_by_width(src, "key_block", d), stages=_by_width(src, "dkdv_stages", d))
    sets = re.fullmatch(r"D >= (\d+) \? (\d+) : (\d+)",
                        re.search(r"constexpr int a_sets\(\) \{\s*return ([^;]+);", src).group(1))
    design["a_sets"] = int(sets.group(2)) if d >= int(sets.group(1)) else int(sets.group(3))
    parts = re.fullmatch(r"D > (\d+) \? (\d+) : (\d+)",
                         re.search(r"constexpr int dq_parts\(\) \{\s*return ([^;]+);", src).group(1))
    design["dq_parts"] = int(parts.group(2)) if d > int(parts.group(1)) else int(parts.group(3))
    for key, name in (("q_tile", "kQTile"), ("chain", "kChainQueries"), ("score_slices", "kScoreSlices"),
                      ("slot", "kSlot"), ("dq_rows", "kDqRows"), ("dq_keys", "kDqKeys"), ("dq_slot", "kDqSlot"),
                      ("dq_stages", "kDqStages"), ("consumer_regs", "kConsumerRegs"),
                      ("producer_regs", "kProducerRegs")):
        design[key] = _constant(src, name)

    def smem(name, head):
        expr = re.search(rf"constexpr size_t {name}\(\) \{{\s*return ([^;]+);", src).group(1)
        pds = re.search(r"constexpr int pds_bytes\(\) \{[^}]*?return ([^;]+);", src).group(1)
        for word, value in (("pds_bytes<D>()", f"({pds})"), ("dkdv_stages<D>()", design["stages"]),
                            ("key_block<D>()", design["key_block"]), ("sizeof(float)", 4),
                            ("sizeof(uint64_t)", 8), ("kQTile", design["q_tile"]), ("kSlot", design["slot"]),
                            ("kDqStages", design["dq_stages"]), ("kDqSlot", design["dq_slot"]), ("D", head)):
            expr = expr.replace(word, str(value))
        return eval(" ".join(expr.split()))

    design["smem"], design["dq_smem"] = smem("dkdv_smem", d), smem("dq_smem", d)
    return design


def _zero_pad(x, dim, multiple):
    """x with zeros appended along dim up to a multiple of ``multiple`` (the
    kernel's tiles past a tensor's end read zeros)."""
    extra = -x.shape[dim] % multiple
    if not extra:
        return x
    shape = list(x.shape)
    shape[dim] = extra
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype)], dim)


def _f32_backward_arithmetic(q, k, v, pad, causal, o, lse, do, terms=3, chain=None, splits=1):
    """csrc/flash_backward_f32.cu's arithmetic in PyTorch, its design read
    from the source, in the truncating model of the tensor cores' sums:
    delta = rowsum(dO O) in float32; S and dP a ``score_slices`` k = 8
    slices (all three terms) into a fresh accumulator, added to S (dP) in
    float32; P = exp(S - lse)
    on the visible pairs (zero for a row with lse = -inf), kept as its hi
    and lo TF32 terms, dS = (hi + lo) (dP - delta); the dK/dV pass over key
    blocks that are live (a key in range
    and not padding, and seen by some query), from the 128-query tile that
    sees the block's first key on, the tiles cut into ``splits`` ranges,
    dV^T = dO^T P and dK^T = Q^T dS a ``chain`` queries (default the
    source's) into a fresh accumulator added to each split's float32 sums,
    the splits added in order; dQ = dS K a 32-key tile into a fresh
    accumulator added to dQ in float32. Returns (dq, dk, dv)."""
    b, h, nq, d = q.shape
    nk = k.shape[2]
    design = _f32_backward_design(d)
    bk, tile = design["key_block"], design["q_tile"]
    chain = chain or design["chain"]
    width = 8 * design["score_slices"]
    visible = fl._visibility(nq, nk, pad, causal, q.device).expand(b, 1, nq, nk)
    finite = torch.isfinite(lse)
    delta = (do * o).sum(-1)

    def scores(x, y):
        s = torch.zeros(b, h, nq, nk)
        for c0 in range(0, d, width):
            s = s + _tensor_core_products(torch.zeros_like(s), x[..., c0:c0 + width], y[..., c0:c0 + width], terms)
        return s

    s, dp = scores(q, k), scores(do, v)
    p = torch.where(visible & finite[..., None],
                    torch.exp(s - torch.where(finite, lse, torch.zeros_like(lse))[..., None]), torch.zeros_like(s))
    p_hi = _tf32(p)
    ds = (p_hi + _tf32(p - p_hi)) * (dp - delta[..., None])
    # dK/dV: the kernel's key blocks, tiles, splits and chains (rows past Nq read zeros)
    rows = -(-nq // tile) * tile
    qz, doz, pz, dsz = (_zero_pad(x, 2, tile) for x in (q, do, p, ds))
    dk, dv = torch.zeros(b, h, nk, d), torch.zeros(b, h, nk, d)
    off = nk - nq
    for k0 in range(0, nk, bk):
        keys = slice(k0, k0 + bk)
        live = pad is None or not bool(pad[:, keys].all())  # every head of a batch row: the kernel's rows are (b, h)
        if not live or (causal and k0 > off + nq - 1):
            continue
        t0 = max(0, k0 - off) // tile if causal else 0
        n_t = rows // tile - t0
        out_k, out_v = None, None
        for split in range(splits):
            acc_k, acc_v = torch.zeros(b, h, d, pz[..., keys].shape[-1]), torch.zeros(b, h, d, pz[..., keys].shape[-1])
            for t in range(t0 + n_t * split // splits, t0 + n_t * (split + 1) // splits):
                for c0 in range(t * tile, (t + 1) * tile, chain):
                    c = slice(c0, c0 + chain)
                    for acc, x, y in ((acc_v, doz, pz), (acc_k, qz, dsz)):
                        fresh = torch.zeros_like(acc)
                        acc += _tensor_core_products(fresh, x[..., c, :].transpose(-1, -2),
                                                     y[..., c, keys].transpose(-1, -2), terms)
            out_k = acc_k if out_k is None else out_k + acc_k
            out_v = acc_v if out_v is None else out_v + acc_v
        dk[:, :, keys], dv[:, :, keys] = out_k.transpose(-1, -2), out_v.transpose(-1, -2)
    if pad is not None:  # the kernel writes pad keys' dK and dV as zeros
        at = pad[:, None, :, None].expand_as(dk)
        dk, dv = dk.masked_fill(at, 0.0), dv.masked_fill(at, 0.0)
    # dQ: a 32-key tile at a time
    dq = torch.zeros(b, h, nq, d)
    dsk, kz = _zero_pad(ds, 3, design["dq_keys"]), _zero_pad(k, 2, design["dq_keys"])
    for k0 in range(0, dsk.shape[-1], design["dq_keys"]):
        c = slice(k0, k0 + design["dq_keys"])
        dq = dq + _tensor_core_products(torch.zeros_like(dq), dsk[..., c], kz[..., c, :].transpose(-1, -2), terms)
    return dq, dk, dv


F32_BACKWARD_CASES = {  # name: (batch, heads, queries, keys, left pads of the keys per row, causal)
    # row 1: 70 pad keys (a pad-only key block at every width) and its first
    # 20 queries see no key (lse = -inf); 100 queries: a ragged tile
    "padded_causal_ragged": (2, 1, 100, 150, [0, 70], True),
    "full_all_pad_row": (3, 1, 70, 150, [0, 150, 90], False),  # row 1: every key padding
}


def _f32_backward_case(d, case, seed=0):
    b, h, nq, nk, pads, causal = F32_BACKWARD_CASES[case]
    rs = np.random.RandomState(d + nk + seed)
    q = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32) * d**-0.5)
    k, v = (torch.from_numpy(rs.randn(b, h, nk, d).astype(np.float32)) for _ in range(2))
    do = torch.from_numpy(rs.randn(b, h, nq, d).astype(np.float32))
    pad = torch.arange(nk)[None, :] < torch.tensor(pads)[:, None]
    return q, k, v, pad, causal, do


def _f32_backward_errors(q, k, v, pad, causal, do, **emulation):
    """Max |x - x64| of the emulated kernel's dq, dk and dv and of the plain
    float32 backward's, against the plain backward in float64 (each from
    its own forward's o and lse)."""
    o64, lse64 = fl._forward_plain(q.double(), k.double(), v.double(), pad, causal)
    want = fl._backward_plain(q.double(), k.double(), v.double(), pad, causal, o64, lse64, do.double())
    o, lse = fl._forward_plain(q, k, v, pad, causal)
    plain = fl._backward_plain(q, k, v, pad, causal, o, lse, do)
    got = _f32_backward_arithmetic(q, k, v, pad, causal, o, lse, do, **emulation)
    errs = {name: ((x.double() - w).abs().max().item(), (y.double() - w).abs().max().item())
            for name, x, y, w in zip(("dq", "dk", "dv"), got, plain, want)}
    return errs, got, lse


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("case", sorted(F32_BACKWARD_CASES))
@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 512])
def test_f32_backward_emulation_is_float32_class(d, case):
    """csrc/flash_backward_f32.cu's arithmetic (three TF32 products in the
    model of truncating tensor-core sums, its key blocks, query tiles,
    chains and fresh accumulators read from the source, its query range in 2
    splits) against the float64 plain backward, at a padded causal ragged
    shape (rows that see no key, a pad-only key block) and at a full mask with
    a batch row whose keys are all padding: dq, dk and dv each within
    F32_CLASS_FACTOR x the plain float32 version's error; pad keys' dk and dv
    exact zeros; rows with lse = -inf zero dq."""
    q, k, v, pad, causal, do = _f32_backward_case(d, case)
    errs, got, lse = _f32_backward_errors(q, k, v, pad, causal, do, splits=2)
    for name, (err, plain) in errs.items():
        assert err <= F32_CLASS_FACTOR * plain, (name, err / plain)
    at = pad[:, None, :, None].expand_as(got[1])
    assert (got[1][at] == 0).all() and (got[2][at] == 0).all()
    blind = torch.isneginf(lse)
    assert blind.any() and (got[0][blind] == 0).all()


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("d", [64, 512])
def test_f32_backward_one_tf32_term_is_not_float32_class(d):
    """The negative control: the same arithmetic with one TF32 product (hi
    hi) in place of three is more than F32_CLASS_FACTOR x the plain float32
    version's error from float64 in dq, dk and dv."""
    errs, _, _ = _f32_backward_errors(*_f32_backward_case(d, "padded_causal_ragged"), terms=1)
    for name, (err, plain) in errs.items():
        assert err > F32_CLASS_FACTOR * plain, (name, err / plain)


@pytest.mark.usefixtures("two_torch_threads")
def test_f32_backward_truncating_sums_need_fresh_accumulators():
    """Why dV^T and dK^T start a fresh accumulator every kChainQueries
    queries: over 2,048 queries (one key block of 32 keys, D 64, full mask)
    the design stays within F32_CLASS_FACTOR x the plain float32 version's
    error from float64 in dk and dv, and one chain of truncating sums over
    every query is past it."""
    rs = np.random.RandomState(2048)
    nq, nk, d = 2048, 32, 64
    q = torch.from_numpy(rs.randn(1, 1, nq, d).astype(np.float32) * d**-0.5)
    k, v, do = (torch.from_numpy(rs.randn(1, 1, n, d).astype(np.float32)) for n in (nk, nk, nq))
    fresh, _, _ = _f32_backward_errors(q, k, v, None, False, do)
    chain, _, _ = _f32_backward_errors(q, k, v, None, False, do, chain=nq)
    assert _f32_backward_design(d)["chain"] < nq
    for name in ("dk", "dv"):
        assert fresh[name][0] <= F32_CLASS_FACTOR * fresh[name][1], (name, fresh[name])
        assert chain[name][0] > F32_CLASS_FACTOR * chain[name][1], (name, chain[name])


@pytest.mark.usefixtures("two_torch_threads")
@pytest.mark.parametrize("d", [64, 512])
def test_f32_backward_emulation_matches_interpreted_splash(d):
    """The float32 backward's emulated arithmetic against ``jax.grad``
    through JAX's splash in interpret mode on the same inputs (numpy, seeded),
    causal with padding keys, 128 queries over 256 keys: dq, dk and dv within
    the file's atol 2e-5; pad keys' gradients exact zeros."""
    rs = np.random.RandomState(d + 7)
    q, k, v = (rs.randn(2, 1, n, d).astype(np.float32) * s for n, s in ((128, d**-0.5), (256, 1.0), (256, 1.0)))
    do = rs.randn(2, 1, 128, d).astype(np.float32) * d**-0.5
    pad = np.arange(256)[None, :] < np.array([0, 45])[:, None]

    def loss(q, k, v):
        return jnp.sum(jax_splash_mha(q, k, v, pad_mask=jnp.asarray(pad), causal=True, interpret=True)
                       * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(a) for a in (q, k, v, do)]
    o, lse = fl._forward_plain(t[0], t[1], t[2], torch.from_numpy(pad), True)
    got = _f32_backward_arithmetic(t[0], t[1], t[2], torch.from_numpy(pad), True, o, lse, t[3])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL, err_msg=name)
    at = torch.from_numpy(pad)[:, None, :, None].expand_as(got[1])
    assert not got[1][at].any() and not got[2][at].any()


@pytest.mark.parametrize("d", [64, 128, 192, 256, 320, 384, 448, 512])
def test_f32_backward_design_fits_the_card(d):
    """Each width of csrc/flash_backward_f32.cu, read from the source: both
    passes' shared memory (dK/dV: P^T and dS^T as hi and lo terms, its ring of
    16 KB slots; dQ: its ring of 8 KB slots; the mbarriers and 1 KB of
    alignment slack) fits the 232,448 bytes a block may have and equals the
    header's table, as do the key block, the slots and consumer 0's
    accumulators at its peak (dV^T's m-tiles, S or dP, a box's own) and its
    register sets of A fragments; those leave at least 32 of the consumers'
    setmaxnreg registers, the dQ pass's (its part of D's columns, 32 a box
    for two consumers' rows: half a register a column; a box's own
    accumulator; dS's four slices as hi and lo) at least 24, the parts cover
    D in whole boxes, and the warpgroups' registers fit the SM's
    65,536; a ring slot holds a Q box of the query tile and a K box of the key
    block as hi and lo, the query tile is two consumers' 64 rows, its chains
    whole k = 8 slices that divide it, and the wgmma N (the key block, 32 in
    dQ) a multiple of 8 up to 256."""
    design = _f32_backward_design(d)
    bk = design["key_block"]
    assert design["smem"] <= SMEM_PER_BLOCK and design["dq_smem"] <= SMEM_PER_BLOCK
    row = re.search(rf"//   D {d}: (\d+)-key blocks, (\d+) slots, ([\d,]+) bytes, (\d+) \+ (\d+) \+ (\d+) "
                    rf"accumulators, (\d) A sets?; dQ (\d+) slots, ([\d,]+) bytes", F32_BACKWARD_SOURCE.read_text())
    n = [int(x.replace(",", "")) for x in row.groups()]
    running, s = d * bk // 128, bk // 2
    assert n == [bk, design["stages"], design["smem"], running, s, s, design["a_sets"], design["dq_stages"],
                 design["dq_smem"]]
    assert running + 2 * s + 8 * design["a_sets"] + 32 <= design["consumer_regs"]
    columns = d // design["dq_parts"]
    assert columns % 32 == 0 and columns // 2 + 16 + 32 + 24 <= design["consumer_regs"]
    assert 128 * design["producer_regs"] + 256 * design["consumer_regs"] <= 65_536
    assert design["slot"] >= max(design["q_tile"], 2 * bk) * 128 and design["dq_slot"] >= design["dq_rows"] * 128
    assert design["q_tile"] == 2 * 64 and design["q_tile"] % design["chain"] == 0 and design["chain"] % 8 == 0
    assert 4 % design["score_slices"] == 0 and bk % 8 == 0 and bk <= 256 and design["dq_keys"] == 32


def test_f32_backward_splits_and_scratch():
    """The float32 dK/dV pass's query splits: the flow decoder's patch (64
    key blocks of 32 keys) gets 9 on 132 SMs, the flagship's 160 heads of 16
    key blocks none, a short query range never below 4 tiles a split; the
    wrapper's query tile and key blocks are the source's; the scratch holds
    K and V as two terms and K^T as two terms over Nk rounded up to 8, and
    the dS scratch's rows are Nk rounded up to 4."""
    for d in range(64, fl.MAX_HEAD_DIM + 1, 64):
        design = _f32_backward_design(d)
        assert fl._F32_QUERY_TILE == design["q_tile"]
        blocks = -(-2048 // design["key_block"])
        assert fl.f32_backward_splits(1, 10**6, 2048, d, 132) == -(-fl._F32_WAVES * 132 // blocks)
    assert fl.f32_backward_splits(1, 182_528, 2048, 512, 132) == 9
    assert fl.f32_backward_splits(160, 512, 1024, 128, 132) == 1
    assert fl.f32_backward_splits(4, 1024, 768, 192, 132) == 2
    assert fl.f32_backward_scratch_floats(3, 150, 64) == 2 * 3 * 64 * (2 * 150 + 152)
    assert fl._f32_ds_keys(150) == 152 and fl._f32_ds_keys(2048) == 2048
