"""Port parity: perceiver_io_torch.ops.flash (the plain version of kernels
B1a/B1b and the autograd Function's CPU route) against the JAX package's
``splash_mha`` in Pallas interpret mode, at tests/test_flash.py's shapes
(B=1, H=2, D=64, 128 queries x 256 keys), in float32; and the bf16 CUDA
kernels' roundings, emulated in plain PyTorch (the forward's P; the
backward's P and dS, with its tiling), against the plain version's limits.

Tolerances: the forward within atol 2e-5, as the JAX package's own tests
hold splash against its XLA formulation; dq, dk and dv against ``jax.grad``
through the same interpreted splash within atol 2e-5 (float32 sums taken in
another order; gradients here are of order 0.1-1). The Function's CPU route
(FlashAttention-2's recomputed backward) is pinned to autograd of the plain
version in float64 (``gradcheck``, and atol 1e-12 on the gradients).
"""

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
    # the flagship's shapes, and the kernels' head-width limit
    assert fl.flash_supported(128, 128, 512, 1024, False, False)
    assert fl.flash_supported(128, 128, 512, 512, False, False)
    assert not fl.flash_supported(256, 256, 512, 512, False, False)
    assert not fl.flash_supported(64, 64, 64, 512, False, False)  # fewer than 128 queries


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


def _bf16_kernel_arithmetic(q, k, v, pad, causal, split_p, tile=64):
    """The bf16 forward's arithmetic (csrc/flash_forward_mma.cu) in plain
    float32 PyTorch: 64-key tiles, the online softmax, P rounded to bf16 in
    one term or split into two (hi + lo) before the P V product, and the sum
    l of the unrounded p. Returns (o, lse) in float32."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    b, h, nq, d = q.shape
    visible = fl._visibility(nq, k.shape[2], pad, causal, q.device)
    m = torch.full((b, h, nq), float("-inf"))
    l, acc = torch.zeros(b, h, nq), torch.zeros(b, h, nq, d)
    for k0 in range(0, k.shape[2], tile):
        vt = vf[:, :, k0:k0 + tile]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + tile])
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


def _kernel_terms(x, terms):
    """x as the kernel feeds it to a product: float32 unrounded (terms=0),
    rounded to bf16 once (1), or as hi + lo bf16 terms (2)."""
    if terms == 0:
        return x
    hi = x.bfloat16().float()
    return hi if terms == 1 else hi + (x - hi).bfloat16().float()


def _bf16_backward_arithmetic(q, k, v, pad, causal, o, lse, do, terms):
    """The bf16 backward's arithmetic (csrc/flash_backward_mma.cu) in plain
    float32 PyTorch: delta = rowsum(dO * O) from the float32 O; the dK/dV
    pass over 128-key blocks and the query tiles from each block's causal
    bound on, the dQ pass over 128-query blocks and the key tiles up to
    theirs (tiles of 64 rows, 32 at D 128); P and dS go into their products
    in ``terms`` bf16 terms (0: unrounded); pad keys' dK and dV are zeros.
    Returns (dq, dk, dv) in float32, before the kernel's cast to bf16."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    b, h, nq, d = q.shape
    nk = k.shape[2]
    rows, cols, off = 128, 32 if d == 128 else 64, nk - nq
    visible = fl._visibility(nq, nk, pad, causal, q.device)
    lse_safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    delta = (dof * o.float()).sum(-1)

    def p_ds(qs, ks):
        s = torch.einsum("bhqd,bhkd->bhqk", qf[:, :, qs], kf[:, :, ks])
        p = torch.where(visible[:, :, qs, ks], torch.exp(s - lse_safe[:, :, qs, None]), torch.zeros_like(s))
        dp = torch.einsum("bhqd,bhkd->bhqk", dof[:, :, qs], vf[:, :, ks])
        return p, p * (dp - delta[:, :, qs, None])

    dq, dk, dv = torch.zeros(b, h, nq, d), torch.zeros(b, h, nk, d), torch.zeros(b, h, nk, d)
    for k0 in range(0, nk, rows):
        ks = slice(k0, k0 + rows)
        for q0 in range(max(0, k0 - off) // cols * cols if causal else 0, nq, cols):
            qs = slice(q0, q0 + cols)
            p, ds = p_ds(qs, ks)
            dv[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd", _kernel_terms(p, terms), dof[:, :, qs])
            dk[:, :, ks] += torch.einsum("bhqk,bhqd->bhkd", _kernel_terms(ds, terms), qf[:, :, qs])
    for q0 in range(0, nq, rows):
        qs = slice(q0, q0 + rows)
        k_end = min(nk, max(0, off + q0 + min(rows, nq - q0))) if causal else nk
        for k0 in range(0, k_end, cols):
            ks = slice(k0, k0 + cols)
            dq[:, :, qs] += torch.einsum("bhqk,bhkd->bhqd", _kernel_terms(p_ds(qs, ks)[1], terms), kf[:, :, ks])
    if pad is not None:
        dk, dv = (t.masked_fill(pad[:, None, :, None], 0.0) for t in (dk, dv))
    return dq, dk, dv


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


def test_wrapper_checks_shapes():
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match=r"\(B, H, Nk, D\)"):
        fl.splash_mha(q, torch.zeros(1, 3, 4, 8), torch.zeros(1, 3, 4, 8))
    with pytest.raises(ValueError, match="pad_mask"):
        fl.splash_mha(q, q, q, pad_mask=torch.zeros(1, 5, dtype=torch.bool))
    with pytest.raises(ValueError, match="share a dtype"):
        fl.splash_mha(q, q.double(), q)
