"""Card-only tests of the port's CUDA kernels. They import torch and the port
only (no JAX), so the card's machine can run them without the repo's
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a card every test skips (a CUDA kernel has no CPU mode); the CPU
tiers check the kernels' plain versions against the JAX package instead.
"""

import pytest
import torch

import dataclasses

import perceiver_io_torch.ops.decode_kernel as dk
import perceiver_io_torch.ops.flash as fl
import perceiver_io_torch.ops.paged_decode_kernel as pk
import perceiver_io_torch.ops.ragged_paged_kernel as rk
from perceiver_io_torch.models.core.config import CausalSequenceModelConfig, flagship_455m_config
from perceiver_io_torch.models.core.perceiver_ar import CausalSequenceModel
from perceiver_io_torch.reliability import FAULTS, armed
from perceiver_io_torch.serving import BREAKER_CLOSED, RequestStatus, ServingEngine, ServingRouter
from perceiver_io_torch.training.trainer import TrainState, build_optimizer, make_causal_lm_train_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q", [1, 3, 8])
def test_decode_kernel_matches_plain(card, monkeypatch, dtype, n_q):
    """Max error 1e-4 in float32; in bfloat16 0.03 of the plain output's RMS
    (both sides round float32 sums to bfloat16 apart: one step is up to 2**-7
    of a value), as chip_smoke.py holds it."""
    g = torch.Generator(card).manual_seed(n_q)
    b, h, d, cap, r = 2, 3, 64, 300, 32
    q = (torch.randn(b, h, n_q, d, generator=g, device=card) * d**-0.5).to(dtype)
    k = torch.randn(b, cap, h * d, generator=g, device=card).to(dtype)
    v = torch.randn(b, cap, h * d, generator=g, device=card).to(dtype)
    ang = torch.rand(b, cap, r // 2, generator=g, device=card).mul(cap).repeat_interleave(2, -1)
    pad = torch.zeros(b, cap, dtype=torch.bool, device=card)
    pad[1, :40] = True
    q_pos = torch.tensor([299, 250], dtype=torch.int32, device=card)
    live = torch.tensor([300, 211], dtype=torch.int32, device=card)
    want = dk.fused_decode_attention_reference(q, k, v, ang, q_pos, pad, live)

    monkeypatch.setattr(dk, "fused_decode_attention_reference", None)  # the CUDA path must not need it
    before = dk.launches
    got = dk.fused_decode_attention(q, k, v, ang, q_pos, pad, live)
    torch.cuda.synchronize()
    assert dk.launches == before + 1
    want = want.float()
    atol = 1e-4 if dtype == torch.float32 else 0.03 * want.pow(2).mean().sqrt().item()
    torch.testing.assert_close(got.float(), want, atol=atol, rtol=0)


def test_decode_kernel_rejects_what_it_does_not_take(card):
    kv = torch.zeros(1, 8, 32, device=card)
    args = (torch.zeros(1, 8, 16, device=card), 7, torch.zeros(1, 8, dtype=torch.bool, device=card))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        dk.fused_decode_attention(torch.zeros(1, 2, 1, 16, device=card, dtype=torch.float64), kv.double(),
                                  kv.double(), *args)
    strided = torch.zeros(1, 3, 2, 16, device=card).transpose(1, 2)  # (1, 2, 3, 16), not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        dk.fused_decode_attention(strided, kv, kv, *args)


def test_model_on_the_card_matches_the_cpu(card):
    """A small model's prefill and decode steps, f32, card vs CPU (atol 1e-5),
    with 1 + layers kernel launches per decode step."""
    cfg = CausalSequenceModelConfig(vocab_size=64, max_seq_len=16, max_latents=8, num_channels=32, num_heads=2,
                                    num_self_attention_layers=2, abs_pos_emb=False, output_norm=True,
                                    num_self_attention_rotary_layers=-1)
    cpu = CausalSequenceModel(cfg, device="cpu", seed=3)
    gpu = CausalSequenceModel(cfg, device=card, seed=4)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, 64, (2, 12), generator=torch.Generator().manual_seed(0))
    c_cpu, c_gpu = cpu.init_cache(2), gpu.init_cache(2)
    with torch.no_grad():
        l_cpu, c_cpu = cpu.prefill(x, 6, c_cpu)
        l_gpu, c_gpu = gpu.prefill(x.to(card), 6, c_gpu)
        torch.testing.assert_close(l_gpu.cpu(), l_cpu, atol=1e-5, rtol=0)
        for step in range(6):  # crosses the window roll
            tok = l_cpu[:, -1].argmax(-1, keepdim=True)
            dk.launches = 0
            l_cpu, c_cpu = cpu.decode_step(tok, c_cpu)
            l_gpu, c_gpu = gpu.decode_step(tok.to(card), c_gpu)
            assert dk.launches == 1 + cfg.num_self_attention_layers
            torch.testing.assert_close(l_gpu.cpu(), l_cpu, atol=1e-5, rtol=0)


def _paged_inputs(dev, pool, q_dtype, w, h=3, d=64, window=300, ps=48, r=32, seed=0):
    """A page pool (``pool``: "f32", "bf16", "int8" or "int4", the quantized
    ones written through ``write_pages``), distinct shuffled pages per row,
    angles per physical position and scaled queries."""
    g = torch.Generator(dev).manual_seed(seed)
    p = -(-window // ps)
    n_pages = w * p + 2
    q = (torch.randn(w, h, 1, d, generator=g, device=dev) * d**-0.5).to(q_dtype)
    kf, vf = (torch.randn(n_pages, ps, h * d, generator=g, device=dev) for _ in range(2))
    table = (torch.randperm(n_pages - 1, generator=g, device=dev)[: w * p] + 1).reshape(w, p).to(torch.int32)
    ang = torch.rand(w, p * ps, r // 2, generator=g, device=dev).mul(window).repeat_interleave(2, -1)
    if pool in ("f32", "bf16"):
        dt = torch.float32 if pool == "f32" else torch.bfloat16
        return q, kf.to(dt), vf.to(dt), table, ang, {}, 8
    qbits = 4 if pool == "int4" else 8
    c = h * d // 2 if qbits == 4 else h * d
    pool_dt = torch.uint8 if qbits == 4 else torch.int8
    cache = pk.PagedKVCache(torch.zeros(n_pages, ps, c, dtype=pool_dt, device=dev),
                            torch.zeros(n_pages, ps, c, dtype=pool_dt, device=dev), table,
                            torch.zeros(w, dtype=torch.int32, device=dev), window,
                            torch.zeros(n_pages, h, device=dev), torch.zeros(n_pages, h, device=dev), num_heads=h,
                            qbits=qbits)
    cache.write_pages(torch.arange(n_pages, device=dev), kf, vf)
    return q, cache.kp, cache.vp, table, ang, dict(k_scale=cache.k_scale, v_scale=cache.v_scale), qbits


def _limit(q_dtype, pool, want):
    """1e-4 in float32; 0.03 of the plain output's RMS for bf16 and quantized
    pools, as chip_smoke.py holds them."""
    if q_dtype == torch.float32 and pool == "f32":
        return 1e-4
    return 0.03 * want.float().pow(2).mean().sqrt().item()


@pytest.mark.parametrize("pool,q_dtype", [("f32", torch.float32), ("bf16", torch.bfloat16),
                                          ("int8", torch.float32), ("int8", torch.bfloat16)])
def test_b3_kernel_matches_plain(card, monkeypatch, pool, q_dtype):
    """Ring offsets that wrap, live counts that leave dead pages, a page
    size (48) that does not divide the window (300)."""
    q, kp, vp, table, ang, scales, _ = _paged_inputs(card, pool, q_dtype, w=4)
    start = torch.tensor([0, 299, 123, 17], dtype=torch.int32, device=card)
    live = torch.tensor([300, 50, 1, 299], dtype=torch.int32, device=card)
    want = pk.fused_paged_decode_attention_reference(q, kp, vp, table, start, live, ang, 300, **scales)
    monkeypatch.setattr(pk, "fused_paged_decode_attention_reference", None)  # the CUDA path must not need it
    monkeypatch.setattr(pk, "paged_attention_plain", None)
    before = pk.launches
    got = pk.fused_paged_decode_attention(q, kp, vp, table, start, live, ang, 300, **scales)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    torch.testing.assert_close(got.float(), want.float(), atol=_limit(q_dtype, pool, want), rtol=0)


@pytest.mark.parametrize("pool,q_dtype", [("int4", torch.float32), ("int4", torch.bfloat16),
                                          ("bf16", torch.bfloat16), ("int8", torch.bfloat16),
                                          ("f32", torch.float32)])
def test_b4_kernel_matches_plain(card, monkeypatch, pool, q_dtype):
    """Decode items, latent-finish items with causal bounds window - L + j
    over a wrapped ring, and live = 0 padding lanes, which must be exact
    zeros."""
    q, kp, vp, table, ang, scales, qbits = _paged_inputs(card, pool, q_dtype, w=7)
    window, latents = 300, 3
    start = torch.tensor([5, 250, 250, 250, 40, 0, 7], dtype=torch.int32, device=card)
    live = torch.tensor([300, 260, 260, 260, 31, 0, 0], dtype=torch.int32, device=card)
    cb = torch.tensor([299, window - latents, window - latents + 1, window - latents + 2, 299, 299, 10],
                      dtype=torch.int32, device=card)
    args = (q, kp, vp, table, start, live, cb, ang, window)
    want = rk.fused_ragged_paged_attention_reference(*args, qbits=qbits, **scales)
    monkeypatch.setattr(rk, "fused_ragged_paged_attention_reference", None)
    monkeypatch.setattr(pk, "paged_attention_plain", None)
    before = rk.launches
    got = rk.fused_ragged_paged_attention(*args, qbits=qbits, **scales)
    torch.cuda.synchronize()
    assert rk.launches == before + 1
    assert (got[5:] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), atol=_limit(q_dtype, pool, want), rtol=0)


@pytest.mark.parametrize("kv_quant", [None, "int8", "int4"])
def test_paged_engine_on_the_card_matches_the_cpu(card, kv_quant):
    """A small paged engine in float32, card vs CPU: identical greedy tokens,
    with one cross-attention launch (B3, or B4 for int4 pools) and one B2
    launch per self-attention layer in every decode tick."""
    cfg = CausalSequenceModelConfig(vocab_size=64, max_seq_len=24, max_latents=6, num_channels=32, num_heads=2,
                                    num_self_attention_layers=2, abs_pos_emb=False, output_norm=True,
                                    num_self_attention_rotary_layers=-1, init_scale=0.5)
    cpu = CausalSequenceModel(cfg, device="cpu", seed=3)
    gpu = CausalSequenceModel(cfg, device=card, seed=4)
    gpu.load_state_dict(cpu.state_dict())
    rs = torch.Generator().manual_seed(1)
    prompts = [torch.randint(1, 64, (n,), generator=rs).tolist() for n in (3, 7, 24, 13, 6)]
    max_new = [6, 9, 4, 12, 5]

    def run(model):
        engine = ServingEngine(model, num_slots=3, kv_page_size=5, kv_quant=kv_quant)
        handles = [engine.submit(p, max_new_tokens=m) for p, m in zip(prompts, max_new)]
        ticks = 0
        dk.launches = pk.launches = rk.launches = 0
        while engine.step():
            ticks += 1
        return [h.result().tolist() for h in handles], ticks + 1, (dk.launches, pk.launches, rk.launches)

    want, _, _ = run(cpu)
    got, ticks, (b2, b3, b4) = run(gpu)
    assert got == want
    assert b2 >= 2 * ticks and (b4 if kv_quant == "int4" else b3) == ticks and (b3 if kv_quant == "int4" else b4) == 0


def _decode_split_case(dev, dtype, n_q, cap=2048, seed=0):
    """Few (row, head) pairs over a long cache, so that B2 takes many splits:
    row 0 has pad slots across whole splits, row 1 is all padding, row 2's
    last query sits at slot 3 (with n_q = 8 its first queries see nothing)."""
    g = torch.Generator(dev).manual_seed(seed)
    b, h, d, r = 3, 1, 64, 64
    q = (torch.randn(b, h, n_q, d, generator=g, device=dev) * d**-0.5).to(dtype)
    k = torch.randn(b, cap, h * d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, cap, h * d, generator=g, device=dev).to(dtype)
    ang = torch.rand(b, cap, r // 2, generator=g, device=dev).mul(cap).repeat_interleave(2, -1)
    pad = torch.zeros(b, cap, dtype=torch.bool, device=dev)
    pad[0, 600:900] = True
    pad[1] = True
    q_pos = torch.tensor([cap - 1, cap - 1, 3], dtype=torch.int32, device=dev)
    return q, k, v, ang, q_pos, pad


def _paged_split_case(dev, pool, q_dtype, seed=0):
    """Few (row, head) pairs over a window of many small pages, so that B3
    and B4 take many splits: full, short, empty and wrapped rows for B3; a
    decode item, latent-finish items and two empty items for B4."""
    window = 1000
    inputs = _paged_inputs(dev, pool, q_dtype, w=5, h=2, window=window, ps=16, seed=seed)
    start = torch.tensor([0, 999, 17, 500, 3], dtype=torch.int32, device=dev)
    live = torch.tensor([1000, 17, 0, 1000, 900], dtype=torch.int32, device=dev)
    cb = torch.tensor([999, 999, 999, 600, 101], dtype=torch.int32, device=dev)
    return inputs, window, start, live, cb


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q", [1, 8])
def test_decode_kernel_many_splits(card, dtype, n_q):
    """B2 split-K at 32 splits a (row, head): splits inside the padding and
    queries that see nothing give exact zeros, not NaN; two runs give the
    same bits."""
    q, k, v, ang, q_pos, pad = _decode_split_case(card, dtype, n_q)
    assert dk.decode_splits(3, 1, k.shape[1], dk.num_sms(card)) >= 16
    want = dk.fused_decode_attention_reference(q, k, v, ang, q_pos, pad)
    got = dk.fused_decode_attention(q, k, v, ang, q_pos, pad)
    again = dk.fused_decode_attention(q, k, v, ang, q_pos, pad)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got[1] == 0).all() and (got[2, :, : max(n_q - 4, 0)] == 0).all()
    atol = 1e-4 if dtype == torch.float32 else 0.03 * want.float().pow(2).mean().sqrt().item()
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)


@pytest.mark.parametrize("kernel,pool,q_dtype", [("B3", "f32", torch.float32), ("B3", "int8", torch.bfloat16),
                                                 ("B4", "int4", torch.bfloat16), ("B4", "bf16", torch.bfloat16)])
def test_paged_kernels_many_splits(card, kernel, pool, q_dtype):
    """B3 and B4 split-K at 27 splits a (row, head) over 16-row pages: rows
    and items that see nothing are exact zeros; two runs give the same bits."""
    (q, kp, vp, table, ang, scales, qbits), window, start, live, cb = _paged_split_case(card, pool, q_dtype)
    assert pk.paged_splits(5, 2, window, 16, dk.num_sms(card)) >= 16
    if kernel == "B3":
        args = (q, kp, vp, table, start, live, ang, window)
        want = pk.fused_paged_decode_attention_reference(*args, **scales)
        run = lambda: pk.fused_paged_decode_attention(*args, **scales)
        empty = live == 0
    else:
        args = (q, kp, vp, table, start, live, cb, ang, window)
        want = rk.fused_ragged_paged_attention_reference(*args, qbits=qbits, **scales)
        run = lambda: rk.fused_ragged_paged_attention(*args, qbits=qbits, **scales)
        empty = rk.fold_causal_bound(start, live, cb, window)[1] == 0
    got, again = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert empty.any() and (got[empty] == 0).all()
    torch.testing.assert_close(got.float(), want.float(), atol=_limit(q_dtype, pool, want), rtol=0)


def _assert_split_records(rec, splits_per_row):
    """``rec`` (rows, heads, S, D + 2) holds the workspace records of a q = 0
    launch, filled with NaN before it: every score is 0, so split k of a
    row with n_k > 1 splits holds m = 0 and l = the count of slots it saw
    (m = -inf, l = 0 if none); a row with one split and the blocks past a
    row's n_k write no record. ``splits_per_row[i]`` is the Python mirror's
    slots of each split of row i."""
    for i, splits in enumerate(splits_per_row):
        n_k = len(splits) if len(splits) > 1 else 0
        for k in range(rec.shape[2]):
            got = rec[i, :, k, :2]
            if k >= n_k:
                assert got.isnan().all(), (i, k)
                continue
            want_m = 0.0 if splits[k] else float("-inf")
            assert (got[:, 0] == want_m).all() and (got[:, 1] == len(splits[k])).all(), (i, k, got, len(splits[k]))


@pytest.mark.parametrize("live", [None, (2048, 1500, 4)])
def test_decode_split_rows_match_the_kernel(card, live):
    """B2's split ranges as the kernel computes them (read back from its
    workspace) equal those of their Python mirror, decode_split_rows, which
    the CPU tests check."""
    q, k, v, ang, q_pos, pad = _decode_split_case(card, torch.float32, 1)
    q.zero_()
    live_t = None if live is None else torch.tensor(live, dtype=torch.int32, device=card)
    b, h, _, d = q.shape
    cap = k.shape[1]
    splits = dk.decode_splits(b, h, cap, dk.num_sms(card))  # q_pos is a tensor: the wrapper's span is cap
    assert splits >= 16
    size = b * h * splits * (d + 2)
    ws, _ = dk.split_workspace(torch.cuda.current_stream(card), size, b * h)
    ws.fill_(float("nan"))
    dk.fused_decode_attention(q, k, v, ang, q_pos, pad, live_t)
    rec = ws[:size].view(b, h, splits, d + 2).cpu()
    mirror = [dk.decode_split_rows(int(q_pos[i]), None if live is None else live[i], cap, pad[i].tolist(), splits)
              for i in range(b)]
    assert len(mirror[0]) == splits and len(mirror[2]) == 1  # row 2 sees 4 slots: one split, no record
    _assert_split_records(rec, mirror)


@pytest.mark.parametrize("kernel,pool", [("B3", "f32"), ("B4", "int4")])
def test_paged_split_rows_match_the_kernel(card, kernel, pool):
    """B3's and B4's split ranges as the kernel computes them (read back from
    its workspace) equal those of their Python mirror, paged_split_rows,
    which the CPU tests check."""
    (q, kp, vp, table, ang, scales, qbits), window, start, live, cb = _paged_split_case(card, pool, torch.float32)
    q.zero_()
    w, h, _, d = q.shape
    splits = pk.paged_splits(w, h, window, 16, dk.num_sms(card))
    size = w * h * splits * (d + 2)
    ws, _ = dk.split_workspace(torch.cuda.current_stream(card), size, w * h)
    ws.fill_(float("nan"))
    if kernel == "B3":
        pk.fused_paged_decode_attention(q, kp, vp, table, start, live, ang, window, **scales)
        eff_start, eff_live = start, live
    else:
        rk.fused_ragged_paged_attention(q, kp, vp, table, start, live, cb, ang, window, qbits=qbits, **scales)
        eff_start, eff_live = rk.fold_causal_bound(start, live, cb, window)
    rec = ws[:size].view(w, h, splits, d + 2).cpu()
    mirror = [[rows for _, rows in pk.paged_split_rows(int(s0), int(lv), window, 16, splits)]
              for s0, lv in zip(eff_start.tolist(), eff_live.tolist())]
    assert max(len(m) for m in mirror) == splits
    _assert_split_records(rec, mirror)


def test_split_workspace_is_reused_across_shapes(card):
    """Calls of different shapes in a row on one stream share the split
    workspace and its counters (grown on demand, left at zero by every
    launch): B2 small, B2 large, B3, B4, then B2 small again, each against
    its plain version."""
    calls = []  # (launch, plain output, limit)
    for n_q, cap in ((1, 512), (8, 2048)):
        args = _decode_split_case(card, torch.float32, n_q, cap=cap, seed=cap)
        calls.append((lambda a=args: dk.fused_decode_attention(*a), dk.fused_decode_attention_reference(*args), 1e-4))
    (q, kp, vp, table, ang, scales, _), window, start, live, cb = _paged_split_case(card, "f32", torch.float32)
    args3 = (q, kp, vp, table, start, live, ang, window)
    calls.append((lambda: pk.fused_paged_decode_attention(*args3, **scales),
                  pk.fused_paged_decode_attention_reference(*args3, **scales), 1e-4))
    (q, kp, vp, table, ang, sc4, qbits), _, _, _, _ = _paged_split_case(card, "int4", torch.float32, seed=1)
    args4 = (q, kp, vp, table, start, live, cb, ang, window)
    want4 = rk.fused_ragged_paged_attention_reference(*args4, qbits=qbits, **sc4)
    calls.append((lambda: rk.fused_ragged_paged_attention(*args4, qbits=qbits, **sc4), want4,
                  _limit(torch.float32, "int4", want4)))
    calls.append(calls[0])
    outs = [run() for run, _, _ in calls]
    torch.cuda.synchronize()
    for got, (_, want, atol) in zip(outs, calls):
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    key = (torch.cuda.current_device(), torch.cuda.current_stream(card).cuda_stream)
    assert (dk._workspaces[key][1] == 0).all()


def _flash_limit(want, dtype):
    """1e-4 in float32; in bfloat16 0.03 of the plain tensor's RMS plus one
    bfloat16 step of the element (both sides round a float32 result apart),
    as chip_smoke.py holds them."""
    if dtype == torch.float32:
        return dict(atol=1e-4, rtol=0)
    return dict(atol=0.03 * want.float().pow(2).mean().sqrt().item(), rtol=2.0**-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,nq,nk,d,pads,causal", [
    (2, 3, 70, 150, 64, [0, 90], True),          # ragged tails, a padding-only key tile
    (2, 2, 100, 60, 128, [0, 10], True),         # Nk < Nq: the first queries see no key
    (2, 10, 512, 1024, 128, [0, 300], True),     # the flagship cross-attention's shape
    (2, 8, 512, 2304, 64, [0, 1790], True),      # the 30M cross-attention after the gather
    (2, 3, 200, 330, 128, [0, 40], True),        # Nq not a multiple of 128, Nk not of 64
    (2, 4, 200, 330, 64, [0, 100], False),       # no causal mask
], ids=["ragged", "short_keys", "flagship", "clm_30m", "ragged_128", "not_causal"])
def test_flash_kernels_match_plain(card, monkeypatch, dtype, b, h, nq, nk, d, pads, causal):
    """B1a and B1b (left-padded keys) against the plain version and its
    autograd gradients (bf16: flash_forward_mma.cu and flash_backward_mma.cu;
    float32: flash_forward_f32.cu and flash_backward_f32.cu); pad keys get
    exact-zero dK and dV, queries that see no key exact-zero outputs."""
    g = torch.Generator(card).manual_seed(nq)
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).to(dtype)
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).to(dtype) for _ in range(2))
    do = torch.randn(b, h, nq, d, generator=g, device=card).to(dtype)
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor(pads, device=card)[:, None]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = fl.flash_attention_reference(*ref, pad_mask=pad, causal=causal)
    want_grads = torch.autograd.grad(want, ref, do)

    monkeypatch.setattr(fl, "_forward_plain", None)  # the CUDA path must not need them
    monkeypatch.setattr(fl, "_backward_plain", None)
    before = (fl.forward_launches, fl.backward_launches)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = fl.splash_mha(*leaves, pad_mask=pad, causal=causal)
    got_grads = torch.autograd.grad(got, leaves, do)
    torch.cuda.synchronize()
    assert (fl.forward_launches, fl.backward_launches) == (before[0] + 1, before[1] + 1)
    for x, y in zip((got, *got_grads), (want, *want_grads)):
        torch.testing.assert_close(x.float(), y.float(), **_flash_limit(y, dtype))
    at = pad[:, None, :, None].expand_as(got_grads[1])
    assert (got_grads[1][at] == 0).all() and (got_grads[2][at] == 0).all()
    last_key = nk - nq + torch.arange(nq, device=card) if causal else torch.full((nq,), nk - 1, device=card)
    blind = last_key < pad.sum(1, keepdim=True)  # (b, nq): every visible key is a pad
    if blind.any():
        assert (got.transpose(1, 2)[blind] == 0).all() and (got_grads[0].transpose(1, 2)[blind] == 0).all()


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "mma"), (torch.float32, "fp32")])
def test_flash_forward_route(card, monkeypatch, dtype, entry):
    """bfloat16 reaches the tensor-core forward (flash_forward_mma.cu), with P
    in two bf16 terms for B5 and for a B1a whose output will be
    differentiated (B1b reads it), one for a B1a without gradients; float32
    reaches flash_forward_f32.cu's forward (three TF32 products on the
    tensor cores) for B1a with and without gradients and for B5. Each call
    adds one to its own counter."""
    calls = []
    mma, f32 = fl._mma_entry(), fl._f32_entry()

    def spy_mma(*args):
        calls.append(("mma", args[12]))  # split_p
        return mma(*args)

    def spy_fp32(*args):
        calls.append(("fp32", None))
        return f32(*args)

    monkeypatch.setattr(fl, "_mma_entry", lambda: spy_mma)
    monkeypatch.setattr(fl, "_f32_entry", lambda: spy_fp32)
    q = torch.randn(1, 2, 128, 64, device=card).to(dtype)
    leaf = q.clone().requires_grad_()
    before = (fl.forward_launches, fl.block_launches)
    fl.splash_mha(q, q, q, causal=True)
    fl.splash_mha(leaf, q, q, causal=True)
    fl.ring_block_forward(q, q, q, None)
    torch.cuda.synchronize()
    assert (fl.forward_launches, fl.block_launches) == (before[0] + 2, before[1] + 1)
    assert calls == ([("mma", 0), ("mma", 1), ("mma", 1)] if entry == "mma" else [("fp32", None)] * 3)


@pytest.mark.parametrize("dtype,entry", [(torch.bfloat16, "mma"), (torch.float32, "fp32")])
def test_flash_backward_route(card, monkeypatch, dtype, entry):
    """bfloat16 reaches the tensor-core backward (flash_backward_mma.cu),
    float32 flash_backward_f32.cu's (three TF32 products on the tensor
    cores); each backward adds one to backward_launches."""
    calls = []
    mma, f32 = fl._mma_backward_entry(), fl._f32_backward_entry()

    def spy_mma(*args):
        calls.append("mma")
        return mma(*args)

    def spy_fp32(*args):
        calls.append("fp32")
        return f32(*args)

    monkeypatch.setattr(fl, "_mma_backward_entry", lambda: spy_mma)
    monkeypatch.setattr(fl, "_f32_backward_entry", lambda: spy_fp32)
    leaves = [torch.randn(1, 2, 128, 64, device=card).to(dtype).requires_grad_() for _ in range(3)]
    before = fl.backward_launches
    for _ in range(2):
        torch.autograd.grad(fl.splash_mha(*leaves, causal=True).float().sum(), leaves)
    torch.cuda.synchronize()
    assert fl.backward_launches == before + 2
    assert calls == [entry] * 2


def test_flash_backward_is_deterministic(card):
    """No atomics: the bf16 backward twice on the same inputs (a ragged,
    left-padded, causal flagship-width case) gives the same bits."""
    g = torch.Generator(card).manual_seed(7)
    b, h, nq, nk, d = 2, 4, 200, 330, 128
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).bfloat16()
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).bfloat16() for _ in range(2))
    do = torch.randn(b, h, nq, d, generator=g, device=card).bfloat16()
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor([0, 40], device=card)[:, None]
    o, lse = fl._launch_forward(q, k, v, pad, True)
    first = fl._launch_backward(q, k, v, pad, True, o, lse, do)
    second = fl._launch_backward(q, k, v, pad, True, o, lse, do)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_flash_backward_rejects_a_misaligned_gradient(card):
    """The bf16 backward copies rows of q, k, v and dO in 16-byte pieces: a
    dO that is not 16-byte aligned raises before any launch."""
    q = torch.randn(1, 2, 128, 64, device=card).bfloat16()
    o, lse = fl._launch_forward(q, q, q, None, True)
    shifted = torch.zeros(2 * 128 * 64 + 1, device=card, dtype=torch.bfloat16)[1:].view(1, 2, 128, 64)
    before = fl.backward_launches
    with pytest.raises(ValueError, match="16-byte aligned tensors; do is not"):
        fl._launch_backward(q, q, q, None, True, o, lse, shifted)
    assert fl.backward_launches == before


def test_flash_rejects_what_it_does_not_take(card):
    q = torch.zeros(1, 2, 128, 64, device=card)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fl.splash_mha(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dims"):
        fl.splash_mha(*(torch.zeros(1, 2, 128, 32, device=card),) * 3)
    strided = torch.zeros(1, 128, 2, 64, device=card).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fl.splash_mha(strided, q, q)
    shifted = torch.zeros(2 * 128 * 64 + 1, device=card, dtype=torch.bfloat16)[1:].view(1, 2, 128, 64)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fl.splash_mha(shifted, q.bfloat16(), q.bfloat16())


WIDE_DIMS = [192, 256, 320, 384, 448, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_DIMS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_wide_flash_forward_matches_plain(card, monkeypatch, dtype, d, causal):
    """B1a at the wide heads (bf16: flash_forward_wide.cu, P in one bf16
    term without gradients and in two with; float32: flash_forward_f32.cu,
    its consumers splitting D) against the plain version, at ragged sizes with left-padded
    keys: the output within B1's limits, and with two terms (and in float32)
    the float32 output and lse within 1e-4."""
    g = torch.Generator(card).manual_seed(d)
    b, h, nq, nk = 2, 2, 300, 200
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).to(dtype)
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).to(dtype) for _ in range(2))
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor([0, 37], device=card)[:, None]
    want_o, want_lse = fl._forward_plain(q, k, v, pad, causal)
    want = want_o.to(dtype)
    monkeypatch.setattr(fl, "_forward_plain", None)  # the CUDA path must not need it
    before = (fl.forward_launches, fl.forward_launches_by_width.get(d, 0))
    with torch.no_grad():
        got = fl.splash_mha(q, k, v, pad_mask=pad, causal=causal)
    o, lse = fl._launch_forward(q, k, v, pad, causal, split_p=True)
    torch.cuda.synchronize()
    assert (fl.forward_launches, fl.forward_launches_by_width[d]) == (before[0] + 2, before[1] + 2)
    torch.testing.assert_close(got.float(), want.float(), **_flash_limit(want, dtype))
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(o, want_o, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-4, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_flash_forward_pad_only_row_is_exact_zeros_and_bits_repeat(card, dtype):
    """At D = 512 a row whose keys are all padding gets exact zeros and lse
    = -inf, and two launches on the same inputs give the same bits."""
    g = torch.Generator(card).manual_seed(1)
    b, h, nq, nk, d = 2, 1, 256, 128, 512
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).to(dtype)
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).to(dtype) for _ in range(2))
    pad = torch.zeros(b, nk, dtype=torch.bool, device=card)
    pad[1] = True
    first = fl._launch_forward(q, k, v, pad, False, split_p=False)
    second = fl._launch_forward(q, k, v, pad, False, split_p=False)
    torch.cuda.synchronize()
    assert (first[0][1] == 0).all() and torch.isneginf(first[1][1]).all()
    assert torch.isfinite(first[0][0]).all() and first[0][0].abs().sum() > 0
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.parametrize("d", [192, 256])
@pytest.mark.parametrize("causal", [False, True], ids=["padded", "padded_causal"])
def test_wide_flash_forward_spare_block_and_bits_repeat(card, d, causal):
    """The wide bf16 kernel's cluster pairs at an odd query-tile count
    (Nq = 1,050: 16 tiles of 64 and a partial one, so the grid's last
    cluster holds a spare block), left-padded keys, causal or not: one-term
    P (a bf16 output) within B1's bf16 limit of the plain version, two-term
    P (a float32 output) within 1e-4 with its lse, and each launch twice
    gives the same bits."""
    g = torch.Generator(card).manual_seed(d + causal)
    b, h, nq, nk = 2, 2, 1050, 768
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).bfloat16()
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).bfloat16() for _ in range(2))
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor([0, 300], device=card)[:, None]
    want_o, want_lse = fl._forward_plain(q, k, v, pad, causal)
    want = want_o.bfloat16()
    for split_p in (False, True):
        first, second = (fl._launch_forward(q, k, v, pad, causal, split_p=split_p) for _ in range(2))
        torch.cuda.synchronize()
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
        o, lse = first
        assert o.dtype == (torch.float32 if split_p else torch.bfloat16) and lse.dtype == torch.float32
        if split_p:
            finite = torch.isfinite(want_lse)
            assert torch.equal(torch.isfinite(lse), finite)
            torch.testing.assert_close(o, want_o, atol=1e-4, rtol=0)
            torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-4, rtol=0)
        else:
            torch.testing.assert_close(o.float(), want.float(), **_flash_limit(want, torch.bfloat16))


def test_wide_flash_forward_at_512_over_many_clusters(card):
    """D = 512 (the flow decoder's width: 32-key tiles, two stages), 4,100
    queries (65 tiles: 33 clusters, the last with a spare block) over 2,048
    keys, full mask, two batch rows: two-term P within 1e-4 of the plain
    float32 output and lse, one-term P's bf16 output within B1's limit, and
    the no-gradient Function returning the kernel's bf16 output as it is."""
    g = torch.Generator(card).manual_seed(12)
    b, h, nq, nk, d = 2, 1, 4100, 2048, 512
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).bfloat16()
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).bfloat16() for _ in range(2))
    want_o, want_lse = fl._forward_plain(q, k, v, None, False)
    o, lse = fl._launch_forward(q, k, v, None, False, split_p=True)
    with torch.no_grad():
        got = fl.splash_mha(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(o, want_o, atol=1e-4, rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=0)
    want = want_o.bfloat16()
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), **_flash_limit(want, torch.bfloat16))


F32_DIMS = [64, 128, 192, 256, 320, 384, 448, 512]


@pytest.mark.parametrize("d", F32_DIMS)
def test_f32_flash_forward_every_width(card, monkeypatch, d):
    """B1a in float32 (flash_forward_f32.cu) at every width it takes, padded
    and causal at a ragged shape (130 queries: a partial block, an odd
    query-tile count and so a spare block at D > 128; 200 keys, not a
    multiple of 8; row 1's first 60 keys padding, so its first queries see no
    key): the output and lse within 1e-4 of the plain version, exact zeros
    and -inf where a query sees no key, each call one launch counted at its
    width, and two runs the same bits; a ring block through B5's entry at
    the same width, ragged, with a row whose keys are all padding."""
    g = torch.Generator(card).manual_seed(d + 1)
    b, h, nq, nk = 2, 2, 130, 200
    q = torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card) for _ in range(2))
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor([0, 130], device=card)[:, None]
    want_o, want_lse = fl._forward_plain(q, k, v, pad, True)
    ring_pad = torch.arange(nk, device=card)[None, :] < torch.tensor([17, nk], device=card)[:, None]
    want_ring = fl._forward_plain(q, k, v, ring_pad, False)
    monkeypatch.setattr(fl, "_forward_plain", None)  # the CUDA path must not need it
    before = (fl.forward_launches, fl.forward_launches_by_width.get(d, 0), fl.block_launches)
    first, second = (fl._launch_forward(q, k, v, pad, True) for _ in range(2))
    ring = fl.ring_block_forward(q, k, v, ring_pad)
    torch.cuda.synchronize()
    assert (fl.forward_launches, fl.forward_launches_by_width[d], fl.block_launches) == (
        before[0] + 2, before[1] + 2, before[2] + 1)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
    for (o, lse), (w_o, w_lse) in ((first, (want_o, want_lse)), (ring, want_ring)):
        finite = torch.isfinite(w_lse)
        assert not finite.all() and torch.equal(torch.isfinite(lse), finite)
        assert (o[~finite] == 0).all() and torch.isneginf(lse[~finite]).all()
        torch.testing.assert_close(o, w_o, atol=1e-4, rtol=0)
        torch.testing.assert_close(lse[finite], w_lse[finite], atol=1e-4, rtol=0)


def test_f32_flash_forward_rejects_what_it_does_not_take(card):
    """The float32 forward reads q, k and v through 16-byte aligned tensor
    maps and loads: a k that is not 16-byte aligned raises before any
    launch; a float16 input raises."""
    q = torch.randn(1, 2, 128, 64, device=card)
    shifted = torch.zeros(2 * 128 * 64 + 1, device=card)[1:].view(1, 2, 128, 64)
    before = fl.forward_launches
    with pytest.raises(ValueError, match="16-byte aligned tensors; k is not"):
        fl._launch_forward(q, shifted, q, None, True)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fl._launch_forward(q.half(), q.half(), q.half(), None, True)
    assert fl.forward_launches == before


def test_wide_flash_backward_raises(card):
    """B1b takes heads of up to 512 channels: a wider one (576) raises
    before any launch, and never gives way to the plain version."""
    q = torch.randn(1, 1, 128, 576, device=card).bfloat16()
    o = torch.zeros(q.shape, device=card)
    lse = torch.zeros(1, 1, 128, device=card)
    before = (fl.backward_launches, dict(fl.backward_launches_by_width))
    with pytest.raises(ValueError, match="head dims"):
        fl._launch_backward(q, q, q, None, False, o, lse, q)
    assert (fl.backward_launches, fl.backward_launches_by_width) == before
    assert not fl.flash_supported(576, 576, 128, 128, False, False)


WIDE_BACKWARD_DIMS = [192, 256, 320, 384, 448, 512]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDE_BACKWARD_DIMS)
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_wide_flash_backward_matches_plain(card, monkeypatch, dtype, d, causal):
    """B1b at the wide heads (bf16: flash_backward_wide.cu, whose dK/dV
    pass splits the queries over 2 blocks a key tile at these shapes;
    float32: flash_backward_f32.cu) against autograd of the
    plain version, at ragged sizes with left-padded keys: dq, dk and dv
    within B1's limits, pad keys' dk and dv exact zeros, and (causal) the
    queries that see no key exact-zero dq. 300 queries are 5 of the dQ
    pass's 64-query tiles and 200 keys 7 of the dK/dV pass's 32-key tiles:
    both passes' last cluster holds a spare block."""
    g = torch.Generator(card).manual_seed(d + causal)
    b, h, nq, nk = 2, 2, 300, 200
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).to(dtype)
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).to(dtype) for _ in range(2))
    do = torch.randn(b, h, nq, d, generator=g, device=card).to(dtype)
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor([0, 37], device=card)[:, None]
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(fl.flash_attention_reference(*ref, pad_mask=pad, causal=causal), ref, do)

    monkeypatch.setattr(fl, "_forward_plain", None)  # the CUDA path must not need them
    monkeypatch.setattr(fl, "_backward_plain", None)
    before = (fl.backward_launches, fl.backward_launches_by_width.get(d, 0))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got = torch.autograd.grad(fl.splash_mha(*leaves, pad_mask=pad, causal=causal), leaves, do)
    torch.cuda.synchronize()
    assert fl.wide_backward_splits(b * h, nq, nk, d, torch.cuda.get_device_properties(card).multi_processor_count) == 2
    assert (fl.backward_launches, fl.backward_launches_by_width[d]) == (before[0] + 1, before[1] + 1)
    last_key = nk - nq + torch.arange(nq, device=card) if causal else torch.full((nq,), nk - 1, device=card)
    blind = last_key < pad.sum(1, keepdim=True)  # (b, nq): every visible key is a pad
    assert blind.any() == causal
    at = pad[:, None, :, None].expand_as(want[1])
    for x, y in zip(got, want):
        torch.testing.assert_close(x.float(), y.float(), **_flash_limit(y, dtype))
    assert (got[1][at] == 0).all() and (got[2][at] == 0).all()
    assert (got[0].transpose(1, 2)[blind] == 0).all()


F32_BACKWARD_DIMS = [64, 128, 192, 256, 320, 384, 448, 512]
# the float32-class limit, as chip_smoke.py's: a float32 kernel's error from
# the float64 plain version at most this many times the plain float32 one's
F32_CLASS_FACTOR = 4


@pytest.mark.parametrize("d", F32_BACKWARD_DIMS)
def test_f32_flash_backward_at_every_width(card, d):
    """B1b in float32 (flash_backward_f32.cu) at every head width, padded
    causal and ragged: 1,100 queries over 300 keys (9 of the dK/dV pass's
    128-query tiles, the last ragged; a ragged last key block; 9 of the dQ
    pass's), row 1's first 60 keys padding (a pad-only key block) and its
    first queries seeing no key, the dK/dV pass's query range over 3 splits
    and over 1. From the plain forward's (o, lse): dq, dk and dv float32
    class, within F32_CLASS_FACTOR x the plain float32 backward's error from
    the float64 one (an absolute limit is not one here: dq reaches ~70,
    where 1e-4 is 16 float32 steps), pad keys' dk and dv exact zeros, the
    queries that see nothing exact-zero dq, each split count the same bits
    twice; one launch a call, counted by width and dtype."""
    g = torch.Generator(card).manual_seed(d)
    b, h, nq, nk = 2, 1, 1100, 300
    q = torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5
    k, v, do = (torch.randn(b, h, n, d, generator=g, device=card) for n in (nk, nk, nq))
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor([0, 60], device=card)[:, None]
    o, lse = fl._forward_plain(q, k, v, pad, True)
    plain = fl._backward_plain(q, k, v, pad, True, o, lse, do)
    o64, lse64 = fl._forward_plain(q.double(), k.double(), v.double(), pad, True)
    want = fl._backward_plain(q.double(), k.double(), v.double(), pad, True, o64, lse64, do.double())
    plain_err = [(x.double() - y).abs().max().item() for x, y in zip(plain, want)]
    at = pad[:, None, :, None].expand_as(want[1])
    blind = torch.isneginf(lse)
    assert blind.any()
    for splits in (3, 1):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(fl, "f32_backward_splits", lambda *args: splits)
            before = (fl.backward_launches, fl.backward_launches_by_width.get(d, 0),
                      fl.backward_launches_by_dtype.get("float32", 0))
            first = fl._launch_backward(q, k, v, pad, True, o, lse, do)
            second = fl._launch_backward(q, k, v, pad, True, o, lse, do)
            torch.cuda.synchronize()
            assert (fl.backward_launches, fl.backward_launches_by_width[d],
                    fl.backward_launches_by_dtype["float32"]) == tuple(x + 2 for x in before)
        assert all(torch.equal(x, y) for x, y in zip(first, second))
        for name, x, y, e in zip(("dq", "dk", "dv"), first, want, plain_err):
            err = (x.double() - y).abs().max().item()
            assert err <= F32_CLASS_FACTOR * e, (splits, name, err, e)
        assert (first[1][at] == 0).all() and (first[2][at] == 0).all()
        assert (first[0][blind] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_flash_backward_is_deterministic(card, dtype):
    """No atomics at D = 512 either: the backward twice on the same inputs
    (left-padded keys, causal, the bf16 dK/dV pass over 3 query splits)
    gives the same bits."""
    g = torch.Generator(card).manual_seed(5)
    b, h, nq, nk, d = 2, 1, 700, 300, 512
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).to(dtype)
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).to(dtype) for _ in range(2))
    do = torch.randn(b, h, nq, d, generator=g, device=card).to(dtype)
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor([0, 40], device=card)[:, None]
    o, lse = fl._launch_forward(q, k, v, pad, True)
    first = fl._launch_backward(q, k, v, pad, True, o, lse, do)
    second = fl._launch_backward(q, k, v, pad, True, o, lse, do)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.parametrize("d", [256, 320])
def test_wide_flash_backward_spare_blocks_and_bits_repeat(card, d):
    """The bf16 wide backward's clusters at ragged edges: 1,050 queries are
    17 of the dQ pass's 64-query tiles and 720 keys 23 of the dK/dV pass's
    32-key blocks (the last half full), so both passes' last cluster holds a
    spare block; left-padded keys, causal (row 1's first queries see no
    key). dq, dk and dv within B1's bf16 limit of the plain backward from
    the same (o, lse), pad keys' dk and dv exact zeros, the queries that see
    nothing exact-zero dq, and two runs the same bits."""
    g = torch.Generator(card).manual_seed(d)
    b, h, nq, nk = 2, 2, 1050, 720
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).bfloat16()
    k, v, do = (torch.randn(b, h, n, d, generator=g, device=card).bfloat16() for n in (nk, nk, nq))
    pad = torch.arange(nk, device=card)[None, :] < torch.tensor([0, 300], device=card)[:, None]
    o, lse = fl._forward_plain(q, k, v, pad, True)
    want = fl._backward_plain(q, k, v, pad, True, o, lse, do)
    first = fl._launch_backward(q, k, v, pad, True, o, lse, do)
    second = fl._launch_backward(q, k, v, pad, True, o, lse, do)
    torch.cuda.synchronize()
    for x, y in zip(first, want):
        torch.testing.assert_close(x.float(), y.float(), **_flash_limit(y, torch.bfloat16))
    at = pad[:, None, :, None].expand_as(first[1])
    assert (first[1][at] == 0).all() and (first[2][at] == 0).all()
    blind = torch.isneginf(lse)  # (b, h, nq): every visible key is a pad
    assert blind.any() and (first[0][blind] == 0).all()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


def test_optical_flow_b1a_counts_and_cpu_agreement(card):
    """The optical-flow model at a small size whose decoder head (512
    channels over 256 pixel queries and 128 latents) and 64-channel
    self-attention heads pass the gate: an inference forward launches B1a
    once a layer at D = 64 and once at D = 512, and a forward and backward
    B1a and B1b once each a layer, the wide head among them; in float32
    (TF32 off) the flow is within 1e-3 x its RMS of the CPU's."""
    from perceiver_io_torch.models.vision.optical_flow import (OpticalFlow, OpticalFlowConfig,
                                                               OpticalFlowDecoderConfig, OpticalFlowEncoderConfig)

    cfg = OpticalFlowConfig(
        encoder=OpticalFlowEncoderConfig(image_shape=(16, 16), num_patch_input_channels=27,
                                         num_cross_attention_heads=1, num_self_attention_heads=2,
                                         num_self_attention_layers_per_block=3),
        decoder=OpticalFlowDecoderConfig(image_shape=(16, 16), num_cross_attention_heads=1,
                                         num_cross_attention_qk_channels=512, num_cross_attention_v_channels=512,
                                         cross_attention_residual=False),
        num_latents=128, num_latent_channels=128)
    cpu = OpticalFlow(cfg, device="cpu", seed=0)
    gpu = OpticalFlow(cfg, device=card, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 2, 27, 16, 16, generator=torch.Generator().manual_seed(0))
    fl.forward_launches_by_width.clear()
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(card)).cpu()
    assert fl.forward_launches_by_width == {64: 3, 512: 1}
    rms = want.pow(2).mean().sqrt().item()
    assert (got - want).abs().max().item() <= 1e-3 * rms
    fl.forward_launches_by_width.clear()
    fl.backward_launches_by_width.clear()
    gpu(x.to(card).requires_grad_()).float().sum().backward()  # records gradients: B1a and B1b, wide too
    assert fl.forward_launches_by_width == {64: 3, 512: 1}
    assert fl.backward_launches_by_width == {64: 3, 512: 1}
    bf16 = OpticalFlow(cfg, device=card, dtype=torch.bfloat16, seed=0)
    with torch.inference_mode():
        flow = bf16(x.to(card))
    assert flow.shape == (2, 16, 16, 2) and torch.isfinite(flow).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_forward_at_the_image_classifier_shape(card, dtype):
    """B1a as the 48.4M image classifier's latent self-attention calls it in
    inference: 8 heads of 128 over 512 x 512, full mask, no pads, no
    gradients (batch 4 here): within the plain version's limit, the output
    in the input's dtype, two runs the same bits, one launch a call."""
    g = torch.Generator(card).manual_seed(17)
    q = (torch.randn(4, 8, 512, 128, generator=g, device=card) * 128**-0.5).to(dtype)
    k, v = (torch.randn(4, 8, 512, 128, generator=g, device=card).to(dtype) for _ in range(2))
    before = fl.forward_launches
    with torch.inference_mode():
        got, again = fl.splash_mha(q, k, v), fl.splash_mha(q, k, v)
    torch.cuda.synchronize()
    assert fl.forward_launches == before + 2 and got.dtype == dtype
    assert torch.equal(got, again)
    want = fl.flash_attention_reference(q, k, v)
    torch.testing.assert_close(got.float(), want.float(), **_flash_limit(want, dtype))


def test_image_classifier_b1a_counts_and_cpu_agreement(card):
    """The image classifier at the 48.4M model's latent width (512 latents
    of 1,024 channels, 8 heads of 128) with 2 layers a block, 2 blocks and a
    16 x 16 image: an inference forward launches B1a once a self-attention
    layer at D = 128 (4) and nothing else; in float32 (TF32 off) the logits
    are within 1e-3 of the CPU's with the same top-1; in bf16 they are
    finite; a train step at dropout 0.1 launches no B1 at all (attention
    dropout keeps every call off the gate)."""
    from perceiver_io_torch.models.core.config import ClassificationDecoderConfig
    from perceiver_io_torch.models.vision.image_classifier import (ImageClassifier, ImageClassifierConfig,
                                                                   ImageEncoderConfig)
    from perceiver_io_torch.training.trainer import make_classifier_train_step

    def config(dropout):
        return ImageClassifierConfig(
            encoder=ImageEncoderConfig(image_shape=(16, 16, 3), num_frequency_bands=8, num_cross_attention_heads=1,
                                       num_self_attention_heads=8, num_self_attention_layers_per_block=2,
                                       num_self_attention_blocks=2, dropout=dropout),
            decoder=ClassificationDecoderConfig(num_classes=100, num_output_query_channels=1024,
                                                num_cross_attention_heads=1, dropout=dropout),
            num_latents=512, num_latent_channels=1024)

    cpu = ImageClassifier(config(0.0), device="cpu", seed=0)
    gpu = ImageClassifier(config(0.0), device=card, seed=1)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    fl.forward_launches_by_width.clear()
    with torch.inference_mode():
        want = cpu(x)
        got = gpu(x.to(card)).cpu()
    assert fl.forward_launches_by_width == {128: 4}
    assert (got - want).abs().max().item() <= 1e-3 and torch.equal(got.argmax(-1), want.argmax(-1))
    bf16 = ImageClassifier(config(0.0), device=card, dtype=torch.bfloat16, seed=0)
    with torch.inference_mode():
        assert torch.isfinite(bf16(x.to(card))).all()
    model = ImageClassifier(config(0.1), device=card, dtype=torch.bfloat16, seed=0)
    tx = build_optimizer(1e-4)
    before = (fl.forward_launches, fl.backward_launches)
    batch = {"image": x.to(card), "label": torch.tensor([3, 7], device=card)}
    _, metrics = make_classifier_train_step(model, tx)(TrainState.create(model, tx), batch)
    assert torch.isfinite(metrics["loss"]) and (fl.forward_launches, fl.backward_launches) == before


def test_flow_train_step_launch_counts_at_reduced_depth(card):
    """The 41M optical-flow model at full width with 2 self-attention layers,
    one 368 x 496 patch, bf16 over float32 parameters, activation
    checkpointing: one flow train step launches B1a at D 64 twice a layer
    (the forward and the checkpoint's recompute) and twice at D 512 (the
    decoder, checkpointed too), B1b once a layer at D 64 and once at D 512,
    nothing else of the flash kernels; the loss is finite."""
    import numpy as np

    from perceiver_io_torch.data.vision.synthetic import flow_patches
    from perceiver_io_torch.models.vision.optical_flow import OpticalFlow, official_41m_config
    from perceiver_io_torch.scripts.convergence import make_flow_train_step

    full = official_41m_config()
    cfg = dataclasses.replace(full, activation_checkpointing=True,
                              encoder=dataclasses.replace(full.encoder, num_self_attention_layers_per_block=2))
    model = OpticalFlow(cfg, device=card, dtype=torch.bfloat16, seed=0)
    x, flow = flow_patches(np.random.default_rng(0), cfg.encoder.image_shape, 1)
    batch = {"x": torch.from_numpy(x).to(card), "flow": torch.from_numpy(flow).to(card)}
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    step = make_flow_train_step(model, tx, 20)
    fl.forward_launches_by_width.clear()
    fl.backward_launches_by_width.clear()
    before = fl.block_launches
    _, metrics = step(TrainState.create(model, tx), batch)
    assert torch.isfinite(metrics["loss"]).item()
    assert fl.forward_launches_by_width == {64: 4, 512: 2}  # checkpointing recomputes the decoder's layer too
    assert fl.backward_launches_by_width == {64: 2, 512: 1}
    assert fl.block_launches == before


def test_flagship_width_train_step_on_the_card(card):
    """One train step of the flagship at full width with 2 layers (bf16
    compute, batch 2): a finite loss, B1b once per attention call (3) and
    B1a once more per checkpointed self-attention layer (5)."""
    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2)
    model = CausalSequenceModel(cfg, device=card, dtype=torch.bfloat16, seed=0)
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    state = TrainState.create(model, tx)
    x = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=torch.Generator(card).manual_seed(0),
                      device=card)
    fl.forward_launches = fl.backward_launches = 0
    state, metrics = make_causal_lm_train_step(model, tx, cfg.max_latents)(
        state, {"input_ids": x, "labels": torch.roll(x, -1, dims=1)})
    assert torch.isfinite(metrics["loss"]).item()
    assert (fl.forward_launches, fl.backward_launches) == (5, 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,nq,nk,d,pads", [
    (3, 2, 70, 150, 64, [0, 150, 90]),          # ragged tiles; row 1's block is all padding
    (4, 8, 256, 1152, 64, [0, 300, 1152, 17]),  # clm_8k's cross-attention block at {"seq": 4}
    (16, 10, 256, 512, 128, None),              # the flagship's cross-attention block at {"seq": 2}
    (3, 2, 200, 512, 256, [0, 512, 100]),       # a wide block (flash_forward_wide.cu), row 1 all padding
], ids=["ragged_all_pad_row", "clm_8k_cross_block", "flagship_seq2_block", "wide_256_block"])
def test_ring_block_kernel_matches_plain(card, monkeypatch, dtype, b, h, nq, nk, d, pads):
    """B5 (B1a's entry, no causal mask) against its plain version: the
    float32 output and log-sum-exp within 1e-4 for both input types, as
    chip_smoke.py holds them (both sides sum in float32 from the same
    inputs); a row whose keys are all padding gives exact zeros and
    lse = -inf."""
    g = torch.Generator(card).manual_seed(nk)
    q = (torch.randn(b, h, nq, d, generator=g, device=card) * d**-0.5).to(dtype)
    k, v = (torch.randn(b, h, nk, d, generator=g, device=card).to(dtype) for _ in range(2))
    pad = None if pads is None else torch.arange(nk, device=card)[None, :] < torch.tensor(pads, device=card)[:, None]
    want_o, want_lse = fl._forward_plain(q, k, v, pad, False)
    monkeypatch.setattr(fl, "_forward_plain", None)  # the CUDA path must not need it
    before = fl.block_launches
    o, lse = fl.ring_block_forward(q, k, v, pad)
    torch.cuda.synchronize()
    assert fl.block_launches == before + 1 and o.dtype == lse.dtype == torch.float32
    blind = torch.zeros(b, dtype=torch.bool, device=card) if pad is None else pad.all(1)
    assert (o[blind] == 0).all() and torch.isneginf(lse[blind]).all()
    torch.testing.assert_close(o, want_o, atol=1e-4, rtol=0.0)
    torch.testing.assert_close(lse[~blind], want_lse[~blind], atol=1e-4, rtol=0.0)


def test_ring_on_the_card_matches_the_cpu(card):
    """A small sequence-parallel model (256 latents over 768 tokens, heads
    of 64, {"seq": 2}: B5 for the fully visible blocks) in float32, one
    training forward and backward under a mesh of the card against the same
    under a mesh of the CPU: loss within 1e-5 relative, gradients within
    1e-3 x their RMS, as chip_smoke.py holds the clm_8k ring."""
    from perceiver_io_torch.parallel.mesh import make_mesh, set_mesh
    from perceiver_io_torch.training.losses import cross_entropy
    from perceiver_io_torch.training.trainer import trainable

    cfg = CausalSequenceModelConfig(vocab_size=64, max_seq_len=768, max_latents=256, num_channels=128, num_heads=2,
                                    num_self_attention_layers=2, cross_attention_dropout=0.0,
                                    sequence_parallel_axis="seq")
    cpu = CausalSequenceModel(cfg, device="cpu", seed=3)
    gpu = CausalSequenceModel(cfg, device=card, seed=4)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randint(0, 64, (2, 768), generator=torch.Generator().manual_seed(0))

    def run(model, dev):
        model.train()
        with set_mesh(make_mesh({"seq": 2}, devices=[dev] * 2)):
            loss = cross_entropy(model(x.to(dev), 512), torch.roll(x, -1, dims=1)[:, 512:].to(dev))
            return loss.item(), torch.autograd.grad(loss, trainable(model))

    want, want_grads = run(cpu, torch.device("cpu"))
    fl.block_launches = 0
    got, got_grads = run(gpu, card)
    assert fl.block_launches == 2 + 2 * 1  # cross: 2 visible blocks of 128 latents over 384 keys; self: 1 a layer
    assert abs(got - want) <= 1e-5 * abs(want)
    for a, b in zip(got_grads, want_grads):
        assert (a.cpu() - b).abs().max() <= 1e-3 * b.pow(2).mean().sqrt().clamp_min(1e-30)


GRAPH_POOLS = [(None, None), (5, None), (5, "int8"), (5, "int4")]
GRAPH_IDS = ["dense", "paged-fp", "paged-int8", "paged-int4"]


def _graph_model(card):
    """More latents than decode attention's 8 queries: prefills and finishes
    take the masked softmax, so every B2-B4 launch is a decode's."""
    cfg = CausalSequenceModelConfig(vocab_size=64, max_seq_len=32, max_latents=12, num_channels=32, num_heads=2,
                                    num_self_attention_layers=2, abs_pos_emb=False, output_norm=True,
                                    num_self_attention_rotary_layers=-1, init_scale=0.5)
    return cfg, CausalSequenceModel(cfg, device=card, seed=4)


@pytest.mark.parametrize("page,quant", GRAPH_POOLS, ids=GRAPH_IDS)
def test_graph_replay_equals_eager_decode(card, page, quant):
    """16 ticks of the same requests (greedy and sampled, admitted between
    ticks) on a captured-graph engine and on an eager one, in float32: the
    same tokens and the same next logits after every tick (atol 1e-5)."""
    _, model = _graph_model(card)
    kw = {} if page is None else dict(kv_page_size=page, kv_quant=quant)
    engines = [ServingEngine(model, num_slots=3, cuda_graph=graph, **kw) for graph in (True, False)]
    assert [e.decode_compilations for e in engines] == [1, 0]
    requests = [(list(range(5, 19)), dict(max_new_tokens=9)),
                (list(range(20, 40)), dict(max_new_tokens=12, do_sample=True, temperature=0.8, top_k=20)),
                ([3, 1, 4], dict(max_new_tokens=5)), (list(range(40, 56)), dict(max_new_tokens=6))]
    handles = [[], []]
    for tick in range(16):
        for i, engine in enumerate(engines):
            if tick < len(requests):
                prompt, options = requests[tick]
                handles[i].append(engine.submit(prompt, seed=tick, **options))
            engine.step()
        graph, eager = (e._state.next_logits for e in engines)
        torch.testing.assert_close(graph, eager, atol=1e-5, rtol=0)
    tokens = [[h.result().tolist() for h in hs] for hs in handles]
    assert tokens[0] == tokens[1] and sum(map(len, tokens[0])) > 16
    assert engines[0].graph_replays == engines[0].metrics.snapshot()["decode_steps"] > 0


@pytest.mark.parametrize("page,quant", GRAPH_POOLS, ids=GRAPH_IDS)
def test_graph_captured_once_through_churn_with_exact_launch_counts(card, page, quant):
    """Admissions (classic, split, chunked, prefix hits), evictions and
    chunk ticks never capture again; every replay adds the launches its
    capture recorded (B2 once a layer, plus B2, B3 or B4 for the
    cross-attention), so the counters equal replays x launches a capture."""
    cfg, model = _graph_model(card)
    kw = {} if page is None else dict(kv_page_size=page, kv_quant=quant, prefill_chunk_tokens=page,
                                      prefix_cache=True, max_prefill_slots=2)
    engine = ServingEngine(model, num_slots=3, **kw)
    layers = cfg.num_self_attention_layers
    cross = "B2" if page is None else ("B4" if quant == "int4" else "B3")
    per_capture = {"B2": layers + (cross == "B2"), "B3": int(cross == "B3"), "B4": int(cross == "B4")}
    assert engine._graph_launches == per_capture
    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    preamble = list(range(30, 48))
    handles = [engine.submit(preamble + [i] * (1 + i % 5), max_new_tokens=2 + i % 5) for i in range(9)]
    handles.append(engine.submit([1, 2], max_new_tokens=3))
    engine.run_until_drained(max_steps=300)
    assert all(h.ok for h in handles)
    snap = engine.metrics.snapshot()
    replays = engine.graph_replays
    assert engine.decode_compilations == engine.total_compilations == 1
    assert replays == snap["decode_steps"]
    assert {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches} == {
        k: replays * v for k, v in per_capture.items()}
    if page is not None:
        assert snap["chunked_prefill"]["chunks_dispatched"] > len(handles)
        assert snap["prefix_cache"]["hits"] > 0


def _contended_kw(page, quant):
    """Dense: two slots for three requests; paged: three slots and a pool of
    two full windows (plus the trash page)."""
    if page is None:
        return dict(num_slots=2)
    return dict(num_slots=3, kv_page_size=page, kv_quant=quant, num_kv_pages=2 * -(-32 // page) + 1)


@pytest.mark.parametrize("page,quant", GRAPH_POOLS, ids=GRAPH_IDS)
def test_graph_preempt_resume_equals_eager(card, page, quant):
    """A class-1 arrival preempts a running class-0 request (greedy or
    sampled); the resumed request replays its tokens through the graph's
    forced-token mux. The graph engine gives the eager engine's tokens and
    the uncontended run's, with one capture and a replay a decode tick."""
    _, model = _graph_model(card)
    requests = [(list(range(5, 25)), dict(max_new_tokens=8)),
                (list(range(20, 38)), dict(max_new_tokens=9, do_sample=True, temperature=0.8, top_k=20)),
                (list(range(40, 56)), dict(max_new_tokens=6))]
    uncontended = ServingEngine(model, num_slots=3, cuda_graph=False,
                                **({} if page is None else dict(kv_page_size=page, kv_quant=quant)))
    want = [uncontended.submit(p, seed=i, **o) for i, (p, o) in enumerate(requests)]
    uncontended.run_until_drained(max_steps=100)
    tokens = []
    for graph in (True, False):
        engine = ServingEngine(model, cuda_graph=graph, **_contended_kw(page, quant))
        handles = [engine.submit(p, seed=i, **o) for i, (p, o) in enumerate(requests[:2])]
        for _ in range(3):
            engine.step()
        handles.append(engine.submit(requests[2][0], seed=2, priority=1, **requests[2][1]))
        engine.step()
        assert handles[2].status is RequestStatus.RUNNING and sum(h.preemptions for h in handles[:2]) == 1
        engine.run_until_drained(max_steps=200)
        assert all(h.ok for h in handles)
        snap = engine.metrics.snapshot()
        assert snap["preempted_replays"] == 1
        assert engine.decode_compilations == int(graph)
        if graph:
            assert engine.graph_replays == snap["decode_steps"]
        tokens.append([h.result().tolist() for h in handles])
    assert tokens[0] == tokens[1] == [h.result().tolist() for h in want]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("page,quant", GRAPH_POOLS, ids=GRAPH_IDS)
def test_graph_quarantine_leaves_the_pool_finite(card, page, quant, sampled):
    """NaN logits on one slot of the graph engine (a sampled slot must not
    raise): it ends FAILED, every pool tensor, scale and logit is finite
    afterwards, the slot-mate's tokens equal the eager engine's, and the
    graph is still the one capture."""
    _, model = _graph_model(card)
    options = dict(max_new_tokens=8, do_sample=sampled, temperature=0.8, top_k=20)
    kw = {} if page is None else dict(kv_page_size=page, kv_quant=quant)
    survivors = []
    for graph in (True, False):
        engine = ServingEngine(model, num_slots=2, cuda_graph=graph, **kw)
        poisoned = engine.submit(list(range(5, 25)), seed=1, **options)
        survivor = engine.submit(list(range(30, 46)), seed=2, **options)
        engine.step()
        engine.step()
        FAULTS.arm("serving.nan", slot=poisoned.slot)
        try:
            engine.step()
        finally:
            FAULTS.disarm("serving.nan")
        engine.run_until_drained(max_steps=100)
        assert poisoned.status is RequestStatus.FAILED and len(poisoned.output_ids) == 2
        assert survivor.ok
        c = engine._cache
        pool = [c.ca.kp, c.ca.vp, c.ca.k_scale, c.ca.v_scale] if page is not None else [c.ca.k, c.ca.v]
        for t in pool + [c.sa.k, c.sa.v, engine._state.next_logits]:
            assert t is None or bool(t.float().isfinite().all())
        assert engine.decode_compilations == int(graph)
        survivors.append(survivor.result().tolist())
    assert survivors[0] == survivors[1]


@pytest.mark.parametrize("page,quant", [(None, None), (5, "int4")], ids=["dense", "paged-int4"])
def test_graph_recovery_in_process_equals_the_uninterrupted_run(card, tmp_path, page, quant):
    """A journaled graph engine abandoned after 4 ticks (greedy and sampled
    requests in flight), recovered on the card and drained: every request's
    tokens equal the uninterrupted run's, with one capture and a replay a
    decode tick."""
    _, model = _graph_model(card)
    kw = dict(num_slots=2, **({} if page is None else dict(kv_page_size=page, kv_quant=quant)))
    requests = [(list(range(5, 25)), dict(max_new_tokens=8)),
                (list(range(20, 38)), dict(max_new_tokens=9, do_sample=True, temperature=0.8, top_k=20)),
                (list(range(40, 56)), dict(max_new_tokens=6))]
    submit = lambda e: [e.submit(p, seed=i, **o) for i, (p, o) in enumerate(requests)]
    reference = ServingEngine(model, **kw)
    want = submit(reference)
    reference.run_until_drained(max_steps=200)
    engine = ServingEngine(model, journal=str(tmp_path / "j"), **kw)
    submit(engine)
    for _ in range(4):
        engine.step()
    recovered, info = ServingEngine.recover(model, str(tmp_path / "j"), **kw)
    assert info["sessions"] == 3 and info["in_flight"] == 2 and info["replayed_tokens"] > 0
    recovered.run_until_drained(max_steps=200)
    assert [h.result().tolist() for h in info["handles"]] == [h.result().tolist() for h in want]
    assert recovered.decode_compilations == 1
    assert recovered.graph_replays == recovered.metrics.snapshot()["decode_steps"]
    recovered.close()


def test_int8_weight_engine_captures_once_and_its_pool_stays_below_a_float_copy(card):
    """Under int8 weights each layer dequantizes its own weights inside the
    decode graph: one capture, tokens equal to the eager int8 engine's, the
    launch counts exact, and the graph's private pool below one float copy
    of the parameters (the flagship's width, 2 layers)."""
    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2)
    model = CausalSequenceModel(cfg, device=card, dtype=torch.bfloat16, seed=0)
    engine = ServingEngine(model, num_slots=4, kv_page_size=128, weight_dtype="int8")
    snap = engine.metrics.snapshot()["weight_serving"]
    assert engine.decode_compilations == 1
    assert 0 < engine.graph_pool_bytes < snap["param_bytes_fp"]
    eager = ServingEngine(model, num_slots=4, kv_page_size=128, weight_dtype="int8", cuda_graph=False)
    rs = torch.Generator().manual_seed(0)
    prompts = [torch.randint(1, cfg.vocab_size, (600 + 50 * i,), generator=rs).tolist() for i in range(4)]
    torch.cuda.synchronize()
    pk.launches = 0
    tokens = []
    for e in (engine, eager):
        handles = [e.submit(p, max_new_tokens=12) for p in prompts]
        e.run_until_drained(max_steps=200)
        tokens.append([h.result().tolist() for h in handles])
    assert tokens[0] == tokens[1]
    assert engine.graph_replays == engine.metrics.snapshot()["decode_steps"]
    assert pk.launches == engine.graph_replays + eager.metrics.snapshot()["decode_steps"]


ROUTER_REQUESTS = [(list(range(5, 25)), dict(max_new_tokens=8)),
                   (list(range(20, 38)), dict(max_new_tokens=9, do_sample=True, temperature=0.8, top_k=20)),
                   (list(range(40, 56)), dict(max_new_tokens=7)),
                   (list(range(8, 30)), dict(max_new_tokens=6, do_sample=True, temperature=0.8, top_k=20)),
                   (list(range(33, 50)), dict(max_new_tokens=8))]


def _router_reference(model, kw):
    """One graph engine of a replica's geometry: a tick's numerics do not
    depend on what else it holds, so each request's tokens are the fleet's."""
    engine = ServingEngine(model, **kw)
    handles = [engine.submit(p, seed=i, **o) for i, (p, o) in enumerate(ROUTER_REQUESTS)]
    engine.run_until_drained(max_steps=300)
    return [h.result().tolist() for h in handles]


def _one_capture_a_replica(router, discarded=(0, 0)):
    """One capture a replica and a replay a decode tick, besides the
    ``discarded`` half-ticks a replica replayed and never harvested."""
    for r, extra in zip(router.replicas, discarded):
        assert r.engine.decode_compilations == r.engine.total_compilations == 1
        assert r.engine.graph_replays == r.engine.metrics.snapshot()["decode_steps"] + extra


@pytest.mark.parametrize("page,quant", [(None, None), (5, "int4")], ids=["dense", "paged-int4"])
def test_router_replicas_capture_once_before_and_after_a_failover(card, page, quant):
    """Two graph replicas over one model: a fault-free run, then a run in
    which replica 0 crashes at its third tick. Every request's tokens (greedy
    and sampled) equal a single engine's, each replica holds one capture
    throughout with a replay a decode tick, and the kernels' counts equal
    the replays times the launches a capture recorded."""
    cfg, model = _graph_model(card)
    kw = dict(num_slots=3, **({} if page is None else dict(kv_page_size=page, kv_quant=quant)))
    expected = _router_reference(model, kw)
    cross = "B2" if page is None else "B4"
    per_capture = {"B2": cfg.num_self_attention_layers + (cross == "B2"), "B3": 0, "B4": int(cross == "B4")}
    for crash in (False, True):
        router = ServingRouter(model, num_replicas=2, breaker_cooldown_ticks=2, **kw)
        _one_capture_a_replica(router)
        assert all(r.engine._graph_launches == per_capture for r in router.replicas)
        torch.cuda.synchronize()
        dk.launches = pk.launches = rk.launches = 0
        handles = [router.submit(p, seed=i, **o) for i, (p, o) in enumerate(ROUTER_REQUESTS)]
        if crash:
            with armed("replica.crash", slot=0, after=2, times=1):
                router.run_until_drained(max_steps=300)
            for _ in range(4):
                router.step()
            assert sum(h.failovers for h in handles) > 0 and router.replicas[0].breaker == BREAKER_CLOSED
        else:
            router.run_until_drained(max_steps=300)
        assert [h.result().tolist() for h in handles] == expected
        _one_capture_a_replica(router)
        replays = sum(r.engine.graph_replays for r in router.replicas)
        assert {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches} == {
            k: replays * v for k, v in per_capture.items()}
        router.close()


def test_router_crash_between_dispatch_and_harvest(card):
    """Replica 0 crashes after its third tick's decode was dispatched, before
    the tick's sync: that half-tick's tokens never land, its requests fail
    over with the tokens the host had, and the probe's engine requeues the
    discarded slots. Every request's tokens equal the fault-free run's; the
    breaker opens, half-opens and closes; one capture a replica; and the
    recovered replica then serves a request with the single engine's
    tokens."""
    _, model = _graph_model(card)
    kw = dict(num_slots=3, kv_page_size=5)
    expected = _router_reference(model, kw)
    router = ServingRouter(model, num_replicas=2, breaker_cooldown_ticks=2, **kw)
    handles = [router.submit(p, seed=i, **o) for i, (p, o) in enumerate(ROUTER_REQUESTS)]
    with armed("replica.crash.harvest", slot=0, after=2, times=1):
        router.run_until_drained(max_steps=300)
    for _ in range(4):
        router.step()
    assert [h.result().tolist() for h in handles] == expected
    assert router.snapshot()["breaker_transitions"] == {"closed->open": 1, "open->half_open": 1,
                                                        "half_open->closed": 1}
    moved = [h for h in handles if h.failovers]
    assert moved and all(h.replica == 1 for h in moved)
    _one_capture_a_replica(router, discarded=(1, 0))
    assert router.replicas[0].engine._pool.pages_in_use == 0
    prompt, options = ROUTER_REQUESTS[0]
    again = router.submit(prompt, seed=0, **options)
    router.run_until_drained(max_steps=100)
    assert again.replica == 0 and again.result().tolist() == expected[0]
    router.close()


def test_process_router_on_the_card_matches_in_process_and_respawns(card, tmp_path):
    """Two replicas in worker processes on the card (the serving kernels
    built before the spawn): every request's tokens (greedy and
    sampled) equal the in-process router's, each worker holds one capture
    and its B2/B3 launches equal its replays times a capture's, and a real
    SIGKILL of journaled worker 1 (``transport.worker.kill``) is answered
    by one respawn through its journal with no failover and the same
    tokens. The transport's timeouts bound every wait on a worker."""
    cfg, model = _graph_model(card)
    kw = dict(num_slots=3, kv_page_size=5)
    inproc = ServingRouter(model, num_replicas=2, **kw)
    handles = [inproc.submit(p, seed=i, **o) for i, (p, o) in enumerate(ROUTER_REQUESTS)]
    inproc.run_until_drained(max_steps=300)
    expected = [h.result().tolist() for h in handles]
    inproc.close()
    per_capture = {"B2": cfg.num_self_attention_layers, "B3": 1, "B4": 0}
    for kill in (False, True):
        router = ServingRouter(model, num_replicas=2, replica_mode="process", journal=str(tmp_path / f"{kill}" / "r{i}"),
                               transport=dict(rpc_timeout_s=60.0, init_timeout_s=300.0), **kw)
        try:
            assert [r.engine.decode_compilations for r in router.replicas] == [1, 1]
            handles = [router.submit(p, seed=i, **o) for i, (p, o) in enumerate(ROUTER_REQUESTS)]
            if kill:
                for _ in range(3):
                    router.step()
                with armed("transport.worker.kill", slot=1, times=1):
                    router.run_until_drained(max_steps=300)
            else:
                router.run_until_drained(max_steps=300)
            assert [h.result().tolist() for h in handles] == expected
            snap = router.snapshot()
            assert snap["failovers"] == 0 and snap["breaker_transitions"] == {}
            assert snap["transport"]["worker_respawns"] == int(kill) and snap["transport"]["workers_alive"] == 2
            assert [r.engine.decode_compilations for r in router.replicas] == [1, 1]
            for stats in router.retired_transport + [r.engine.transport_stats() for r in router.replicas]:
                assert stats["launches"] == {k: stats["graph_replays"] * v for k, v in per_capture.items()}
            assert all(r.engine.device_stats()["probe"] == 28.0 for r in router.replicas)
        finally:
            router.close()


def test_worker_warm_up_leaves_the_memory_of_an_unwarmed_worker(card):
    """A worker's init on the card (``_Worker.op_init``, its warm-up on a
    throwaway engine of one slot included) against the same build without
    the warm-up, both in this process: the memory the init leaves
    allocated and the peak the worker reports (``device_stats``) match the
    unwarmed build's to within one slot's pool, and the memory it leaves
    reserved exceeds the unwarmed build's by less than that pool (the
    warm-up's blocks went back to the card). A window of 16,384 tokens at
    512 channels: a slot's cross-attention cache (64 MiB in float32)
    outweighs the per-stream workspaces that a first eager pass
    allocates."""
    import gc
    import pickle

    from perceiver_io_torch.serving.transport import model_recipe
    from perceiver_io_torch.serving.worker import _Worker

    cfg = CausalSequenceModelConfig(vocab_size=64, max_seq_len=16384, max_latents=64, num_channels=512, num_heads=8,
                                    num_self_attention_layers=2, abs_pos_emb=False, output_norm=True,
                                    num_self_attention_rotary_layers=-1, init_scale=0.5)
    model = CausalSequenceModel(cfg, device=card, seed=4)
    kw = dict(num_slots=4, kv_page_size=128)
    recipe = model_recipe(model)
    one_slot = ServingEngine(model, num_slots=1, kv_page_size=128, cuda_graph=False)
    pool = sum(t.numel() * t.element_size() for t in one_slot._cache_tensors())
    one_slot.close()
    del one_slot

    def settle():
        gc.collect()
        torch.cuda.synchronize(card)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(card)
        return torch.cuda.memory_allocated(card), torch.cuda.memory_reserved(card)

    # unwarmed: the worker's build (the model from its recipe, the engine) alone
    base, base_reserved = settle()
    built = CausalSequenceModel(cfg, device=card, dtype=model.dtype, param_dtype=model.param_dtype)
    built.load_state_dict(pickle.loads(recipe)["state_dict"])
    engine = ServingEngine(built, **kw)
    torch.cuda.synchronize(card)
    held_u, peak_u = torch.cuda.memory_allocated(card) - base, torch.cuda.max_memory_allocated(card) - base
    reserved_u = torch.cuda.memory_reserved(card) - base_reserved
    engine.close()
    del engine, built
    # warmed: the worker's own init
    base, base_reserved = settle()
    worker = _Worker()
    info = worker.op_init({"model": recipe, "engine_kwargs": kw, "metrics_jsonl": None, "journal": None,
                           "numerics": {"default_dtype": torch.get_default_dtype(),
                                        "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                                        "cudnn_tf32": torch.backends.cudnn.allow_tf32},
                           "num_threads": torch.get_num_threads(), "replica_id": 0, "obs_ns": "serving.r0"})
    try:
        stats = worker.op_device_stats(None)
        assert info["warm_requests"] == len({cfg.max_latents - 1, *worker.engine.prefill_buckets}) + 1
        held, peak = stats["memory_allocated"] - base, stats["max_memory_allocated"] - base
        assert abs(held - held_u) <= pool, (held, held_u, pool)
        assert abs(peak - peak_u) <= pool, (peak, peak_u, pool)
        reserved = stats["memory_reserved"] - base_reserved
        assert reserved - reserved_u < pool, (reserved, reserved_u, held, held_u, pool)
    finally:
        worker.op_close(None)


def test_fleet_ops_deploy_flip_and_rolling_restart_on_the_card(card, tmp_path):
    """The fleet operations over two graph replicas on the card: a partial
    deploy flips replica 1 to a second model's weights by building it a
    fresh engine (one capture) while replica 0 keeps its engine and
    weights; each request (greedy and sampled) decodes its pinned version's
    tokens. Then a journaled rolling restart under load rebuilds both
    replicas (one capture each) with the same tokens. Every engine the
    fleet built replays once a decode tick, and the kernels' counts equal
    all the replays, and the warm-up step of each engine built after the
    counters were zeroed, times a capture's launches."""
    cfg, model = _graph_model(card)
    v1 = CausalSequenceModel(cfg, device=card, seed=5)
    kw = dict(num_slots=3, kv_page_size=5)
    ref0, ref1 = _router_reference(model, kw), _router_reference(v1, kw)
    assert ref0 != ref1
    per_capture = {"B2": cfg.num_self_attention_layers, "B3": 1, "B4": 0}
    router = ServingRouter(model, num_replicas=2, journal=str(tmp_path / "r{i}"), **kw)
    seen = {r.rid: r.engine for r in router.replicas}
    engines = list(seen.values())

    def step():
        work = router.step()
        for r in router.replicas:
            if seen[r.rid] is not r.engine:
                seen[r.rid] = r.engine
                engines.append(r.engine)
        return work

    torch.cuda.synchronize()
    dk.launches = pk.launches = rk.launches = 0
    e0 = router.replicas[0].engine
    router.deploy(v1.state_dict(), fraction=0.5)
    step()
    assert [r.version for r in router.replicas] == [0, 1] and router.replicas[0].engine is e0
    handles = [router.submit(p, seed=i, **o) for i, (p, o) in enumerate(ROUTER_REQUESTS)]
    while step():
        pass
    assert [h.version for h in handles] == [0, 1, 0, 1, 0]
    assert [h.result().tolist() for h in handles] == [(ref1 if h.version else ref0)[i] for i, h in enumerate(handles)]
    assert router.rollback()
    for _ in range(2):
        step()
    assert [r.version for r in router.replicas] == [0, 0]
    handles = [router.submit(p, seed=i, **o) for i, (p, o) in enumerate(ROUTER_REQUESTS[:2])]
    step()
    assert router.begin_rolling_restart()
    handles += [router.submit(p, seed=i + 2, **o) for i, (p, o) in enumerate(ROUTER_REQUESTS[2:])]
    while step():
        pass
    assert [h.result().tolist() for h in handles] == ref0
    snap = router.snapshot()
    router.close()
    assert snap["fleet_ops"]["recycles"] == 2 and snap["failovers"] == 0 and snap["breaker_transitions"] == {}
    assert len(engines) == 2 + 2 + 2  # the first two, the flip and the flip back, two rebuilds
    for e in engines:
        assert e.decode_compilations == e.total_compilations == 1
        assert e.graph_replays == e.metrics.decode_steps
    # an engine built after the counters were zeroed ran one eager decode
    # step before its capture (the capture's warm-up)
    passes = sum(e.graph_replays for e in engines) + len(engines) - 2
    torch.cuda.synchronize()
    assert {"B2": dk.launches, "B3": pk.launches, "B4": rk.launches} == {
        k: passes * v for k, v in per_capture.items()}


def test_pinned_side_stream_prefetcher_delivers_the_cpu_batches(card):
    """The prefetcher's card path (pinned host copy, H2D on its side stream,
    the consumer's stream waiting on its event) delivers the batches that
    the CPU path does, in order, and is consumed by a kernel on the current
    stream right away."""
    import numpy as np

    from perceiver_io_torch.data.loader import DataLoader
    from perceiver_io_torch.data.prefetch import DevicePrefetcher

    def loader():
        return DataLoader(list(range(64)), 4, collate_fn=lambda ex: {
            "ids": np.asarray(ex, np.int64), "x": np.repeat(np.asarray(ex, np.float32)[:, None], 1 << 16, 1)},
            shuffle=True, rng=np.random.default_rng(2))

    want = [{k: v.clone() for k, v in b.items()} for b in DevicePrefetcher(loader(), depth=2, device="cpu")]
    got = []
    for batch in DevicePrefetcher(loader(), depth=3, device=card):
        assert all(v.device.type == "cuda" for v in batch.values())
        got.append({k: (v * 1).cpu() for k, v in batch.items()})  # read on the current stream at once
    assert len(got) == len(want) == 16
    for g, w in zip(got, want):
        assert all(torch.equal(g[k], w[k]) for k in w)


def test_async_snapshot_submitted_before_an_in_place_step_holds_the_pre_step_state(card, tmp_path):
    """A submit queues D2H copies into pinned buffers on the current stream
    and returns; the in-place step queued after it cannot reach the copies:
    the written checkpoint is the state before the step, and it restores
    into the model in place."""
    from perceiver_io_torch.training.checkpoint import PINNED, AsyncCheckpointWriter, load_pytree, restore_checkpoint

    cfg = dataclasses.replace(flagship_455m_config(), num_self_attention_layers=2, num_channels=512, num_heads=4)
    model = CausalSequenceModel(cfg, device=card, dtype=torch.bfloat16, seed=0)
    tx = build_optimizer(1e-3, max_grad_norm=1.0)
    state = TrainState.create(model, tx, seed=0)
    step = make_causal_lm_train_step(model, tx, max_latents=cfg.max_latents)
    g = torch.Generator(card).manual_seed(0)
    x = torch.randint(0, cfg.vocab_size, (2, cfg.max_seq_len), generator=g, device=card)
    batch = {"input_ids": x, "labels": torch.roll(x, -1, dims=1)}
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    before = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    mu = [t.cpu().clone() for t in state.opt_state.mu]
    writer = AsyncCheckpointWriter()
    torch.cuda._sleep(50_000_000)  # a long kernel first: the copies and the step queue behind it
    writer.submit(str(tmp_path / "last"), state, lineage=True)
    state, _ = step(state, batch)
    writer.close()
    assert writer.submits[0]["pinned"]  # page-locked: the copies did not hold the step thread
    assert PINNED.nbytes >= sum(v.numel() * v.element_size() for v in before.values())
    saved = load_pytree(str(tmp_path / "last"))
    assert int(saved["step"]) == 1
    assert all(torch.equal(saved[f"model/{k}"], v) for k, v in before.items())
    assert all(torch.equal(saved[f"opt_state/mu/{i}"], t) for i, t in enumerate(mu))
    assert not all(torch.equal(v.cpu(), before[k]) for k, v in model.state_dict().items())  # the step moved them
    params = list(model.parameters())
    restore_checkpoint(str(tmp_path / "last"), state)
    assert state.step == 1 and all(a is b for a, b in zip(model.parameters(), params))
    assert all(torch.equal(v.cpu(), before[k]) for k, v in model.state_dict().items())
    PINNED.clear()


def _sync_sites(fn):
    """``fn()``'s result and its synchronizing CUDA calls, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them, counted by the
    Python line that made them."""
    import collections
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's first use also warns that it is a prototype: not a sync)
    return out, collections.Counter(f"{w.filename.rsplit('/', 2)[-1]}:{w.lineno}" for w in caught
                                    if "called a synchronizing CUDA operation" in str(w.message))


@pytest.mark.parametrize("page,quant", [(None, None), (5, "int4")], ids=["dense", "paged-int4"])
def test_telemetry_watchdog_reads_the_capture_and_flags_a_late_kernel_load(card, page, quant):
    """A captured engine with telemetry on: greedy tokens and the host syncs
    of a run equal the telemetry-off engine's, the watchdog reads the decode
    graph's one capture against budget 1 with nothing unexpected, and after
    ``mark_steady`` a kernel library loaded anew in the process (its handle
    dropped, so ``library()`` loads it again) is flagged."""
    from perceiver_io_torch.obs import validate_chrome_trace
    from perceiver_io_torch.ops import cuda_build

    _, model = _graph_model(card)
    kw = {} if page is None else dict(kv_page_size=page, kv_quant=quant)
    requests = [(list(range(5, 19)), 6), (list(range(20, 40)), 9), ([3, 1, 4], 5), (list(range(40, 56)), 7)]
    runs = {}
    for telemetry in (False, True, False, True):
        engine = ServingEngine(model, num_slots=3, telemetry=telemetry, **kw)

        def serve():
            handles = [engine.submit(p, max_new_tokens=m) for p, m in requests]
            engine.run_until_drained(max_steps=200)
            return [h.result().tolist() for h in handles]

        tokens, sites = _sync_sites(serve)
        runs.setdefault(telemetry, []).append((tokens, sites, engine.metrics.snapshot()["decode_steps"]))
        if telemetry:
            summary = engine.telemetry_summary()
            assert summary["compile"]["per_function"] == {"serving.decode_step": {"compilations": 1, "budget": 1}}
            assert summary["compile"]["unexpected"] == [] and engine.watchdog.check() == []
            assert summary["phases"]["serving.sample_sync"]["count"] == engine.metrics.snapshot()["decode_steps"]
            assert validate_chrome_trace(engine.telemetry.chrome_trace()) == []
            watchdog = engine.watchdog
        engine.close()
    want = runs[False][0]
    assert all(run == want for run in runs[True] + runs[False]) and sum(want[1].values()) > 0, [
        (tokens == want[0], sites, ticks) for tokens, sites, ticks in runs[True] + runs[False]]

    engine = ServingEngine(model, num_slots=3, telemetry=True, **kw)
    engine.watchdog.mark_steady()
    name = "decode_attention" if page is None else "paged_attention"
    cuda_build._libs.pop(name)
    cuda_build.library(name)  # a first load in the process again
    violations = engine.watchdog.check()
    assert [(v["kind"], v["libraries"]) for v in violations] == [("backend_compile_after_steady", [name])]
    assert engine.telemetry.summary()["counters"]["compile.unexpected"] == 1
    assert watchdog.backend_compiles == 0  # closed before the load: not counted
    engine.close()


def _offload_model(card, **knobs):
    cfg = CausalSequenceModelConfig(vocab_size=256, max_seq_len=512, max_latents=256, num_channels=256, num_heads=2,
                                    num_self_attention_layers=4, cross_attention_dropout=0.0,
                                    activation_checkpointing=True, **knobs)
    return CausalSequenceModel(cfg, device=card, dtype=torch.bfloat16, seed=0)


def _peak_loss_and_grads(model, x):
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model.train()
    logits = model(x, prefix_len=x.shape[1] - model.max_latents)
    loss = logits.float().logsumexp(-1).mean()
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    return loss, grads, torch.cuda.max_memory_allocated()


def test_offloading_keeps_the_products_in_pinned_host_memory(card):
    """activation_offloading on a small bf16 model on the card: every saved
    product goes to page-locked host memory and comes back; the peak is
    below the dots_with_no_batch_dims_saveable step's; loss and gradients
    equal that step's (the same products, restored bit for bit)."""
    from perceiver_io_torch.models.core import offload

    dots = _offload_model(card, remat_policy="dots_with_no_batch_dims_saveable")
    off = _offload_model(card, activation_offloading=True)
    x = torch.randint(0, 256, (16, 512), generator=torch.Generator(card).manual_seed(1), device=card)
    want_loss, want_grads, dots_peak = _peak_loss_and_grads(dots, x)
    del dots
    offload.reset_stats()
    seen = []
    real_put = offload._Store.put

    def put(store, out):
        real_put(store, out)
        seen.append(store.entries[-1][0])

    offload._Store.put = put
    try:
        loss, grads, peak = _peak_loss_and_grads(off, x)
    finally:
        offload._Store.put = real_put
    assert seen and all(buf.is_pinned() and buf.device.type == "cpu" for buf in seen)
    assert offload.STATS["offloaded"] == 6 * 4 and offload.STATS["restored"] > 0
    assert offload.POOL.nbytes >= offload.STATS["d2h_bytes"] > 0
    assert peak < dots_peak
    assert torch.equal(loss, want_loss)
    for a, b in zip(grads, want_grads):
        torch.testing.assert_close(a, b, atol=1e-3 * b.float().pow(2).mean().sqrt().item(), rtol=0)
    offload.POOL.clear()


def test_text_pipeline_engine_path_equals_generate_on_the_card(card):
    """TextGenerationPipeline on the card, float32: the engine's outputs for
    4 prompts equal generate() on the engine's canonical padding (the
    prompts left-padded to the window, num_latents = max_latents), run as
    one batch of the engine's slots; B2 launched."""
    from perceiver_io_torch.generation.generate import generate
    from perceiver_io_torch.models.text.clm import CausalLanguageModel, CausalLanguageModelConfig
    from perceiver_io_torch.pipelines import TextGenerationPipeline

    cfg = CausalLanguageModelConfig(vocab_size=262, max_seq_len=256, max_latents=64, num_channels=128, num_heads=2,
                                    num_self_attention_layers=2, cross_attention_dropout=0.0, init_scale=0.5)
    model = CausalLanguageModel(cfg, device=card, seed=3)
    prompts = ["def forward(self, x):" * 4, "import numpy as np\n" * 5, "return torch.cat([a, b])" * 3,
               "class Model(nn.Module):" * 4]
    pipe = TextGenerationPipeline(model, engine_slots=4)
    before = dk.launches
    out = pipe(prompts, max_new_tokens=12)
    assert dk.launches > before
    tok = pipe._tokenizer
    ids = torch.zeros(4, 256, dtype=torch.long)
    pad = torch.ones(4, 256, dtype=torch.bool)
    for i, p in enumerate(prompts):
        enc = tok.encode(p)
        ids[i, 256 - len(enc):] = torch.tensor(enc)
        pad[i, 256 - len(enc):] = False
    want = generate(model, ids, num_latents=64, pad_mask=pad, max_new_tokens=12).cpu()
    assert out == [p + tok.decode([t for t in row[256:].tolist() if t != 0]) for p, row in zip(prompts, want)]
