"""The split-K schedule of the decode-attention kernels B2, B3 and B4, on the
CPU: the index arithmetic that cuts each (row, head)'s slots or pages into
splits (``decode_split_rows`` and ``paged_split_rows``, the Python mirrors of
the kernels' own arithmetic in ``csrc/decode_attention.cu`` and
``csrc/paged_attention.cu``), the split counts the wrappers pass, and the
merge: a float64 emulation that runs the plain attention over each split and
merges the splits in the kernels' order, with their -inf and clamp rules,
gives the plain versions' output within 1e-12, exact zeros included. The
kernels themselves run only on the card (``test_torch_cuda.py``)."""

import numpy as np
import pytest
import torch

import perceiver_io_torch.ops.decode_kernel as dk
import perceiver_io_torch.ops.paged_decode_kernel as pk
import perceiver_io_torch.ops.ragged_paged_kernel as rk
from perceiver_io_torch.ops.position import apply_rope


@pytest.mark.parametrize("rows,heads,span,sms", [
    (8, 10, 1024, 132), (8, 10, 512, 132), (8, 8, 4096, 132), (1, 1, 100, 132), (64, 16, 4096, 132),
    (2, 1, 0, 132), (3, 2, 63, 8),
])
def test_split_counts(rows, heads, span, sms):
    """B2 asks for about SPLIT_BLOCKS_PER_SM blocks on every SM, at least one
    split per MAX_SPLIT_SLOTS slots, and no more splits than
    MIN_SPLIT_SLOTS-slot runs; B3/B4 for PAGED_SPLIT_BLOCKS_PER_SM, with at
    most one split a page and at most MAX_SPLIT_PAGES pages a split."""
    s = dk.decode_splits(rows, heads, span, sms)
    runs = max(1, span // dk.MIN_SPLIT_SLOTS)
    assert 1 <= s <= runs
    assert s >= min(runs, -(-span // dk.MAX_SPLIT_SLOTS))
    assert rows * heads * s >= min(dk.SPLIT_BLOCKS_PER_SM * sms, rows * heads * runs)
    for ps in (16, 100, 128):
        window = max(span, 1)
        pages = -(-window // ps)
        sp = pk.paged_splits(rows, heads, window, ps, sms)
        assert 1 <= sp <= max(pages, -(-pages // pk.MAX_SPLIT_PAGES))
        assert -(-pages // sp) <= pk.MAX_SPLIT_PAGES
        assert rows * heads * sp >= min(pk.PAGED_SPLIT_BLOCKS_PER_SM * sms, rows * heads * pages)


# ------------------------------------------------------------ B3 and B4
def _paged_rows(window, ps):
    """(start, live, causal bound or None) rows: wrapped ring offsets, live
    of 0, 1, a page - 1, a page, a page + 1 and the window, and the
    latent-finish bounds of a prompt over L latents."""
    rows = []
    for start in (0, 5, ps - 1, window // 2 + 3, window - 1):
        for live in (0, 1, ps - 1, ps, ps + 1, window // 2, window):
            rows.append((start, min(live, window), None))
    n, latents = min(window, 3 * ps + 7), 5
    rows += [(n % window, n, window - latents + j) for j in range(latents)]
    rows += [(7, window, window - 1), (window - 3, window - 2, window // 3), (9, 0, window - 1)]
    return rows


PAGED_GEOMETRY = [(1024, 100), (300, 48), (256, 64), (1000, 16), (128, 128)]


@pytest.mark.parametrize("window,ps", PAGED_GEOMETRY)
@pytest.mark.parametrize("splits", [1, 3, 4, 64])
def test_paged_splits_cover_each_visible_slot_once(window, ps, splits):
    """Every visible position falls in exactly one split, every position a
    split reads is visible, every page a split walks holds a live position,
    and each split of a row with live pages has at least one page."""
    for start, live, cb in _paged_rows(window, ps):
        t = lambda x: torch.tensor([x], dtype=torch.int32)
        s, lv = (start, live) if cb is None else [int(x) for x in rk.fold_causal_bound(t(start), t(live), t(cb),
                                                                                       window)]
        visible = set(torch.nonzero(pk.paged_visibility(t(s), t(lv), window, -(-window // ps) * ps)[0])[:, 0].tolist())
        parts = pk.paged_split_rows(s, lv, window, ps, splits)
        read = [rr for _, rows in parts for rr in rows]
        assert sorted(read) == sorted(visible) and len(read) == len(set(read)), (start, live, cb)
        for pages, _ in parts:
            assert all(bool(pk._page_has_live(i, s, lv, window, ps)) for i in pages), (start, live, cb, pages)
            assert pages or not visible
        assert len(parts) == max(1, min(splits, len({rr // ps for rr in visible})))


def _paged_case(pool, w, window, ps, seed):
    """float64 queries and fp pools (quantized pools: float32 scales), angles
    per physical position, distinct shuffled pages per row."""
    rs = np.random.RandomState(seed)
    h, d, r = 2, 8, 4
    p = -(-window // ps)
    n_pages = w * p + 1
    q = torch.from_numpy(rs.randn(w, h, 1, d) * d**-0.5)
    kf, vf = (torch.from_numpy(rs.randn(n_pages, ps, h * d)) for _ in range(2))
    table = torch.from_numpy((rs.permutation(n_pages - 1)[: w * p] + 1).reshape(w, p).astype(np.int32))
    ang = torch.from_numpy(np.repeat(rs.rand(w, p * ps, r // 2) * window, 2, axis=-1).astype(np.float32))
    if pool == "f64":
        return q, kf, vf, table, ang, {}, 8
    qbits = 4 if pool == "int4" else 8
    dt = torch.uint8 if qbits == 4 else torch.int8
    c = h * d // (8 // qbits)
    cache = pk.PagedKVCache(torch.zeros(n_pages, ps, c, dtype=dt), torch.zeros(n_pages, ps, c, dtype=dt), table,
                            torch.zeros(w, dtype=torch.int32), window, torch.zeros(n_pages, h),
                            torch.zeros(n_pages, h), num_heads=h, qbits=qbits)
    cache.write_pages(torch.arange(n_pages), kf, vf)
    return q, cache.kp, cache.vp, table, ang, dict(k_scale=cache.k_scale, v_scale=cache.v_scale), qbits


def _split_state(q, k, v, rows):
    """The plain softmax state (m, l, acc) of one query (D,) over key and
    value rows ``rows`` of k, v (n, D), float64: (-inf, 0, 0) over none."""
    if not rows:
        return -np.inf, 0.0, torch.zeros_like(q)
    s = k[rows] @ q
    m = s.max()
    p = torch.exp(s - m)
    return m.item(), p.sum().item(), p @ v[rows]


def _merge(states):
    """The kernels' merge, in split order: m = -inf adds nothing, l is
    clamped at 1e-30."""
    big = max(m for m, _, _ in states)
    num, den = 0.0, 0.0
    for m, l, acc in states:
        f = 0.0 if m == -np.inf else np.exp(m - big)
        den += l * f
        num = num + acc * f
    return num / max(den, 1e-30)


@pytest.mark.parametrize("kernel,pool", [("B3", "f64"), ("B3", "int8"), ("B4", "f64"), ("B4", "int4"),
                                         ("B4", "int8")])
@pytest.mark.parametrize("window,ps", [(300, 48), (256, 64), (1000, 16)])
def test_paged_split_merge_matches_plain(kernel, pool, window, ps):
    """Split the rows as the kernel does (at 5 splits), attend over each split
    in float64, merge: within 1e-12 of the plain version, and exact zeros for
    rows and items that see nothing."""
    cases = _paged_rows(window, ps)
    q, kp, vp, table, ang, scales, qbits = _paged_case(pool, len(cases), window, ps, seed=window + ps)
    col = lambda i: torch.tensor([c[i] if c[i] is not None else window - 1 for c in cases], dtype=torch.int32)
    start, live, cb = col(0), col(1), col(2)
    if kernel == "B3":
        want = pk.fused_paged_decode_attention_reference(q, kp, vp, table, start, live, ang, window, **scales)
        eff_start, eff_live = start, live
    else:
        want = rk.fused_ragged_paged_attention_reference(q, kp, vp, table, start, live, cb, ang, window,
                                                         qbits=qbits, **scales)
        eff_start, eff_live = rk.fold_causal_bound(start, live, cb, window)
    w, h, _, d = q.shape
    cache = pk.PagedKVCache(kp, vp, table, start, window, scales.get("k_scale"), scales.get("v_scale"),
                            num_heads=h, qbits=qbits)
    k, v = (t.reshape(w, -1, h, d).transpose(1, 2).double() for t in cache.gather_dense())
    k = apply_rope(k, ang.double())
    got = torch.empty_like(want)
    for i in range(w):
        parts = pk.paged_split_rows(int(eff_start[i]), int(eff_live[i]), window, ps, 5)
        for j in range(h):
            got[i, j, 0] = _merge([_split_state(q[i, j, 0], k[i, j], v[i, j], rows) for _, rows in parts])
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)
    empty = eff_live == 0
    assert empty.any() and (got[empty] == 0).all()


# ------------------------------------------------------------------ B2
def _decode_rows(cap):
    """(q_pos, live or None, left pads, n_q) rows: full and short windows,
    pads of 0 to all, live bounds that leave dead left pads, queries whose
    causal bounds see nothing."""
    rows = []
    for n_q in (1, 3, 8):
        for pads in (0, 1, 17, cap // 2, cap - 1, cap):
            rows.append((cap - 1, cap - pads, pads, n_q))
            rows.append((cap - 1, None, pads, n_q))
        rows += [(3, 4, 0, n_q), (0, 1, 0, n_q), (cap // 3, cap // 3 + 1 - 5, 5, n_q), (cap - 1, 0, 0, n_q)]
    return rows


@pytest.mark.parametrize("cap", [64, 300, 1024])
@pytest.mark.parametrize("splits", [1, 2, 5, 32])
def test_decode_splits_cover_each_visible_slot_once(cap, splits):
    """Every slot some query sees falls in exactly one split, no split reads
    a pad slot or a dead slot below q_pos + 1 - live, and every split has at
    least MIN_SPLIT_SLOTS slots when the row has them."""
    for q_pos, live, pads, n_q in _decode_rows(cap):
        pad = [j < pads for j in range(cap)]
        lo = 0 if live is None else q_pos + 1 - live
        visible = {j for j in range(cap) if j <= q_pos and not pad[j] and j >= lo}
        parts = dk.decode_split_rows(q_pos, live, cap, pad, splits)
        read = [j for rows in parts for j in rows]
        assert sorted(read) == sorted(visible) and len(read) == len(set(read)), (q_pos, live, pads)
        n = max(min(q_pos, cap - 1) - max(lo, 0) + 1, 0)
        assert len(parts) == max(1, min(splits, n // dk.MIN_SPLIT_SLOTS))
        if len(parts) > 1:
            assert n // len(parts) >= dk.MIN_SPLIT_SLOTS


@pytest.mark.parametrize("cap,r", [(300, 8), (1024, 2)])
def test_decode_split_merge_matches_plain(cap, r):
    """Split as the kernel does (at 7 splits), attend over each split in
    float64 under each query's causal bound, merge: within 1e-12 of the
    plain version, and exact zeros for queries that see nothing."""
    for n_q in (1, 3, 8):
        rows = [row for row in _decode_rows(cap) if row[3] == n_q and row[1] is not None]
        rs = np.random.RandomState(cap + n_q)
        b, h, d = len(rows), 2, 8
        q = torch.from_numpy(rs.randn(b, h, n_q, d) * d**-0.5)
        kc, vc = (torch.from_numpy(rs.randn(b, cap, h * d)) for _ in range(2))
        ang = torch.from_numpy(np.repeat(rs.rand(b, cap, r // 2) * cap, 2, axis=-1).astype(np.float32))
        q_pos = torch.tensor([row[0] for row in rows], dtype=torch.int32)
        live = torch.tensor([row[1] for row in rows], dtype=torch.int32)
        pad = torch.arange(cap)[None, :] < torch.tensor([row[2] for row in rows])[:, None]
        want = dk.fused_decode_attention_reference(q, kc, vc, ang, q_pos, pad, live)
        k = apply_rope(kc.reshape(b, cap, h, d).transpose(1, 2), ang.double())
        v = vc.reshape(b, cap, h, d).transpose(1, 2)
        got = torch.empty_like(want)
        for i, (qp, lv, _, _) in enumerate(rows):
            parts = dk.decode_split_rows(qp, lv, cap, pad[i].tolist(), 7)
            for j in range(h):
                for qi in range(n_q):
                    bound = qp - (n_q - 1 - qi)
                    got[i, j, qi] = _merge([_split_state(q[i, j, qi], k[i, j], v[i, j], [s for s in sl if s <= bound])
                                            for sl in parts])
        torch.testing.assert_close(got, want, atol=1e-12, rtol=0)
        blind = [(i, qi) for i, (qp, lv, pads, _) in enumerate(rows) for qi in range(n_q)
                 if not any(max(pads, qp + 1 - lv) <= s <= qp - (n_q - 1 - qi) for s in range(cap))]
        assert blind and all((got[i, :, qi] == 0).all() for i, qi in blind)
