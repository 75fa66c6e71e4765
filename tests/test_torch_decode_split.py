"""The decode kernels' key split, held to the JAX package on the CPU.

The CUDA decode bodies of kernels #1 and #3 (csrc/decode_split.cuh) split
each slot's live key range across blocks: split s covers the positions
``[base + s·split_keys, base + (s+1)·split_keys)`` (``base``: the window's
floor rounded down to the 32-key tile), split 0 also holds the self column,
a split past the slot's ``n`` is dead, and a combine pass rescales each live
split's unnormalised state by ``exp(m_s − max m)`` and sums them in split
order. A CUDA kernel cannot run here, so this file holds

* the host planner (``_kernels.decode_splits``) to its contract, and
* a plain PyTorch mirror of the two passes (partials per split, then the
  combine, built from the port's plain block update), test-only code on no
  path, to the Pallas decode kernels in interpret mode on numpy-seeded
  inputs: n_split 1…8, n_stale at 0, 1 and at every split boundary ±1, a
  window whose floor falls inside a split, slots whose every split but
  split 0 is empty; bf16-valued fp32 and int8 caches; the page pool at
  pages_per_block 1 and 2 and the contiguous cache through a row map;
  groups 1, 3 and 8 at head widths 64 and 256.

Tolerance: 1e-5 in fp32, as the other attention parity tests (the same
function, sums in another order). The kernels themselves are held to the
plain versions at split boundaries on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmapigateway_tpu.models import llama as jllama
from llmapigateway_tpu.ops import flash_attention as jfa
from llmapigateway_tpu.ops import paged_attention as jpa
from llmapigateway_tpu_torch.ops import _kernels
from llmapigateway_tpu_torch.ops import flash_attention as tfa
from llmapigateway_tpu_torch.ops import paged_attention as tpa

ATOL = RTOL = 1e-5
TILE = _kernels.TILE_K
PAGE = 16                        # a 32-key tile spans two pages
WINDOW = 45                      # no multiple of the tile or the page


# ---------------------------------------------------------------------------
# The planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [0, 16, 256])
def test_planner_contract(page):
    """Every plan covers the extent in whole tiles with no dead trailing
    split, stays within MAX_SPLITS, keeps splits of at least
    MIN_SPLIT_TILES tiles when it splits, keeps a page's keys in one split
    (page multiples or divisors), and reaches two waves of blocks whenever
    the extent has the tiles for it."""
    for B in (1, 2, 3, 8, 16, 64):
        for KV in (1, 2, 4, 8, 32):
            for extent in (0, 1, 31, 32, 100, 512, 2079, 4096, 4128, 32768):
                n, keys = _kernels.decode_splits(B, KV, extent, page)
                tiles = max(1, -(-extent // TILE))
                assert 1 <= n <= _kernels.MAX_SPLITS
                assert keys % TILE == 0 and keys > 0
                assert n * keys >= extent
                assert (n - 1) * keys < max(extent, 1)
                if n > 1:
                    assert keys >= _kernels.MIN_SPLIT_TILES * TILE
                if page and n > 1:
                    assert keys % page == 0 or page % keys == 0
                waves = -(-2 * _kernels.SM_COUNT // (B * KV))
                if tiles // _kernels.MIN_SPLIT_TILES >= 2 * waves \
                        and waves <= _kernels.MAX_SPLITS // 2:
                    assert B * KV * n >= 2 * _kernels.SM_COUNT, (B, KV, extent)


# The plans of chip_smoke.py's decode rows (B 8; page 256 paged, S
# contiguous; mistral-7b window 4096 over 8192, phi-3-mini window 2047).
PINNED = [
    ("llama-3-8b paged", 8, 8, 16 * 256, 0, 256, (32, 128)),
    ("llama-3-8b contiguous", 8, 8, 4096, 0, 0, (32, 128)),
    ("gemma-2b paged", 8, 1, 16 * 256, 0, 256, (32, 128)),
    ("tinyllama-1.1b paged", 8, 4, 8 * 256, 0, 256, (16, 128)),
    ("mistral-7b paged", 8, 8, 32 * 256, 4096, 256, (26, 160)),
    ("phi-3-mini paged", 8, 32, 16 * 256, 2047, 256, (9, 256)),
    ("one short slot", 1, 8, 160, 0, 0, (1, 160)),
    ("phi-3-mini heads, no window", 8, 32, 16 * 256, 0, 256, (8, 512)),
]


@pytest.mark.parametrize("name,B,KV,limit,window,page,want", PINNED,
                         ids=[p[0] for p in PINNED])
def test_planner_served_shapes(name, B, KV, limit, window, page, want):
    plan = _kernels.decode_plan(B, KV, limit, window, page)
    assert tuple(plan) == want
    G, Dh = 4, 128
    floats = _kernels.workspace_floats(plan, B, KV, G, Dh)
    assert floats == (0 if want[0] == 1
                      else B * KV * want[0] * G * (Dh + 2))


def test_extent_caps_at_the_window():
    assert _kernels.decode_extent(4096, 0) == 4096
    assert _kernels.decode_extent(8192, 4096) == 4096 + TILE
    assert _kernels.decode_extent(100, 4096) == 100


# ---------------------------------------------------------------------------
# The two passes, mirrored in plain PyTorch
# ---------------------------------------------------------------------------

def live_splits(lo: int, n: int, plan) -> int:
    """csrc/decode_split.cuh live_splits: split 0 always (the self
    column), split s while base + s·split_keys < n."""
    base = lo - lo % TILE
    if n <= base:
        return 1
    return min(plan.n_split, -(-(n - base) // plan.split_keys))


def split_decode_mirror(q, k_new, v_new, k, v, n_stale, ks, vs, window,
                        limit, plan):
    """The decode kernels' two passes over a dense view k/v [B, KV, S, Dh]
    (ks/vs [B, KV, 1, S] or None) of a cache whose reach is ``limit``:
    per slot, each live split's unnormalised (m, l, acc) from the port's
    plain block update — split 0 seeded by the self column, the others
    empty — then the combine: rescale by exp(m_s − max m), sum l and acc in
    split order, divide (l == 0 guarded). Returns [B, H·Dh] fp32."""
    B, H, Dh = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.float().reshape(B, KV, G, Dh)
    out = []
    for b in range(B):
        n_st = int(n_stale[b])
        n = min(n_st, limit)
        lo = max(n_st - (window - 1), 0) if window else 0
        base = lo - lo % TILE
        parts = []
        for s in range(live_splits(lo, n, plan)):
            p0 = base + s * plan.split_keys
            p1 = min(p0 + plan.split_keys, n)
            if s == 0:
                m, l, acc = tfa.self_column_init(qg[b], k_new[b, :, None],
                                                 v_new[b, :, None])
            else:
                m = torch.full((KV, G, 1), tfa.NEG_INF)
                l = torch.zeros((KV, G, 1))
                acc = torch.zeros((KV, G, Dh))
            if p1 > p0:
                pos = torch.arange(p0, p1)
                visible = ((pos >= lo) & (pos < n))[None, None, :]
                m, l, acc = tfa.attend_block(
                    qg[b], k[b, :, p0:p1], v[b, :, p0:p1], m, l, acc,
                    visible,
                    None if ks is None else ks[b, :, :, p0:p1],
                    None if vs is None else vs[b, :, :, p0:p1])
            parts.append((m, l, acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        l_sum = torch.zeros_like(mx)
        acc_sum = torch.zeros((KV, G, Dh))
        for m, l, acc in parts:
            f = torch.exp(m - mx)
            l_sum = l_sum + f * l
            acc_sum = acc_sum + f * acc
        out.append(acc_sum / torch.where(l_sum == 0, 1.0, l_sum))
    return torch.stack(out).reshape(B, H * Dh)


def _t(a):
    return torch.from_numpy(np.array(a))


def _side(rng, shape, quant):
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    if not quant:
        return x
    q, s = jllama.quantize_kv(jnp.asarray(x))
    return {"q": np.asarray(q), "s": np.asarray(s)[..., None, :]}


def _jax(side):
    if isinstance(side, dict):
        return {k: jnp.asarray(v) for k, v in side.items()}
    return jnp.asarray(side)


def _torch(side):
    if isinstance(side, dict):
        return {k: _t(v) for k, v in side.items()}
    return _t(side)


def _dense(side):
    """(values, scales) of a torch cache side; int8 values as fp32 (the
    kernels' exact widening)."""
    values, scales = tfa.split_kv(side)
    return values.float(), scales


def _n_stale(plan, limit, window):
    """0, 1, every split boundary ±1 and the cache's end; with a window,
    also the floor's edges and positions whose floor falls inside a split
    with n - base on a boundary ±1."""
    sk = plan.split_keys
    ns = {0, 1, limit - 1, limit}
    for s in range(1, plan.n_split):
        ns |= {s * sk - 1, s * sk, s * sk + 1}
    if window:
        ns |= {window - 1, window, window + 1}
        for s in range(1, plan.n_split + 1):
            for d in (-1, 0, 1):
                # n - base = (window - 1) + (w0 % TILE) for n >= window.
                rem = s * sk + d - (window - 1)
                if 0 <= rem < TILE:
                    ns |= {window - 1 + TILE * m + rem for m in (1, 3)}
        ns.add(window + 2 * TILE + 7)          # a floor inside split 0
    return np.asarray(sorted(x for x in ns if 0 <= x <= limit), np.int32)


LAYOUTS = ("paged-ppb1", "paged-ppb2", "contiguous-rows")
GEOMETRIES = [(64, 1, 2), (256, 3, 1), (64, 8, 1), (256, 1, 2), (64, 3, 2),
              (256, 8, 1)]                     # (Dh, G, KV)
CASES = [pytest.param(n_split, layout, quant,
                      id=f"split{n_split}-{layout}-{'int8' if quant else 'fp32'}")
         for n_split in range(1, 9) for layout in LAYOUTS
         for quant in (False, True)]


def _case(n_split, layout, quant):
    """The case's geometry, window, plan and cache reach: each n_split
    meets both windows and every geometry across layouts and KV types."""
    i = n_split + LAYOUTS.index(layout) + quant
    Dh, G, KV = GEOMETRIES[i % len(GEOMETRIES)]
    window = WINDOW if (n_split + quant) % 2 else 0
    if window:
        extent, limit = window + TILE, 256
    else:
        extent = n_split * TILE * (2 if n_split <= 3 else 1)
        limit = extent
    tiles = -(-extent // TILE)
    plan = _kernels.DecodeSplits(n_split,
                                 max(1, -(-tiles // n_split)) * TILE)
    return Dh, G, KV, window, plan, limit


@pytest.mark.parametrize("n_split,layout,quant", CASES)
def test_split_mirror_matches_pallas(n_split, layout, quant):
    Dh, G, KV, window, plan, limit = _case(n_split, layout, quant)
    assert plan.n_split * plan.split_keys >= _kernels.decode_extent(
        limit, window)
    rng = np.random.default_rng(1000 * n_split + 10 * LAYOUTS.index(layout)
                                + quant)
    n_stale = _n_stale(plan, limit, window)
    B, H = len(n_stale), KV * G
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kn = rng.standard_normal((B, KV, Dh)).astype(np.float32)
    vn = rng.standard_normal((B, KV, Dh)).astype(np.float32)

    if layout.startswith("paged"):
        ppb = int(layout[-1])
        NP = limit // PAGE
        P = B * NP + 2 * ppb                    # the trash run and a spare
        runs = rng.permutation(np.arange(1, B * NP // ppb + 1))
        table = (runs.reshape(B, NP // ppb, 1) * ppb
                 + np.arange(ppb)).reshape(B, NP).astype(np.int32)
        if ppb == 1 and window:
            # The SWA ring's table: pages wholly below the floor unmapped.
            for b, n in enumerate(n_stale):
                table[b, :max(n - (window - 1), 0) // PAGE] = 0
        pk = _side(rng, (P, KV, PAGE, Dh), quant)
        pv = _side(rng, (P, KV, PAGE, Dh), quant)
        ref = jpa.paged_decode_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), _jax(pk),
            _jax(pv), jnp.asarray(table), jnp.asarray(n_stale),
            window=window, pages_per_block=ppb, interpret=True)
        args = (_t(q), _t(kn), _t(vn), _torch(pk), _torch(pv), _t(table),
                _t(n_stale))
        plain = tpa.paged_decode_attention(*args, window=window,
                                           pages_per_block=ppb)
        k, ks = _dense(tpa.gather_pages(_torch(pk), _t(table), limit))
        v, vs = _dense(tpa.gather_pages(_torch(pv), _t(table), limit))
    else:
        rows = rng.permutation(B + 3)[:B].astype(np.int32)
        lk = _side(rng, (B + 3, KV, limit, Dh), quant)
        lv = _side(rng, (B + 3, KV, limit, Dh), quant)

        def picked(side):
            if isinstance(side, dict):
                return {k: v[rows] for k, v in side.items()}
            return side[rows]
        ref = jfa.flash_decode_attention(
            jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            _jax(picked(lk)), _jax(picked(lv)), jnp.asarray(n_stale),
            block_s=16, window=window, interpret=True)
        plain = tfa.flash_decode_attention(
            _t(q), _t(kn), _t(vn), _torch(lk), _torch(lv), _t(n_stale),
            _t(rows), window=window)
        k, ks = _dense(_torch(picked(lk)))
        v, vs = _dense(_torch(picked(lv)))

    got = split_decode_mirror(_t(q), _t(kn), _t(vn), k, v, _t(n_stale), ks,
                              vs, window, limit, plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)
    # The slots reach the last split the extent can fill, and split 0 alone.
    live = [live_splits(max(n - (window - 1), 0) if window else 0,
                        min(int(n), limit), plan) for n in n_stale]
    extent = _kernels.decode_extent(limit, window)
    assert max(live) == min(plan.n_split, -(-extent // plan.split_keys))
    assert 1 in live


def test_mirror_sees_a_dropped_split():
    """The mirror is sensitive to the split arithmetic: combining all but
    the last live split of a long slot misses its keys."""
    rng = np.random.default_rng(9)
    B, KV, G, Dh, S = 1, 1, 2, 64, 128
    plan = _kernels.DecodeSplits(4, 32)
    q = _t(rng.standard_normal((B, KV * G, Dh)).astype(np.float32))
    kn = _t(rng.standard_normal((B, KV, Dh)).astype(np.float32))
    vn = _t(rng.standard_normal((B, KV, Dh)).astype(np.float32))
    k = _t(rng.standard_normal((B, KV, S, Dh)).astype(np.float32))
    v = _t(rng.standard_normal((B, KV, S, Dh)).astype(np.float32))
    n_stale = torch.tensor([S], dtype=torch.int32)
    full = split_decode_mirror(q, kn, vn, k, v, n_stale, None, None, 0, S,
                               plan)
    ref = tfa.decode_core(q, kn, vn, k, v, n_stale)
    np.testing.assert_allclose(full.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)
    short = split_decode_mirror(q, kn, vn, k, v, n_stale, None, None, 0, S,
                                plan._replace(n_split=3))
    assert (short - ref).abs().max() > 1e-3
