"""The prefill kernels' tile algorithm, held to the JAX package on the CPU.

The CUDA prefill body of kernels #2 and #4 (csrc/prefill_mma.cuh) gives
each block BQ query rows of one head (64; 32 at Dh 256), walks the keys in
KT-key tiles (64; 32 at Dh 256) from the tile holding the window floor of
the block's first query up to its last query, zero-fills the keys outside
``[lo, n_keys)``, masks only the tiles that need it (the causal diagonal,
the window floor, the cache's end), keeps the online softmax in the log2
domain, multiplies int8 scores by the key's scale after the Dh^-½ factor
and before the mask and the probabilities by the value's scale after ``l``
took them, and multiplies P by V with P split into bf16 hi + lo. Its blocks
run heaviest first. A CUDA kernel cannot run here, so this file holds a
plain PyTorch mirror of that arithmetic (test-only code on no path) to the
Pallas prefill kernels in interpret mode on numpy-seeded inputs: starts at
a tile edge and ±1, a window floor inside a tile, a ragged last query tile,
bf16-valued fp32 and int8 caches, the page pool at pages_per_block 1 and 2
and the contiguous cache through a row map, groups 1, 3 and 8 at head
widths 64 and 256.

Tolerance: 2^-14 absolute plus 2^-14 relative in fp32. The mirror's P·V
takes P as two bf16 values (~2^-18 relative a term), the rest is the JAX
function's fp32 arithmetic in another order. The kernels themselves are
held to the plain versions on the card by chip_smoke.py.
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
from test_torch_engine import one_torch_thread  # noqa: F401

ATOL = RTOL = 2.0 ** -14
LOG2E = 1.4426950408889634
PAGE = 16
WINDOW = 45                      # the floor falls inside a key tile
STARTS = [0, 63, 64, 65, 130]    # a tile edge ±1, a floor mid-tile
T = 70                           # ragged: 64 + 6 rows (32 + 32 + 6 at Dh 256)
S = 224                          # 14 pages; >= max(start) + T


# ---------------------------------------------------------------------------
# The block order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_tiles,H,B", [(1, 1, 1), (8, 32, 3), (5, 3, 2),
                                         (16, 8, 1)])
def test_block_order_is_a_bijection_heaviest_first(n_tiles, H, B):
    order = _kernels.prefill_block_order(n_tiles, H, B)
    assert len(order) == n_tiles * H * B
    assert set(order) == {(t, h, b) for t in range(n_tiles)
                          for h in range(H) for b in range(B)}
    tiles = [t for t, _, _ in order]
    assert tiles == sorted(tiles, reverse=True)       # most keys first
    assert {(h, b) for t, h, b in order[:H * B]} == {
        (h, b) for h in range(H) for b in range(B)}


def test_query_and_key_tiles():
    assert [_kernels.prefill_rows(d) for d in _kernels.HEAD_DIMS] == [
        64, 64, 64, 32]
    assert [_kernels.prefill_tile_keys(d) for d in _kernels.HEAD_DIMS] == [
        64, 64, 64, 32]


# ---------------------------------------------------------------------------
# The body, mirrored in plain PyTorch
# ---------------------------------------------------------------------------

def pv(p, v, precision):
    """P·V with P as the kernel takes it: ``"hilo"`` two bf16 values
    (hi = bf16(p), lo = bf16(p - hi)), ``"bf16"`` one, ``"fp32"`` exact."""
    if precision == "fp32":
        return p @ v
    hi = p.to(torch.bfloat16).float()
    if precision == "bf16":
        return hi @ v
    return hi @ v + (p - hi).to(torch.bfloat16).float() @ v


def prefill_tiles_mirror(q, k, v, start, ks, vs, window, limit,
                         precision="hilo", diagonal_mask=True):
    """The prefill body over a dense view k/v [B, KV, N, Dh] (int8 values as
    fp32; ks/vs [B, KV, 1, N] or None) of a cache whose reach is ``limit``
    (NP·page or S): each block of ``prefill_block_order`` takes BQ rows of
    one head, walks KT-key tiles from the window floor's tile, zero-fills
    keys outside [lo, n_keys), masks the tiles the kernel masks
    (``diagonal_mask=False`` drops the causal term there), and updates m, l
    and acc in the log2 domain. Returns [B, T, H·Dh] fp32."""
    B, Tq, H, Dh = q.shape
    KV = k.shape[1]
    G = H // KV
    BQ, KT = _kernels.prefill_rows(Dh), _kernels.prefill_tile_keys(Dh)
    sc = torch.tensor(Dh ** -0.5 * LOG2E, dtype=torch.float32)
    out = torch.zeros(B, Tq, H, Dh)
    n_tiles = -(-Tq // BQ)
    for tile, h, b in _kernels.prefill_block_order(n_tiles, H, B):
        t0, kv = tile * BQ, h // G
        rows = min(BQ, Tq - t0)
        first_q = int(start[b]) + t0
        n_keys = min(first_q + rows, limit)
        lo = max(first_q - (window - 1), 0) if window else 0
        p_begin = lo - lo % KT
        nt = -(-(n_keys - p_begin) // KT) if n_keys > p_begin else 0
        qr = q[b, t0:t0 + rows, h].float()
        q_pos = first_q + torch.arange(rows)
        m = torch.full((rows,), tfa.NEG_INF)
        l = torch.zeros(rows)
        acc = torch.zeros(rows, Dh)
        for t in range(nt):
            p0 = p_begin + t * KT
            pos = torch.arange(p0, p0 + KT)
            live = (pos >= lo) & (pos < n_keys)
            idx = pos.clamp(max=limit - 1)
            kt = torch.where(live[:, None], k[b, kv, idx], 0.0)
            vt = torch.where(live[:, None], v[b, kv, idx], 0.0)
            s = (qr @ kt.T) * sc
            if ks is not None:
                s = s * torch.where(live, ks[b, kv, 0, idx], 0.0)
            if (p0 + KT - 1 > first_q or p0 + KT > n_keys
                    or (window and p0 <= first_q + rows - 1 - window)):
                visible = (pos < n_keys)[None, :].expand(rows, KT)
                if diagonal_mask:
                    visible = visible & (pos[None, :] <= q_pos[:, None])
                if window:
                    visible = visible & (pos[None, :] > q_pos[:, None]
                                         - window)
                s = torch.where(visible, s, tfa.NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[:, None])
            l = alpha * l + p.sum(dim=-1)
            if vs is not None:
                p = p * torch.where(live, vs[b, kv, 0, idx], 0.0)
            acc = acc * alpha[:, None] + pv(p, vt, precision)
            m = m_new
        out[b, t0:t0 + rows, h] = acc / torch.where(l == 0, 1.0, l)[:, None]
    return out.reshape(B, Tq, H * Dh)


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


LAYOUTS = ("paged-ppb1", "paged-ppb2", "contiguous-rows")
GEOMETRIES = [(64, 1, 2), (256, 3, 1), (64, 8, 1), (256, 1, 2), (64, 3, 2),
              (256, 8, 1)]                     # (Dh, G, KV)
CASES = [pytest.param(g, layout, quant, window,
                      id=f"Dh{GEOMETRIES[g][0]}-G{GEOMETRIES[g][1]}-{layout}"
                         f"-{'int8' if quant else 'fp32'}-window{window}")
         for g in range(len(GEOMETRIES)) for layout in LAYOUTS
         for quant, window in ((False, 0), (True, WINDOW))
         if (g + LAYOUTS.index(layout)) % 2 == 0] + [
    pytest.param(g, layout, quant, window,
                 id=f"Dh{GEOMETRIES[g][0]}-G{GEOMETRIES[g][1]}-{layout}"
                    f"-{'int8' if quant else 'fp32'}-window{window}")
    for g in range(len(GEOMETRIES)) for layout in LAYOUTS
    for quant, window in ((True, 0), (False, WINDOW))
    if (g + LAYOUTS.index(layout)) % 2 == 1]


def _inputs(g, layout, quant, window):
    """q, the JAX reference, the port's plain version and the dense view
    (k, ks, v, vs) with the cache's reach, for one case."""
    Dh, G, KV = GEOMETRIES[g]
    rng = np.random.default_rng(100 * g + 10 * LAYOUTS.index(layout)
                                + 2 * quant + bool(window))
    start = np.asarray(STARTS, np.int32)
    B, H = len(start), KV * G
    q = rng.standard_normal((B, T, H, Dh)).astype(np.float32)
    if layout.startswith("paged"):
        ppb = int(layout[-1])
        NP = S // PAGE
        P = B * NP + 2 * ppb                    # the trash run and a spare
        runs = rng.permutation(np.arange(1, B * NP // ppb + 1))
        table = (runs.reshape(B, NP // ppb, 1) * ppb
                 + np.arange(ppb)).reshape(B, NP).astype(np.int32)
        if ppb == 1 and window:
            # The SWA ring's table: pages wholly below the floor unmapped.
            for b, s0 in enumerate(start):
                table[b, :max(s0 - (window - 1), 0) // PAGE] = 0
        pk = _side(rng, (P, KV, PAGE, Dh), quant)
        pv_ = _side(rng, (P, KV, PAGE, Dh), quant)
        ref = jpa.paged_prefill_attention(
            jnp.asarray(q), _jax(pk), _jax(pv_), jnp.asarray(table),
            jnp.asarray(start), block_t=T, window=window,
            pages_per_block=ppb, interpret=True)
        plain = tpa.paged_prefill_attention(
            _t(q), _torch(pk), _torch(pv_), _t(table), _t(start),
            window=window, pages_per_block=ppb)
        k, ks = _dense(tpa.gather_pages(_torch(pk), _t(table), S))
        v, vs = _dense(tpa.gather_pages(_torch(pv_), _t(table), S))
    else:
        rows = rng.permutation(B + 3)[:B].astype(np.int32)
        lk = _side(rng, (B + 3, KV, S, Dh), quant)
        lv = _side(rng, (B + 3, KV, S, Dh), quant)

        def picked(side):
            if isinstance(side, dict):
                return {k: v[rows] for k, v in side.items()}
            return side[rows]
        ref = jfa.flash_prefill_attention(
            jnp.asarray(q), _jax(picked(lk)), _jax(picked(lv)),
            jnp.asarray(start), block_t=T, block_s=32, window=window,
            interpret=True)
        plain = tfa.flash_prefill_attention(
            _t(q), _torch(lk), _torch(lv), _t(start), _t(rows),
            window=window)
        k, ks = _dense(_torch(picked(lk)))
        v, vs = _dense(_torch(picked(lv)))
    return _t(q), np.asarray(ref), plain, (k, ks, v, vs), _t(start)


@pytest.mark.parametrize("g,layout,quant,window", CASES)
def test_tile_mirror_matches_pallas(g, layout, quant, window):
    q, ref, plain, (k, ks, v, vs), start = _inputs(g, layout, quant, window)
    got = prefill_tiles_mirror(q, k, v, start, ks, vs, window, S)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(plain.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_mirror_sees_a_dropped_diagonal_mask():
    """The mirror is sensitive to the tile masks: without the causal term on
    the diagonal tiles, rows see keys past their own position."""
    q, ref, _, (k, ks, v, vs), start = _inputs(0, "contiguous-rows", False, 0)
    assert np.abs(prefill_tiles_mirror(q, k, v, start, ks, vs, 0, S).numpy()
                  - ref).max() <= ATOL + RTOL * np.abs(ref).max()
    dropped = prefill_tiles_mirror(q, k, v, start, ks, vs, 0, S,
                                   diagonal_mask=False)
    assert np.abs(dropped.numpy() - ref).max() > 1e-2


def test_p_split_into_bf16_hi_lo_keeps_fp32_precision():
    """Why P goes through the MMA as bf16 hi + lo: on a chunk whose rows
    average many keys, one bf16 P moves outputs by more than 2^-12 from the
    fp32 P·V, the hi + lo pair by less."""
    rng = np.random.default_rng(7)
    B, Tq, H, Dh, N = 1, 64, 2, 64, 1024
    q = _t(rng.standard_normal((B, Tq, H, Dh)).astype(np.float32) * 0.2)
    k = _t(rng.standard_normal((B, H, N, Dh)).astype(np.float32))
    v = _t(rng.standard_normal((B, H, N, Dh)).astype(np.float32) * 4 + 8)
    start = torch.tensor([N - Tq], dtype=torch.int32)
    exact = prefill_tiles_mirror(q, k, v, start, None, None, 0, N, "fp32")
    hilo = prefill_tiles_mirror(q, k, v, start, None, None, 0, N, "hilo")
    single = prefill_tiles_mirror(q, k, v, start, None, None, 0, N, "bf16")
    assert (hilo - exact).abs().max() <= 2.0 ** -12
    assert (single - exact).abs().max() > 2.0 ** -12
    ref = tfa.causal_core(q, k, v, start)
    np.testing.assert_allclose(hilo.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)
