// The prefill body of kernels #2 and #4 (paged and flash prefill) for
// Hopper: tensor-core tiles (mma.sync m16n8k16, bf16 in, fp32 accumulate),
// K/V tiles streamed through a cp.async ring, the online softmax in
// registers, and P·V with P kept to fp32 precision as a bf16 pair.
//
// It replaces the body of the Pallas prefill kernels _paged_prefill_kernel
// (llmapigateway_tpu/ops/paged_attention.py:384) and _prefill_kernel
// (llmapigateway_tpu/ops/flash_attention.py:282): a chunk of T queries at
// positions start + t, causal (or windowed) over keys already in the cache.
// The Pallas kernels carry m/l/acc in VMEM scratch along a sequential grid
// axis over key blocks; here a block owns its query rows for the whole key
// walk and the carried state lives in the registers of its warps.
//
// Bound: operations. A chunk of T queries does 4 * T * keys * Dh flops per
// head against one pass over its keys, ~T / 2 flops a byte at T 512, above
// the card's ~295 flop/byte ridge, so the time is the tensor cores'. The
// design:
// * Block: 4 warps and BQ query rows of one head (64; 32 at Dh 256). The
//   warps split the rows into groups of 16 (one m16 MMA row block) and, at
//   Dh 256, the head width of P·V into two halves (WN = 2), which keeps a
//   warp's fp32 output at 16 x 128 (64 registers a lane); both warps of a
//   row group compute the same scores.
// * Keys in tiles of KT = 64 (32 at Dh 256, so that two blocks fit an SM),
//   walked from the tile holding the window floor of the block's first
//   query (0 without a window) up to its last query. Each tile's K and V
//   stream into a 2-stage ring with cp.async (16 bytes, zero-fill outside
//   [lo, n_keys) or past the table: below the floor the SWA ring may have
//   recycled the page). Tile t + 1's copy is issued after tile t's Q K^T
//   products, so the tensor cores start first and the copy is in flight
//   under the softmax and P·V; one barrier a tile. A tile's rows take one
//   table lookup when the page is whole tiles (a lookup a key otherwise),
//   a tile ahead.
//   Rows are padded by 16 bytes, so the ldmatrix reads of 8 rows hit 8
//   different bank groups.
// * S = Q K^T: ldmatrix fragments of Q and K, fp32 accumulators. Scores are
//   scaled to the log2 domain (Dh^-1/2 * log2 e; int8: then by the key's
//   scale). The causal / window / extent mask runs only on tiles that need
//   it: the diagonal tile(s), the tiles at the window floor, and a tile
//   past n_keys.
// * Online softmax in registers: a row's max is a quad shuffle (the 4 lanes
//   of an MMA row), each lane keeps a partial row sum, summed once at the
//   end; no shared memory and no barrier.
// * P·V: the JAX kernel multiplies fp32 P by fp32 V. One bf16 P would add
//   ~2^-9 relative error per term, enough to push the worst element of a
//   long row past the smoke's 2^-8 tolerance; P is split into bf16 hi and
//   lo = bf16(P - hi) and both go through the MMA into one accumulator
//   (~2^-17 relative per term; V is exact in bf16, int8 values too). This
//   doubles the P·V MMAs (1.5x the block's tensor work); TF32 m16n8k8 would
//   keep ~2^-11 per term at half the bf16 rate.
// * Int8 K/V land raw through the ring (half the bytes) and are widened to
//   bf16 in shared memory (exact: |q| <= 127); each score is multiplied by
//   its key's scale after the Dh^-1/2 factor and before the mask, l sums the
//   unscaled probabilities, and each probability is multiplied by its
//   value's scale before P·V (JAX attend_block, flash_attention.py:79).
// * Order: a 1-D grid whose first blocks are the last query tile of every
//   (head, slot), so the blocks with the most key tiles start first.
//
// mma.sync and not wgmma: a block's work is 16-row MMAs over 64-key tiles
// whose rows come from a page table, with the masking and softmax between
// the two products; mma.sync keeps that in the registers of each warp at
// these shapes (a bound of 0.009-0.072 ms against SDPA's 0.10-0.53 ms).
#pragma once

#include "attention_common.cuh"
#include "decode_split.cuh"    // cp.async helpers, NWARPS, FULL_MASK

namespace pa {

constexpr float LOG2E = 1.4426950408889634f;

template <typename KVT>
struct PrefillGeo {
    using elem = typename KVT::elem;
    static constexpr int HD = KVT::kHD;
    static constexpr int BQ = HD > 128 ? 32 : 64;    // query rows a block
    static constexpr int KT = HD > 128 ? 32 : 64;    // keys a tile
    static constexpr int STAGES = 2;
    static constexpr int WM = BQ / 16;               // row groups
    static constexpr int WN = NWARPS / WM;           // warps a row group
    static constexpr int DW = HD / WN;               // P·V columns a warp
    static constexpr int ROW = HD * 2 + 16;          // padded bf16 row bytes
    static constexpr int RAW_ROW = HD * static_cast<int>(sizeof(elem));
    static constexpr int CH = RAW_ROW / 16;          // 16-byte copies a row
    static constexpr int NS = KT / 8;                // score n-tiles
    static constexpr int NO = DW / 8;                // output n-tiles a warp
    static_assert(HD % 16 == 0 && DW % 16 == 0, "16-wide MMA steps");
    static_assert(WM * WN == NWARPS, "warps must tile the block");
};

// bf16 K/V: the ring holds the tiles as they are used.
template <typename KVT>
struct PrefillTilesBf16 {
    using Gm = PrefillGeo<KVT>;
    alignas(16) unsigned char q[Gm::BQ * Gm::ROW];
    alignas(16) unsigned char k[Gm::STAGES][Gm::KT * Gm::ROW];
    alignas(16) unsigned char v[Gm::STAGES][Gm::KT * Gm::ROW];
};

// int8 K/V: the ring holds raw tiles and their scales; one widened tile.
template <typename KVT>
struct PrefillTilesInt8 {
    using Gm = PrefillGeo<KVT>;
    alignas(16) unsigned char q[Gm::BQ * Gm::ROW];
    alignas(16) unsigned char k[1][Gm::KT * Gm::ROW];
    alignas(16) unsigned char v[1][Gm::KT * Gm::ROW];
    struct Raw {
        alignas(16) unsigned char k[Gm::KT * Gm::RAW_ROW];
        alignas(16) unsigned char v[Gm::KT * Gm::RAW_ROW];
        alignas(16) float ks[Gm::KT];
        alignas(16) float vs[Gm::KT];
    } raw[Gm::STAGES];
};

// The prefill body's shared memory for one KV type (body_smem,
// launch_with_smem).
template <typename KVT>
using PrefillTiles = typename std::conditional<
    KVT::kQuant, PrefillTilesInt8<KVT>, PrefillTilesBf16<KVT>>::type;

// --------------------------------------------------------------------------
// Tensor-core pieces
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr) : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
        "{%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr) : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as a bf16 pair hi (round to nearest) and the pair of what is left,
// lo = bf16(x - hi.x), bf16(y - hi.y): hi + lo holds x and y to ~2^-17.
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi,
                                             uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(x - bf16_lo(hi), y - bf16_hi(hi));
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// --------------------------------------------------------------------------
// Copies
// --------------------------------------------------------------------------

// The block's BQ query rows (row r at q + r * stride; rows >= n_valid zero)
// into the padded Q tile.
template <typename Gm>
__device__ __forceinline__ void issue_q(unsigned char* dst, const bf16* q,
                                        long long stride, int n_valid) {
    constexpr int QCH = Gm::HD / 8;                  // 16-byte copies a row
    for (int i = threadIdx.x; i < Gm::BQ * QCH; i += NTHREADS) {
        const int r = i / QCH, c = i % QCH;
        const bool valid = r < n_valid;
        cp_async16(dst + r * Gm::ROW + c * 16,
                   q + (valid ? r * stride + c * 8 : 0), valid);
    }
}

// The row of key `pos` in the cache, or -1 outside [lo, n) or past the table
// (then the key is zero-filled and never read).
template <typename Rows>
__device__ __forceinline__ long long key_row(const Rows& rows, int pos,
                                             int lo, int n) {
    return pos >= lo && pos < n ? rows(pos) : -1;
}

// The row of the first key of the tile at p0 (a multiple of KT) when the
// tile's keys are consecutive rows — always in the contiguous cache, and in
// a page pool whose page is whole tiles, where the tile lies in one page
// (one table lookup a tile) — else -1.
template <int KT>
__device__ __forceinline__ long long tile_base(const DenseRows& rows,
                                              int p0) {
    return rows.base + p0;
}
template <int KT, typename Rows>
__device__ __forceinline__ long long tile_base(const Rows& rows, int p0) {
    return rows.page % KT == 0 ? rows(p0) : -1;
}

// Where a tile's keys live: consecutive rows from `base`, or (base -1) a row
// per key, each lane holding that of its own key (`lane_row`, key_row).
struct TileRows {
    long long base, lane_row;
};

// A K and V tile into (kd, vd): warp w copies keys w, w + 4, w + 8, ... of
// the tile at p0. Each copy instruction takes whole rows, 16 bytes a lane,
// and the 4 warps together take consecutive keys, so the block reads the
// tile front to back. A key's row is base + key, or, per key, the row its
// lane looked up (lane l of warp w holds key w + 4 * (l % KW)), handed out
// by a shuffle. bf16 rows go into padded rows, int8 rows raw and
// the keys' scales into (ksd, vsd). A key outside [lo, n) or past the table
// is zero (scale 0) and never read.
template <typename Gm, typename KVT>
__device__ __forceinline__ void issue_kv(
        unsigned char* kd, unsigned char* vd, float* ksd, float* vsd,
        const typename KVT::elem* k, const typename KVT::elem* v,
        const float* ks, const float* vs, const TileRows& tr, int p0,
        int lo, int n) {
    constexpr int KW = Gm::KT / NWARPS;              // keys a warp
    static_assert(32 % KW == 0 && (KW * Gm::CH) % 32 == 0,
                  "a warp's keys and their rows split over its lanes");
    constexpr int DST_ROW = KVT::kQuant ? Gm::RAW_ROW : Gm::ROW;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    auto row_at = [&](int key) {
        const int pos = p0 + key;
        return pos >= lo && pos < n ? tr.base + key : -1LL;
    };
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
#pragma unroll
    for (int j = 0; j < KW * Gm::CH / 32; ++j) {
        const int i = lane + 32 * j, r = i / Gm::CH, c = i % Gm::CH;
        const int key = NWARPS * r + warp;
        const long long kr = tr.base >= 0
            ? row_at(key) : __shfl_sync(FULL_MASK, tr.lane_row, r);
        const bool valid = kr >= 0;
        const long long off = valid ? kr * Gm::RAW_ROW + c * 16 : 0;
        const int dst = key * DST_ROW + c * 16;
        cp_async16(kd + dst, kb + off, valid);
        cp_async16(vd + dst, vb + off, valid);
    }
    if constexpr (KVT::kQuant) {
        const int key = NWARPS * (lane % KW) + warp;
        const long long row = tr.base >= 0 ? row_at(key) : tr.lane_row;
        if (lane < 2 * KW)
            cp_async4((lane < KW ? ksd : vsd) + key,
                      (lane < KW ? ks : vs) + (row >= 0 ? row : 0),
                      row >= 0);
    }
}

// Widen a raw int8 tile (KT rows of HD bytes) into padded bf16 rows
// (exact).
template <typename Gm>
__device__ __forceinline__ void widen_tile(const unsigned char* src,
                                           unsigned char* dst) {
    for (int i = threadIdx.x; i < Gm::KT * Gm::CH; i += NTHREADS) {
        const int r = i / Gm::CH, c = i % Gm::CH;
        const uint4 w =
            *reinterpret_cast<const uint4*>(src + r * Gm::RAW_ROW + c * 16);
        const uint32_t x[4] = {w.x, w.y, w.z, w.w};
        uint32_t y[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            y[2 * j] = i8x2_as_bf16x2(x[j], 0);
            y[2 * j + 1] = i8x2_as_bf16x2(x[j], 2);
        }
        uint4* d = reinterpret_cast<uint4*>(dst + r * Gm::ROW + c * 32);
        d[0] = make_uint4(y[0], y[1], y[2], y[3]);
        d[1] = make_uint4(y[4], y[5], y[6], y[7]);
    }
}

// --------------------------------------------------------------------------
// Block order
// --------------------------------------------------------------------------

// Block L of the 1-D grid of n_tiles * H * B blocks: query tile
// n_tiles - 1 - L / (H * B), head L % H, slot (L / H) % B — every (head,
// slot)'s last tile, which walks the most keys, comes first
// (ops/_kernels.py prefill_block_order).
struct PrefillBlock {
    int tile, h, b;
};
__device__ __forceinline__ PrefillBlock prefill_block(int n_tiles, int H,
                                                      int B) {
    const int L = blockIdx.x, per = H * B;
    return {n_tiles - 1 - L / per, L % H, (L % per) / H};
}

// --------------------------------------------------------------------------
// The body
// --------------------------------------------------------------------------

// A tile of `rows_in_tile` (<= BQ) query positions first_q, first_q + 1, ...
// of one head (row r at q + r * stride, output at out + r * stride) against
// keys [0, n_keys): row r sees key s iff s <= first_q + r and, with a
// window, s > first_q + r - window. Keys below the window floor of the
// first query's tile and past n_keys are never read.
template <typename KVT, typename Rows>
__device__ __forceinline__ void prefill_mma_body(
        PrefillTiles<KVT>& sm, const bf16* q, long long stride,
        int rows_in_tile, int first_q, int n_keys, int window,
        const typename KVT::elem* k, const typename KVT::elem* v,
        const float* ks, const float* vs, const Rows& rows, float scale,
        bf16* out) {
    using Gm = PrefillGeo<KVT>;
    constexpr int KT = Gm::KT, ROW = Gm::ROW, NS = Gm::NS, NO = Gm::NO;
    constexpr bool QUANT = KVT::kQuant;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp % Gm::WM, wn = warp / Gm::WM;
    const int g = lane >> 2, tig = lane & 3;

    const int lo = window_floor(first_q, window);
    const int p_begin = lo - lo % KT;
    const int nt = n_keys > p_begin ? (n_keys - p_begin + KT - 1) / KT : 0;
    // Where the keys of tile t live (issue_kv): looked up a tile ahead of
    // its copy, so the table read's latency hides under a tile's math.
    const int my_key = NWARPS * (lane % (KT / NWARPS)) + warp;
    auto rows_of = [&](int t) -> TileRows {
        if (t >= nt) return {-1, -1};
        const int p0 = p_begin + t * KT;
        const long long base = tile_base<KT>(rows, p0);
        return {base, base >= 0 ? 0 : key_row(rows, p0 + my_key, lo, n_keys)};
    };
    auto issue = [&](int t, const TileRows& tr) {
        const int s = t % Gm::STAGES, p0 = p_begin + t * KT;
        if constexpr (QUANT)
            issue_kv<Gm, KVT>(sm.raw[s].k, sm.raw[s].v, sm.raw[s].ks,
                              sm.raw[s].vs, k, v, ks, vs, tr, p0, lo,
                              n_keys);
        else
            issue_kv<Gm, KVT>(sm.k[s], sm.v[s], nullptr, nullptr, k, v, ks,
                              vs, tr, p0, lo, n_keys);
    };
    issue_q<Gm>(sm.q, q, stride, rows_in_tile);
    if (nt > 0) issue(0, rows_of(0));
    cp_async_commit();
    TileRows next = rows_of(1);

    // ldmatrix lane addresses. Q (A, row-major): rows wm*16 + (lane % 8) +
    // 8 * ((lane / 8) % 2), columns 8 * (lane / 16) of each 16-wide step.
    const uint32_t q_lane = smem_addr(sm.q)
        + (wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROW
        + (lane >> 4) * 16;
    // K (B of Q K^T, keys as columns): keys (lane / 16) * 8 + lane % 8 of
    // each 16-key pair of n-tiles, columns 8 * ((lane / 8) % 2).
    const int k_lane = ((lane >> 4) * 8 + (lane & 7)) * ROW
                       + ((lane >> 3) & 1) * 16;
    // V (B of P V, transposed): keys 8 * ((lane / 8) % 2) + lane % 8 of a
    // 16-key step, columns wn * DW + 8 * (lane / 16) of each 16-wide pair.
    const int v_lane = ((((lane >> 3) & 1) * 8) + (lane & 7)) * ROW
                       + (wn * Gm::DW + (lane >> 4) * 8) * 2;

    float o[NO][4];
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    const float sc = scale * LOG2E;
    const int row0 = first_q + wm * 16 + g;     // this lane's rows: +0, +8
    const int last_q = first_q + rows_in_tile - 1;

    for (int t = 0; t < nt; ++t) {
        cp_async_wait<0>();
        __syncthreads();    // tile t landed; every warp is past tile t - 1
        const int stage = t % Gm::STAGES;
        if constexpr (QUANT) {
            widen_tile<Gm>(sm.raw[stage].k, sm.k[0]);
            widen_tile<Gm>(sm.raw[stage].v, sm.v[0]);
            __syncthreads();
        }
        const int kb = QUANT ? 0 : stage;
        const uint32_t k_base = smem_addr(sm.k[kb]) + k_lane;
        const uint32_t v_base = smem_addr(sm.v[kb]) + v_lane;
        const int p0 = p_begin + t * KT;

        // S = Q K^T, 16 rows x KT keys a warp.
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < Gm::HD / 16; ++kk) {
            uint32_t a[4];
            ldsm_x4(q_lane + kk * 32, a);
#pragma unroll
            for (int j2 = 0; j2 < NS / 2; ++j2) {
                uint32_t b[4];
                ldsm_x4(k_base + j2 * 16 * ROW + kk * 32, b);
                mma_bf16(s[2 * j2], a, b[0], b[1]);
                mma_bf16(s[2 * j2 + 1], a, b[2], b[3]);
            }
        }

        // The next tile's copy: its stage was tile t - 1's, which every warp
        // is past.
        if (t + 1 < nt) issue(t + 1, next);
        cp_async_commit();
        next = rows_of(t + 2);

        // Log2-domain scores, the key scales, and the mask where the tile
        // needs one. Lane element e of n-tile j: row row0 + 8 * (e / 2), key
        // p0 + 8 j + 2 tig + e % 2.
        const bool masked = p0 + KT - 1 > first_q || p0 + KT > n_keys
                            || (window > 0 && p0 <= last_q - window);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            float2 kscale = make_float2(1.f, 1.f);
            if constexpr (QUANT)
                kscale = *reinterpret_cast<const float2*>(
                    &sm.raw[stage].ks[j * 8 + 2 * tig]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[j][e] * sc;
                if constexpr (QUANT) x *= (e & 1) ? kscale.y : kscale.x;
                if (masked) {
                    const int key = p0 + j * 8 + 2 * tig + (e & 1);
                    const int row = row0 + (e >> 1) * 8;
                    if (!(key < n_keys && key <= row
                          && (window == 0 || key > row - window)))
                        x = NEG_INF;
                }
                s[j][e] = x;
            }
        }

        // Online softmax: row max over the quad, rescale, probabilities.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float mx = m[h];
#pragma unroll
            for (int j = 0; j < NS; ++j)
                mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, 2));
            const float alpha = exp2f(m[h] - mx);
            m[h] = mx;
            l[h] *= alpha;
#pragma unroll
            for (int n = 0; n < NO; ++n) {
                o[n][2 * h] *= alpha;
                o[n][2 * h + 1] *= alpha;
            }
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
            float2 vscale = make_float2(1.f, 1.f);
            if constexpr (QUANT)
                vscale = *reinterpret_cast<const float2*>(
                    &sm.raw[stage].vs[j * 8 + 2 * tig]);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = exp2f(s[j][e] - m[e >> 1]);
                l[e >> 1] += p;
                s[j][e] = QUANT ? p * ((e & 1) ? vscale.y : vscale.x) : p;
            }
        }

        // O += P V over 16-key steps, P as bf16 hi + lo (A fragments from
        // the score accumulators of n-tiles 2 jj and 2 jj + 1).
#pragma unroll
        for (int jj = 0; jj < KT / 16; ++jj) {
            uint32_t ah[4], al[4];
            split_bf16x2(s[2 * jj][0], s[2 * jj][1], ah[0], al[0]);
            split_bf16x2(s[2 * jj][2], s[2 * jj][3], ah[1], al[1]);
            split_bf16x2(s[2 * jj + 1][0], s[2 * jj + 1][1], ah[2], al[2]);
            split_bf16x2(s[2 * jj + 1][2], s[2 * jj + 1][3], ah[3], al[3]);
#pragma unroll
            for (int d2 = 0; d2 < NO / 2; ++d2) {
                uint32_t b[4];
                ldsm_x4_trans(v_base + jj * 16 * ROW + d2 * 32, b);
                mma_bf16(o[2 * d2], ah, b[0], b[1]);
                mma_bf16(o[2 * d2], al, b[0], b[1]);
                mma_bf16(o[2 * d2 + 1], ah, b[2], b[3]);
                mma_bf16(o[2 * d2 + 1], al, b[2], b[3]);
            }
        }
    }
    cp_async_wait<0>();

    // acc / l (l == 0 guarded, as the Pallas prefill kernel does), rounded
    // to bf16: lane columns wn * DW + 8 n + 2 tig of rows +0 and +8.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float lr = l[h];
        lr += __shfl_xor_sync(FULL_MASK, lr, 1);
        lr += __shfl_xor_sync(FULL_MASK, lr, 2);
        const float inv = 1.f / (lr == 0.f ? 1.f : lr);
        const int r = wm * 16 + g + 8 * h;
        if (r >= rows_in_tile) continue;
        __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
            out + r * stride + wn * Gm::DW + 2 * tig);
#pragma unroll
        for (int n = 0; n < NO; ++n)
            dst[n * 4] = __floats2bfloat162_rn(o[n][2 * h] * inv,
                                               o[n][2 * h + 1] * inv);
    }
}

}  // namespace pa
