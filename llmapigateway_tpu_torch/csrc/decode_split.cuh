// The decode body of kernels #1 and #3 (paged and flash decode) for Hopper:
// the key range split across blocks, a combine pass, pipelined tiles and
// warp-parallel math.
//
// It replaces the body of the Pallas decode kernels _paged_decode_kernel
// (llmapigateway_tpu/ops/paged_attention.py:204) and _decode_kernel
// (llmapigateway_tpu/ops/flash_attention.py:147): one query token per slot,
// the G query heads of one KV head, against the slot's stale keys [lo, n)
// plus the self column. The Pallas kernels walk the keys along a sequential
// grid axis and carry m/l/acc in scratch from one step to the next
// (paged_attention.py:210-215). Blocks on the GPU run in no order, so that
// axis becomes a split of the key range across blocks and a second pass:
//
// * Grid (KV, B, n_split). Split s of slot b covers the positions
//   [base + s * split_keys, base + (s + 1) * split_keys) of its live range,
//   base = lo rounded down to the 32-key tile, in whole tiles. The host picks
//   n_split and split_keys from shapes alone (ops/_kernels.py
//   decode_splits), never from n_stale; a block reads n_stale[b] itself and
//   a split past the slot's n does no work (live_splits).
// * Each block streams its tiles through a ring of STAGES shared-memory
//   buffers with cp.async (16 bytes, .cg), so tile t + 1 is in flight while
//   tile t is scored; one barrier a tile. Keys outside [lo, n), or that the
//   Rows policy does not map, are never read: their copy is the zero-fill
//   form (below a window the SWA ring may have recycled the page). Int8 tiles
//   are copied raw (half a bf16 tile's bytes) and widened when read.
// * The 4 warps split the R rows into groups of RW = min(R, 4) and share the
//   tile's four 8-key chunks among the warps of a row group. A warp scores
//   its RW rows against 8 keys with the lanes splitting the head width (pair
//   p = lane + 32 i of every row), the 8 * RW partial dot products meet in
//   one butterfly reduce-scatter (31 shuffles at RW 4), and each row's max
//   and sum are three shuffles. So every lane works at G 1 too. Each warp
//   keeps its own online-softmax state; at the end the warps of a row group
//   merge theirs through shared memory.
// * The self column (the new token; the cache is stale) seeds split 0.
// * A split writes its unnormalised fp32 acc, m and l for its rows < G to
//   the workspace; decode_combine_kernel rescales each live split by
//   exp(m_s - max m) and sums l and acc in split order (deterministic), with
//   the l == 0 guard. With one split, or when split 0 is a slot's only live
//   split, the block writes the bf16 output itself and the combine skips
//   the slot.
//
// Bound: bytes (each live K/V byte read once; 2 * G flops a byte, far below
// the ~295 flop/byte ridge). The split fills the card (the host aims at 16
// waves of blocks on 132 SMs, splits of at least 4 tiles), the ring keeps
// copies in flight under the math, and the warp layout keeps the math off
// the critical path. The combine is a programmatic dependent launch, so its
// launch overlaps the partial pass.
#pragma once

#include "attention_common.cuh"

namespace pa {

constexpr int DECODE_CHUNK = 8;              // keys a warp scores at once
constexpr int NWARPS = NTHREADS / 32;
constexpr int MAX_SPLITS = 64;               // ops/_kernels.py MAX_SPLITS
constexpr int RING_BYTES = 40 * 1024;        // shared memory the ring aims at
constexpr unsigned FULL_MASK = 0xffffffffu;

// --------------------------------------------------------------------------
// cp.async
// --------------------------------------------------------------------------

// 16 bytes from global to shared memory, or 16 zero bytes when !valid
// (then `src` is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Programmatic dependent launch (sm_90): the partial pass lets the combine
// launch while it runs; the combine waits for the partial grid's completion
// (and its writes) before reading the workspace.
__device__ __forceinline__ void allow_dependent_launch() {
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary_grid() {
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// --------------------------------------------------------------------------
// Geometry and shared memory
// --------------------------------------------------------------------------

// The decode body of R rows (decode_rows(G)) over KV type KVT.
template <int R, typename KVT>
struct SplitGeo {
    using elem = typename KVT::elem;
    static constexpr int HD = KVT::kHD, PAIRS = HD / 2;
    static constexpr int NWL = (PAIRS + 31) / 32;     // pairs a lane owns
    static constexpr int RW = R < 4 ? R : 4;          // rows a warp owns
    static constexpr int LG = RW == 4 ? 2 : RW == 2 ? 1 : 0;  // log2(RW)
    static constexpr int WR = R / RW;                 // row groups
    static constexpr int WK = NWARPS / WR;            // warps sharing a row group
    static constexpr int V = DECODE_CHUNK * RW;       // partial scores a lane holds
    static constexpr int ROW_BYTES = HD * static_cast<int>(sizeof(elem));
    static constexpr int CH = ROW_BYTES / 16;         // 16-byte copies a key row
    static constexpr int STAGE_BYTES = 2 * TILE_K * ROW_BYTES + 2 * TILE_K * 4;
    static constexpr int STAGES = 4 * STAGE_BYTES <= RING_BYTES ? 4
                                  : 3 * STAGE_BYTES <= RING_BYTES ? 3 : 2;
    static_assert(NWARPS % WR == 0, "row groups must divide the warps");
    static_assert((TILE_K / DECODE_CHUNK) % WK == 0,
                  "the tile's chunks must split over a row group's warps");
};

template <int R, typename KVT>
struct SplitSmem {
    using Gm = SplitGeo<R, KVT>;
    struct Stage {
        alignas(16) unsigned char k[TILE_K * Gm::ROW_BYTES];
        alignas(16) unsigned char v[TILE_K * Gm::ROW_BYTES];
        float ks[TILE_K], vs[TILE_K];              // int8 scales (unused: bf16)
    };
    static constexpr int MK = Gm::WK > 1 ? Gm::WK - 1 : 1;
    // The states of the warps other than the first of each row group,
    // written after the last tile over the ring.
    struct Merge {
        float acc[MK][Gm::WR][Gm::RW][Gm::HD];
        float m[MK][Gm::WR][Gm::RW], l[MK][Gm::WR][Gm::RW];
    };
    union {
        Stage stage[Gm::STAGES];
        Merge merge;
    };
    // Each warp's probabilities and rescale factors of its current chunk.
    alignas(16) float e[NWARPS][Gm::RW][DECODE_CHUNK];
    float alpha[NWARPS][Gm::RW];
};

// The workspace of a split launch: acc [B, KV, n_split, G, HD], then m and l
// [B, KV, n_split, G], fp32; the pointers of slot b, KV head kv (null when
// the launch has one split and no workspace).
struct SplitParts {
    float *acc, *m, *l;
    __device__ SplitParts(float* ws, int B, int KV, int G, int HD,
                          int n_split, int b, int kv) {
        if (ws == nullptr) {
            acc = m = l = nullptr;
            return;
        }
        const long long slot = ((long long)b * KV + kv) * n_split * G;
        const long long cells = (long long)B * KV * n_split * G;
        acc = ws + slot * HD;
        m = ws + cells * HD + slot;
        l = m + cells;
    }
};

// How many splits of a slot hold keys of [lo, n): split 0 always (the self
// column), split s while base + s * split_keys < n.
__device__ __forceinline__ int live_splits(int lo, int n, int split_keys,
                                           int n_split) {
    const int base = lo - lo % TILE_K;
    return n > base ? min(n_split, (n - base + split_keys - 1) / split_keys)
                    : 1;
}

// The key extent a split launch must cover: the cache's reach `limit`, or
// under a window the keys from the tile holding the window's floor.
inline long long decode_extent(long long limit, int window) {
    return window > 0 && window + TILE_K < limit ? window + TILE_K : limit;
}

// --------------------------------------------------------------------------
// Device pieces
// --------------------------------------------------------------------------

// Values 2p and 2p + 1 of a K/V row in shared memory, as fp32. Int8 is
// widened exactly: the biased byte becomes the low mantissa bits of 2^23.
template <typename KVT>
__device__ __forceinline__ float2 row_pair(const unsigned char* row, int p) {
    if constexpr (KVT::kQuant) {
        const uint32_t w =
            reinterpret_cast<const unsigned short*>(row)[p] ^ 0x8080u;
        return make_float2(
            __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540)) - 8388736.f,
            __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7541)) - 8388736.f);
    } else {
        const uint32_t w = reinterpret_cast<const uint32_t*>(row)[p];
        return make_float2(bf16_lo(w), bf16_hi(w));
    }
}

// Start the copies of the K and V tile of keys [pos0, pos0 + TILE_K) (and
// their int8 scales) into `st`; keys outside [lo, n) or unmapped are zero.
template <typename Gm, typename KVT, typename Stage, typename Rows>
__device__ __forceinline__ void issue_tile(
        Stage& st, const typename KVT::elem* k, const typename KVT::elem* v,
        const float* ks, const float* vs, const Rows& rows, int pos0, int lo,
        int n) {
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
    for (int i = threadIdx.x; i < TILE_K * Gm::CH; i += NTHREADS) {
        const int r = i / Gm::CH, c = i % Gm::CH;
        const int pos = pos0 + r;
        const long long row = pos >= lo && pos < n ? rows(pos) : -1;
        const long long off = row >= 0 ? row * Gm::ROW_BYTES + c * 16 : 0;
        const int dst = r * Gm::ROW_BYTES + c * 16;
        cp_async16(st.k + dst, kb + off, row >= 0);
        cp_async16(st.v + dst, vb + off, row >= 0);
    }
    if constexpr (KVT::kQuant) {
        for (int r = threadIdx.x; r < TILE_K; r += NTHREADS) {
            const int pos = pos0 + r;
            const long long row = pos >= lo && pos < n ? rows(pos) : -1;
            cp_async4(st.ks + r, ks + (row >= 0 ? row : 0), row >= 0);
            cp_async4(st.vs + r, vs + (row >= 0 ? row : 0), row >= 0);
        }
    }
}

// Butterfly reduce-scatter of x[0..N) over the 32 lanes, offsets O, O/2,
// ..., 1: each step keeps half of the values (the upper half on the lane
// whose bit O is set) and adds the partner's copy of it; once one value is
// left, the remaining steps sum it. For N = 8 * RW values indexed
// j * RW + r, lane l ends with the sum of value (l >> 2) * RW
// + ((l & 3) >> (2 - log2 RW)): key j = l >> 2 of the chunk, for its row.
template <int N, int O, int NV>
__device__ __forceinline__ void reduce_scatter(float (&x)[NV], int lane) {
    if constexpr (N > 1) {
        const bool up = lane & O;
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
            const float send = up ? x[i] : x[i + N / 2];
            const float keep = up ? x[i + N / 2] : x[i];
            x[i] = keep + __shfl_xor_sync(FULL_MASK, send, O);
        }
    } else {
        x[0] += __shfl_xor_sync(FULL_MASK, x[0], O);
    }
    if constexpr (O > 1) reduce_scatter<(N > 1 ? N / 2 : 1), O / 2>(x, lane);
}

// One warp's online-softmax update over the 8 keys of chunk c of the tile
// in `st` (keys pos0 + 8c ..): scores of its RW rows (q in registers,
// lanes across the head width), row max and sum by shuffles, then
// acc = alpha * acc + sum_j e_j [* vs_j] v_j over the lane's pairs. m_lane
// and l_lane are the state of the lane's row my_r.
template <typename Gm, typename KVT, typename Stage>
__device__ __forceinline__ void attend_chunk(
        const Stage& st, int c, int pos0, int lo, int n, float scale,
        const float (&qf)[Gm::RW][Gm::NWL][2],
        float (&acc)[Gm::RW][Gm::NWL][2], float& m_lane, float& l_lane,
        float (&e_s)[Gm::RW][DECODE_CHUNK], float (&alpha_s)[Gm::RW],
        int lane, int my_r) {
    constexpr int RW = Gm::RW, NWL = Gm::NWL, PAIRS = Gm::PAIRS;
    float part[Gm::V];
#pragma unroll
    for (int i = 0; i < Gm::V; ++i) part[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DECODE_CHUNK; ++j) {
        const unsigned char* kr =
            st.k + (c * DECODE_CHUNK + j) * Gm::ROW_BYTES;
#pragma unroll
        for (int i = 0; i < NWL; ++i) {
            const int p = lane + 32 * i;
            if (PAIRS % 32 == 0 || p < PAIRS) {
                const float2 kk = row_pair<KVT>(kr, p);
#pragma unroll
                for (int r = 0; r < RW; ++r)
                    part[j * RW + r] = fmaf(
                        qf[r][i][1], kk.y,
                        fmaf(qf[r][i][0], kk.x, part[j * RW + r]));
            }
        }
    }
    reduce_scatter<Gm::V, 16>(part, lane);

    const int j = lane >> 2, key = c * DECODE_CHUNK + j, pos = pos0 + key;
    const bool visible = pos >= lo && pos < n;
    float s = part[0] * scale;
    if constexpr (KVT::kQuant) s *= st.ks[key];
    float mx = visible ? s : NEG_INF;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, o));
    const float m_new = fmaxf(m_lane, mx);
    const float alpha = expf(m_lane - m_new);
    const float e = visible ? expf(s - m_new) : 0.f;
    float sum = e;
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
        sum += __shfl_xor_sync(FULL_MASK, sum, o);
    l_lane = alpha * l_lane + sum;
    m_lane = m_new;

    // Hand every lane the chunk's probabilities of all RW rows.
    if ((lane & ((4 >> Gm::LG) - 1)) == 0) {
        e_s[my_r][j] = e;
        if (j == 0) alpha_s[my_r] = alpha;
    }
    __syncwarp();
    float a[RW], ew[RW][DECODE_CHUNK];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        a[r] = alpha_s[r];
        const float4 e0 = reinterpret_cast<const float4*>(e_s[r])[0];
        const float4 e1 = reinterpret_cast<const float4*>(e_s[r])[1];
        ew[r][0] = e0.x; ew[r][1] = e0.y; ew[r][2] = e0.z; ew[r][3] = e0.w;
        ew[r][4] = e1.x; ew[r][5] = e1.y; ew[r][6] = e1.z; ew[r][7] = e1.w;
    }
    if constexpr (KVT::kQuant) {
#pragma unroll
        for (int jj = 0; jj < DECODE_CHUNK; ++jj) {
            const float vsj = st.vs[c * DECODE_CHUNK + jj];
#pragma unroll
            for (int r = 0; r < RW; ++r) ew[r][jj] *= vsj;
        }
    }
    __syncwarp();                  // e_s and alpha_s are free again
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int i = 0; i < NWL; ++i) {
            acc[r][i][0] *= a[r];
            acc[r][i][1] *= a[r];
        }
#pragma unroll
    for (int jj = 0; jj < DECODE_CHUNK; ++jj) {
        const unsigned char* vr =
            st.v + (c * DECODE_CHUNK + jj) * Gm::ROW_BYTES;
#pragma unroll
        for (int i = 0; i < NWL; ++i) {
            const int p = lane + 32 * i;
            if (PAIRS % 32 == 0 || p < PAIRS) {
                const float2 vv = row_pair<KVT>(vr, p);
#pragma unroll
                for (int r = 0; r < RW; ++r) {
                    acc[r][i][0] = fmaf(ew[r][jj], vv.x, acc[r][i][0]);
                    acc[r][i][1] = fmaf(ew[r][jj], vv.y, acc[r][i][1]);
                }
            }
        }
    }
}

// --------------------------------------------------------------------------
// The body of split blockIdx.z
// --------------------------------------------------------------------------

// The G query heads of one KV head of one slot (rows q[0..G), HD apart)
// against the stale keys [lo, n) of this block's split, plus the self
// column on split 0. R = decode_rows(G) >= G rows: rows G..R-1 are zero
// queries, never written. Writes the output rows at `out` (one live split)
// or the split's partial state to `parts`.
template <int R, typename KVT, typename Rows>
__device__ __forceinline__ void split_decode_body(
        SplitSmem<R, KVT>& sm, int G, const bf16* q, const bf16* k_new,
        const bf16* v_new, const typename KVT::elem* k,
        const typename KVT::elem* v, const float* ks, const float* vs,
        const Rows& rows, int lo, int n, float scale, int n_split,
        int split_keys, bf16* out, const SplitParts& parts) {
    using Gm = SplitGeo<R, KVT>;
    constexpr int PAIRS = Gm::PAIRS, NWL = Gm::NWL, RW = Gm::RW,
                  WK = Gm::WK, STAGES = Gm::STAGES, HD = Gm::HD;
    allow_dependent_launch();
    const int split = blockIdx.z;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int rg = warp / WK, kg = warp % WK;
    const int row0 = rg * RW;                       // the warp's first row
    const int my_r = (lane & 3) >> (2 - Gm::LG);    // the lane's row
    const bool seeds = split == 0 && kg == 0;       // holds the self column
    // The query rows and the self column's key and value, loaded before
    // anything that waits on n_stale.
    uint32_t qw[RW][NWL], knw[NWL], vnw[NWL];
#pragma unroll
    for (int i = 0; i < NWL; ++i) {
        const int p = lane + 32 * i;
#pragma unroll
        for (int r = 0; r < RW; ++r)
            qw[r][i] = row0 + r < G && p < PAIRS
                ? reinterpret_cast<const uint32_t*>(q)[(row0 + r) * PAIRS + p]
                : 0u;
        knw[i] = seeds && p < PAIRS
            ? reinterpret_cast<const uint32_t*>(k_new)[p] : 0u;
        vnw[i] = seeds && p < PAIRS
            ? reinterpret_cast<const uint32_t*>(v_new)[p] : 0u;
    }
    const int live = live_splits(lo, n, split_keys, n_split);
    if (split >= live) return;
    const int base = lo - lo % TILE_K;
    const int p_begin = base + split * split_keys;
    const int p_end = min(p_begin + split_keys, n);
    const int nt = p_end > p_begin ? (p_end - p_begin + TILE_K - 1) / TILE_K
                                   : 0;

#pragma unroll
    for (int t = 0; t < STAGES - 1; ++t) {
        if (t < nt)
            issue_tile<Gm, KVT>(sm.stage[t], k, v, ks, vs, rows,
                                p_begin + t * TILE_K, lo, n);
        cp_async_commit();
    }

    float qf[RW][NWL][2], acc[RW][NWL][2];
#pragma unroll
    for (int r = 0; r < RW; ++r)
#pragma unroll
        for (int i = 0; i < NWL; ++i) {
            qf[r][i][0] = bf16_lo(qw[r][i]);
            qf[r][i][1] = bf16_hi(qw[r][i]);
            acc[r][i][0] = acc[r][i][1] = 0.f;
        }
    float m_lane = NEG_INF, l_lane = 0.f;
    if (seeds) {
        // Self column: m = q . k_new * scale, l = 1, acc = v_new, at full
        // precision in both KV types.
        float d[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) d[r] = 0.f;
#pragma unroll
        for (int i = 0; i < NWL; ++i) {
#pragma unroll
            for (int r = 0; r < RW; ++r) {
                d[r] = fmaf(qf[r][i][1], bf16_hi(knw[i]),
                            fmaf(qf[r][i][0], bf16_lo(knw[i]), d[r]));
                acc[r][i][0] = bf16_lo(vnw[i]);
                acc[r][i][1] = bf16_hi(vnw[i]);
            }
        }
#pragma unroll
        for (int r = 0; r < RW; ++r) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                d[r] += __shfl_xor_sync(FULL_MASK, d[r], o);
            if (r == my_r) m_lane = d[r] * scale;
        }
        l_lane = 1.f;
    }

    for (int t = 0; t < nt; ++t) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();    // tile t landed; every warp is past tile t - 1
        if (t + STAGES - 1 < nt)
            issue_tile<Gm, KVT>(sm.stage[(t + STAGES - 1) % STAGES], k, v, ks,
                                vs, rows, p_begin + (t + STAGES - 1) * TILE_K,
                                lo, n);
        cp_async_commit();
        const auto& st = sm.stage[t % STAGES];
        const int pos0 = p_begin + t * TILE_K;
#pragma unroll
        for (int c = 0; c < TILE_K / DECODE_CHUNK; c += WK)
            attend_chunk<Gm, KVT>(st, c + kg, pos0, lo, n, scale, qf, acc,
                                  m_lane, l_lane, sm.e[warp], sm.alpha[warp],
                                  lane, my_r);
    }
    cp_async_wait<0>();

    // Every lane gets m and l of each of its warp's rows.
    float M[RW], L[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        M[r] = __shfl_sync(FULL_MASK, m_lane, r << (2 - Gm::LG));
        L[r] = __shfl_sync(FULL_MASK, l_lane, r << (2 - Gm::LG));
    }
    if constexpr (WK > 1) {
        // Merge the row group's warps: exp(m_w - max m) rescales each.
        auto& mg = sm.merge;
        __syncthreads();    // every warp is done with the ring
        if (kg > 0) {
#pragma unroll
            for (int r = 0; r < RW; ++r) {
#pragma unroll
                for (int i = 0; i < NWL; ++i) {
                    const int p = lane + 32 * i;
                    if (p < PAIRS)
                        *reinterpret_cast<float2*>(
                            &mg.acc[kg - 1][rg][r][2 * p]) =
                            make_float2(acc[r][i][0], acc[r][i][1]);
                }
                if (lane == r) {
                    mg.m[kg - 1][rg][r] = M[r];
                    mg.l[kg - 1][rg][r] = L[r];
                }
            }
        }
        __syncthreads();
        if (kg > 0) return;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
            float mx = M[r];
#pragma unroll
            for (int w = 0; w < WK - 1; ++w) mx = fmaxf(mx, mg.m[w][rg][r]);
            const float w0 = expf(M[r] - mx);
            float l = w0 * L[r];
#pragma unroll
            for (int i = 0; i < NWL; ++i) {
                acc[r][i][0] *= w0;
                acc[r][i][1] *= w0;
            }
#pragma unroll
            for (int w = 0; w < WK - 1; ++w) {
                const float f = expf(mg.m[w][rg][r] - mx);
                l += f * mg.l[w][rg][r];
#pragma unroll
                for (int i = 0; i < NWL; ++i) {
                    const int p = lane + 32 * i;
                    if (p < PAIRS) {
                        const float2 o = *reinterpret_cast<const float2*>(
                            &mg.acc[w][rg][r][2 * p]);
                        acc[r][i][0] = fmaf(f, o.x, acc[r][i][0]);
                        acc[r][i][1] = fmaf(f, o.y, acc[r][i][1]);
                    }
                }
            }
            M[r] = mx;
            L[r] = l;
        }
    }

    const bool final_out = n_split == 1 || live == 1;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
        const int row = row0 + r;
        if (row >= G) continue;
        // acc / l (l == 0 guarded, as the Pallas prefill kernel does).
        const float l = L[r] == 0.f ? 1.f : L[r];
#pragma unroll
        for (int i = 0; i < NWL; ++i) {
            const int p = lane + 32 * i;
            if (p >= PAIRS) continue;
            if (final_out)
                reinterpret_cast<__nv_bfloat162*>(out + row * HD)[p] =
                    __floats2bfloat162_rn(acc[r][i][0] / l,
                                          acc[r][i][1] / l);
            else
                reinterpret_cast<float2*>(
                    parts.acc + ((long long)split * G + row) * HD)[p] =
                    make_float2(acc[r][i][0], acc[r][i][1]);
        }
        if (!final_out && lane == 0) {
            parts.m[split * G + row] = M[r];
            parts.l[split * G + row] = L[r];
        }
    }
}

// --------------------------------------------------------------------------
// The combine pass
// --------------------------------------------------------------------------

// One block per (query row r, KV head, slot) of a launch of n_split > 1:
// out = sum_s exp(m_s - M) acc_s / sum_s exp(m_s - M) l_s over the slot's
// live splits, in split order. A slot with one live split was written by
// its split 0 and is skipped. `limit` is the cache's reach (NP * page, S).
template <int HD>
__global__ void __launch_bounds__(NTHREADS) decode_combine_kernel(
        float* __restrict__ ws, const int* __restrict__ n_stale,
        bf16* __restrict__ out, int B, int G, int KV, int limit, int window,
        int n_split, int split_keys) {
    constexpr int PAIRS = HD / 2;
    const int r = blockIdx.x, kv = blockIdx.y, b = blockIdx.z;
    const int n = min(n_stale[b], limit);
    const int lo = window_floor(n_stale[b], window);
    const int live = live_splits(lo, n, split_keys, n_split);
    // Every block waits, so the combine never completes before the partial
    // pass does (what runs after it on the stream reads `out`).
    wait_for_primary_grid();
    if (live == 1) return;
    const SplitParts parts(ws, B, KV, G, HD, n_split, b, kv);
    float mx = NEG_INF;
    for (int s = 0; s < live; ++s) mx = fmaxf(mx, parts.m[s * G + r]);
    float l = 0.f;
    for (int s = 0; s < live; ++s)
        l += expf(parts.m[s * G + r] - mx) * parts.l[s * G + r];
    if (l == 0.f) l = 1.f;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        out + (((long long)b * KV + kv) * G + r) * HD);
    for (int p = threadIdx.x; p < PAIRS; p += NTHREADS) {
        float x = 0.f, y = 0.f;
        for (int s = 0; s < live; ++s) {
            const float f = expf(parts.m[s * G + r] - mx);
            const float2 a = reinterpret_cast<const float2*>(
                parts.acc + ((long long)s * G + r) * HD)[p];
            x = fmaf(f, a.x, x);
            y = fmaf(f, a.y, y);
        }
        dst[p] = __floats2bfloat162_rn(x / l, y / l);
    }
}

// Launch the combine after a split launch's partial pass on the same
// stream, as a programmatic dependent launch (its blocks start while the
// partial pass finishes and wait for it); returns the partial pass's launch
// error, or the combine's.
template <int HD>
inline cudaError_t launch_combine(void* ws, const void* n_stale, void* out,
                                  int B, int G, int KV, int limit, int window,
                                  int n_split, int split_keys,
                                  cudaStream_t stream) {
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(G, KV, B);
    cfg.blockDim = dim3(NTHREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, decode_combine_kernel<HD>,
                              static_cast<float*>(ws),
                              static_cast<const int*>(n_stale),
                              static_cast<bf16*>(out), B, G, KV, limit,
                              window, n_split, split_keys);
}

// The split arguments a decode entry refuses: a split count outside
// [1, MAX_SPLITS], splits that are not whole tiles or do not cover the key
// extent, or several splits without a workspace.
inline bool bad_split(int n_split, int split_keys, long long extent,
                      const void* ws) {
    return n_split < 1 || n_split > MAX_SPLITS || split_keys <= 0 ||
           split_keys % TILE_K != 0 ||
           (long long)n_split * split_keys < extent ||
           (n_split > 1 && ws == nullptr);
}

}  // namespace pa
