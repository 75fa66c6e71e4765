// Shared online-softmax block math of the attention kernels.
//
// The CUDA twin of the JAX package's single-copy block update
// (llmapigateway_tpu/ops/flash_attention.py: self_column_init :60,
// attend_block :79) and of the port's plain helpers
// (llmapigateway_tpu_torch/ops/flash_attention.py). The prefill kernels in
// paged_attention.cu and flash_attention.cu are built from prefill_body
// here: a thread block owns a tile of query positions of one head, keeps
// their fp32 state m/l in shared memory and acc in registers, and walks the
// keys in shared-memory tiles of TILE_K tokens. The decode kernels are built
// from split_decode_body (decode_split.cuh), which shares the KV types, the
// key addressing and the host dispatch below.
//
// The kernels differ only in two template parameters of the bodies:
// * how a key's row is found (Rows): PagedRows through the slot's
//   page-table row, PagedRunRows through one table entry per aligned run
//   of pages_per_block logical pages (the packed multi-page table),
//   DenseRows by a row stride in the contiguous cache. A key's scale sits at
//   the same row index in every layout (scales are stored [.., KV, 1, N]
//   beside values [.., KV, N, Dh]).
// * the KV element type (KVT): Bf16KV, or Int8KV with a per-key fp32 scale.
//   The prefill body widens int8 values to bf16 in shared memory, which is
//   exact (|q| <= 127 needs 7 bits; bf16 keeps 8), so the score and PV loops
//   are the same code; the int8 body multiplies each score by its key's
//   scale after the Dh^-1/2 factor and before the mask, accumulates l from
//   the UNSCALED probabilities, and multiplies each probability by its
//   value's scale in the PV product.
//
// A sliding window (mistral family; HF semantics: key j is visible to the
// query at position i iff i - j < window, the query itself included) is a
// runtime argument: the bodies start their tile walk at the tile holding
// the first key any of their rows can see, so a windowed decode reads
// O(window) keys, not O(context). Keys below that floor inside the first
// tile are never read (zero-filled, as past-the-end keys are) and are
// masked. window == 0 is full causal attention.
//
// The head width HD is a template parameter of everything below: the
// kernels are built for the widths of the served presets (HEAD_DIMS: 64 for
// tinyllama and qwen2, 96 for phi-3-mini, 128 for llama-3 and mistral, 256
// for gemma). The prefill body's shared-memory rows hold HD bf16 values as
// PAIRS 32-bit words padded to ROW_WORDS words (an odd count), so a warp
// reading one column across 32 rows hits 32 different banks.
//
// Width 256 outgrows two fixed budgets of the 64-row prefill tile, and the
// design answers both per width (Dims<HD>): (1) the accumulator — a thread
// owns NPAIR = HD / (2 * NTHREADS / TILE_Q) pairs, 64 fp32 registers at
// (TILE_Q 64, HD 128), 128 at (64, 256), where ptxas would spill — so the
// query tile is 32 rows at HD 256, which keeps the per-thread accumulator
// at 64 registers (the HD 128 body's, which compiles without spills) at
// the cost of twice the key-tile walks per query; (2) shared memory —
// Smem<32, 256> is 54,400 bytes, past the 48 KiB a static __shared__
// declaration may take — so a body whose Smem is larger takes it as
// DYNAMIC shared memory, after the launcher raises the function's limit
// (cudaFuncAttributeMaxDynamicSharedMemorySize). Every other prefill body
// keeps a static declaration (body_smem).
//
// Decode rows are the G query heads of one KV head. The decode bodies are
// built per row count R (1, 2, 4, 8, 16), and G is a runtime argument: a
// group runs the body of R = G rounded up to a power of two (decode_rows),
// so G 3 (llama-3b-class) and G 7 (qwen2-0.5b) run the 4- and 8-row bodies.
// Rows >= G are zero queries whose state is computed and never written
// back; q and out are addressed with the true G (KV head kv owns query
// heads kv*G .. kv*G + G - 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pa {

constexpr int TILE_K = 32;                   // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr int STATIC_SMEM_MAX = 48 * 1024;   // a launch's default smem limit
constexpr float NEG_INF = -1e30f;            // finite, as in the Pallas kernels

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}

template <int HD>
struct Dims {
    static_assert(HD % 16 == 0, "rows load as 16-byte chunks of int8");
    static constexpr int PAIRS = HD / 2;          // bf16x2 words per row
    static constexpr int ROW_WORDS = PAIRS + 1;   // padded shared-memory row
    // Query rows per prefill block: 32 at HD 256 keeps the accumulator at
    // 64 registers a thread (see the header comment).
    static constexpr int TILE_Q = HD > 128 ? 32 : 64;
};

// The decode body's row count for a group of G query heads: G rounded up
// to a power of two, so the rows split over the block's warps.
__host__ __device__ constexpr int decode_rows(int G) {
    int r = 1;
    while (r < G) r *= 2;
    return r;
}

// --------------------------------------------------------------------------
// KV element types
// --------------------------------------------------------------------------

template <int HD>
struct Bf16KV {
    using elem = bf16;
    static constexpr int kHD = HD;
    static constexpr bool kQuant = false;
    static constexpr int CHUNKS = HD / 8;         // 16-byte loads per row

    // Chunk c (values 8c .. 8c+7) of key row `row` into its padded slot.
    __device__ static void load(const elem* base, long long row, int c,
                                uint32_t* dst) {
        const uint4 v =
            __ldg(reinterpret_cast<const uint4*>(base + row * HD) + c);
        dst[c * 4 + 0] = v.x;
        dst[c * 4 + 1] = v.y;
        dst[c * 4 + 2] = v.z;
        dst[c * 4 + 3] = v.w;
    }
    __device__ static void zero(int c, uint32_t* dst) {
#pragma unroll
        for (int i = 0; i < 4; ++i) dst[c * 4 + i] = 0u;
    }
};

// Signed byte `k` of w, as the bits of its (exact) bf16 value.
__device__ __forceinline__ uint32_t i8_as_bf16(uint32_t w, int k) {
    const int v = static_cast<int>(w << (24 - 8 * k)) >> 24;
    return __float_as_uint(static_cast<float>(v)) >> 16;
}
__device__ __forceinline__ uint32_t i8x2_as_bf16x2(uint32_t w, int k) {
    return i8_as_bf16(w, k) | (i8_as_bf16(w, k + 1) << 16);
}

template <int HD>
struct Int8KV {
    using elem = int8_t;
    static constexpr int kHD = HD;
    static constexpr bool kQuant = true;
    static constexpr int CHUNKS = HD / 16;        // an HD-byte row, 16 B a load

    // Chunk c (values 16c .. 16c+15) of key row `row`, widened to bf16.
    __device__ static void load(const elem* base, long long row, int c,
                                uint32_t* dst) {
        const uint4 v =
            __ldg(reinterpret_cast<const uint4*>(base + row * HD) + c);
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            dst[c * 8 + 2 * i] = i8x2_as_bf16x2(w[i], 0);
            dst[c * 8 + 2 * i + 1] = i8x2_as_bf16x2(w[i], 2);
        }
    }
    __device__ static void zero(int c, uint32_t* dst) {
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[c * 8 + i] = 0u;
    }
};

// --------------------------------------------------------------------------
// Key addressing: the row index of the key at position `pos`, or -1 when
// the position lies outside what the cache holds for this row (never read).
// --------------------------------------------------------------------------

// Page pool [P, KV, page, HD]: the block reads its own page-table row
// (there is no scalar prefetch on the GPU). An unallocated table entry (0,
// the trash page) is never dereferenced for a live position: reads stop at
// n_stale or the causal bound, and past the table.
struct PagedRows {
    const int* table_row;
    int NP, page, KV, kv;
    __device__ static PagedRows make(const int* table_row, int NP, int page,
                                     int KV, int kv, int /*ppb*/) {
        return {table_row, NP, page, KV, kv};
    }
    __device__ long long operator()(int pos) const {
        const int lp = pos / page;
        if (lp >= NP) return -1;
        return (static_cast<long long>(table_row[lp]) * KV + kv) * page
               + (pos - lp * page);
    }
};

// Packed multi-page pool (kv_pages_per_block = ppb > 1): the allocator maps
// every aligned run of ppb logical pages onto ppb contiguous physical pages
// starting at a ppb-aligned page, so a run needs ONE table entry, p0 =
// table[(lp / ppb) * ppb], and logical page lp lives at p0 + lp % ppb (the
// Pallas kernel's gather-free superpage index map,
// llmapigateway_tpu/ops/paged_attention.py:320-330). The keys, and their
// order, are those of PagedRows on the same packed table, so the output is
// the same bit for bit.
struct PagedRunRows {
    const int* table_row;
    int NP, page, KV, kv, ppb;
    __device__ static PagedRunRows make(const int* table_row, int NP,
                                        int page, int KV, int kv, int ppb) {
        return {table_row, NP, page, KV, kv, ppb};
    }
    __device__ long long operator()(int pos) const {
        const int lp = pos / page;
        if (lp >= NP) return -1;
        const int in_run = lp % ppb;
        const long long p0 = table_row[lp - in_run];
        return ((p0 + in_run) * KV + kv) * page + (pos - lp * page);
    }
};

// Contiguous cache [Bc, KV, S, HD]: row `base` is (cache row, kv).
struct DenseRows {
    long long base;      // (cache_row * KV + kv) * S
    int S;
    __device__ long long operator()(int pos) const {
        return pos < S ? base + pos : -1;
    }
};

// --------------------------------------------------------------------------
// Shared memory and per-thread state
// --------------------------------------------------------------------------

template <int R, int HD>
struct Smem {
    static constexpr int ROW_WORDS = Dims<HD>::ROW_WORDS;
    uint32_t q[R * ROW_WORDS];
    uint32_t k[TILE_K * ROW_WORDS];
    uint32_t v[TILE_K * ROW_WORDS];
    float s[R * (TILE_K + 1)];
    float ks[TILE_K], vs[TILE_K];    // the tile's int8 scales
    float m[R], l[R], alpha[R];
};

// The shared memory of the prefill body for one KV type.
template <typename KVT>
using PrefillSmem = Smem<Dims<KVT::kHD>::TILE_Q, KVT::kHD>;

// Per-thread slice of the R x HD fp32 accumulator: thread t owns row
// t / TPR and the bf16 pairs lane, lane + TPR, ... of it.
template <int R, int HD>
struct RowAcc {
    static constexpr int PAIRS = Dims<HD>::PAIRS;
    static constexpr int TPR = NTHREADS / R;                  // threads per row
    static constexpr int NPAIR = (PAIRS + TPR - 1) / TPR;     // pairs per thread
    static_assert(NTHREADS % R == 0, "rows must divide the block");
    float x[NPAIR], y[NPAIR];

    __device__ __forceinline__ int row() const { return threadIdx.x / TPR; }
    __device__ __forceinline__ int pair(int i) const {
        return threadIdx.x % TPR + i * TPR;
    }
};

// Load `n_rows` query rows of HD bf16 (row r at src + r * stride elements,
// 16-byte aligned) into padded shared memory; rows >= n_valid are zeroed.
template <int HD>
__device__ __forceinline__ void load_q_rows(const bf16* src, long long stride,
                                            int n_valid, int n_rows,
                                            uint32_t* dst) {
    using Q = Bf16KV<HD>;
    constexpr int ROW_WORDS = Dims<HD>::ROW_WORDS;
    for (int i = threadIdx.x; i < n_rows * Q::CHUNKS; i += NTHREADS) {
        const int r = i / Q::CHUNKS, c = i % Q::CHUNKS;
        if (r < n_valid)
            Q::load(src + r * stride, 0, c, dst + r * ROW_WORDS);
        else
            Q::zero(c, dst + r * ROW_WORDS);
    }
}

// Load the K and V tile of keys [pos0, pos0 + TILE_K) — and, for int8, their
// scales. Keys outside [lo, limit), and keys the Rows policy does not hold,
// are zeroed (scale 0) and never read from device memory: below a window's
// floor the page may be trash or recycled (the paged SWA ring), and a
// zeroed key cannot carry a stale int8 scale into a live row's softmax.
template <typename KVT, typename Rows>
__device__ __forceinline__ void load_kv_tile(
        const typename KVT::elem* k, const typename KVT::elem* v,
        const float* ks, const float* vs, const Rows& rows, int pos0,
        int lo, int limit, uint32_t* k_s, uint32_t* v_s, float* ks_s,
        float* vs_s) {
    constexpr int ROW_WORDS = Dims<KVT::kHD>::ROW_WORDS;
    for (int i = threadIdx.x; i < TILE_K * KVT::CHUNKS; i += NTHREADS) {
        const int r = i / KVT::CHUNKS, c = i % KVT::CHUNKS;
        const int pos = pos0 + r;
        const long long row = pos >= lo && pos < limit ? rows(pos) : -1;
        if (row >= 0) {
            KVT::load(k, row, c, k_s + r * ROW_WORDS);
            KVT::load(v, row, c, v_s + r * ROW_WORDS);
        } else {
            KVT::zero(c, k_s + r * ROW_WORDS);
            KVT::zero(c, v_s + r * ROW_WORDS);
        }
    }
    if constexpr (KVT::kQuant) {
        for (int r = threadIdx.x; r < TILE_K; r += NTHREADS) {
            const int pos = pos0 + r;
            const long long row = pos >= lo && pos < limit ? rows(pos) : -1;
            ks_s[r] = row >= 0 ? __ldg(ks + row) : 0.f;
            vs_s[r] = row >= 0 ? __ldg(vs + row) : 0.f;
        }
    }
}

// Scores of the R query rows against the TILE_K keys of the tile, with the
// caller's mask: s_s[r][j] = visible(r, j) ? (q.k * scale) [* ks_j] : NEG_INF.
template <int R, int HD, bool QUANT, typename Visible>
__device__ __forceinline__ void tile_scores(const uint32_t* q_s,
                                            const uint32_t* k_s,
                                            const float* ks_s, float scale,
                                            float* s_s, Visible visible) {
    constexpr int PAIRS = Dims<HD>::PAIRS, ROW_WORDS = Dims<HD>::ROW_WORDS;
    for (int i = threadIdx.x; i < R * TILE_K; i += NTHREADS) {
        const int r = i / TILE_K, j = i % TILE_K;
        const uint32_t* qr = q_s + r * ROW_WORDS;
        const uint32_t* kr = k_s + j * ROW_WORDS;
        float s = 0.f;
#pragma unroll 8
        for (int p = 0; p < PAIRS; ++p) {
            const uint32_t qw = qr[p], kw = kr[p];
            s += bf16_lo(qw) * bf16_lo(kw) + bf16_hi(qw) * bf16_hi(kw);
        }
        s *= scale;
        if constexpr (QUANT) s *= ks_s[j];
        s_s[r * (TILE_K + 1) + j] = visible(r, j) ? s : NEG_INF;
    }
}

// attend_block: the online-softmax update for one tile.
//   m_new = max(m, max_j s), alpha = exp(m - m_new), e_j = exp(s_j - m_new)
//   l = alpha * l + sum_j e_j,  acc = alpha * acc + sum_j e_j [* vs_j] v_j
// Row statistics run one thread per row and leave e_j in s_s and alpha in
// alpha_s; then every thread updates its slice of acc from the V tile.
// Starts after the caller's barrier over s_s; ends with a barrier-free PV.
template <int R, int HD, bool QUANT>
__device__ __forceinline__ void attend_block(float* s_s, const uint32_t* v_s,
                                             const float* vs_s, float* m_s,
                                             float* l_s, float* alpha_s,
                                             RowAcc<R, HD>& acc) {
    constexpr int PAIRS = Dims<HD>::PAIRS, ROW_WORDS = Dims<HD>::ROW_WORDS;
    for (int r = threadIdx.x; r < R; r += NTHREADS) {
        float* sr = s_s + r * (TILE_K + 1);
        const float m_prev = m_s[r];
        float m_new = m_prev;
        for (int j = 0; j < TILE_K; ++j) m_new = fmaxf(m_new, sr[j]);
        float sum = 0.f;
        for (int j = 0; j < TILE_K; ++j) {
            const float e = expf(sr[j] - m_new);
            sr[j] = e;
            sum += e;
        }
        const float alpha = expf(m_prev - m_new);
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
        alpha_s[r] = alpha;
    }
    __syncthreads();
    const int r = acc.row();
    const float alpha = alpha_s[r];
    const float* er = s_s + r * (TILE_K + 1);
#pragma unroll
    for (int i = 0; i < RowAcc<R, HD>::NPAIR; ++i) {
        acc.x[i] *= alpha;
        acc.y[i] *= alpha;
    }
    for (int j = 0; j < TILE_K; ++j) {
        float e = er[j];
        if constexpr (QUANT) e *= vs_s[j];
        const uint32_t* vr = v_s + j * ROW_WORDS;
#pragma unroll
        for (int i = 0; i < RowAcc<R, HD>::NPAIR; ++i) {
            const int p = acc.pair(i);
            if (p < PAIRS) {
                const uint32_t w = vr[p];
                acc.x[i] += e * bf16_lo(w);
                acc.y[i] += e * bf16_hi(w);
            }
        }
    }
}

// acc / l (l == 0 guarded, as the Pallas prefill kernel does), rounded to
// bf16, into the row's HD outputs at `dst`.
template <int R, int HD>
__device__ __forceinline__ void write_row(const RowAcc<R, HD>& acc,
                                          const float* l_s, bf16* dst) {
    constexpr int PAIRS = Dims<HD>::PAIRS;
    const float l0 = l_s[acc.row()];
    const float l = l0 == 0.f ? 1.f : l0;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
    for (int i = 0; i < RowAcc<R, HD>::NPAIR; ++i) {
        const int p = acc.pair(i);
        if (p < PAIRS)
            out[p] = __floats2bfloat162_rn(acc.x[i] / l, acc.y[i] / l);
    }
}

// --------------------------------------------------------------------------
// The prefill body
// --------------------------------------------------------------------------

// The first key position a query at `q_pos` sees under `window` (0: all).
__device__ __forceinline__ int window_floor(int q_pos, int window) {
    return window > 0 ? max(q_pos - (window - 1), 0) : 0;
}

// Prefill: a tile of `rows_in_tile` query positions first_q, first_q + 1, ...
// of one head (row r at q + r * stride) against keys [0, n_keys), causal:
// query row r sees keys s <= first_q + r, and with a window also
// s > first_q + r - window. Keys past the tile's last query, and keys below
// the window floor of its first query, are never walked.
template <typename KVT, typename Rows>
__device__ __forceinline__ void prefill_body(
        PrefillSmem<KVT>& sm, const bf16* q, long long stride,
        int rows_in_tile, int first_q, int n_keys, int window,
        const typename KVT::elem* k, const typename KVT::elem* v,
        const float* ks, const float* vs, const Rows& rows, float scale,
        bf16* out) {
    constexpr int HD = KVT::kHD, TILE_Q = Dims<HD>::TILE_Q;
    load_q_rows<HD>(q, stride, rows_in_tile, TILE_Q, sm.q);
    for (int r = threadIdx.x; r < TILE_Q; r += NTHREADS) {
        sm.m[r] = NEG_INF;
        sm.l[r] = 0.f;
    }
    RowAcc<TILE_Q, HD> acc;
#pragma unroll
    for (int i = 0; i < RowAcc<TILE_Q, HD>::NPAIR; ++i)
        acc.x[i] = acc.y[i] = 0.f;

    const int lo = window_floor(first_q, window);
    for (int pos0 = lo - lo % TILE_K; pos0 < n_keys; pos0 += TILE_K) {
        __syncthreads();
        load_kv_tile<KVT>(k, v, ks, vs, rows, pos0, lo, n_keys, sm.k, sm.v,
                          sm.ks, sm.vs);
        __syncthreads();
        tile_scores<TILE_Q, HD, KVT::kQuant>(
            sm.q, sm.k, sm.ks, scale, sm.s, [=](int r, int j) {
                const int s = pos0 + j, q_pos = first_q + r;
                return r < rows_in_tile && s < n_keys && s <= q_pos
                       && (window == 0 || s > q_pos - window);
            });
        __syncthreads();
        attend_block<TILE_Q, HD, KVT::kQuant>(sm.s, sm.v, sm.vs, sm.m, sm.l,
                                              sm.alpha, acc);
    }
    __syncthreads();
    if (acc.row() < rows_in_tile)
        write_row<TILE_Q, HD>(acc, sm.l, out + acc.row() * stride);
}

// --------------------------------------------------------------------------
// Host side
// --------------------------------------------------------------------------

// Call f(std::integral_constant<int, R>{}) with the decode body's row count
// R = decode_rows(G) for a group size the decode kernels take (GROUP_SIZES
// in ops/_kernels.py); false for any other.
template <typename F>
inline bool with_rows(int G, F&& f) {
    switch (G) {
        case 1: case 2: case 3: case 4: case 7: case 8: case 16: break;
        default: return false;
    }
    switch (decode_rows(G)) {
        case 1: f(std::integral_constant<int, 1>{}); return true;
        case 2: f(std::integral_constant<int, 2>{}); return true;
        case 4: f(std::integral_constant<int, 4>{}); return true;
        case 8: f(std::integral_constant<int, 8>{}); return true;
        default: f(std::integral_constant<int, 16>{}); return true;
    }
}

// Call f(KVT{}) for the KV type of (quant, head width) the kernels are built
// for — head widths 64, 96, 128 and 256 (HEAD_DIMS); false for any other.
template <typename F>
inline bool with_kv_type(int quant, int head_dim, F&& f) {
    switch (head_dim) {
        case 64: return quant ? f(Int8KV<64>{}) : f(Bf16KV<64>{});
        case 96: return quant ? f(Int8KV<96>{}) : f(Bf16KV<96>{});
        case 128: return quant ? f(Int8KV<128>{}) : f(Bf16KV<128>{});
        case 256: return quant ? f(Int8KV<256>{}) : f(Bf16KV<256>{});
        default: return false;
    }
}

// Launch `kernel`, whose body's shared memory is `SM` (body_smem): as
// dynamic shared memory when it is above the 48 KiB default, after raising
// the function's limit. Returns the attribute call's error (the launch's
// own is read by the caller).
template <typename SM, typename Kernel, typename... Args>
inline cudaError_t launch_with_smem(Kernel kernel, dim3 grid,
                                    cudaStream_t stream, Args... args) {
    constexpr bool dynamic = sizeof(SM) > STATIC_SMEM_MAX;
    constexpr int bytes = dynamic ? static_cast<int>(sizeof(SM)) : 0;
    if constexpr (dynamic) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
        if (err != cudaSuccess) return err;
    }
    kernel<<<grid, NTHREADS, bytes, stream>>>(args...);
    return cudaSuccess;
}

// A body's Smem: a static __shared__ declaration when it fits the 48 KiB
// one may take, else the block's dynamic shared memory (launch_with_smem
// sizes it).
template <typename SM>
__device__ __forceinline__ SM& body_smem() {
    if constexpr (sizeof(SM) <= STATIC_SMEM_MAX) {
        __shared__ SM sm;
        return sm;
    } else {
        extern __shared__ __align__(16) unsigned char smem_raw[];
        return *reinterpret_cast<SM*>(smem_raw);
    }
}

}  // namespace pa
