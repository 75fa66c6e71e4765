// Shared online-softmax block math of the paged attention kernels.
//
// The CUDA twin of the JAX package's single-copy block update
// (llmapigateway_tpu/ops/flash_attention.py: self_column_init :60,
// attend_block :79) and of the port's plain helpers
// (llmapigateway_tpu_torch/ops/flash_attention.py). Both kernels in
// paged_attention.cu are built from these functions: a thread block owns R
// query rows (decode: the G query heads of one KV head; prefill: a tile of
// query positions of one head), keeps their fp32 state m/l in shared memory
// and acc in registers, and walks the keys in shared-memory tiles of
// TILE_K tokens read from the page pool through the slot's page table.
//
// Shared-memory rows hold HEAD_DIM bf16 values as PAIRS 32-bit words padded
// to ROW_WORDS words, so a warp reading one column across 32 rows hits 32
// different banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pa {

constexpr int HEAD_DIM = 128;
constexpr int PAIRS = HEAD_DIM / 2;          // bf16x2 words per row
constexpr int ROW_WORDS = PAIRS + 1;         // padded shared-memory row
constexpr int CHUNKS = HEAD_DIM / 8;         // 16-byte chunks per row
constexpr int TILE_K = 32;                   // keys per shared-memory tile
constexpr int NTHREADS = 128;
constexpr float NEG_INF = -1e30f;            // finite, as in the Pallas kernels

__device__ __forceinline__ float bf16_lo(uint32_t w) {
    return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
    return __uint_as_float(w & 0xffff0000u);
}

// One 16-byte chunk of a row into its padded shared-memory slot.
__device__ __forceinline__ void store_chunk(uint32_t* row, int c, uint4 v) {
    row[c * 4 + 0] = v.x;
    row[c * 4 + 1] = v.y;
    row[c * 4 + 2] = v.z;
    row[c * 4 + 3] = v.w;
}

// Load `n_rows` rows of HEAD_DIM bf16 (row r at src + r * stride elements,
// 16-byte aligned) into padded shared memory; rows >= n_valid are zeroed.
__device__ __forceinline__ void load_rows(const __nv_bfloat16* src,
                                          long long stride, int n_valid,
                                          int n_rows, uint32_t* dst) {
    for (int i = threadIdx.x; i < n_rows * CHUNKS; i += NTHREADS) {
        const int r = i / CHUNKS, c = i % CHUNKS;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (r < n_valid)
            v = __ldg(reinterpret_cast<const uint4*>(src + r * stride) + c);
        store_chunk(dst + r * ROW_WORDS, c, v);
    }
}

// Load the K and V tile of keys [pos0, pos0 + TILE_K) of one KV head from
// the page pool [P, KV, page, HEAD_DIM]. The block reads its own page-table
// row (there is no scalar prefetch on the GPU). Keys at or past `limit`, and
// keys whose logical page is past the table, are zeroed and never read from
// the pool — an unallocated table entry (0, the trash page) is never
// dereferenced for a live position.
__device__ __forceinline__ void load_kv_tile(
        const __nv_bfloat16* k_pages, const __nv_bfloat16* v_pages,
        const int* table_row, int NP, int page, int KV, int kv, int pos0,
        int limit, uint32_t* k_s, uint32_t* v_s) {
    for (int i = threadIdx.x; i < TILE_K * CHUNKS; i += NTHREADS) {
        const int r = i / CHUNKS, c = i % CHUNKS;
        const int pos = pos0 + r;
        uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
        const int lp = pos / page;
        if (pos < limit && lp < NP) {
            const long long phys = table_row[lp];
            const long long off =
                ((phys * KV + kv) * page + (pos - lp * page)) * HEAD_DIM;
            kv4 = __ldg(reinterpret_cast<const uint4*>(k_pages + off) + c);
            vv4 = __ldg(reinterpret_cast<const uint4*>(v_pages + off) + c);
        }
        store_chunk(k_s + r * ROW_WORDS, c, kv4);
        store_chunk(v_s + r * ROW_WORDS, c, vv4);
    }
}

// Per-thread slice of the R x HEAD_DIM fp32 accumulator: thread t owns row
// t / TPR and the bf16 pairs lane, lane + TPR, ... of it.
template <int R>
struct RowAcc {
    static constexpr int TPR = NTHREADS / R;                  // threads per row
    static constexpr int NPAIR = (PAIRS + TPR - 1) / TPR;     // pairs per thread
    static_assert(NTHREADS % R == 0, "rows must divide the block");
    float x[NPAIR], y[NPAIR];

    __device__ __forceinline__ int row() const { return threadIdx.x / TPR; }
    __device__ __forceinline__ int pair(int i) const {
        return threadIdx.x % TPR + i * TPR;
    }
};

// self_column_init: seed the state from the new token attending itself —
// m = q . k_new * scale, l = 1, acc = v_new. The stale pool does not hold
// the current token (deferred insert), so its contribution starts here.
template <int R>
__device__ __forceinline__ void self_column_init(
        const uint32_t* q_s, const __nv_bfloat16* k_new,
        const __nv_bfloat16* v_new, float scale, float* m_s, float* l_s,
        RowAcc<R>& acc) {
    const uint32_t* kn = reinterpret_cast<const uint32_t*>(k_new);
    const uint32_t* vn = reinterpret_cast<const uint32_t*>(v_new);
    for (int r = threadIdx.x; r < R; r += NTHREADS) {
        float s = 0.f;
        for (int p = 0; p < PAIRS; ++p) {
            const uint32_t qw = q_s[r * ROW_WORDS + p], kw = kn[p];
            s += bf16_lo(qw) * bf16_lo(kw) + bf16_hi(qw) * bf16_hi(kw);
        }
        m_s[r] = s * scale;
        l_s[r] = 1.f;
    }
#pragma unroll
    for (int i = 0; i < RowAcc<R>::NPAIR; ++i) {
        const int p = acc.pair(i);
        const uint32_t w = p < PAIRS ? vn[p] : 0u;
        acc.x[i] = bf16_lo(w);
        acc.y[i] = bf16_hi(w);
    }
}

// Scores of the R query rows against the TILE_K keys of the tile, scaled,
// with the caller's mask: s_s[r][j] = visible(r, j) ? q.k * scale : NEG_INF.
template <int R, typename Visible>
__device__ __forceinline__ void tile_scores(const uint32_t* q_s,
                                            const uint32_t* k_s, float scale,
                                            float* s_s, Visible visible) {
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
        s_s[r * (TILE_K + 1) + j] = visible(r, j) ? s * scale : NEG_INF;
    }
}

// attend_block: the online-softmax update for one tile.
//   m_new = max(m, max_j s), alpha = exp(m - m_new), e_j = exp(s_j - m_new)
//   l = alpha * l + sum_j e_j,  acc = alpha * acc + sum_j e_j v_j
// Row statistics run one thread per row and leave e_j in s_s and alpha in
// alpha_s; then every thread updates its slice of acc from the V tile.
// Starts after the caller's barrier over s_s; ends with a barrier-free PV.
template <int R>
__device__ __forceinline__ void attend_block(float* s_s, const uint32_t* v_s,
                                             float* m_s, float* l_s,
                                             float* alpha_s, RowAcc<R>& acc) {
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
    for (int i = 0; i < RowAcc<R>::NPAIR; ++i) {
        acc.x[i] *= alpha;
        acc.y[i] *= alpha;
    }
    for (int j = 0; j < TILE_K; ++j) {
        const float e = er[j];
        const uint32_t* vr = v_s + j * ROW_WORDS;
#pragma unroll
        for (int i = 0; i < RowAcc<R>::NPAIR; ++i) {
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
// bf16, into the row's HEAD_DIM outputs at `dst`.
template <int R>
__device__ __forceinline__ void write_row(const RowAcc<R>& acc,
                                          const float* l_s,
                                          __nv_bfloat16* dst) {
    const float l0 = l_s[acc.row()];
    const float l = l0 == 0.f ? 1.f : l0;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst);
#pragma unroll
    for (int i = 0; i < RowAcc<R>::NPAIR; ++i) {
        const int p = acc.pair(i);
        if (p < PAIRS)
            out[p] = __floats2bfloat162_rn(acc.x[i] / l, acc.y[i] / l);
    }
}

}  // namespace pa
