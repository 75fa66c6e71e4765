// Paged attention kernels for Hopper (sm_90a), bf16 pools, fp32 math.
//
// paged_decode_kernel replaces the Pallas TPU kernel paged_decode_attention /
// _paged_decode_kernel (llmapigateway_tpu/ops/paged_attention.py:272, :204):
// one query token per slot against the STALE page pool (ragged by n_stale)
// plus the self column, GQA handled in the kernel.
//   Bound: bytes. Every live K/V byte is read once (B * n * KV * Dh * 2 * 2)
//   and each byte feeds 2*G flops, far below the card's ~295 flop/byte
//   ridge. Design: one block per (KV head, slot) keeps its G query rows in
//   shared memory, so K/V stream from the pool exactly once per group (never
//   repeated per query head); 16-byte coalesced loads of 32-key tiles
//   through the slot's page table; only live keys are read. Known weakness:
//   B * KV blocks (64 at batch 8 for llama-3-8b) underfill 132 SMs, and a
//   tile's loads do not overlap its math (no split of the key range across
//   blocks, no cp.async/TMA pipeline yet).
//
// paged_prefill_kernel replaces paged_prefill_attention /
// _paged_prefill_kernel (:438, :384): a chunk of T queries at positions
// start + t, causal over the pool (the chunk's own keys already inserted).
//   Bound: operations at chunk sizes (2 * T * keys * Dh * 2 flops per head
//   against one pass over K/V). Design: one block per (64-query tile, head,
//   slot), keys in 32-key shared-memory tiles up to the tile's causal bound,
//   per-element causal mask, fp32 FMA (no tensor cores yet: mma/wgmma, TMA
//   and split-K are later work). The ragged last query tile is masked in the
//   kernel, so T needs no padding.
//
// Both are built from the shared block math in attention_common.cuh. Each C
// entry launches on the caller's stream and returns cudaGetLastError().
#include "attention_common.cuh"

using namespace pa;

namespace {

constexpr int TILE_Q = 64;     // query rows per prefill block

template <int G>
__global__ void __launch_bounds__(NTHREADS) paged_decode_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k_new,
        const __nv_bfloat16* __restrict__ v_new,
        const __nv_bfloat16* __restrict__ k_pages,
        const __nv_bfloat16* __restrict__ v_pages,
        const int* __restrict__ page_table, const int* __restrict__ n_stale,
        __nv_bfloat16* __restrict__ out, int KV, int page, int NP,
        float scale) {
    __shared__ uint32_t q_s[G * ROW_WORDS];
    __shared__ uint32_t k_s[TILE_K * ROW_WORDS];
    __shared__ uint32_t v_s[TILE_K * ROW_WORDS];
    __shared__ float s_s[G * (TILE_K + 1)];
    __shared__ float m_s[G], l_s[G], alpha_s[G];

    const int kv = blockIdx.x, b = blockIdx.y;
    // Query heads kv*G .. kv*G+G-1 of slot b are contiguous rows of q
    // [B, H, Dh] and of out [B, H*Dh] (the JAX kernel's qg reshape).
    const long long head0 = (long long)b * KV * G + (long long)kv * G;
    load_rows(q + head0 * HEAD_DIM, HEAD_DIM, G, G, q_s);
    __syncthreads();

    RowAcc<G> acc;
    const long long self_off = ((long long)b * KV + kv) * HEAD_DIM;
    self_column_init<G>(q_s, k_new + self_off, v_new + self_off, scale, m_s,
                        l_s, acc);

    // Live stale keys: [0, n_stale[b]), never past the table's reach.
    const int n = min(n_stale[b], NP * page);
    const int* table_row = page_table + (long long)b * NP;
    for (int pos0 = 0; pos0 < n; pos0 += TILE_K) {
        __syncthreads();    // the previous tile's readers are done
        load_kv_tile(k_pages, v_pages, table_row, NP, page, KV, kv, pos0, n,
                     k_s, v_s);
        __syncthreads();
        tile_scores<G>(q_s, k_s, scale, s_s,
                       [=](int, int j) { return pos0 + j < n; });
        __syncthreads();
        attend_block<G>(s_s, v_s, m_s, l_s, alpha_s, acc);
    }
    __syncthreads();
    write_row<G>(acc, l_s, out + (head0 + acc.row()) * HEAD_DIM);
}

__global__ void __launch_bounds__(NTHREADS) paged_prefill_kernel(
        const __nv_bfloat16* __restrict__ q,
        const __nv_bfloat16* __restrict__ k_pages,
        const __nv_bfloat16* __restrict__ v_pages,
        const int* __restrict__ page_table, const int* __restrict__ start,
        __nv_bfloat16* __restrict__ out, int T, int H, int KV, int page,
        int NP, float scale) {
    __shared__ uint32_t q_s[TILE_Q * ROW_WORDS];
    __shared__ uint32_t k_s[TILE_K * ROW_WORDS];
    __shared__ uint32_t v_s[TILE_K * ROW_WORDS];
    __shared__ float s_s[TILE_Q * (TILE_K + 1)];
    __shared__ float m_s[TILE_Q], l_s[TILE_Q], alpha_s[TILE_Q];

    const int t0 = blockIdx.x * TILE_Q, h = blockIdx.y, b = blockIdx.z;
    const int kv = h / (H / KV);
    const int rows = min(TILE_Q, T - t0);          // ragged last tile
    // q and out are [B, T, H, Dh]: consecutive positions H*Dh apart.
    const long long stride = (long long)H * HEAD_DIM;
    const long long row0 = ((long long)b * T + t0) * stride
                           + (long long)h * HEAD_DIM;
    load_rows(q + row0, stride, rows, TILE_Q, q_s);
    for (int r = threadIdx.x; r < TILE_Q; r += NTHREADS) {
        m_s[r] = NEG_INF;
        l_s[r] = 0.f;
    }
    RowAcc<TILE_Q> acc;
#pragma unroll
    for (int i = 0; i < RowAcc<TILE_Q>::NPAIR; ++i) acc.x[i] = acc.y[i] = 0.f;

    // Query row r sits at position first_q + r and sees keys s <= first_q + r;
    // the tile's last query bounds the keys walked (pages past it skipped).
    const int first_q = start[b] + t0;
    const int n_keys = min(first_q + rows, NP * page);
    const int* table_row = page_table + (long long)b * NP;
    for (int pos0 = 0; pos0 < n_keys; pos0 += TILE_K) {
        __syncthreads();
        load_kv_tile(k_pages, v_pages, table_row, NP, page, KV, kv, pos0,
                     n_keys, k_s, v_s);
        __syncthreads();
        tile_scores<TILE_Q>(q_s, k_s, scale, s_s, [=](int r, int j) {
            const int s = pos0 + j;
            return r < rows && s < n_keys && s <= first_q + r;
        });
        __syncthreads();
        attend_block<TILE_Q>(s_s, v_s, m_s, l_s, alpha_s, acc);
    }
    __syncthreads();
    if (acc.row() < rows)
        write_row<TILE_Q>(acc, l_s, out + row0 + acc.row() * stride);
}

template <int G>
void launch_decode(const void* q, const void* k_new, const void* v_new,
                   const void* k_pages, const void* v_pages,
                   const void* page_table, const void* n_stale, void* out,
                   int B, int KV, int page, int NP, float scale,
                   cudaStream_t stream) {
    paged_decode_kernel<G><<<dim3(KV, B), NTHREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_new),
        static_cast<const __nv_bfloat16*>(v_new),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages),
        static_cast<const int*>(page_table),
        static_cast<const int*>(n_stale),
        static_cast<__nv_bfloat16*>(out), KV, page, NP, scale);
}

}  // namespace

extern "C" int paged_decode_attention_bf16(
        const void* q, const void* k_new, const void* v_new,
        const void* k_pages, const void* v_pages, const void* page_table,
        const void* n_stale, void* out, int B, int H, int KV, int head_dim,
        int page, int NP, float scale, void* stream) {
    if (head_dim != HEAD_DIM || B < 0 || KV <= 0 || H % KV != 0 ||
        page <= 0 || NP <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (H / KV) {
        case 1: launch_decode<1>(q, k_new, v_new, k_pages, v_pages, page_table,
                                 n_stale, out, B, KV, page, NP, scale, s);
                break;
        case 2: launch_decode<2>(q, k_new, v_new, k_pages, v_pages, page_table,
                                 n_stale, out, B, KV, page, NP, scale, s);
                break;
        case 4: launch_decode<4>(q, k_new, v_new, k_pages, v_pages, page_table,
                                 n_stale, out, B, KV, page, NP, scale, s);
                break;
        case 8: launch_decode<8>(q, k_new, v_new, k_pages, v_pages, page_table,
                                 n_stale, out, B, KV, page, NP, scale, s);
                break;
        case 16: launch_decode<16>(q, k_new, v_new, k_pages, v_pages,
                                   page_table, n_stale, out, B, KV, page, NP,
                                   scale, s);
                 break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

extern "C" int paged_prefill_attention_bf16(
        const void* q, const void* k_pages, const void* v_pages,
        const void* page_table, const void* start, void* out, int B, int T,
        int H, int KV, int head_dim, int page, int NP, float scale,
        void* stream) {
    if (head_dim != HEAD_DIM || B < 0 || T < 0 || KV <= 0 || H % KV != 0 ||
        page <= 0 || NP <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || T == 0) return 0;
    const dim3 grid((T + TILE_Q - 1) / TILE_Q, H, B);
    paged_prefill_kernel<<<grid, NTHREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pages),
        static_cast<const __nv_bfloat16*>(v_pages),
        static_cast<const int*>(page_table), static_cast<const int*>(start),
        static_cast<__nv_bfloat16*>(out), T, H, KV, page, NP, scale);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pa_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
