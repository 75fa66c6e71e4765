// Paged attention kernels for Hopper (sm_90a), fp32 softmax and sums, over a
// bf16 pool or an int8 pool with per-key fp32 scales.
//
// paged_decode_kernel replaces the Pallas TPU kernel paged_decode_attention /
// _paged_decode_kernel (llmapigateway_tpu/ops/paged_attention.py:272, :204):
// one query token per slot against the STALE page pool (ragged by n_stale)
// plus the self column, GQA handled in the kernel, with its two variants:
// a sliding window (stale keys from w0 = max(n_stale - (window - 1), 0)
// only; a slot's splits start at w0's tile, so a windowed decode reads
// O(window) keys and never touches a page below the window, which the SWA
// ring may have recycled) and multi-page blocks (pages_per_block > 1: one
// table lookup per aligned run of pages, PagedRunRows).
//   Bound: bytes. Every live K/V byte is read once (B * n * KV * Dh * 2 * 2
//   in bf16, half that plus 8 bytes of scales a key in int8) and each byte
//   feeds 2*G flops, far below the card's ~295 flop/byte ridge. Design
//   (decode_split.cuh): the slot's key range split across blocks, grid
//   (KV, B, n_split), each block's 32-key tiles streamed through a cp.async
//   ring, warp-parallel scores and softmax, and a combine pass over the
//   splits' partial states; K/V stream from the pool once per group (never
//   repeated per query head).
//
// paged_prefill_kernel replaces paged_prefill_attention /
// _paged_prefill_kernel (:438, :384): a chunk of T queries at positions
// start + t, causal over the pool (the chunk's own keys already inserted,
// and read back quantized under int8).
//   Bound: operations at chunk sizes (4 * T * keys * Dh flops per head
//   against one pass over K/V). Design (prefill_mma.cuh): tensor-core tiles
//   (mma.sync m16n8k16, fp32 accumulate), 64-key K/V tiles streamed through
//   a 2-stage cp.async ring, the online softmax in registers, P·V with P as
//   a bf16 hi + lo pair, the mask only on the tiles that need it, and a 1-D
//   grid that starts the query tiles with the most keys first. The ragged
//   last query tile is masked in the kernel, so T needs no padding. The same
//   window and multi-page variants as decode: a window walks keys from the
//   64-key tile holding the floor of the tile's first query (page live iff
//   (lp + 1) * page - 1 > first_q - window, :404-426).
//
// Both run over PagedRows (ppb 1) or PagedRunRows (ppb > 1), in a bf16 and
// an int8 instantiation for each head width (64, 96, 128, 256) and, for
// decode, each row count (1, 2, 4, 8, 16: groups 1, 2, 3, 4, 7, 8, 16
// rounded up, the group itself a runtime argument); the window is a runtime
// argument. The prefill bodies at Dh 96/128/256 and the Dh 256 bf16 decode
// bodies take dynamic shared memory (past the 48 KiB static limit).
// Each C entry launches on the caller's stream and returns
// cudaGetLastError().
#include "attention_common.cuh"
#include "decode_split.cuh"
#include "prefill_mma.cuh"

using namespace pa;

namespace {

template <int R, typename KVT, typename Rows>
__global__ void __launch_bounds__(NTHREADS) paged_decode_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k_new,
        const bf16* __restrict__ v_new,
        const typename KVT::elem* __restrict__ k_pages,
        const typename KVT::elem* __restrict__ v_pages,
        const float* __restrict__ k_scales,
        const float* __restrict__ v_scales,
        const int* __restrict__ page_table, const int* __restrict__ n_stale,
        bf16* __restrict__ out, float* __restrict__ ws, int B, int G, int KV,
        int page, int NP, float scale, int window, int ppb, int n_split,
        int split_keys) {
    constexpr int HD = KVT::kHD;
    auto& sm = body_smem<SplitSmem<R, KVT>>();
    const int kv = blockIdx.x, b = blockIdx.y;
    // Query heads kv*G .. kv*G+G-1 of slot b are contiguous rows of q
    // [B, H, Dh] and of out [B, H*Dh] (the JAX kernel's qg reshape).
    const long long head0 = ((long long)b * KV + kv) * G;
    const long long self_off = ((long long)b * KV + kv) * HD;
    const Rows rows = Rows::make(page_table + (long long)b * NP, NP, page,
                                 KV, kv, ppb);
    // Live stale keys: [w0, n_stale[b]), never past the table's reach; the
    // query sits at position n_stale[b].
    const int n = min(n_stale[b], NP * page);
    const int w0 = window_floor(n_stale[b], window);
    split_decode_body<R, KVT>(
        sm, G, q + head0 * HD, k_new + self_off, v_new + self_off, k_pages,
        v_pages, k_scales, v_scales, rows, w0, n, scale, n_split, split_keys,
        out + head0 * HD, SplitParts(ws, B, KV, G, HD, n_split, b, kv));
}

template <typename KVT, typename Rows>
__global__ void __launch_bounds__(NTHREADS) paged_prefill_kernel(
        const bf16* __restrict__ q,
        const typename KVT::elem* __restrict__ k_pages,
        const typename KVT::elem* __restrict__ v_pages,
        const float* __restrict__ k_scales,
        const float* __restrict__ v_scales,
        const int* __restrict__ page_table, const int* __restrict__ start,
        bf16* __restrict__ out, int B, int T, int H, int KV, int page, int NP,
        float scale, int window, int ppb) {
    constexpr int HD = KVT::kHD, BQ = PrefillGeo<KVT>::BQ;
    auto& sm = body_smem<PrefillTiles<KVT>>();
    const PrefillBlock blk = prefill_block((T + BQ - 1) / BQ, H, B);
    const int t0 = blk.tile * BQ, h = blk.h, b = blk.b;
    const int kv = h / (H / KV);
    const int rows_in_tile = min(BQ, T - t0);       // ragged last tile
    // q and out are [B, T, H, Dh]: consecutive positions H*Dh apart.
    const long long stride = (long long)H * HD;
    const long long row0 = ((long long)b * T + t0) * stride
                           + (long long)h * HD;
    const int first_q = start[b] + t0;
    const int n_keys = min(first_q + rows_in_tile, NP * page);
    const Rows rows = Rows::make(page_table + (long long)b * NP, NP, page,
                                 KV, kv, ppb);
    prefill_mma_body<KVT>(sm, q + row0, stride, rows_in_tile, first_q,
                          n_keys, window, k_pages, v_pages, k_scales,
                          v_scales, rows, scale, out + row0);
}

// The partial pass over grid (KV, B, n_split), then (n_split > 1) the
// combine; `err` takes the first launch error. False for a group the
// kernels are not built for.
template <typename KVT, typename Rows>
bool launch_decode(const void* q, const void* k_new, const void* v_new,
                   const void* k, const void* v, const void* ks,
                   const void* vs, const void* page_table,
                   const void* n_stale, void* out, void* ws, int B, int G,
                   int KV, int page, int NP, float scale, int window, int ppb,
                   int n_split, int split_keys, cudaStream_t stream,
                   cudaError_t& err) {
    using E = typename KVT::elem;
    const bool ok = with_rows(G, [&](auto r) {
        constexpr int R = decltype(r)::value;
        err = launch_with_smem<SplitSmem<R, KVT>>(
            paged_decode_kernel<R, KVT, Rows>, dim3(KV, B, n_split), stream,
            static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
            static_cast<const bf16*>(v_new), static_cast<const E*>(k),
            static_cast<const E*>(v), static_cast<const float*>(ks),
            static_cast<const float*>(vs),
            static_cast<const int*>(page_table),
            static_cast<const int*>(n_stale), static_cast<bf16*>(out),
            static_cast<float*>(ws), B, G, KV, page, NP, scale, window, ppb,
            n_split, split_keys);
    });
    if (ok && err == cudaSuccess && n_split > 1)
        err = launch_combine<KVT::kHD>(ws, n_stale, out, B, G, KV, NP * page,
                                       window, n_split, split_keys, stream);
    return ok;
}

// Returns the error of a refused attribute call for a body above 48 KiB of
// shared memory (the launch's own error is read by the C entry).
template <typename KVT, typename Rows>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs,
                           const void* page_table, const void* start,
                           void* out, int B, int T, int H, int KV, int page,
                           int NP, float scale, int window, int ppb,
                           cudaStream_t stream) {
    using E = typename KVT::elem;
    constexpr int BQ = PrefillGeo<KVT>::BQ;
    const dim3 grid((T + BQ - 1) / BQ * H * B);
    return launch_with_smem<PrefillTiles<KVT>>(
        paged_prefill_kernel<KVT, Rows>, grid, stream,
        static_cast<const bf16*>(q), static_cast<const E*>(k),
        static_cast<const E*>(v), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const int*>(page_table),
        static_cast<const int*>(start), static_cast<bf16*>(out), B, T, H, KV,
        page, NP, scale, window, ppb);
}

// The body for (KV type and head width, pages_per_block): PagedRows reads
// one table entry per page, PagedRunRows one per aligned run of ppb pages.
// False for a head width the kernels are not built for.
template <typename F>
bool with_body(int quant, int head_dim, int ppb, F&& f) {
    return with_kv_type(quant, head_dim, [&](auto kvt) {
        return ppb == 1 ? f(kvt, PagedRows{}) : f(kvt, PagedRunRows{});
    });
}

}  // namespace

// The geometry both entries refuse: a window below 0, a run length below
// 1, or a table width that does not split into whole runs.
static bool bad_variant(int window, int ppb, int NP) {
    return window < 0 || ppb < 1 || NP % ppb != 0;
}

// k/v: the pools (bf16, or int8 when `quant`); ks/vs: the int8 scales
// [P, KV, 1, page] (ignored for bf16); window: 0 or the sliding window;
// ppb: pages_per_block (the table must be packed in runs of ppb); n_split,
// split_keys: the key split (ops/_kernels.py decode_splits), which must
// cover decode_extent(NP * page, window); ws: the fp32 workspace of
// B * KV * n_split * G * (head_dim + 2) floats (null for one split).
extern "C" int paged_decode_attention(
        const void* q, const void* k_new, const void* v_new, const void* k,
        const void* v, const void* ks, const void* vs,
        const void* page_table, const void* n_stale, void* out, void* ws,
        int B, int H, int KV, int head_dim, int page, int NP, float scale,
        int quant, int window, int ppb, int n_split, int split_keys,
        void* stream) {
    if (B < 0 || KV <= 0 || H % KV != 0 || page <= 0 || NP <= 0 ||
        bad_variant(window, ppb, NP) ||
        bad_split(n_split, split_keys,
                  decode_extent((long long)NP * page, window), ws))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    const bool ok = with_body(quant, head_dim, ppb, [&](auto kvt, auto rows) {
        return launch_decode<decltype(kvt), decltype(rows)>(
            q, k_new, v_new, k, v, ks, vs, page_table, n_stale, out, ws, B,
            H / KV, KV, page, NP, scale, window, ppb, n_split, split_keys, s,
            err);
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int paged_prefill_attention(
        const void* q, const void* k, const void* v, const void* ks,
        const void* vs, const void* page_table, const void* start, void* out,
        int B, int T, int H, int KV, int head_dim, int page, int NP,
        float scale, int quant, int window, int ppb, void* stream) {
    if (B < 0 || T < 0 || KV <= 0 || H % KV != 0 || page <= 0 || NP <= 0 ||
        bad_variant(window, ppb, NP))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || T == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    const bool ok = with_body(quant, head_dim, ppb, [&](auto kvt, auto rows) {
        err = launch_prefill<decltype(kvt), decltype(rows)>(
            q, k, v, ks, vs, page_table, start, out, B, T, H, KV, page, NP,
            scale, window, ppb, s);
        return true;
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* paged_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
