// Flash attention kernels over the contiguous head-major KV cache for Hopper
// (sm_90a), fp32 softmax and sums, over a bf16 cache or an int8 cache with
// per-key fp32 scales.
//
// flash_decode_kernel replaces the Pallas TPU kernel flash_decode_attention /
// _decode_kernel (llmapigateway_tpu/ops/flash_attention.py:186, :147): one
// query token per slot against its row of the STALE cache [Bc, KV, S, Dh]
// (ragged by n_stale) plus the self column, GQA inside the kernel.
//   Bound: bytes, as the paged decode kernel's (every live K/V byte read
//   once; 2*G flops a byte). Design: the paged decode kernel's split body
//   (decode_split.cuh: the key range split across blocks, a cp.async ring,
//   warp-parallel math, a combine pass), with keys found by a row stride
//   instead of a page table, nothing past n_stale read. The Pallas kernel's
//   BlockSpec clamp that elides dead blocks' DMA becomes the split's bounds
//   — at both ends under a sliding window (keys from w0 = max(n_stale -
//   (window - 1), 0), :160-176), so a windowed decode reads O(window) keys of
//   the row, not O(context).
//
// flash_prefill_kernel replaces flash_prefill_attention / _prefill_kernel
// (:329, :282): a chunk of T queries at positions start + t, causal over the
// cache row (the chunk's own keys already inserted, read back quantized under
// int8).
//   Bound: operations at chunk sizes. Design: the paged prefill kernel's
//   body (prefill_mma.cuh: mma.sync tiles, a cp.async ring of 64-key tiles,
//   register softmax, P·V with P as a bf16 hi + lo pair, heaviest query
//   tiles first) over the cache row; with a window, from the 64-key tile
//   holding the floor of the tile's first query (:300-317). Positions past
//   the cache extent S hold no keys: a query there sees all S keys and is
//   the caller's pad.
//
// Both kernels take an optional row map `rows` [B] (nullptr: row b): query
// row b reads cache row rows[b], so the engine's prefill of K slots works on
// the [B_slots, ...] cache in place. Both are the shared bodies
// (decode_split.cuh, prefill_mma.cuh) over DenseRows, in a bf16 and an int8
// instantiation for each head width (64, 96, 128, 256) and, for decode, each
// row count (1, 2, 4, 8, 16: groups 1, 2, 3, 4, 7, 8, 16 rounded up, the
// group itself a runtime argument); the prefill bodies at Dh 96/128/256 and
// the Dh 256 bf16 decode bodies take dynamic shared memory (past the 48 KiB
// static limit).
// Each C entry launches on the caller's stream and returns
// cudaGetLastError().
#include "attention_common.cuh"
#include "decode_split.cuh"
#include "prefill_mma.cuh"

using namespace pa;

namespace {

template <int R, typename KVT>
__global__ void __launch_bounds__(NTHREADS) flash_decode_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ k_new,
        const bf16* __restrict__ v_new,
        const typename KVT::elem* __restrict__ k,
        const typename KVT::elem* __restrict__ v,
        const float* __restrict__ k_scales,
        const float* __restrict__ v_scales, const int* __restrict__ row_map,
        const int* __restrict__ n_stale, bf16* __restrict__ out,
        float* __restrict__ ws, int B, int G, int KV, int S, float scale,
        int window, int n_split, int split_keys) {
    constexpr int HD = KVT::kHD;
    auto& sm = body_smem<SplitSmem<R, KVT>>();
    const int kv = blockIdx.x, b = blockIdx.y;
    const long long head0 = ((long long)b * KV + kv) * G;
    const long long self_off = ((long long)b * KV + kv) * HD;
    const long long row = row_map ? row_map[b] : b;
    const DenseRows rows{(row * KV + kv) * S, S};
    const int n = min(n_stale[b], S);
    const int w0 = window_floor(n_stale[b], window);
    split_decode_body<R, KVT>(
        sm, G, q + head0 * HD, k_new + self_off, v_new + self_off, k, v,
        k_scales, v_scales, rows, w0, n, scale, n_split, split_keys,
        out + head0 * HD, SplitParts(ws, B, KV, G, HD, n_split, b, kv));
}

template <typename KVT>
__global__ void __launch_bounds__(NTHREADS) flash_prefill_kernel(
        const bf16* __restrict__ q, const typename KVT::elem* __restrict__ k,
        const typename KVT::elem* __restrict__ v,
        const float* __restrict__ k_scales,
        const float* __restrict__ v_scales, const int* __restrict__ row_map,
        const int* __restrict__ start, bf16* __restrict__ out, int B, int T,
        int H, int KV, int S, float scale, int window) {
    constexpr int HD = KVT::kHD, BQ = PrefillGeo<KVT>::BQ;
    auto& sm = body_smem<PrefillTiles<KVT>>();
    const PrefillBlock blk = prefill_block((T + BQ - 1) / BQ, H, B);
    const int t0 = blk.tile * BQ, h = blk.h, b = blk.b;
    const int kv = h / (H / KV);
    const int rows_in_tile = min(BQ, T - t0);       // ragged last tile
    const long long stride = (long long)H * HD;
    const long long q0 = ((long long)b * T + t0) * stride
                         + (long long)h * HD;
    const int first_q = start[b] + t0;
    const int n_keys = min(first_q + rows_in_tile, S);
    const long long row = row_map ? row_map[b] : b;
    const DenseRows rows{(row * KV + kv) * S, S};
    prefill_mma_body<KVT>(sm, q + q0, stride, rows_in_tile, first_q, n_keys,
                          window, k, v, k_scales, v_scales, rows, scale,
                          out + q0);
}

// The partial pass over grid (KV, B, n_split), then (n_split > 1) the
// combine; `err` takes the first launch error. False for a group the
// kernels are not built for.
template <typename KVT>
bool launch_decode(const void* q, const void* k_new, const void* v_new,
                   const void* k, const void* v, const void* ks,
                   const void* vs, const void* row_map, const void* n_stale,
                   void* out, void* ws, int B, int G, int KV, int S,
                   float scale, int window, int n_split, int split_keys,
                   cudaStream_t stream, cudaError_t& err) {
    using E = typename KVT::elem;
    const bool ok = with_rows(G, [&](auto r) {
        constexpr int R = decltype(r)::value;
        err = launch_with_smem<SplitSmem<R, KVT>>(
            flash_decode_kernel<R, KVT>, dim3(KV, B, n_split), stream,
            static_cast<const bf16*>(q), static_cast<const bf16*>(k_new),
            static_cast<const bf16*>(v_new), static_cast<const E*>(k),
            static_cast<const E*>(v), static_cast<const float*>(ks),
            static_cast<const float*>(vs), static_cast<const int*>(row_map),
            static_cast<const int*>(n_stale), static_cast<bf16*>(out),
            static_cast<float*>(ws), B, G, KV, S, scale, window, n_split,
            split_keys);
    });
    if (ok && err == cudaSuccess && n_split > 1)
        err = launch_combine<KVT::kHD>(ws, n_stale, out, B, G, KV, S, window,
                                       n_split, split_keys, stream);
    return ok;
}

// Returns the error of a refused attribute call for a body above 48 KiB of
// shared memory (the launch's own error is read by the C entry).
template <typename KVT>
cudaError_t launch_prefill(const void* q, const void* k, const void* v,
                           const void* ks, const void* vs,
                           const void* row_map, const void* start, void* out,
                           int B, int T, int H, int KV, int S, float scale,
                           int window, cudaStream_t stream) {
    using E = typename KVT::elem;
    constexpr int BQ = PrefillGeo<KVT>::BQ;
    const dim3 grid((T + BQ - 1) / BQ * H * B);
    return launch_with_smem<PrefillTiles<KVT>>(
        flash_prefill_kernel<KVT>, grid, stream, static_cast<const bf16*>(q),
        static_cast<const E*>(k), static_cast<const E*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs),
        static_cast<const int*>(row_map), static_cast<const int*>(start),
        static_cast<bf16*>(out), B, T, H, KV, S, scale, window);
}

}  // namespace

// k/v: the cache layer [Bc, KV, S, Dh] (bf16, or int8 when `quant`); ks/vs:
// the int8 scales [Bc, KV, 1, S] (ignored for bf16); row_map: [B] or null;
// window: 0 or the sliding window; n_split, split_keys: the key split
// (ops/_kernels.py decode_splits), which must cover decode_extent(S,
// window); ws: the fp32 workspace of B * KV * n_split * G * (head_dim + 2)
// floats (null for one split).
extern "C" int flash_decode_attention(
        const void* q, const void* k_new, const void* v_new, const void* k,
        const void* v, const void* ks, const void* vs, const void* row_map,
        const void* n_stale, void* out, void* ws, int B, int H, int KV,
        int head_dim, int S, float scale, int quant, int window, int n_split,
        int split_keys, void* stream) {
    if (B < 0 || KV <= 0 || H % KV != 0 || S < 0 || window < 0 ||
        bad_split(n_split, split_keys, decode_extent(S, window), ws))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    const bool ok = with_kv_type(quant, head_dim, [&](auto kvt) {
        return launch_decode<decltype(kvt)>(q, k_new, v_new, k, v, ks, vs,
                                            row_map, n_stale, out, ws, B,
                                            H / KV, KV, S, scale, window,
                                            n_split, split_keys, s, err);
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_prefill_attention(
        const void* q, const void* k, const void* v, const void* ks,
        const void* vs, const void* row_map, const void* start, void* out,
        int B, int T, int H, int KV, int head_dim, int S, float scale,
        int quant, int window, void* stream) {
    if (B < 0 || T < 0 || KV <= 0 || H % KV != 0 || S < 0 || window < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || T == 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaSuccess;
    const bool ok = with_kv_type(quant, head_dim, [&](auto kvt) {
        err = launch_prefill<decltype(kvt)>(q, k, v, ks, vs, row_map, start,
                                            out, B, T, H, KV, S, scale,
                                            window, s);
        return true;
    });
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
