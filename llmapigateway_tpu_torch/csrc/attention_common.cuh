// Shared pieces of the attention kernels: KV element types, key addressing
// and host dispatch.
//
// The CUDA side of the JAX package's single-copy block update
// (llmapigateway_tpu/ops/flash_attention.py: self_column_init :60,
// attend_block :79) and of the port's plain helpers
// (llmapigateway_tpu_torch/ops/flash_attention.py). The prefill kernels in
// paged_attention.cu and flash_attention.cu are built from prefill_mma_body
// (prefill_mma.cuh: tensor-core tiles over a cp.async ring), the decode
// kernels from split_decode_body (decode_split.cuh: the key range split
// across blocks and a combine pass). Both share what is below.
//
// The kernels differ only in two template parameters of the bodies:
// * how a key's row is found (Rows): PagedRows through the slot's
//   page-table row, PagedRunRows through one table entry per aligned run
//   of pages_per_block logical pages (the packed multi-page table),
//   DenseRows by a row stride in the contiguous cache. A key's scale sits at
//   the same row index in every layout (scales are stored [.., KV, 1, N]
//   beside values [.., KV, N, Dh]).
// * the KV element type (KVT): Bf16KV, or Int8KV with a per-key fp32 scale.
//   Both bodies copy int8 rows raw (half the bytes) and widen them exactly
//   (|q| <= 127 needs 7 bits; bf16 keeps 8); they multiply each score by its
//   key's scale after the Dh^-1/2 factor and before the mask, accumulate l
//   from the UNSCALED probabilities, and multiply each probability by its
//   value's scale in the PV product.
//
// A sliding window (mistral family; HF semantics: key j is visible to the
// query at position i iff i - j < window, the query itself included) is a
// runtime argument: the bodies start their tile walk at the tile holding
// the first key any of their rows can see, so a windowed call reads
// O(window) keys, not O(context). Keys below that floor inside the first
// tile are never read (zero-filled, as past-the-end keys are) and are
// masked. window == 0 is full causal attention.
//
// The head width HD is a template parameter of everything below: the
// kernels are built for the widths of the served presets (HEAD_DIMS: 64 for
// tinyllama and qwen2, 96 for phi-3-mini, 128 for llama-3 and mistral, 256
// for gemma). A body whose shared memory is past the 48 KiB a static
// __shared__ declaration may take runs on DYNAMIC shared memory, after the
// launcher raises the function's limit (body_smem, launch_with_smem).
//
// Decode rows are the G query heads of one KV head. The decode bodies are
// built per row count R (1, 2, 4, 8, 16), and G is a runtime argument: a
// group runs the body of R = G rounded up to a power of two (decode_rows),
// so G 3 (llama-3b-class) and G 7 (qwen2-0.5b) run the 4- and 8-row bodies.
// Rows >= G are zero queries whose state is computed and never written
// back; q and out are addressed with the true G (KV head kv owns query
// heads kv*G .. kv*G + G - 1). The prefill bodies take any G: a block owns
// query rows of one head.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pa {

constexpr int TILE_K = 32;                   // keys per decode tile
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
};

// Signed byte `k` of w, as the bits of its (exact) bf16 value.
__device__ __forceinline__ uint32_t i8_as_bf16(uint32_t w, int k) {
    const int v = static_cast<int>(w << (24 - 8 * k)) >> 24;
    return __float_as_uint(static_cast<float>(v)) >> 16;
}
// Signed bytes k and k + 1 of w as a bf16 pair (byte k in the low half).
__device__ __forceinline__ uint32_t i8x2_as_bf16x2(uint32_t w, int k) {
    return i8_as_bf16(w, k) | (i8_as_bf16(w, k + 1) << 16);
}

template <int HD>
struct Int8KV {
    using elem = int8_t;
    static constexpr int kHD = HD;
    static constexpr bool kQuant = true;
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
// Windows
// --------------------------------------------------------------------------

// The first key position a query at `q_pos` sees under `window` (0: all).
__device__ __forceinline__ int window_floor(int q_pos, int window) {
    return window > 0 ? max(q_pos - (window - 1), 0) : 0;
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
