// W4A8 product for Hopper (sm_90a): int8 activations times packed int4
// weights, summed exactly in int32, rescaled in fp32 — the int4 layer
// projections of ``quant: "int4"`` (models/quant.py ``mm``, ``moe_mm_dense``,
// ``moe_mm_batched``).
//
// Replaces no Pallas kernel. The JAX package leaves this product to XLA: a
// mixed s8 x s4 ``dot_general`` with an int32 accumulator
// (llmapigateway_tpu/models/quant.py:36-40 and the dots at :171, :185,
// :199). PyTorch has no call that takes packed int4 weights, so the port
// writes it by hand.
//
//   out[e, m, n] = float(sum_k xq[e, m, k] * wq[e, n, k]) * xs[e, m] * ws[e, n]
//
// rounded once to the output type (bf16, fp16 or fp32); a debug mode
// writes the int32 sums themselves. The weight of expert e is stored
// N-major and packed two levels a byte: byte j of row n holds level k = 2j
// in its low nibble and k = 2j + 1 in its high nibble, each a two's-
// complement nibble in [-7, 7] (ops/quant_mm.py ``pack_int4``).
//
//   Bound. At decode (M of 1 to 32 rows) the packed weight bytes, N * K / 2
//   an expert, over the published 3.35 TB/s of an H100 SXM; at prefill (M
//   512) the int8 operations 2 * M * N * K over its 1979 TOP/s. The
//   design aims at the first: one warp owns NPW output channels and its 32
//   lanes stride the contraction 32 levels each, so every weight load is a
//   16-byte read and a warp reads 512 contiguous bytes of a row; the
//   nibbles are unpacked in registers (two byte permutes a word) and summed
//   with dp4a, and each unpacked chunk serves MR rows (up to 8) of
//   activations read through L1. A block of WARPS warps covers WARPS * NPW
//   channels; the grid
//   is (channel blocks, row groups of MR, experts), the expert batch taken
//   through strides (a stride of 0 shares one activation block among all
//   experts). The sums of a warp meet by shuffles and the epilogue applies
//   both scales. dp4a runs on the integer pipe, not the tensor cores, so a
//   prefill-sized product runs far from its operations bound: that is a
//   later kernel's work (mma.sync s8 on unpacked tiles).
//
// The C entry launches on the caller's stream and returns
// cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int NTHREADS = WARPS * 32;
constexpr int NPW = 2;                 // output channels a warp owns
constexpr int LANE_K = 32;             // levels a lane sums per step
constexpr int WARP_K = 32 * LANE_K;    // levels a warp covers per step

enum OutType { OUT_F32 = 0, OUT_BF16 = 1, OUT_F16 = 2, OUT_ACC = 3 };

// Four packed bytes (eight levels k0..k7) -> two words of four signed
// bytes each, in k order.
__device__ __forceinline__ void unpack8(uint32_t w, int& a, int& b) {
    uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;          // k0 k2 k4 k6
    uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;   // k1 k3 k5 k7
    lo = __vsub4(lo, 0x08080808u);                           // sign-extend
    hi = __vsub4(hi, 0x08080808u);
    a = static_cast<int>(__byte_perm(lo, hi, 0x5140));      // k0 k1 k2 k3
    b = static_cast<int>(__byte_perm(lo, hi, 0x7362));      // k4 k5 k6 k7
}

template <int OUT>
__device__ __forceinline__ void store(void* out, long long o, int acc,
                                      float xs, float ws) {
    if constexpr (OUT == OUT_ACC) {
        static_cast<int*>(out)[o] = acc;
    } else {
        const float y = __int2float_rn(acc) * xs * ws;
        if constexpr (OUT == OUT_F32) {
            static_cast<float*>(out)[o] = y;
        } else if constexpr (OUT == OUT_BF16) {
            static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
        } else {
            static_cast<__half*>(out)[o] = __float2half_rn(y);
        }
    }
}

template <int MR, int OUT>
__global__ void __launch_bounds__(NTHREADS) w4a8_kernel(
        const int8_t* __restrict__ x, long long x_se,
        const float* __restrict__ xs, long long xs_se,
        const uint8_t* __restrict__ w, const float* __restrict__ ws,
        void* __restrict__ out, int M, int N, int K) {
    const int e = blockIdx.z;
    const int m0 = blockIdx.y * MR;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * WARPS + warp) * NPW;
    if (n0 >= N) return;                 // no block-wide barrier follows
    const int rows = min(MR, M - m0);
    const int8_t* xe = x + e * x_se + static_cast<long long>(m0) * K;
    const long long row_bytes = K / 2;
    const uint8_t* we = w + static_cast<long long>(e) * N * row_bytes;

    int acc[NPW][MR];
#pragma unroll
    for (int c = 0; c < NPW; ++c)
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[c][m] = 0;

#pragma unroll 2
    for (int k0 = lane * LANE_K; k0 < K; k0 += WARP_K) {
        int wk[NPW][8];
#pragma unroll
        for (int c = 0; c < NPW; ++c) {
            uint4 p = make_uint4(0u, 0u, 0u, 0u);
            if (n0 + c < N)
                p = __ldg(reinterpret_cast<const uint4*>(
                    we + (n0 + c) * row_bytes + k0 / 2));
            unpack8(p.x, wk[c][0], wk[c][1]);
            unpack8(p.y, wk[c][2], wk[c][3]);
            unpack8(p.z, wk[c][4], wk[c][5]);
            unpack8(p.w, wk[c][6], wk[c][7]);
        }
#pragma unroll
        for (int m = 0; m < MR; ++m) {
            if (m >= rows) break;
            const int8_t* xr = xe + static_cast<long long>(m) * K + k0;
            const uint4 xa = __ldg(reinterpret_cast<const uint4*>(xr));
            const uint4 xb = __ldg(reinterpret_cast<const uint4*>(xr + 16));
            const int xw[8] = {static_cast<int>(xa.x), static_cast<int>(xa.y),
                               static_cast<int>(xa.z), static_cast<int>(xa.w),
                               static_cast<int>(xb.x), static_cast<int>(xb.y),
                               static_cast<int>(xb.z), static_cast<int>(xb.w)};
#pragma unroll
            for (int c = 0; c < NPW; ++c)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[c][m] = __dp4a(wk[c][j], xw[j], acc[c][m]);
        }
    }

    // Butterfly: every lane ends with every (channel, row) sum; lane
    // c * MR + m stores that one.
#pragma unroll
    for (int c = 0; c < NPW; ++c) {
#pragma unroll
        for (int m = 0; m < MR; ++m) {
            int v = acc[c][m];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            const int n = n0 + c;
            if (lane == (c * MR + m) % 32 && n < N && m < rows) {
                const long long o =
                    (static_cast<long long>(e) * M + m0 + m) * N + n;
                store<OUT>(out, o, v,
                           OUT == OUT_ACC ? 0.f : xs[e * xs_se + m0 + m],
                           OUT == OUT_ACC ? 0.f
                                          : ws[static_cast<long long>(e) * N + n]);
            }
        }
    }
}

template <int MR>
int launch_rows(const void* x, long long x_se, const void* xs,
                long long xs_se, const void* w, const void* ws, void* out,
                int E, int M, int N, int K, int out_type,
                cudaStream_t stream) {
    const dim3 grid((N + WARPS * NPW - 1) / (WARPS * NPW), (M + MR - 1) / MR,
                    E);
    const auto* xp = static_cast<const int8_t*>(x);
    const auto* sp = static_cast<const float*>(xs);
    const auto* wp = static_cast<const uint8_t*>(w);
    const auto* wsp = static_cast<const float*>(ws);
    switch (out_type) {
        case OUT_F32:
            w4a8_kernel<MR, OUT_F32><<<grid, NTHREADS, 0, stream>>>(
                xp, x_se, sp, xs_se, wp, wsp, out, M, N, K);
            break;
        case OUT_BF16:
            w4a8_kernel<MR, OUT_BF16><<<grid, NTHREADS, 0, stream>>>(
                xp, x_se, sp, xs_se, wp, wsp, out, M, N, K);
            break;
        case OUT_F16:
            w4a8_kernel<MR, OUT_F16><<<grid, NTHREADS, 0, stream>>>(
                xp, x_se, sp, xs_se, wp, wsp, out, M, N, K);
            break;
        case OUT_ACC:
            w4a8_kernel<MR, OUT_ACC><<<grid, NTHREADS, 0, stream>>>(
                xp, x_se, sp, xs_se, wp, wsp, out, M, N, K);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: int8, row m of expert e at x + e * x_se + m * K (rows contiguous, 16-
// byte aligned); xs: fp32 row scales at xs + e * xs_se + m; w: uint8
// [E, N, K / 2] packed (contiguous); ws: fp32 [E, N]; out: [E, M, N] of
// out_type (0 fp32, 1 bf16, 2 fp16, 3 int32 sums). K a multiple of 32.
extern "C" int w4a8_mm(const void* x, long long x_se, const void* xs,
                       long long xs_se, const void* w, const void* ws,
                       void* out, int E, int M, int N, int K, int out_type,
                       void* stream) {
    if (E <= 0 || M < 0 || N <= 0 || K <= 0 || K % LANE_K || E > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    if (M == 0) return 0;
    auto s = static_cast<cudaStream_t>(stream);
    if (M == 1)
        return launch_rows<1>(x, x_se, xs, xs_se, w, ws, out, E, M, N, K,
                              out_type, s);
    if (M == 2)
        return launch_rows<2>(x, x_se, xs, xs_se, w, ws, out, E, M, N, K,
                              out_type, s);
    if (M <= 4)
        return launch_rows<4>(x, x_se, xs, xs_se, w, ws, out, E, M, N, K,
                              out_type, s);
    return launch_rows<8>(x, x_se, xs, xs_se, w, ws, out, E, M, N, K,
                          out_type, s);
}

extern "C" const char* w4a8_mm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
