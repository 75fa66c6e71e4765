// W4A8 product for Hopper (sm_90a): int8 activations times packed int4
// weights, summed exactly in int32 on the tensor cores, rescaled in fp32 —
// the int4 layer projections of ``quant: "int4"`` (models/quant.py ``mm``,
// ``moe_mm_dense``, ``moe_mm_batched``).
//
// Replaces no Pallas kernel. The JAX package leaves this product to XLA: a
// mixed s8 x s4 ``dot_general`` with an int32 accumulator
// (llmapigateway_tpu/models/quant.py:36-40 and the dots at :171, :185,
// :199). PyTorch has no call that takes packed int4 weights, so the port
// writes it by hand.
//
//   out[e, m, n] = float(sum_k xq[e, m, k] * wq[e, n, k]) * xs[e, m] * ws[e, n]
//
// rounded once to the output type (fp32, bf16 or fp16); a debug mode
// writes the int32 sums themselves. The weight of expert e is stored
// N-major and packed two levels a byte: byte j of row n holds level k = 2j
// in its low nibble and k = 2j + 1 in its high nibble, each a two's-
// complement nibble in [-7, 7] (ops/quant_mm.py ``pack_int4``).
//
// Three bodies, one chosen per launch from the shape alone (plan:
// ops/_kernels.py ``w4a8_plan``, which mirrors the constants below). They
// rest on one fact: the sums are exact integers, so any order of k, any
// split of K across warps or blocks and any int32 combine give the plain
// version's sums bit for bit. For the tensor cores a nibble is unpacked to
// a signed byte holding 16 times its level (two masks and two byte
// permutes a word, no sign extension), and the sums are shifted right by
// 4, exactly (|16 * 127 * 8 * K| < 2^31 for K <= 131072).
//
//   Decode body (w4a8_kernel_decode, up to 64 rows). Bound: the packed
//   weight bytes, N * K / 2 an expert, over the card's 3.35 TB/s. The
//   operands of mma.sync m16n8k32 s8 are swapped: A is 16 output channels
//   of unpacked weight levels, B up to 8 activation rows, so one unpacked
//   fragment serves all M rows (1, 2, 4 or 8 n8 tiles) from registers and
//   the weights are read once, whatever M. Each 8 levels of a k32 step
//   keep their order inside a fragment register and the four lanes of a
//   quad take 32 contiguous levels each, so one 16-byte shared-memory read
//   gives a lane the packed weights of four mma steps. A block of 8 warps
//   streams 128 / kw channel rows (256 contiguous bytes a row a stage) and
//   its activation rows through a 3- or 4-stage cp.async ring of
//   512-level stages; kw warps split each stage's K and add their sums in
//   shared memory at the end, so narrow products still fill the card.
//
//   Tile body (w4a8_kernel_tile, more than 64 rows: prefill chunks, expert
//   dispatch). Bound: the int8 operations, 2 * M * N * K an expert, over
//   1979 TOP/s. Blocks of 128 rows x 128 channels, two warpgroups, K in
//   stages of 128 levels through a 5-stage cp.async ring (16 KB of
//   activations and 8 KB of packed weights a stage). The block unpacks a
//   stage's weights once into an int8 tile in shared memory (two tiles
//   alternate), and each warpgroup runs wgmma m64n128k32 s8 on its 64
//   activation rows and that tile: both K-major in the 128-byte swizzle
//   wgmma reads, so no fragment-ordered packing is needed in device
//   memory. Step s's wgmma run while step s + 1 waits and unpacks.
//
//   Row body (w4a8_kernel_row, one row, or two where K is not split): the
//   port's first, dp4a kernel, kept because it streams a row's weights as
//   fast as the decode body or faster there (PERF.md): 16-byte __ldg
//   reads, 8 channels a block.
//
// A product of few blocks or a long K splits K across blocks too: each
// split stores its int32 partials in a workspace the wrapper allocates per
// call, and the last block to arrive at an output tile (an atomic counter,
// zeroed per call in the same workspace) adds the other splits' partials
// to its own sums, in its own registers, and applies the scales. Shared
// memory above 48 KB is set up by w4a8_mm_init, which the loader calls
// once when it loads the library. The C entry launches on the caller's
// stream and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int K_STEP = 128;              // levels a tile stage holds
constexpr int STEP_BYTES = K_STEP / 2;   // packed bytes of a row a stage

constexpr int DEC_WARPS = 8;
constexpr int DEC_THREADS = DEC_WARPS * 32;
constexpr int DEC_CHANNELS = DEC_WARPS * 16;    // output channels a block owns
constexpr int DEC_K_STEP = 512;                // levels a decode stage holds
constexpr int DEC_MAX_TILES = 8;                // n8 tiles of rows: M <= 64

constexpr int TILE_M = 128, TILE_N = 128;
constexpr int TILE_THREADS = 256;               // 8 warps: 2 (M) x 4 (N)
constexpr int TILE_STAGES = 5;

constexpr int TILE_STAGE_BYTES = TILE_M * K_STEP + TILE_N * STEP_BYTES;
constexpr int TILE_SMEM =     // two unpacked tiles; 1 KB to align to 1024
    TILE_STAGES * TILE_STAGE_BYTES + 2 * TILE_N * K_STEP + 1024;

enum OutType { OUT_F32 = 0, OUT_BF16 = 1, OUT_F16 = 2, OUT_ACC = 3 };

struct Args {
    const int8_t* x;        // row m of expert e at x + e * x_se + m * K
    long long x_se;
    const float* xs;        // scale of row m of expert e at xs[e * xs_se + m]
    long long xs_se;
    const uint8_t* w;       // [E, N, K / 2] packed
    const float* ws;        // [E, N]
    void* out;              // [E, M, N] of out_type
    int* parts;             // split K: [n_split, E, M, N] int32 partial sums
    int* counters;          // split K: [E, grid.x] int32, zeroed
    int M, N, K;
    int split_steps;        // K stages a split covers
    int out_type;
    int kw;                 // decode: warps splitting K inside a block
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four packed bytes (levels k0..k7) -> two words of four signed bytes, 16
// times each level, in k order: a = k0..k3, b = k4..k7.
__device__ __forceinline__ void unpack8(uint32_t w, uint32_t& a,
                                        uint32_t& b) {
    const uint32_t lo = (w << 4) & 0xF0F0F0F0u;    // k0 k2 k4 k6
    const uint32_t hi = w & 0xF0F0F0F0u;           // k1 k3 k5 k7
    a = __byte_perm(lo, hi, 0x5140);
    b = __byte_perm(lo, hi, 0x7362);
}

// c += A (16 x 32, row) . B (32 x 8, col), s8 in, s32 accumulate.
__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
    return *reinterpret_cast<const uint4*>(p);
}

// One output element from its exact sum.
__device__ __forceinline__ void store_out(const Args& a, int e, int m, int n,
                                          int sum) {
    const long long o = (static_cast<long long>(e) * a.M + m) * a.N + n;
    if (a.out_type == OUT_ACC) {
        static_cast<int*>(a.out)[o] = sum;
        return;
    }
    const float y = __int2float_rn(sum) * a.xs[e * a.xs_se + m]
                    * a.ws[static_cast<long long>(e) * a.N + n];
    if (a.out_type == OUT_F32)
        static_cast<float*>(a.out)[o] = y;
    else if (a.out_type == OUT_BF16)
        static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(y);
    else
        static_cast<__half*>(a.out)[o] = __float2half_rn(y);
}

// Split K: after its partials are in the workspace, true in every thread
// of the block that arrived last at its output tile.
__device__ __forceinline__ bool last_to_arrive(int* counter, int n_split) {
    __shared__ int last;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(counter, 1) == n_split - 1;
    __syncthreads();
    if (last) __threadfence();
    return last;
}

// Split K: split sp's [M, N] partial sums of expert e.
__device__ __forceinline__ int* split_part(const Args& a, int e, int sp) {
    return a.parts + (static_cast<long long>(sp) * gridDim.z + e) * a.M * a.N;
}

// Copy one 16-byte unit of activation row r (of a stage's rows, K_STEP
// bytes each) into its swizzled place; rows past M are zero-filled.
__device__ __forceinline__ void load_x_unit(uint8_t* st, const int8_t* xe,
                                            int row, int r, int q, int s,
                                            const Args& a) {
    const bool ok = row < a.M;
    cp_async16(st + r * K_STEP + ((q ^ (r & 7)) << 4),
               xe + static_cast<long long>(ok ? row : 0) * a.K + s * K_STEP
                   + q * 16,
               ok);
}

// ---------------------------------------------------------------------------
// Decode body: weights as A (16 channels a warp), rows as B (T n8 tiles)
// ---------------------------------------------------------------------------

// A decode stage holds DEC_K_STEP (512) levels: 256 packed bytes of each
// of the block's channel rows in one run, and 512 bytes of each of its
// 8 T activation rows; a K that is not a multiple of 512 ends in a stage
// zero-filled past K. With kw warps splitting K inside the block, the
// block owns 128 / kw channels: warp w takes channels 16 (w / kw) .. + 15
// and the 128-level chunks (w % kw) * 4 / kw .. of every stage, and the kw
// warps of a channel group add their sums in shared memory at the end.
__host__ __device__ constexpr int dec_stage_bytes(int tiles, int kw) {
    return DEC_CHANNELS / kw * (DEC_K_STEP / 2) + 8 * tiles * DEC_K_STEP;
}

template <int T, int STAGES>
__global__ void __launch_bounds__(DEC_THREADS, 1) w4a8_kernel_decode(Args a) {
    extern __shared__ __align__(16) uint8_t smem[];
    constexpr int KS = DEC_K_STEP, ROW_W = KS / 2;
    constexpr int W_ROW_UNITS = ROW_W / 16, X_ROW_UNITS = KS / 16;
    constexpr int X_UNITS = 8 * T * X_ROW_UNITS;
    const int kw = a.kw, channels = DEC_CHANNELS / kw, per_warp = 4 / kw;
    const int w_bytes = channels * ROW_W;
    const int stage = dec_stage_bytes(T, kw);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tig = lane & 3;
    const int kwi = warp % kw;           // this warp's share of each stage
    const int e = blockIdx.z, n0 = blockIdx.x * channels;
    const int steps = (a.K + KS - 1) / KS;
    const int s0 = blockIdx.y * a.split_steps;
    const int s1 = min(steps, s0 + a.split_steps);
    const long long row_bytes = a.K / 2;
    const uint8_t* wb = a.w + (static_cast<long long>(e) * a.N + n0) * row_bytes;
    const int8_t* xe = a.x + e * a.x_se;

    // Weight units of odd rows trade 64-byte halves, so the two rows of a
    // quarter-warp's reads fall in different banks; activation units XOR
    // the row's low 3 bits.
    auto load = [&](int slot, int s) {
        uint8_t* st = smem + slot * stage;
        for (int c = tid; c < channels * W_ROW_UNITS; c += DEC_THREADS) {
            const int r = c / W_ROW_UNITS, q = c % W_ROW_UNITS;
            const int k = s * KS + q * 32;
            const bool ok = k < a.K;
            cp_async16(st + r * ROW_W + ((q ^ ((r & 1) << 2)) << 4),
                       wb + r * row_bytes + (ok ? k / 2 : 0), ok);
        }
#pragma unroll
        for (int i = 0; i < (X_UNITS + DEC_THREADS - 1) / DEC_THREADS; ++i) {
            const int c = tid + i * DEC_THREADS;
            const int r = c / X_ROW_UNITS, q = c % X_ROW_UNITS;
            const int k = s * KS + q * 16;
            const bool ok = c < X_UNITS && r < a.M && k < a.K;
            if (c < X_UNITS)
                cp_async16(st + w_bytes + r * KS + ((q ^ (r & 7)) << 4),
                           xe + (ok ? static_cast<long long>(r) * a.K + k : 0),
                           ok);
        }
    };

    int acc[T][4];
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][j] = 0;

#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (s0 + i < s1) load(i, s0 + i);
        cp_async_commit();
    }
    const int wr = warp / kw * 16 + g;   // this lane's channel rows wr, wr + 8
    const int wsw = (wr & 1) << 2;       // (wr + 8) & 1 == wr & 1
    for (int s = s0; s < s1; ++s) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        const int nxt = s + STAGES - 1;
        if (nxt < s1) load((nxt - s0) % STAGES, nxt);
        cp_async_commit();
        const uint8_t* st = smem + ((s - s0) % STAGES) * stage;
#pragma unroll
        for (int c = 0; c < KS / 128; ++c) {
            if (c / per_warp != kwi) continue;
            // Levels 128 c + 32 tig + 8 j .. + 7 of rows wr, wr + 8: word j.
            const int wu = ((4 * c + tig) ^ wsw) << 4;
            const uint4 p0 = lds128(st + wr * ROW_W + wu);
            const uint4 p1 = lds128(st + (wr + 8) * ROW_W + wu);
            uint32_t A[4][4];
            unpack8(p0.x, A[0][0], A[0][2]);
            unpack8(p1.x, A[0][1], A[0][3]);
            unpack8(p0.y, A[1][0], A[1][2]);
            unpack8(p1.y, A[1][1], A[1][3]);
            unpack8(p0.z, A[2][0], A[2][2]);
            unpack8(p1.z, A[2][1], A[2][3]);
            unpack8(p0.w, A[3][0], A[3][2]);
            unpack8(p1.w, A[3][1], A[3][3]);
#pragma unroll
            for (int t = 0; t < T; ++t) {
                // Row t * 8 + g, whose low 3 bits are g.
                const uint8_t* xr = st + w_bytes + (t * 8 + g) * KS;
                const uint4 x0 = lds128(xr + (((8 * c + 2 * tig) ^ g) << 4));
                const uint4 x1 =
                    lds128(xr + (((8 * c + 2 * tig + 1) ^ g) << 4));
                mma_s8(acc[t], A[0][0], A[0][1], A[0][2], A[0][3], x0.x, x0.y);
                mma_s8(acc[t], A[1][0], A[1][1], A[1][2], A[1][3], x0.z, x0.w);
                mma_s8(acc[t], A[2][0], A[2][1], A[2][2], A[2][3], x1.x, x1.y);
                mma_s8(acc[t], A[3][0], A[3][1], A[3][2], A[3][3], x1.z, x1.w);
            }
        }
    }
    cp_async_wait<0>();

    if (kw > 1) {                        // the ring is free: add the K shares
        int* red = reinterpret_cast<int*>(smem);
        __syncthreads();
#pragma unroll
        for (int t = 0; t < T; ++t)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                red[((warp * T + t) * 4 + j) * 32 + lane] = acc[t][j];
        __syncthreads();
        for (int w2 = warp + 1; w2 < warp + kw && !kwi; ++w2)
#pragma unroll
            for (int t = 0; t < T; ++t)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[t][j] += red[((w2 * T + t) * 4 + j) * 32 + lane];
    }
    // acc[t][j] of a warp with kwi 0: channel wr + 8 (j >> 1), row
    // t * 8 + 2 tig + (j & 1); the sums themselves from here on.
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][j] >>= 4;
    if (gridDim.y > 1) {
        int* part = split_part(a, e, blockIdx.y);
        if (!kwi) {
#pragma unroll
            for (int t = 0; t < T; ++t)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int m = t * 8 + 2 * tig + (j & 1);
                    if (m < a.M)
                        part[static_cast<long long>(m) * a.N + n0 + wr
                             + 8 * (j >> 1)] = acc[t][j];
                }
        }
        if (!last_to_arrive(a.counters + e * gridDim.x + blockIdx.x,
                            gridDim.y))
            return;
        for (int sp = 0; sp < gridDim.y && !kwi; ++sp) {
            if (sp == blockIdx.y) continue;
            const int* q = split_part(a, e, sp);
#pragma unroll
            for (int t = 0; t < T; ++t)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int m = t * 8 + 2 * tig + (j & 1);
                    if (m < a.M)
                        acc[t][j] += __ldcg(q + static_cast<long long>(m) * a.N
                                            + n0 + wr + 8 * (j >> 1));
                }
        }
    }
    if (kwi) return;
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int m = t * 8 + 2 * tig + (j & 1);
            if (m < a.M) store_out(a, e, m, n0 + wr + 8 * (j >> 1), acc[t][j]);
        }
}

// ---------------------------------------------------------------------------
// Tile body: rows as A (64 a warp), weights as B (32 channels a warp)
// ---------------------------------------------------------------------------

// wgmma's view of a K-major tile in shared memory: rows of 128 bytes,
// 16-byte units stored at unit ^ (row & 7) (the 128-byte swizzle), atoms
// of 8 rows 1024 bytes apart; ``p`` 1024-byte aligned but for the k
// offset inside a row.
__device__ __forceinline__ uint64_t sw128_desc(const uint8_t* p) {
    const uint64_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    return ((a & 0x3FFFF) >> 4) | (uint64_t(1) << 16)
           | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// d (64 rows x 128 columns over a warpgroup) = A (64 x 32) . B^T (128 x 32)
// + (accumulate ? d : 0).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void hold_registers(int (&d)[64]) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// A tile stage holds 128 activation rows and 128 packed weight rows of
// 128 levels. After it lands, the block unpacks its weights once into a
// 128 x 128 int8 tile (16 x level, natural k order; two such tiles
// alternate) and two warpgroups each run four wgmma m64n128k32 on it:
// activations and unpacked weights are both K-major in the 128-byte
// swizzle that wgmma reads.
__global__ void __launch_bounds__(TILE_THREADS, 1) w4a8_kernel_tile(Args a) {
    extern __shared__ __align__(16) uint8_t smem_raw[];
    constexpr int X_BYTES = TILE_M * K_STEP;
    uint8_t* smem = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    uint8_t* wu2 = smem + TILE_STAGES * TILE_STAGE_BYTES;    // unpacked x 2
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wg = warp >> 2;            // warpgroup: rows 64 wg .. + 63
    const int m_tiles = (a.M + TILE_M - 1) / TILE_M;
    const int m0 = (blockIdx.x % m_tiles) * TILE_M;
    const int n0 = (blockIdx.x / m_tiles) * TILE_N;
    const int e = blockIdx.z;
    const int steps = a.K / K_STEP;
    const int s0 = blockIdx.y * a.split_steps;
    const int s1 = min(steps, s0 + a.split_steps);
    const long long row_bytes = a.K / 2;
    const uint8_t* wb = a.w + (static_cast<long long>(e) * a.N + n0) * row_bytes;
    const int8_t* xe = a.x + e * a.x_se;

    auto load = [&](int slot, int s) {
        uint8_t* st = smem + slot * TILE_STAGE_BYTES;
#pragma unroll
        for (int i = 0; i < TILE_M * (K_STEP / 16) / TILE_THREADS; ++i) {
            const int c = tid + i * TILE_THREADS, r = c >> 3;
            load_x_unit(st, xe, m0 + r, r, c & 7, s, a);
        }
#pragma unroll
        for (int i = 0; i < TILE_N * (STEP_BYTES / 16) / TILE_THREADS; ++i) {
            const int c = tid + i * TILE_THREADS, r = c >> 2, q = c & 3;
            cp_async16(st + X_BYTES + r * STEP_BYTES + q * 16,
                       wb + r * row_bytes + s * STEP_BYTES + q * 16, true);
        }
    };

    // Set by the first wgmma (accumulate 0): an instruction other than a
    // wgmma that wrote these registers would serialize the wgmma pipeline.
    int acc[64];

    // Stage s lands TILE_STAGES - 2 steps after its copy starts; step s's
    // wgmma run while step s + 1 waits and unpacks (into the other
    // unpacked tile), and finish before the copy into their ring slot.
#pragma unroll
    for (int i = 0; i < TILE_STAGES - 2; ++i) {
        if (s0 + i < s1) load(i, s0 + i);
        cp_async_commit();
    }
    for (int s = s0; s < s1; ++s) {
        cp_async_wait<TILE_STAGES - 3>();
        __syncthreads();
        const int nxt = s + TILE_STAGES - 2;
        if (nxt < s1) load((nxt - s0) % TILE_STAGES, nxt);
        cp_async_commit();
        const uint8_t* st = smem + ((s - s0) % TILE_STAGES) * TILE_STAGE_BYTES;
        uint8_t* wu = wu2 + ((s - s0) & 1) * TILE_N * K_STEP;
#pragma unroll
        for (int i = 0; i < TILE_N * (STEP_BYTES / 16) / TILE_THREADS; ++i) {
            // Packed unit q of row r (32 levels) -> unpacked units 2q, 2q + 1.
            const int c = tid + i * TILE_THREADS, r = c >> 2, q = c & 3;
            const uint4 p = lds128(st + X_BYTES + r * STEP_BYTES + q * 16);
            uint4 lo, hi;
            unpack8(p.x, lo.x, lo.y);
            unpack8(p.y, lo.z, lo.w);
            unpack8(p.z, hi.x, hi.y);
            unpack8(p.w, hi.z, hi.w);
            uint8_t* row = wu + r * K_STEP;
            *reinterpret_cast<uint4*>(row + (((2 * q) ^ (r & 7)) << 4)) = lo;
            *reinterpret_cast<uint4*>(row + (((2 * q + 1) ^ (r & 7)) << 4)) = hi;
        }
        // What the threads wrote (cp.async, the unpacked tile) is read by
        // the tensor cores through the async proxy.
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < K_STEP / 32; ++ks)
            wgmma_s8(acc, sw128_desc(st + wg * 64 * K_STEP + ks * 32),
                     sw128_desc(wu + ks * 32), s != s0 || ks);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    hold_registers(acc);
    cp_async_wait<0>();

    // acc[4 j + c]: row 64 wg + 16 (warp & 3) + g + 8 (c >> 1), channel
    // 8 j + 2 tig + (c & 1); the sums themselves from here on.
    const int g = lane >> 2, tig = lane & 3;
    const int mw = m0 + wg * 64 + 16 * (warp & 3) + g;
    const int nw = n0 + 2 * tig;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] >>= 4;
    if (gridDim.y > 1) {
        int* part = split_part(a, e, blockIdx.y);
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (mw + 8 * h < a.M)
                    *reinterpret_cast<int2*>(
                        part + static_cast<long long>(mw + 8 * h) * a.N + nw
                        + 8 * j) = make_int2(acc[4 * j + 2 * h],
                                             acc[4 * j + 2 * h + 1]);
        if (!last_to_arrive(a.counters + e * gridDim.x + blockIdx.x,
                            gridDim.y))
            return;
        for (int sp = 0; sp < gridDim.y; ++sp) {
            if (sp == blockIdx.y) continue;
            const int* q = split_part(a, e, sp);
#pragma unroll
            for (int j = 0; j < 16; ++j)
#pragma unroll
                for (int h = 0; h < 2; ++h)
                    if (mw + 8 * h < a.M) {
                        const int2 v = __ldcg(reinterpret_cast<const int2*>(
                            q + static_cast<long long>(mw + 8 * h) * a.N + nw
                            + 8 * j));
                        acc[4 * j + 2 * h] += v.x;
                        acc[4 * j + 2 * h + 1] += v.y;
                    }
        }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
            if (mw + 8 * h < a.M) {
                store_out(a, e, mw + 8 * h, nw + 8 * j, acc[4 * j + 2 * h]);
                store_out(a, e, mw + 8 * h, nw + 8 * j + 1,
                          acc[4 * j + 2 * h + 1]);
            }
}

// ---------------------------------------------------------------------------
// One- and two-row body: the first, dp4a kernel, kept where it wins
// ---------------------------------------------------------------------------

// At one or two rows no fragment has rows to share, and dp4a on
// registers fed by 16-byte __ldg reads (512 contiguous bytes a row a warp,
// 8 channels a block, N / 8 blocks) streams the weights as fast as the
// ring above or faster, where K is too short to split (PERF.md): one warp
// owns NPW output channels and its 32 lanes stride the contraction 32
// levels each; each unpacked chunk serves MR rows; the sums of a warp meet
// by shuffles.
constexpr int DP_WARPS = 4;
constexpr int DP_THREADS = DP_WARPS * 32;
constexpr int DP_NPW = 2;                // output channels a warp owns
constexpr int DP_LANE_K = 32;            // levels a lane sums per step
constexpr int DP_WARP_K = 32 * DP_LANE_K;
constexpr int DP_CHANNELS = DP_WARPS * DP_NPW;

// Four packed bytes (eight levels k0..k7) -> two words of four signed
// bytes each (the levels themselves), in k order.
__device__ __forceinline__ void unpack8_levels(uint32_t w, int& a, int& b) {
    uint32_t lo = (w & 0x0F0F0F0Fu) ^ 0x08080808u;          // k0 k2 k4 k6
    uint32_t hi = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;   // k1 k3 k5 k7
    lo = __vsub4(lo, 0x08080808u);                           // sign-extend
    hi = __vsub4(hi, 0x08080808u);
    a = static_cast<int>(__byte_perm(lo, hi, 0x5140));      // k0 k1 k2 k3
    b = static_cast<int>(__byte_perm(lo, hi, 0x7362));      // k4 k5 k6 k7
}

template <int OUT>
__device__ __forceinline__ void store_typed(void* out, long long o, int acc,
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
__global__ void __launch_bounds__(DP_THREADS) w4a8_kernel_row(
        const int8_t* __restrict__ x, long long x_se,
        const float* __restrict__ xs, long long xs_se,
        const uint8_t* __restrict__ w, const float* __restrict__ ws,
        void* __restrict__ out, int M, int N, int K) {
    const int e = blockIdx.z;
    const int m0 = blockIdx.y * MR;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int n0 = (blockIdx.x * DP_WARPS + warp) * DP_NPW;
    if (n0 >= N) return;                 // no block-wide barrier follows
    const int rows = min(MR, M - m0);
    const int8_t* xe = x + e * x_se + static_cast<long long>(m0) * K;
    const long long row_bytes = K / 2;
    const uint8_t* we = w + static_cast<long long>(e) * N * row_bytes;

    int acc[DP_NPW][MR];
#pragma unroll
    for (int c = 0; c < DP_NPW; ++c)
#pragma unroll
        for (int m = 0; m < MR; ++m) acc[c][m] = 0;

#pragma unroll 2
    for (int k0 = lane * DP_LANE_K; k0 < K; k0 += DP_WARP_K) {
        int wk[DP_NPW][8];
#pragma unroll
        for (int c = 0; c < DP_NPW; ++c) {
            uint4 p = make_uint4(0u, 0u, 0u, 0u);
            if (n0 + c < N)
                p = __ldg(reinterpret_cast<const uint4*>(
                    we + (n0 + c) * row_bytes + k0 / 2));
            unpack8_levels(p.x, wk[c][0], wk[c][1]);
            unpack8_levels(p.y, wk[c][2], wk[c][3]);
            unpack8_levels(p.z, wk[c][4], wk[c][5]);
            unpack8_levels(p.w, wk[c][6], wk[c][7]);
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
            for (int c = 0; c < DP_NPW; ++c)
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    acc[c][m] = __dp4a(wk[c][j], xw[j], acc[c][m]);
        }
    }

    // Butterfly: every lane ends with every (channel, row) sum; lane
    // c * MR + m stores that one.
#pragma unroll
    for (int c = 0; c < DP_NPW; ++c) {
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
                store_typed<OUT>(out, o, v,
                                 OUT == OUT_ACC ? 0.f : xs[e * xs_se + m0 + m],
                                 OUT == OUT_ACC
                                     ? 0.f
                                     : ws[static_cast<long long>(e) * N + n]);
            }
        }
    }
}

template <int MR>
int launch_row(const Args& a, int E, cudaStream_t stream) {
    const dim3 grid((a.N + DP_CHANNELS - 1) / DP_CHANNELS, (a.M + MR - 1) / MR,
                    E);
    switch (a.out_type) {
        case OUT_F32:
            w4a8_kernel_row<MR, OUT_F32><<<grid, DP_THREADS, 0, stream>>>(
                a.x, a.x_se, a.xs, a.xs_se, a.w, a.ws, a.out, a.M, a.N, a.K);
            break;
        case OUT_BF16:
            w4a8_kernel_row<MR, OUT_BF16><<<grid, DP_THREADS, 0, stream>>>(
                a.x, a.x_se, a.xs, a.xs_se, a.w, a.ws, a.out, a.M, a.N, a.K);
            break;
        case OUT_F16:
            w4a8_kernel_row<MR, OUT_F16><<<grid, DP_THREADS, 0, stream>>>(
                a.x, a.x_se, a.xs, a.xs_se, a.w, a.ws, a.out, a.M, a.N, a.K);
            break;
        default:
            w4a8_kernel_row<MR, OUT_ACC><<<grid, DP_THREADS, 0, stream>>>(
                a.x, a.x_se, a.xs, a.xs_se, a.w, a.ws, a.out, a.M, a.N, a.K);
    }
    return static_cast<int>(cudaGetLastError());
}

// The decode ring's depth at T n8 row tiles (144, 160, 144, 192 KB a block
// at kw 1).
constexpr int dec_stages(int tiles) { return tiles >= 4 ? 3 : 4; }

template <int T>
int launch_decode(const Args& a, dim3 grid, cudaStream_t stream) {
    constexpr int ST = dec_stages(T);
    w4a8_kernel_decode<T, ST><<<grid, DEC_THREADS,
                                ST * dec_stage_bytes(T, a.kw), stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

template <int T>
int allow_decode_smem() {
    constexpr int ST = dec_stages(T);
    return static_cast<int>(cudaFuncSetAttribute(
        w4a8_kernel_decode<T, ST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ST * dec_stage_bytes(T, 1)));
}

}  // namespace

// Dynamic shared memory past 48 KB for every body; once per process,
// before any launch (and never inside a graph capture).
extern "C" int w4a8_mm_init() {
    int rc = allow_decode_smem<1>();
    if (!rc) rc = allow_decode_smem<2>();
    if (!rc) rc = allow_decode_smem<4>();
    if (!rc) rc = allow_decode_smem<8>();
    if (!rc)
        rc = static_cast<int>(cudaFuncSetAttribute(
            w4a8_kernel_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
            TILE_SMEM));
    return rc;
}

// x: int8, row m of expert e at x + e * x_se + m * K (rows contiguous, 16-
// byte aligned); xs: fp32 row scales at xs + e * xs_se + m; w: uint8
// [E, N, K / 2] packed (contiguous); ws: fp32 [E, N]; out: [E, M, N] of
// out_type (0 fp32, 1 bf16, 2 fp16, 3 int32 sums); work: for n_split > 1,
// n_split * E * M * N int32 partial sums, then E * grid.x zeroed
// counters. The plan (ops/_kernels.py ``w4a8_plan``): body 0 decode with
// ``tiles`` n8 row tiles (1, 2, 4, 8; M <= 8 * tiles) and kw warps
// splitting K in a block (1, 2, 4), body 1 tile, body 2 one row; K in
// n_split splits of split_steps stages (512 levels decode, 128 tile). K
// and N multiples of 128.
extern "C" int w4a8_mm(const void* x, long long x_se, const void* xs,
                       long long xs_se, const void* w, const void* ws,
                       void* out, void* work, int E, int M, int N, int K,
                       int body, int tiles, int kw, int n_split,
                       int split_steps, int out_type, void* stream) {
    const int steps = body == 0   ? (K + DEC_K_STEP - 1) / DEC_K_STEP
                      : body == 1 ? K / K_STEP
                                  : 1;
    if (E <= 0 || E > 65535 || M <= 0 || N <= 0 || K <= 0 || K % K_STEP
        || N % TILE_N || out_type < OUT_F32 || out_type > OUT_ACC
        || n_split < 1 || n_split > 65535 || split_steps < 1
        || (n_split - 1) * split_steps >= steps
        || n_split * split_steps < steps || (n_split > 1 && !work))
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{static_cast<const int8_t*>(x), x_se, static_cast<const float*>(xs),
           xs_se, static_cast<const uint8_t*>(w),
           static_cast<const float*>(ws), out, nullptr, nullptr, M, N, K,
           split_steps, out_type, kw};
    auto s = static_cast<cudaStream_t>(stream);
    if (body == 0) {
        if (M > 8 * tiles || tiles > DEC_MAX_TILES
            || (kw != 1 && kw != 2 && kw != 4))
            return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid(N / (DEC_CHANNELS / kw), n_split, E);
        if (n_split > 1) {
            a.parts = static_cast<int*>(work);
            a.counters = a.parts + static_cast<long long>(n_split) * E * M * N;
        }
        switch (tiles) {
            case 1: return launch_decode<1>(a, grid, s);
            case 2: return launch_decode<2>(a, grid, s);
            case 4: return launch_decode<4>(a, grid, s);
            case 8: return launch_decode<8>(a, grid, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (body == 2) {                     // one or two rows: dp4a
        if (M > 2 || n_split != 1)
            return static_cast<int>(cudaErrorInvalidValue);
        return M == 1 ? launch_row<1>(a, E, s) : launch_row<2>(a, E, s);
    }
    if (body != 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(((M + TILE_M - 1) / TILE_M) * (N / TILE_N), n_split, E);
    if (n_split > 1) {
        a.parts = static_cast<int*>(work);
        a.counters = a.parts + static_cast<long long>(n_split) * E * M * N;
    }
    w4a8_kernel_tile<<<grid, TILE_THREADS, TILE_SMEM, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* w4a8_mm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
