// One-row KV insert for Hopper (sm_90a): the decode step's write of each
// slot's new key (or value) into one layer of the contiguous cache, in place.
//
// kv_insert_kernel replaces the Pallas TPU kernel insert_pallas /
// _insert_kernel (tools/profile_insert.py:66, :56): for every (b, kv) the
// row new[b, 0, kv, :] lands at cache[b, kv, lengths[b], :] of a cache
// [B, KV, S, Dh], and every other byte of the cache is left as it was (the
// Pallas call aliases the cache to its output).
//   Bound: bytes, and at decode sizes not even those: it moves B * KV * Dh
//   elements in and the same out (8 KB a layer at tinyllama's B 8, KV 4,
//   Dh 64 in bf16, ~2.4 ns at 3.35 TB/s), so one launch's latency is its
//   real floor. Design: the TPU kernel reads, modifies and writes the
//   8-row lane holding the row, because its blocks are (8, 128) tiles; here
//   only the row itself is written — one block per slot b, each thread
//   copying 16-byte chunks of the slot's KV rows (a Dh row of bf16 is Dh/8
//   chunks). The row is element-type agnostic: the wrapper passes its width
//   in 16-byte chunks.
//   Contract: 0 <= lengths[b] < S. A slot whose length lies outside drops
//   its write (the port's rule for contiguous inserts past the cache end);
//   the Pallas kernel instead writes whatever 8-row block its index map
//   clamps to, so the two are compared only in range.
//
// empty_kernel does nothing: the smoke times it on the same stream as the
// launch-latency floor beside kv_insert's bound.
// Each C entry launches on the caller's stream and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;

__global__ void __launch_bounds__(NTHREADS) kv_insert_kernel(
        const uint4* __restrict__ new_rows, uint4* __restrict__ cache,
        const int* __restrict__ lengths, int KV, int S, int chunks) {
    const int b = blockIdx.x;
    const int pos = lengths[b];
    if (pos < 0 || pos >= S) return;             // dropped: out of range
    for (int i = threadIdx.x; i < KV * chunks; i += NTHREADS) {
        const int kv = i / chunks, c = i % chunks;
        const long long row = (static_cast<long long>(b) * KV + kv) * S + pos;
        cache[row * chunks + c] = __ldg(
            new_rows + (static_cast<long long>(b) * KV + kv) * chunks + c);
    }
}

__global__ void empty_kernel() {}

}  // namespace

// new_rows: [B, 1, KV, Dh] (contiguous: row (b, kv) at (b * KV + kv) *
// row_bytes); cache: [B, KV, S, Dh]; lengths: [B] int32; row_bytes: the
// bytes of one Dh row, a multiple of 16 (both pointers 16-byte aligned).
extern "C" int kv_insert(const void* new_rows, void* cache,
                         const void* lengths, int B, int KV, int S,
                         int row_bytes, void* stream) {
    if (B < 0 || KV <= 0 || S < 0 || row_bytes <= 0 || row_bytes % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0 || S == 0) return 0;
    kv_insert_kernel<<<B, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint4*>(new_rows), static_cast<uint4*>(cache),
        static_cast<const int*>(lengths), KV, S, row_bytes / 16);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int empty_launch(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* kv_insert_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
