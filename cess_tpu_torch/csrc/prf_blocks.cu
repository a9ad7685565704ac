// The per-block threefry PRF of PoDR2 (Hopper, sm_90a).
//
// prf_blocks is the PRF the TPU package takes from jax.random (threefry
// lowered by XLA, cess_tpu/ops/podr2.py::prf_elems_at):
//
//     out[f, c, l] = to_field(bits(fold_in(K_f, b_c), (l,)))
//
// where K_f = fold_in(fold_in(key, lo_f), hi_f) and b_c is block index c
// (the identity for tag generation, the challenged blocks for
// verification). Each hash is 20-round threefry2x32 with the rotations
// (13,15,26,6)/(17,29,16,24) and the key schedule k0, k1, k0^k1^0x1BD11BDA,
// all in 32-bit registers.
//
// Bound: integer operations (about 79 a hash) against 4 bytes written a
// limb. The work is 1 + L hashes an element (the block fold and one hash a
// limb) and 2 a fragment (K_f). So a CTA takes a tile of tile_blocks
// blocks of ONE fragment: thread 0 derives the tile's K_f into shared
// memory, and each thread takes the blocks c0 + t, c0 + t + threads, ...
// of the tile at exactly 1 + L hashes a block. That keeps the stores of
// consecutive threads on consecutive blocks in both layouts and costs one
// 64-bit division a tile, none an element. The caller sizes the launch
// (threads, blocks a tile, CTAs; ops/podr2_kernel.py prf_grid, from the
// card's SM count) and the grid strides over the tiles. Output strides let
// tag generation write the limb-major [F, limbs, blocks] layout that
// podr2_tag reads and verification the block-major [F, blocks, limbs].
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kP = 0x7FFFFFFFu;
constexpr int kMaxThreads = 256;  // the launch bound

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void mix4(uint32_t& x0, uint32_t& x1, int a, int b,
                                     int c, int d) {
  x0 += x1; x1 = rotl(x1, a); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, b); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, c); x1 ^= x0;
  x0 += x1; x1 = rotl(x1, d); x1 ^= x0;
}

// threefry2x32 of counter (x0, x1) under key (k0, k1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k1; x1 += k2 + 1u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k2; x1 += k0 + 2u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k0; x1 += k1 + 3u;
  mix4(x0, x1, 17, 29, 16, 24); x0 += k1; x1 += k2 + 4u;
  mix4(x0, x1, 13, 15, 26, 6);  x0 += k2; x1 += k0 + 5u;
}

// fold_in(key, d) = threefry(key, (0, d)).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  threefry(k0, k1, x0, x1);
  k0 = x0; k1 = x1;
}

__device__ __forceinline__ uint32_t to_field(uint32_t x) {
  const uint32_t r = (x & kP) + (x >> 31);
  return r >= kP ? r - kP : r;
}

// L limbs known at compile time, or L == 0: `limbs` at run time. The
// main path's L = 2 has its own build: with its limb loop unrolled it ran
// 0.0189-0.0190 ms at 96 x 16384 against 0.0209-0.0211 for the run-time
// loop (turns in one call, NVIDIA H100 80GB HBM3, 700.00 W).
template <int L>
__global__ void __launch_bounds__(kMaxThreads)
prf_blocks_kernel(const long long* __restrict__ key,
                  const long long* __restrict__ ids,
                  const long long* __restrict__ blk, int32_t* __restrict__ out,
                  long long C, long long tile_blocks, long long tiles_per_f,
                  long long tiles, int limbs, long long s_f, long long s_c,
                  long long s_l) {
  const int nl = L > 0 ? L : limbs;
  __shared__ uint32_t s_key[2];
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const long long f = tile / tiles_per_f;
    const long long t0 = (tile - f * tiles_per_f) * tile_blocks;  // first block
    const long long t_end = t0 + tile_blocks < C ? t0 + tile_blocks : C;
    if (threadIdx.x == 0) {
      // K_f: two hashes, once for the tile
      uint32_t k0 = static_cast<uint32_t>(key[0]);
      uint32_t k1 = static_cast<uint32_t>(key[1]);
      fold_in(k0, k1, static_cast<uint32_t>(ids[2 * f]));
      fold_in(k0, k1, static_cast<uint32_t>(ids[2 * f + 1]));
      s_key[0] = k0;
      s_key[1] = k1;
    }
    __syncthreads();
    const uint32_t k0 = s_key[0], k1 = s_key[1];
    __syncthreads();  // read by all before the next tile's key replaces it
    int32_t* frag = out + f * s_f;
#pragma unroll 2
    for (long long c = t0 + threadIdx.x; c < t_end; c += blockDim.x) {
      uint32_t b0 = k0, b1 = k1;
      fold_in(b0, b1, static_cast<uint32_t>(blk ? blk[c] : c));
      int32_t* dst = frag + c * s_c;
      for (int l = 0; l < nl; ++l) {
        uint32_t x0 = 0u, x1 = static_cast<uint32_t>(l);
        threefry(b0, b1, x0, x1);
        dst[l * s_l] = static_cast<int32_t>(to_field(x0 ^ x1));
      }
    }
  }
}

}  // namespace

// key [2] i64 raw key words, ids [F, 2] i64 (lo, hi) words, blk [C] i64
// block indices or null for 0..C-1, out i32 at element strides
// (s_f, s_c, s_l) for (fragment, block, limb); threads (1..256) a CTA,
// tile_blocks blocks of one fragment a tile, grid CTAs striding over the
// F * ceil(C / tile_blocks) tiles. The low 32 bits of each id word and
// block index are hashed, as JAX's fold_in takes them. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a launch shape out of
// range.
extern "C" int prf_blocks(const void* key, const void* ids, const void* blk,
                          void* out, long long F, long long C, int limbs,
                          long long s_f, long long s_c, long long s_l,
                          int threads, long long tile_blocks, long long grid,
                          void* stream) {
  if (F <= 0 || C <= 0 || limbs <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || tile_blocks <= 0 ||
      grid <= 0 || grid > 0x7FFFFFFFLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles_per_f = (C + tile_blocks - 1) / tile_blocks;
  decltype(&prf_blocks_kernel<0>) kernel = prf_blocks_kernel<0>;
  if (limbs == 2) kernel = prf_blocks_kernel<2>;
  kernel<<<static_cast<unsigned>(grid), threads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key), static_cast<const long long*>(ids),
      static_cast<const long long*>(blk), static_cast<int32_t*>(out), C,
      tile_blocks, tiles_per_f, F * tiles_per_f, limbs, s_f, s_c, s_l);
  return static_cast<int>(cudaGetLastError());
}
