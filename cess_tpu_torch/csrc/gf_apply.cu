// GF(2^8) matrix apply for the Reed-Solomon codec (Hopper, sm_90a).
//
// Replaces the Pallas kernel cess_tpu/ops/rs_pallas.py::_make_kernel,
// which unpacks bytes into bit planes and runs two int8 matrix products
// on the TPU's matrix unit. Here the same function
//
//     out[b, i, x] = XOR_j mat[i, j] * data[b, j, x]      (GF(2^8))
//
// is computed with split nibble tables: mat[i, j] * v equals
// lo[i, j, v & 15] ^ hi[i, j, v >> 4]. The r*q*32 bytes of tables sit in
// shared memory, where a warp's lookups into one 16-entry table touch
// four consecutive banks and never conflict.
//
// Bound: device-memory bytes. RS(2,1) encode reads 2 rows and writes 1
// (3 with the systematic copy); the table lookups cost a few shared
// loads per byte, far below the shared-memory rate at r*q <= 8. So the
// design keeps every global access a 16-byte vector load or store by
// consecutive threads on consecutive addresses, and reads each input
// byte from device memory once: a thread re-reads its 16 input bytes
// for each output row, and those re-reads hit L1. A chunk that is not
// 16-byte aligned or runs past the end of a row takes a masked byte
// loop, so no caller pads.
//
// The optional sys_out receives the input rows as they are read, so an
// encode writes systematic and parity rows of [B, k+m, n] in one pass.
//
// Tables above the default 48 KB of dynamic shared memory are admitted
// by raising the kernel's limit (cudaFuncSetAttribute) up to the 227 KB
// a block may use, e.g. RS(64,64) with 128 KB of tables; the wrapper
// (ops/rs_kernel.py) splits larger matrices into launches over slices of
// the output rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t mul_word(const uint8_t* lo,
                                             const uint8_t* hi,
                                             uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int s = 0; s < 32; s += 8) {
    const uint32_t b = (v >> s) & 0xFFu;
    r |= static_cast<uint32_t>(lo[b & 15u] ^ hi[b >> 4]) << s;
  }
  return r;
}

__global__ void gf_apply_kernel(const uint8_t* __restrict__ tables,
                                const uint8_t* __restrict__ data,
                                uint8_t* __restrict__ out,
                                uint8_t* __restrict__ sys_out, int B, int q,
                                int r, long long n, long long in_bs,
                                long long in_rs, long long out_bs,
                                long long out_rs, long long sys_bs,
                                long long sys_rs, int vec) {
  extern __shared__ uint8_t s_tab[];  // [r, q, 2, 16]: lo then hi
  const int tab_bytes = r * q * 32;
  for (int i = threadIdx.x; i < tab_bytes; i += blockDim.x) {
    s_tab[i] = tables[i];
  }
  __syncthreads();

  const long long chunks = (n + 15) / 16;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < chunks; c += stride) {
    const long long off = c * 16;
    const bool full = vec && off + 16 <= n;
    const int len = static_cast<int>(n - off < 16 ? n - off : 16);
    for (int b = blockIdx.y; b < B; b += gridDim.y) {
      const uint8_t* src = data + b * in_bs + off;
      uint8_t* dst = out + b * out_bs + off;
      uint8_t* sys = sys_out ? sys_out + b * sys_bs + off : nullptr;
      if (full) {
        for (int i = 0; i < r; ++i) {
          uint4 acc = make_uint4(0u, 0u, 0u, 0u);
          for (int j = 0; j < q; ++j) {
            const uint4 v =
                __ldg(reinterpret_cast<const uint4*>(src + j * in_rs));
            if (sys && i == 0) {
              *reinterpret_cast<uint4*>(sys + j * sys_rs) = v;
            }
            const uint8_t* lo = s_tab + (i * q + j) * 32;
            const uint8_t* hi = lo + 16;
            acc.x ^= mul_word(lo, hi, v.x);
            acc.y ^= mul_word(lo, hi, v.y);
            acc.z ^= mul_word(lo, hi, v.z);
            acc.w ^= mul_word(lo, hi, v.w);
          }
          *reinterpret_cast<uint4*>(dst + i * out_rs) = acc;
        }
        if (sys && r == 0) {
          for (int j = 0; j < q; ++j) {
            *reinterpret_cast<uint4*>(sys + j * sys_rs) =
                __ldg(reinterpret_cast<const uint4*>(src + j * in_rs));
          }
        }
      } else {
        for (int e = 0; e < len; ++e) {
          for (int i = 0; i < r; ++i) {
            uint8_t acc = 0;
            for (int j = 0; j < q; ++j) {
              const uint8_t v = src[j * in_rs + e];
              const uint8_t* lo = s_tab + (i * q + j) * 32;
              acc ^= lo[v & 15] ^ lo[16 + (v >> 4)];
            }
            dst[i * out_rs + e] = acc;
          }
          if (sys) {
            for (int j = 0; j < q; ++j) sys[j * sys_rs + e] = src[j * in_rs + e];
          }
        }
      }
    }
  }
}

}  // namespace

// tables: [r, q, 2, 16] u8 on the device; data [B, q, n] and out [B, r, n]
// (sys_out [B, q, n] or null) u8 with unit stride along n and the given
// batch and row strides in bytes; r * q * 32 bytes of tables at most
// 227 KB. vec != 0 promises that every base pointer and stride is a
// multiple of 16. Returns the first CUDA error of the attribute and launch
// calls.
extern "C" int gf_apply(const void* tables, const void* data, void* out,
                        void* sys_out, int B, int q, int r, long long n,
                        long long in_bs, long long in_rs, long long out_bs,
                        long long out_rs, long long sys_bs, long long sys_rs,
                        int vec, void* stream) {
  if (B <= 0 || n <= 0 || q <= 0) return 0;
  const size_t smem = static_cast<size_t>(r) * q * 32;
  if (smem > kDefaultSmem) {
    // raised once per device and size, so that a CUDA graph capture of a
    // warmed-up launch makes no attribute call
    static size_t attr[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (smem > attr[dev]) {
      err = cudaFuncSetAttribute(gf_apply_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      attr[dev] = smem;
    }
  }
  const long long chunks = (n + 15) / 16;
  long long gx = (chunks + kThreads - 1) / kThreads;
  if (gx > 65535) gx = 65535;
  const int gy = B < 65535 ? B : 65535;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  gf_apply_kernel<<<grid, kThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(sys_out), B, q, r, n,
      in_bs, in_rs, out_bs, out_rs, sys_bs, sys_rs, vec);
  return static_cast<int>(cudaGetLastError());
}
