// GF(2^8) matrix apply for the Reed-Solomon codec (Hopper, sm_90a).
//
// Replaces the Pallas kernel cess_tpu/ops/rs_pallas.py::_make_kernel,
// which unpacks bytes into bit planes and runs two int8 matrix products
// on the TPU's matrix unit. Here the same function
//
//     out[b, i, x] = XOR_j mat[i, j] * data[b, j, x]      (GF(2^8))
//
// is computed with split nibble tables: mat[i, j] * v equals
// lo[i, j, v & 15] ^ hi[i, j, v >> 4].
//
// Row-interleaved word tables. The kernel takes the tables [r, q, 2, 16]
// and rebuilds them in shared memory as 32-bit words whose byte t holds
// the product for output row 4g + t of a group g of 4 rows, so one
// 32-bit shared load gives a nibble's products with four output rows,
// and an XOR adds them to an accumulator word that holds 4 output rows
// of one byte position. A warp's 32 lookups into one group's 16 words
// touch 16 banks and never conflict. A pass covers NG groups (NG = 1 for
// r <= 4, else 2: 8 rows); the image is [passes, q, 2 (lo/hi), 2 (group),
// 16] words, one 256-byte block for each (pass, input row), so that a
// lookup address is one __byte_perm: byte 0 from the nibble (times 4),
// bytes 1..3 from the block's 256-aligned offset (tests/test_torch_layouts.py
// interleaved_tables and interleaved_apply state the image and this
// arithmetic in torch). The image takes ceil(r / 8) * 8 * q * 32 bytes
// (q * 256 for r <= 4); the wrapper splits matrices whose image passes
// the 227 KB a block may use over output rows, 8 rows a step.
//
// Bound: device-memory bytes. A thread takes 16 byte positions of every
// input row, each read from device memory once per pass (one pass up to
// 8 output rows, e.g. RS(4,8) encode), and keeps 16 * NG accumulator
// words; per input row and group that is 32 shared loads and 16 XORs
// for 16 bytes (2 lookups a byte), against 64 byte loads and the byte
// extraction and insertion of a byte-wise table. Each output row leaves
// as 16-byte stores after a 4 x 4 byte transpose (8 __byte_perm per 4
// words). A chunk that is not 16-byte aligned or runs past the end of a
// row takes a masked byte loop over the same words, so no caller pads.
//
// The optional sys_out receives the input rows as they are read, so an
// encode writes systematic and parity rows of [B, k+m, n] in one pass.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // measured ahead of 256 and 512
constexpr int kGroupRows = 4;      // output rows in one table word
constexpr int kBlockBytes = 256;   // one (pass, input row): [2][2][16] words
constexpr int kHalfBytes = 128;    // offset of the hi-nibble words
constexpr int kGroupBytes = 64;    // 16 words of one group
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

// Passes over the input for r output rows, NG groups of 4 a pass; at least
// one, which also serves r = 0 (the systematic copy alone).
__host__ __device__ inline int passes_for(int r, int ng) {
  const int rows = ng * kGroupRows;
  return r > rows ? (r + rows - 1) / rows : 1;
}

__device__ __forceinline__ uint32_t lds(const uint32_t* s, uint32_t off) {
  return *reinterpret_cast<const uint32_t*>(
      reinterpret_cast<const uint8_t*>(s) + off);
}

// Add the products of the 4 bytes of input word w (byte positions 4k..4k+3)
// to acc, looked up in the block at byte offset base (256-aligned).
template <int NG>
__device__ __forceinline__ void accumulate(uint32_t (&acc)[NG][16],
                                           const uint32_t* s, uint32_t w,
                                           uint32_t base, int k) {
  const uint32_t lo4 = (w << 2) & 0x3C3C3C3Cu;  // byte e: (lo nibble) * 4
  const uint32_t hi4 = (w >> 2) & 0x3C3C3C3Cu;  // byte e: (hi nibble) * 4
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t a_lo = __byte_perm(lo4, base, 0x7650u | e);
    const uint32_t a_hi = __byte_perm(hi4, base, 0x7650u | e);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      acc[g][4 * k + e] ^= lds(s, a_lo + g * kGroupBytes) ^
                           lds(s, a_hi + kHalfBytes + g * kGroupBytes);
    }
  }
}

template <int NG>
__global__ void __launch_bounds__(kThreads)
gf_apply_kernel(const uint8_t* __restrict__ tables,
                const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                uint8_t* __restrict__ sys_out, int B, int q, int r,
                long long n, long long in_bs, long long in_rs,
                long long out_bs, long long out_rs, long long sys_bs,
                long long sys_rs, int vec) {
  extern __shared__ uint32_t s_tab[];  // [passes, q, 2, 2, 16] words
  const int passes = passes_for(r, NG);
  const int words = passes * q * (kBlockBytes / 4);
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const int v = i & 15;
    const int g = (i >> 4) & 1;
    const int h = (i >> 5) & 1;
    const int pj = i >> 6;
    const int p = pj / q;
    const int j = pj - p * q;
    uint32_t w = 0u;
    if (g < NG) {
#pragma unroll
      for (int t = 0; t < kGroupRows; ++t) {
        const int row = (p * NG + g) * kGroupRows + t;
        if (row < r) {
          w |= static_cast<uint32_t>(tables[((row * q + j) * 2 + h) * 16 + v])
               << (8 * t);
        }
      }
    }
    s_tab[i] = w;
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
        for (int p = 0; p < passes; ++p) {
          uint32_t acc[NG][16];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
#pragma unroll
            for (int x = 0; x < 16; ++x) acc[g][x] = 0u;
          }
          uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
          for (int j = 0; j < q; ++j) {
            // the next row's load is in flight while this one is looked up
            const uint4 nxt =
                j + 1 < q ? __ldg(reinterpret_cast<const uint4*>(
                                src + (j + 1) * in_rs))
                          : v;
            if (sys && p == 0) {
              *reinterpret_cast<uint4*>(sys + j * sys_rs) = v;
            }
            const uint32_t base =
                static_cast<uint32_t>((p * q + j) * kBlockBytes);
            accumulate<NG>(acc, s_tab, v.x, base, 0);
            accumulate<NG>(acc, s_tab, v.y, base, 1);
            accumulate<NG>(acc, s_tab, v.z, base, 2);
            accumulate<NG>(acc, s_tab, v.w, base, 3);
            v = nxt;
          }
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const int row0 = (p * NG + g) * kGroupRows;
            if (row0 >= r) break;
            // 4 x 4 byte transposes: word k of output row t takes byte t
            // of acc[g][4k .. 4k+3]
            uint32_t o[kGroupRows][4];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const uint32_t a0 = acc[g][4 * k], a1 = acc[g][4 * k + 1];
              const uint32_t a2 = acc[g][4 * k + 2], a3 = acc[g][4 * k + 3];
              const uint32_t lo01 = __byte_perm(a0, a1, 0x5140u);
              const uint32_t hi01 = __byte_perm(a0, a1, 0x7362u);
              const uint32_t lo23 = __byte_perm(a2, a3, 0x5140u);
              const uint32_t hi23 = __byte_perm(a2, a3, 0x7362u);
              o[0][k] = __byte_perm(lo01, lo23, 0x5410u);
              o[1][k] = __byte_perm(lo01, lo23, 0x7632u);
              o[2][k] = __byte_perm(hi01, hi23, 0x5410u);
              o[3][k] = __byte_perm(hi01, hi23, 0x7632u);
            }
#pragma unroll
            for (int t = 0; t < kGroupRows; ++t) {
              if (row0 + t < r) {
                *reinterpret_cast<uint4*>(dst + (row0 + t) * out_rs) =
                    make_uint4(o[t][0], o[t][1], o[t][2], o[t][3]);
              }
            }
          }
        }
      } else {
        // the byte path is cold: kept rolled
#pragma unroll 1
        for (int e = 0; e < len; ++e) {
#pragma unroll 1
          for (int p = 0; p < passes; ++p) {
            uint32_t acc[NG];
#pragma unroll
            for (int g = 0; g < NG; ++g) acc[g] = 0u;
#pragma unroll 1
            for (int j = 0; j < q; ++j) {
              const uint32_t x = src[j * in_rs + e];
              const uint32_t base =
                  static_cast<uint32_t>((p * q + j) * kBlockBytes);
#pragma unroll
              for (int g = 0; g < NG; ++g) {
                acc[g] ^= lds(s_tab, base + (x & 15u) * 4 + g * kGroupBytes) ^
                          lds(s_tab, base + kHalfBytes + (x >> 4) * 4 +
                                         g * kGroupBytes);
              }
            }
#pragma unroll
            for (int g = 0; g < NG; ++g) {
#pragma unroll
              for (int t = 0; t < kGroupRows; ++t) {
                const int row = (p * NG + g) * kGroupRows + t;
                if (row < r) {
                  dst[row * out_rs + e] =
                      static_cast<uint8_t>(acc[g] >> (8 * t));
                }
              }
            }
          }
          if (sys) {
#pragma unroll 1
            for (int j = 0; j < q; ++j) {
              sys[j * sys_rs + e] = src[j * in_rs + e];
            }
          }
        }
      }
    }
  }
}

template <int NG>
int launch(const void* tables, const void* data, void* out, void* sys_out,
           int B, int q, int r, long long n, long long in_bs, long long in_rs,
           long long out_bs, long long out_rs, long long sys_bs,
           long long sys_rs, int vec, cudaStream_t stream) {
  const int passes = passes_for(r, NG);
  const size_t smem = static_cast<size_t>(passes) * q * kBlockBytes;
  if (smem > kDefaultSmem) {
    // raised once per device, kernel and size, so that a CUDA graph
    // capture of a warmed-up launch makes no attribute call
    static size_t attr[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (smem > attr[dev]) {
      err = cudaFuncSetAttribute(gf_apply_kernel<NG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      attr[dev] = smem;
    }
  }
  // one chunk a thread where the grid allows: short-lived blocks let new
  // blocks' loads overlap older blocks' lookups (a grid sized to the card's
  // residency, each block striding over many chunks, measured slower)
  const long long chunks = (n + 15) / 16;
  long long gx = (chunks + kThreads - 1) / kThreads;
  if (gx > 65535) gx = 65535;
  const int gy = B < 65535 ? B : 65535;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
  gf_apply_kernel<NG><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(tables), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), static_cast<uint8_t*>(sys_out), B, q, r, n,
      in_bs, in_rs, out_bs, out_rs, sys_bs, sys_rs, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables: [r, q, 2, 16] u8 on the device; data [B, q, n] and out [B, r, n]
// (sys_out [B, q, n] or null) u8 with unit stride along n and the given
// batch and row strides in bytes; the shared image, ceil(r / 8) * 8 * q *
// 32 bytes (q * 256 for r <= 4), at most 227 KB. vec != 0 promises that
// every base pointer and stride is a multiple of 16. Returns the first
// CUDA error of the attribute and launch calls.
extern "C" int gf_apply(const void* tables, const void* data, void* out,
                        void* sys_out, int B, int q, int r, long long n,
                        long long in_bs, long long in_rs, long long out_bs,
                        long long out_rs, long long sys_bs, long long sys_rs,
                        int vec, void* stream) {
  if (B <= 0 || n <= 0 || q <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (r <= kGroupRows) {
    return launch<1>(tables, data, out, sys_out, B, q, r, n, in_bs, in_rs,
                     out_bs, out_rs, sys_bs, sys_rs, vec, s);
  }
  return launch<2>(tables, data, out, sys_out, B, q, r, n, in_bs, in_rs,
                   out_bs, out_rs, sys_bs, sys_rs, vec, s);
}
