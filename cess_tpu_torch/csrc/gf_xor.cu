// GF(2^8) matrix apply by a compiled XOR schedule (Hopper, sm_90a).
//
// Replaces the Pallas kernel cess_tpu/ops/rs_xor.py::_make_kernel. It
// computes the same function as gf_apply.cu, out[b, i] = XOR_j mat[i, j] *
// data[b, j] over GF(2^8), bit-sliced: four consecutive data bytes form
// one 32-bit lane, input plane (j, bit) is (row_j >> bit) & 0x01010101 (the
// information bit of each byte at bit 0 of its byte lane), and every op of
// the schedule (cess_tpu_torch/ops/xor_sched.py) is one full-lane XOR:
//
//     0 XOR   buf[d] = buf[a] ^ buf[b]      2 COPY  buf[d] = buf[a]
//     1 ACC   buf[d] ^= buf[a]              3 ZERO  buf[d] = 0
//
// over the flat address space [q8 inputs | scratch | r8 outputs]. Output
// plane a of row i is or-ed into the output lane as plane << a. No op
// mixes bit positions across byte lanes, so the byte order round-trips.
//
// Design: an interpreter, so one build serves every schedule and nothing
// is compiled at run time. The op list (op, dst, a, b as uint16) is
// copied by each block into shared memory, where the op fetch is a
// broadcast read. One thread owns one lane column and keeps its whole
// address space in dynamic shared memory, slot-major (buf[slot * T +
// tid]), so a warp's accesses to one slot hit 32 consecutive words and
// never conflict. T is the wrapper's choice: the largest power of two
// <= 256 whose words * T * 4 bytes plus the op list (and one spare op)
// fit the 227 KB a block may use (RS(4,8) encode: 166 words, T = 256).
// One 1-D grid strides over every (batch row, lane) pair, sized to the
// blocks the card holds at once, so any batch size and a ragged last
// wave cost nothing.
// Global loads and stores are 4-byte words by consecutive threads; a lane
// that is not 4-byte aligned or runs past the end of a row takes a masked
// byte loop, so no caller pads.
//
// Bound: integer operations. Each lane costs n_xors schedule ops plus
// 2 * q8 to unpack (shift, mask) and 2 * r8 to pack (shift, or): 566 for
// the RS(4,8) encode against 48 bytes moved, far above the card's ratio.
// Interpreting costs about three shared-memory accesses per op (two
// operands and the result, beside the broadcast op fetch), and each op's
// loads wait for the previous op's store, since any op may read what the
// last one wrote: the kernel is bound by that chain of shared-memory
// latencies well before the integer units. Keeping the scratch in
// registers needs straight-line code generated per schedule.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kMask = 0x01010101u;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t load_lane(const uint8_t* p, int len,
                                              bool word) {
  if (word) return __ldg(reinterpret_cast<const uint32_t*>(p));
  uint32_t w = 0;
  for (int e = 0; e < len; ++e) w |= static_cast<uint32_t>(p[e]) << (8 * e);
  return w;
}

__device__ __forceinline__ void store_lane(uint8_t* p, uint32_t w, int len,
                                           bool word) {
  if (word) {
    *reinterpret_cast<uint32_t*>(p) = w;
    return;
  }
  for (int e = 0; e < len; ++e) p[e] = static_cast<uint8_t>(w >> (8 * e));
}

__global__ void gf_xor_kernel(const ushort4* __restrict__ ops, int n_ops,
                              const uint8_t* __restrict__ data,
                              uint8_t* __restrict__ out,
                              uint8_t* __restrict__ sys_out, int B, int q,
                              int r, int words, long long n, long long in_bs,
                              long long in_rs, long long out_bs,
                              long long out_rs, long long sys_bs,
                              long long sys_rs, int vec) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  ushort4* s_ops = reinterpret_cast<ushort4*>(smem + static_cast<size_t>(words) * T);
  for (int i = threadIdx.x; i < n_ops; i += T) s_ops[i] = ops[i];
  __syncthreads();

  uint32_t* mine = smem + threadIdx.x;  // slot s of this lane: mine[s * T]
  const int ob = words - 8 * r;
  const long long n4 = (n + 3) / 4;
  const long long items = n4 * B;
  for (long long t = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
       t < items; t += static_cast<long long>(gridDim.x) * T) {
    const long long b = t / n4;
    const long long off = 4 * (t - b * n4);
    const int len = n - off < 4 ? static_cast<int>(n - off) : 4;
    const bool word = vec && len == 4;
    const uint8_t* src = data + b * in_bs + off;
    uint8_t* sys = sys_out ? sys_out + b * sys_bs + off : nullptr;
    for (int j = 0; j < q; ++j) {
      const uint32_t w = load_lane(src + j * in_rs, len, word);
      if (sys) store_lane(sys + j * sys_rs, w, len, word);
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) mine[(8 * j + bit) * T] = (w >> bit) & kMask;
    }
    ushort4 op = s_ops[0];  // (op, dst, a, b)
    for (int i = 0; i < n_ops; ++i) {
      // fetched before this op's store, so the fetch is off the chain of
      // shared-memory accesses that a store and the next op's loads form;
      // slot n_ops is a spare that the last fetch reads and nothing runs
      const ushort4 next = s_ops[i + 1];
      uint32_t v;
      switch (op.x) {
        case 0: v = mine[op.z * T] ^ mine[op.w * T]; break;
        case 1: v = mine[op.y * T] ^ mine[op.z * T]; break;
        case 2: v = mine[op.z * T]; break;
        default: v = 0u;
      }
      mine[op.y * T] = v;
      op = next;
    }
    uint8_t* dst = out + b * out_bs + off;
    for (int i = 0; i < r; ++i) {
      uint32_t w = 0;
#pragma unroll
      for (int a = 0; a < 8; ++a) w |= mine[(ob + 8 * i + a) * T] << a;
      store_lane(dst + i * out_rs, w, len, word);
    }
  }
}

}  // namespace

// ops: [n_ops, 4] uint16 (op, dst, a, b) on the device; data [B, q, n] and
// out [B, r, n] (sys_out [B, q, n] or null) u8 with unit stride along n and
// the given batch and row strides in bytes; words = q8 + scratch + r8;
// threads = T, a power of two in [32, 256] whose shared memory (words * T
// * 4 + (n_ops + 1) * 8 bytes) the caller checked against 227 KB. vec != 0
// promises that every base pointer and stride is a multiple of 4. Returns
// the first CUDA error of the attribute, occupancy or launch calls.
extern "C" int gf_xor(const void* ops, int n_ops, const void* data, void* out,
                      void* sys_out, int B, int q, int r, int words,
                      long long n, long long in_bs, long long in_rs,
                      long long out_bs, long long out_rs, long long sys_bs,
                      long long sys_rs, int threads, int vec, void* stream) {
  if (B <= 0 || n <= 0 || q <= 0) return 0;
  // set once per device and size, so that a CUDA graph capture of a
  // warmed-up launch makes no attribute call
  static size_t attr[kMaxDevices];
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  const size_t smem = static_cast<size_t>(words) * threads * 4 +
                      static_cast<size_t>(n_ops + 1) * 8;
  if (smem > attr[dev]) {
    err = cudaFuncSetAttribute(gf_xor_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr[dev] = smem;
  }
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gf_xor_kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const long long items = (n + 3) / 4 * B;
  long long blocks = (items + threads - 1) / threads;
  const long long resident = static_cast<long long>(sms[dev]) * per_sm;
  if (blocks > resident) blocks = resident;
  gf_xor_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ushort4*>(ops), n_ops,
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out),
      static_cast<uint8_t*>(sys_out), B, q, r, words, n, in_bs, in_rs, out_bs,
      out_rs, sys_bs, sys_rs, vec);
  return static_cast<int>(cudaGetLastError());
}
