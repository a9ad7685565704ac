// GF(2^8) matrix apply by a compiled XOR schedule (Hopper, sm_90a).
//
// Replaces the Pallas kernel cess_tpu/ops/rs_xor.py::_make_kernel. It
// computes the same function as gf_apply.cu, out[b, i] = XOR_j mat[i, j] *
// data[b, j] over GF(2^8), bit-sliced on 32-byte groups: one thread takes
// the 32 consecutive bytes (8 words) of every row at one column group and
// bit-transposes each row's 8 words into 8 plane words, bit 8e + k of
// plane b being bit b of byte 4k + e (cess_tpu_torch/ops/rs_xor.py
// planes32 states the same transpose in torch). Input plane (j, b) is
// schedule address 8j + b. Every op of the schedule is then one XOR of
// two plane words, i.e. of 32 data bytes' bits, and output row i is the
// inverse transpose of planes (8i .. 8i+7) of the output block. XOR never
// mixes bit positions, so any bit order is exact; the one chosen costs
// three delta swaps (shift, xor, and, xor, shift, xor on 4 word pairs) a
// transpose, 72 operations per 32 bytes of a row.
//
// The op list is the schedule made uniform on the host (rs_xor.stage_ops,
// pinned on the CPU by rs_xor.xor_apply_sliced32): every op is
// buf[d] = buf[a] ^ buf[b], with one slot past the outputs that always
// holds zero (ACC d ^= a is d = d ^ a, COPY is a ^ zero, ZERO is zero ^
// zero), so the loop has no branch.
//
// Design: an interpreter, so one build serves every schedule (a cold
// repair pattern compiles nothing at run time). The host packs the ops
// into bundles of 4 that read none of one another's results
// (rs_xor.bundled_ops, a list schedule; unfilled slots are zero ^ zero
// into the zero slot), and the kernel issues a bundle's 8 loads before its
// 4 stores, so one link of the chain of shared-memory latencies (an op's
// loads wait for the last store) carries 4 ops. Each block copies the op
// list (d, a, b, 0 as uint16 slots, 32 bytes a bundle) into shared memory,
// where the fetch is a broadcast; the fetch of bundle i + 1 is issued
// before bundle i's stores, from a spare bundle past the end of the list
// for the last one. A thread keeps its whole address space in dynamic
// shared memory, thread-major with an odd stride of `words` words
// (rs_xor.words), so that the 32 lanes of a warp touching one slot hit 32
// distinct banks. T threads a block, the largest
// power of two <= 256 whose words * T * 4 bytes plus the op list fit the
// 227 KB a block may use (RS(4,8) encode: 167 words, T = 256; RS(16,16):
// 875 words, T = 32). One 1-D grid strides over every (batch row, group)
// pair, sized to the blocks the card holds at once.
// Global loads and stores are two 16-byte vectors a row when the row's
// address is 16-byte aligned and the group is whole; otherwise (an
// unaligned view, or the ragged last group of a row) a masked byte loop,
// whose missing bytes are zero planes that are never stored.
//
// Bound: device-memory bytes. Per 32-byte group the kernel does n_xors
// schedule XORs plus 72 transpose operations for each of the q + r rows
// (RS(4,8) encode: 374 + 864 against 384 bytes moved), below the card's
// ratio of integer operations to bytes. What holds it back is shared
// memory: three accesses an op, and the 227 KB keep at most 256 threads
// (8 warps) on an SM at 167 words, too few to hide the latency of a chain
// of single ops; the 32-byte planes make each access carry 8x the bytes
// of 4-byte lanes, and the bundles put 4 ops on each link of the chain.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;

// One delta swap on the 4 word pairs whose indices differ in bit log2(S):
// exchanges that word-index bit with bit log2(S) of the bit-in-byte index.
template <int S, uint32_t M>
__device__ __forceinline__ void swap_stage(uint32_t (&w)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (k & S) continue;
    const uint32_t t = ((w[k] >> S) ^ w[k | S]) & M;
    w[k | S] ^= t;
    w[k] ^= t << S;
  }
}

// 32 bytes (8 little-endian words) <-> 8 planes; its own inverse.
__device__ __forceinline__ void transpose8(uint32_t (&w)[8]) {
  swap_stage<1, 0x55555555u>(w);
  swap_stage<2, 0x33333333u>(w);
  swap_stage<4, 0x0F0F0F0Fu>(w);
}

__device__ __forceinline__ bool whole(const uint8_t* p, int len) {
  return len == 32 && (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void load_group(const uint8_t* p, int len,
                                           uint32_t (&w)[8]) {
  if (whole(p, len)) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(p) + 1);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) w[k] = 0u;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    if (e < len) w[e >> 2] |= static_cast<uint32_t>(p[e]) << (8 * (e & 3));
  }
}

__device__ __forceinline__ void store_group(uint8_t* p, int len,
                                            const uint32_t (&w)[8]) {
  if (whole(p, len)) {
    reinterpret_cast<uint4*>(p)[0] = make_uint4(w[0], w[1], w[2], w[3]);
    reinterpret_cast<uint4*>(p)[1] = make_uint4(w[4], w[5], w[6], w[7]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    if (e < len) p[e] = static_cast<uint8_t>(w[e >> 2] >> (8 * (e & 3)));
  }
}

// op (d, a, b, 0) as two little-endian words: d | a << 16, b
__device__ __forceinline__ uint32_t op_d(uint32_t lo) { return lo & 0xFFFFu; }
__device__ __forceinline__ uint32_t op_a(uint32_t lo) { return lo >> 16; }
__device__ __forceinline__ uint32_t op_b(uint32_t hi) { return hi & 0xFFFFu; }

__global__ void gf_xor_kernel(const uint4* __restrict__ ops, int n_bundles,
                              const uint8_t* __restrict__ data,
                              uint8_t* __restrict__ out,
                              uint8_t* __restrict__ sys_out, int B, int q,
                              int r, int words, int zero, long long n,
                              long long in_bs, long long in_rs,
                              long long out_bs, long long out_rs,
                              long long sys_bs, long long sys_rs) {
  extern __shared__ uint32_t smem[];
  const int T = blockDim.x;
  // two uint4 a bundle, each holding two ops
  uint4* s_ops = reinterpret_cast<uint4*>(smem + static_cast<size_t>(words) * T);
  for (int i = threadIdx.x; i < 2 * n_bundles; i += T) s_ops[i] = ops[i];
  uint32_t* mine = smem + threadIdx.x * words;  // this thread's slots
  mine[zero] = 0u;  // only ever rewritten as zero ^ zero
  __syncthreads();

  const int ob = zero - 8 * r;
  const long long groups = (n + 31) / 32;
  const long long items = groups * B;
  for (long long t = static_cast<long long>(blockIdx.x) * T + threadIdx.x;
       t < items; t += static_cast<long long>(gridDim.x) * T) {
    const long long b = t / groups;
    const long long off = 32 * (t - b * groups);
    const int len = n - off < 32 ? static_cast<int>(n - off) : 32;
    const uint8_t* src = data + b * in_bs + off;
    uint8_t* sys = sys_out ? sys_out + b * sys_bs + off : nullptr;
    for (int j = 0; j < q; ++j) {
      uint32_t w[8];
      load_group(src + j * in_rs, len, w);
      if (sys) store_group(sys + j * sys_rs, len, w);
      transpose8(w);
#pragma unroll
      for (int k = 0; k < 8; ++k) mine[8 * j + k] = w[k];
    }
    uint4 c0 = s_ops[0], c1 = s_ops[1];
    for (int i = 0; i < n_bundles; ++i) {
      // fetched before this bundle's stores, so the fetch is off the chain
      // of shared-memory accesses that the stores and the next bundle's
      // loads form; bundle n_bundles is a spare that nothing runs
      const uint4 n0 = s_ops[2 * i + 2], n1 = s_ops[2 * i + 3];
      const uint32_t v0 = mine[op_a(c0.x)] ^ mine[op_b(c0.y)];
      const uint32_t v1 = mine[op_a(c0.z)] ^ mine[op_b(c0.w)];
      const uint32_t v2 = mine[op_a(c1.x)] ^ mine[op_b(c1.y)];
      const uint32_t v3 = mine[op_a(c1.z)] ^ mine[op_b(c1.w)];
      mine[op_d(c0.x)] = v0;
      mine[op_d(c0.z)] = v1;
      mine[op_d(c1.x)] = v2;
      mine[op_d(c1.z)] = v3;
      c0 = n0;
      c1 = n1;
    }
    uint8_t* dst = out + b * out_bs + off;
    for (int i = 0; i < r; ++i) {
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) w[k] = mine[ob + 8 * i + k];
      transpose8(w);
      store_group(dst + i * out_rs, len, w);
    }
  }
}

}  // namespace

// ops: [4 * n_bundles, 4] uint16 (d, a, b, 0) slots on the device, 16-byte
// aligned, in bundles of 4 ops that read no result of their own bundle;
// data [B, q, n]
// and out [B, r, n] (sys_out [B, q, n] or null) u8 with unit stride along
// n and the given batch and row strides in bytes; words: the odd slot
// stride of a thread, zero: the zero slot (outputs end just below it);
// threads = T, a power of two in [32, 256] whose shared memory (words * T
// * 4 + (n_bundles + 1) * 32 bytes) the caller checked against 227 KB. Any
// alignment: each row access checks its own. Returns the first CUDA error
// of the attribute, occupancy or launch calls.
extern "C" int gf_xor(const void* ops, int n_bundles, const void* data, void* out,
                      void* sys_out, int B, int q, int r, int words, int zero,
                      long long n, long long in_bs, long long in_rs,
                      long long out_bs, long long out_rs, long long sys_bs,
                      long long sys_rs, int threads, void* stream) {
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
                      static_cast<size_t>(n_bundles + 1) * 32;
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
  const long long items = (n + 31) / 32 * B;
  long long blocks = (items + threads - 1) / threads;
  const long long resident = static_cast<long long>(sms[dev]) * per_sm;
  if (blocks > resident) blocks = resident;
  gf_xor_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(ops), n_bundles,
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out),
      static_cast<uint8_t*>(sys_out), B, q, r, words, zero, n, in_bs, in_rs,
      out_bs, out_rs, sys_bs, sys_rs);
  return static_cast<int>(cudaGetLastError());
}
