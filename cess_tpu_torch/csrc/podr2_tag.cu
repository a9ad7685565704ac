// PoDR2 tag generation (Hopper, sm_90a).
//
// podr2_tag replaces the Pallas kernel
// cess_tpu/ops/podr2_pallas.py::_kernel. For fragment f, block b and MAC
// limb l it computes
//
//     tag[f, b, l] = (prf[f, l, b] + sum_i byte[f, b, i] * W[l, i]) mod p
//
// with p = 2^31 - 1 and the interleaved weights W[l, 2j] = alpha[j, l],
// W[l, 2j+1] = 256 * alpha[j, l] mod p, so the raw fragment bytes are
// the multiplicands and no byte-to-element packing pass exists. The TPU
// kernel splits W into 16-bit limbs because Mosaic has no 64-bit
// integers; here W is split into its 4 bytes W_k, so that 4 data bytes
// times 4 weight bytes are one __dp4a (a 32-bit integer instruction that
// takes the packed data word as it was loaded, with no byte extraction):
// S_k = sum_i byte_i * W_k,i stays below 2^20 for a lane's 16 bytes, and
// sum_i byte_i * W_i = S0 + 2^8 S1 + 2^16 S2 + 2^24 S3. That sum is folded
// to 32 bits with 2^31 = 1 mod p (the M31 fold: no 64-bit % anywhere),
// the 32 lanes' partials are added mod p by 32-bit shuffles, and the PRF
// is added with one conditional subtract.
//
// Bound: device-memory bytes (768 MiB of fragments for an RS(2,1) batch
// of 32 segments, against about 1.5 integer instructions per byte and
// limb).
// The design keeps the loads in flight: a warp takes 8 consecutive blocks
// (4 KB) an iteration and issues all 8 16-byte loads of each lane before
// any arithmetic, so 16 resident warps an SM (__launch_bounds__ caps the
// registers at 128 for 2 blocks an SM up to 2 limbs) keep 64 KB of loads
// in flight on each SM, about three times what the card's latency times
// its bandwidth asks for. The alternative, a cp.async or TMA ring in
// shared memory, moves the same bytes through one more hop; registers
// suffice because each byte is used once. The 8 blocks also make the
// cross-lane sum a reduce-scatter: 3 rounds halve the 8 partials a lane
// holds (4 + 2 + 1 shuffles), 2 more finish the sum, and lane t ends with
// block t / 4, whose limb t % 4 it writes: 9 shuffles a limb for 8
// blocks instead of 40. Lane t loads bytes [16t, 16t+16) of a block;
// blocks shorter than 512 bytes (sectors < 256) leave lanes idle, and a
// block size that is not a multiple of 16 or an unaligned pointer takes
// a byte loop.
//
// The per-block PRF that tag generation adds is kernel prf_blocks, in
// csrc/prf_blocks.cu.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kP = 0x7FFFFFFFu;
constexpr int kThreads = 256;
constexpr int kWarpBlocks = 8;     // blocks a warp takes an iteration
constexpr int kMaxDevices = 64;

// a + b for a, b <= p: a value <= p congruent to the sum (p stands for 0)
__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;
  return min(s, s - kP);
}

// One lane's share of one limb of one block: 16 data bytes (4 words) times
// the byte planes wb[g][k] of their 16 weights, as a value <= p.
__device__ __forceinline__ uint32_t lane_mac(const uint4& d,
                                             const uint32_t (&wb)[4][4]) {
  const uint32_t word[4] = {d.x, d.y, d.z, d.w};
  uint32_t s[4] = {0u, 0u, 0u, 0u};  // S_k < 16 * 255 * 255 < 2^20
#pragma unroll
  for (int g = 0; g < 4; ++g) {
#pragma unroll
    for (int k = 0; k < 4; ++k) s[k] = __dp4a(word[g], wb[g][k], s[k]);
  }
  const uint32_t lo = s[0] + (s[1] << 8);  // < 2^29
  const uint32_t hi = s[2] + (s[3] << 8);  // < 2^29
  // lo + hi * 2^16 = lo + (hi >> 15) * 2^31 + (hi & 0x7FFF) * 2^16, and
  // 2^31 = 1 mod p: the sum below stays under 2^32
  const uint32_t x = lo + (hi >> 15) + ((hi & 0x7FFFu) << 16);
  return (x & kP) + (x >> 31);
}

__device__ __forceinline__ uint4 load_block(const uint8_t* src, int base,
                                            int lanes, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const uint4*>(src + base));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    if (base + e < lanes) {
      w[e >> 2] |= static_cast<uint32_t>(src[base + e]) << (8 * (e & 3));
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int L>
__global__ void __launch_bounds__(kThreads, L <= 2 ? 2 : 1)
podr2_tag_kernel(const uint8_t* __restrict__ data,
                 const int32_t* __restrict__ w,
                 const int32_t* __restrict__ prf, int32_t* __restrict__ out,
                 long long F, long long blocks, int lanes, int vec) {
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long nwarps = (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int base = lane * 16;
  const bool live = base < lanes;

  // wb[l][g][k]: byte k of the weights at positions base + 4g .. + 3
  uint32_t wb[L][4][4];
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = base + 4 * g + e;
        wv[e] = pos < lanes ? static_cast<uint32_t>(w[l * lanes + pos]) : 0u;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        uint32_t x = 0u;
#pragma unroll
        for (int e = 0; e < 4; ++e) x |= ((wv[e] >> (8 * k)) & 0xFFu) << (8 * e);
        wb[l][g][k] = x;
      }
    }
  }

  const long long total = F * blocks;
  const long long chunks = (total + kWarpBlocks - 1) / kWarpBlocks;
  for (long long c = warp; c < chunks; c += nwarps) {
    const long long t0 = c * kWarpBlocks;
    // every load of the 8 blocks before any arithmetic
    uint4 d[kWarpBlocks];
#pragma unroll
    for (int k = 0; k < kWarpBlocks; ++k) {
      d[k] = make_uint4(0u, 0u, 0u, 0u);
      if (live && t0 + k < total) {
        d[k] = load_block(data + (t0 + k) * lanes, base, lanes, vec != 0);
      }
    }
    // per limb: 8 partials -> reduce-scatter -> lane holds block lane / 4
    uint32_t tot[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      uint32_t v[kWarpBlocks];
#pragma unroll
      for (int k = 0; k < kWarpBlocks; ++k) v[k] = lane_mac(d[k], wb[l]);
      // lane bit 4 keeps blocks 4..7 (else 0..3), bit 3 the upper pair of
      // those, bit 2 the upper one: the kept block is lane >> 2
#pragma unroll
      for (int half = 4; half >= 1; half >>= 1) {
        const bool up = lane & (half << 2);
#pragma unroll
        for (int k = 0; k < half; ++k) {
          const uint32_t keep = up ? v[k + half] : v[k];
          const uint32_t send = up ? v[k] : v[k + half];
          v[k] = addmod(keep, __shfl_xor_sync(0xFFFFFFFFu, send, half << 2));
        }
      }
      v[0] = addmod(v[0], __shfl_xor_sync(0xFFFFFFFFu, v[0], 2));
      tot[l] = addmod(v[0], __shfl_xor_sync(0xFFFFFFFFu, v[0], 1));
    }
    const int l = lane & 3;
    const long long t = t0 + (lane >> 2);
    if (l < L && t < total) {
      uint32_t mac = 0u;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        if (i == l) mac = tot[i];
      }
      const long long f = t / blocks;
      const long long b = t - f * blocks;
      const uint32_t pv = static_cast<uint32_t>(prf[(f * L + l) * blocks + b]);
      out[t * L + l] = static_cast<int32_t>(addmod(mac, pv));
    }
  }
}

// The card's SM count, read once per device.
cudaError_t sm_count(int* out) {
  static int sms[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *out = sms[dev];
  return cudaSuccess;
}

template <int L>
int launch_tag(const void* data, const void* w, const void* prf, void* out,
               long long F, long long blocks, int lanes, int vec,
               cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  cudaError_t err = sm_count(&sms);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, podr2_tag_kernel<L>, kThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * (per_sm < 1 ? 1 : per_sm);
  const long long warps_per_block = kThreads / 32;
  const long long chunks = (F * blocks + kWarpBlocks - 1) / kWarpBlocks;
  long long grid = (chunks + warps_per_block - 1) / warps_per_block;
  if (grid > resident) grid = resident;
  podr2_tag_kernel<L><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(prf), static_cast<int32_t*>(out), F, blocks,
      lanes, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// data [F, blocks, lanes] u8 (lanes = 2 * sectors <= 512), w [limbs, lanes]
// i32, prf [F, limbs, blocks] i32, out [F, blocks, limbs] i32, all
// contiguous on the device; vec != 0 promises lanes % 16 == 0 and a
// 16-byte aligned data pointer. limbs in 1..4. Returns cudaGetLastError().
extern "C" int podr2_tag(const void* data, const void* w, const void* prf,
                         void* out, long long F, long long blocks, int lanes,
                         int limbs, int vec, void* stream) {
  if (F <= 0 || blocks <= 0) return 0;
  if (lanes <= 0 || lanes > 512) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (limbs) {
    case 1: return launch_tag<1>(data, w, prf, out, F, blocks, lanes, vec, s);
    case 2: return launch_tag<2>(data, w, prf, out, F, blocks, lanes, vec, s);
    case 3: return launch_tag<3>(data, w, prf, out, F, blocks, lanes, vec, s);
    case 4: return launch_tag<4>(data, w, prf, out, F, blocks, lanes, vec, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
