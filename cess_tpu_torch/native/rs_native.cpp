// Native (C++) GF(2^8) Reed-Solomon matrix apply — the framework's
// CPU data-plane backend behind the ErasureCodec gate
// (cess_tpu_torch/ops/rs.py make_codec backend="native"), the port's
// own copy of the reference package's native/rs_native.cpp.
//
// Role: the reference's off-chain components do sequential CPU
// RS-encode (SURVEY.md §2.4); this is that path done properly in
// native code — nibble-split table lookups (the classic SIMD erasure
// scheme) with an AVX2 vpshufb fast path and a portable scalar
// fallback, optionally threaded across the batch axis. It doubles as
// the honest "single-node CPU reed-solomon" baseline for the ≥40×
// TPU-speedup metric in BASELINE.md.
//
// ABI (ctypes, cess_tpu_torch/ops/rs_native.py; built by g++ at first
// use into build/native/, cess_tpu_torch/_build.py build_host):
//   cess_rs_apply(mat[r*q], r, q, data[batch*q*n], batch, n,
//                 out[batch*r*n], threads)
// applies the GF(2^8) matrix to every batch element:
//   out[b, i, :] = XOR_j mat[i, j] * data[b, j, :]
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

namespace {

uint8_t EXPT[510];
int LOGT[256];

struct TableInit {
    TableInit() {
        int x = 1;
        for (int i = 0; i < 255; i++) {
            EXPT[i] = static_cast<uint8_t>(x);
            LOGT[x] = i;
            x <<= 1;
            if (x & 0x100) x ^= 0x11D;  // same polynomial as ops/gf.py
        }
        for (int i = 255; i < 510; i++) EXPT[i] = EXPT[i - 255];
        LOGT[0] = 0;
    }
} table_init;

inline uint8_t gf_mul(uint8_t a, uint8_t b) {
    if (!a || !b) return 0;
    return EXPT[LOGT[a] + LOGT[b]];
}

// one output row for one batch element: dst ^= sum_j mat[i,j] * src_j
void apply_row(const uint8_t* tabs, int q, const uint8_t* dbase,
               int64_t n, uint8_t* dst) {
    std::memset(dst, 0, static_cast<size_t>(n));
    for (int j = 0; j < q; j++) {
        const uint8_t* src = dbase + static_cast<int64_t>(j) * n;
        const uint8_t* t = tabs + static_cast<size_t>(j) * 32;
        int64_t x = 0;
#if defined(__AVX2__)
        const __m256i tlo = _mm256_broadcastsi128_si256(
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(t)));
        const __m256i thi = _mm256_broadcastsi128_si256(
            _mm_loadu_si128(reinterpret_cast<const __m128i*>(t + 16)));
        const __m256i maskf = _mm256_set1_epi8(0x0F);
        for (; x + 32 <= n; x += 32) {
            __m256i v = _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(src + x));
            __m256i lo = _mm256_and_si256(v, maskf);
            __m256i hi = _mm256_and_si256(_mm256_srli_epi16(v, 4), maskf);
            __m256i p = _mm256_xor_si256(_mm256_shuffle_epi8(tlo, lo),
                                         _mm256_shuffle_epi8(thi, hi));
            __m256i o = _mm256_loadu_si256(
                reinterpret_cast<const __m256i*>(dst + x));
            _mm256_storeu_si256(reinterpret_cast<__m256i*>(dst + x),
                                _mm256_xor_si256(o, p));
        }
#endif
        for (; x < n; x++)
            dst[x] ^= static_cast<uint8_t>(t[src[x] & 15] ^
                                           t[16 + (src[x] >> 4)]);
    }
}

void apply_range(const uint8_t* tabs, int r, int q, const uint8_t* data,
                 int64_t b0, int64_t b1, int64_t n, uint8_t* out) {
    for (int64_t b = b0; b < b1; b++) {
        const uint8_t* dbase = data + b * q * n;
        uint8_t* obase = out + b * r * n;
        for (int i = 0; i < r; i++)
            apply_row(tabs + static_cast<size_t>(i) * q * 32, q, dbase, n,
                      obase + static_cast<int64_t>(i) * n);
    }
}

}  // namespace

extern "C" {

int cess_rs_simd() {
#if defined(__AVX2__)
    return 2;
#else
    return 0;
#endif
}

void cess_rs_apply(const uint8_t* mat, int r, int q, const uint8_t* data,
                   int64_t batch, int64_t n, uint8_t* out, int threads) {
    // nibble split tables per matrix entry: t[0..15] = c * x,
    // t[16..31] = c * (x << 4); so c*b == t[b&15] ^ t[16 + (b>>4)]
    std::vector<uint8_t> tabs(static_cast<size_t>(r) * q * 32);
    for (int i = 0; i < r; i++)
        for (int j = 0; j < q; j++) {
            uint8_t c = mat[i * q + j];
            uint8_t* t = &tabs[(static_cast<size_t>(i) * q + j) * 32];
            for (int x = 0; x < 16; x++) {
                t[x] = gf_mul(c, static_cast<uint8_t>(x));
                t[16 + x] = gf_mul(c, static_cast<uint8_t>(x << 4));
            }
        }
    if (threads <= 1 || batch <= 1) {
        apply_range(tabs.data(), r, q, data, 0, batch, n, out);
        return;
    }
    int nt = threads < batch ? threads : static_cast<int>(batch);
    std::vector<std::thread> pool;
    int64_t per = (batch + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int64_t b0 = t * per, b1 = b0 + per < batch ? b0 + per : batch;
        if (b0 >= b1) break;
        pool.emplace_back(apply_range, tabs.data(), r, q, data, b0, b1, n,
                          out);
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
