// Native host-side quant codecs + repack (the C++ runtime tier).
//
// The reference's entire runtime is native (Zig); here the device path is
// XLA/Pallas, but the host-side model-load hot path — parsing multi-GB GGUF
// block data and repacking it into the planar K-major device layout — is
// implemented here with OpenMP, ~10-30x faster than the numpy fallback on
// 7B-class models. Semantics are bit-identical to zgml/quant/blocks.py
// and repack.py (tests assert exact equality).
//
// Layouts (see zgml/quant/repack.py):
//   Q8_0 raw block: [f16 scale][32 int8]            (34 B / 32 elements)
//   Q4_0 raw block: [f16 scale][16 nibble bytes]    (18 B / 32 elements),
//                   ggml order: byte j holds elements j (lo) and j+16 (hi)
//   repacked: qvals int8 [k_pad, n_pad] (q8) / packed [k_pad/2, n_pad] (q4,
//             half-split along K), scales f32 [k_pad/32, n_pad]
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC host.cpp -o libzgml_host.so

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

// f16 -> f32 (scalar; scales only, not hot)
float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {  // subnormal
            int shift = 0;
            while (!(mant & 0x400)) { mant <<= 1; ++shift; }
            mant &= 0x3FF;
            bits = sign | ((127 - 15 - shift) << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

uint16_t f32_to_f16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, 4);
    uint32_t sign = (bits >> 16) & 0x8000u;
    int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
    uint32_t mant = bits & 0x7FFFFF;
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;
        mant |= 0x800000;
        uint32_t shifted = mant >> (1 - exp + 13);
        // round to nearest even
        uint32_t rem = mant & ((1u << (1 - exp + 13)) - 1);
        uint32_t half = 1u << (1 - exp + 12);
        if (rem > half || (rem == half && (shifted & 1))) shifted++;
        return (uint16_t)(sign | shifted);
    }
    if (exp >= 31) return (uint16_t)(sign | 0x7C00u);
    uint32_t out = sign | ((uint32_t)exp << 10) | (mant >> 13);
    uint32_t rem = mant & 0x1FFF;
    if (rem > 0x1000 || (rem == 0x1000 && (out & 1))) out++;
    return (uint16_t)out;
}

constexpr int QK = 32;
constexpr int Q8_BYTES = 34;
constexpr int Q4_BYTES = 18;

}  // namespace

extern "C" {

// raw Q8_0 for an [n, k] weight -> K-major planar (qvals [k_pad, n_pad],
// scales [k_pad/32, n_pad]); output buffers must be pre-zeroed.
void q8_repack(const uint8_t* raw, int64_t n, int64_t k,
               int64_t n_pad, int64_t k_pad, int8_t* qvals, float* scales) {
    const int64_t blocks_per_row = k / QK;
#pragma omp parallel for schedule(static)
    for (int64_t row = 0; row < n; ++row) {
        const uint8_t* src = raw + row * blocks_per_row * Q8_BYTES;
        for (int64_t b = 0; b < blocks_per_row; ++b) {
            uint16_t h;
            std::memcpy(&h, src, 2);
            scales[b * n_pad + row] = f16_to_f32(h);
            const int8_t* q = (const int8_t*)(src + 2);
            int8_t* dst = qvals + (b * QK) * n_pad + row;
            for (int i = 0; i < QK; ++i) dst[i * n_pad] = q[i];
            src += Q8_BYTES;
        }
    }
}

// raw Q4_0 -> half-split K-major planar (packed [k_pad/2, n_pad]).
// Packed byte row j = (w[j + k_pad/2] << 4) | w[j], nibbles unsigned 0..15;
// caller pre-fills packed with 0x88 (nibble 8 == value 0) and scales with 0.
void q4_repack(const uint8_t* raw, int64_t n, int64_t k,
               int64_t n_pad, int64_t k_pad, int8_t* packed, float* scales) {
    const int64_t blocks_per_row = k / QK;
    const int64_t half = k_pad / 2;
#pragma omp parallel for schedule(static)
    for (int64_t row = 0; row < n; ++row) {
        const uint8_t* src = raw + row * blocks_per_row * Q4_BYTES;
        uint8_t* pk = (uint8_t*)packed;
        for (int64_t b = 0; b < blocks_per_row; ++b) {
            uint16_t h;
            std::memcpy(&h, src, 2);
            scales[b * n_pad + row] = f16_to_f32(h);
            const uint8_t* nib = src + 2;
            // element e of this block lives at global K index kk = b*32+e;
            // its packed home: row kk (lo nibble) if kk < half, else
            // row kk-half (hi nibble)
            for (int i = 0; i < 16; ++i) {
                uint8_t lo = nib[i] & 0x0F;        // element i
                uint8_t hi = nib[i] >> 4;          // element i + 16
                int64_t kk1 = b * QK + i;
                int64_t kk2 = b * QK + i + 16;
                uint8_t* p1 = &pk[(kk1 < half ? kk1 : kk1 - half) * n_pad + row];
                *p1 = (kk1 < half) ? ((*p1 & 0xF0) | lo) : ((*p1 & 0x0F) | (lo << 4));
                uint8_t* p2 = &pk[(kk2 < half ? kk2 : kk2 - half) * n_pad + row];
                *p2 = (kk2 < half) ? ((*p2 & 0xF0) | hi) : ((*p2 & 0x0F) | (hi << 4));
            }
            src += Q4_BYTES;
        }
    }
}

// f32 [nblocks*32] -> raw Q8_0 bytes (ggml semantics: d = absmax/127)
void quantize_q8_0(const float* x, int64_t nblocks, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const float* src = x + b * QK;
        uint8_t* dst = out + b * Q8_BYTES;
        float amax = 0.f;
        for (int i = 0; i < QK; ++i) {
            float a = std::fabs(src[i]);
            if (a > amax) amax = a;
        }
        uint16_t h = f32_to_f16(amax / 127.0f);
        float d = f16_to_f32(h);
        float inv = d > 0.f ? 1.0f / d : 0.0f;
        std::memcpy(dst, &h, 2);
        int8_t* q = (int8_t*)(dst + 2);
        for (int i = 0; i < QK; ++i) {
            float v = std::nearbyint(src[i] * inv);
            if (v > 127.f) v = 127.f;
            if (v < -128.f) v = -128.f;
            q[i] = (int8_t)v;
        }
    }
}

// f32 -> raw Q4_0 (ggml: d = signed-absmax/-8, q = floor(x*inv + 8.5))
void quantize_q4_0(const float* x, int64_t nblocks, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const float* src = x + b * QK;
        uint8_t* dst = out + b * Q4_BYTES;
        float amax = 0.f, maxv = 0.f;
        for (int i = 0; i < QK; ++i) {
            float a = std::fabs(src[i]);
            if (a > amax) { amax = a; maxv = src[i]; }
        }
        uint16_t h = f32_to_f16(maxv / -8.0f);
        float d = f16_to_f32(h);
        float inv = d != 0.f ? 1.0f / d : 0.0f;
        std::memcpy(dst, &h, 2);
        uint8_t* nib = dst + 2;
        for (int i = 0; i < 16; ++i) {
            int lo = (int)(src[i] * inv + 8.5f);
            int hi = (int)(src[i + 16] * inv + 8.5f);
            if (lo < 0) lo = 0; if (lo > 15) lo = 15;
            if (hi < 0) hi = 0; if (hi > 15) hi = 15;
            nib[i] = (uint8_t)(lo | (hi << 4));
        }
    }
}

void dequant_q8_0(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* src = raw + b * Q8_BYTES;
        uint16_t h;
        std::memcpy(&h, src, 2);
        float d = f16_to_f32(h);
        const int8_t* q = (const int8_t*)(src + 2);
        float* dst = out + b * QK;
        for (int i = 0; i < QK; ++i) dst[i] = q[i] * d;
    }
}

void dequant_q4_0(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* src = raw + b * Q4_BYTES;
        uint16_t h;
        std::memcpy(&h, src, 2);
        float d = f16_to_f32(h);
        const uint8_t* nib = src + 2;
        float* dst = out + b * QK;
        for (int i = 0; i < 16; ++i) {
            dst[i] = (float)((int)(nib[i] & 0x0F) - 8) * d;
            dst[i + 16] = (float)((int)(nib[i] >> 4) - 8) * d;
        }
    }
}

}  // extern "C"
