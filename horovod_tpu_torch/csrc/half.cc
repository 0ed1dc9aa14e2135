#include "half.h"

#include <cstring>

namespace hvdtpu {

void Float32ToBfloat16(const float* src, uint16_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &src[i], 4);
    // round-to-nearest-even on the truncated 16 bits
    uint32_t rounding = 0x7FFF + ((bits >> 16) & 1);
    dst[i] = static_cast<uint16_t>((bits + rounding) >> 16);
  }
}

void Bfloat16ToFloat32(const uint16_t* src, float* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t bits = static_cast<uint32_t>(src[i]) << 16;
    std::memcpy(&dst[i], &bits, 4);
  }
}

void Float32ToFloat16(const float* src, uint16_t* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t x;
    std::memcpy(&x, &src[i], 4);
    uint32_t sign = (x >> 16) & 0x8000u;
    int32_t exp = static_cast<int32_t>((x >> 23) & 0xFF) - 127 + 15;
    uint32_t mant = x & 0x7FFFFFu;
    uint16_t h;
    if (exp <= 0) {
      if (exp < -10) {
        h = static_cast<uint16_t>(sign);  // underflow to signed zero
      } else {
        // round-to-nearest-even into the subnormal steps (the JAX
        // package's copy rounds a tie half up)
        mant |= 0x800000u;
        uint32_t shift = 14 - exp;
        uint32_t half = 1u << (shift - 1);
        uint32_t rem = mant & ((1u << shift) - 1);
        uint32_t rounded = mant >> shift;
        if (rem > half || (rem == half && (rounded & 1))) ++rounded;
        h = static_cast<uint16_t>(sign | rounded);
      }
    } else if (exp >= 0x1F) {
      // a finite value past fp16's range overflows to inf (the JAX
      // package's copy makes it a NaN); inf stays inf, NaN a quiet NaN
      bool nan = ((x >> 23) & 0xFF) == 0xFF && mant != 0;
      h = static_cast<uint16_t>(sign | 0x7C00u | (nan ? 0x200u : 0));
    } else {
      uint32_t rounded = (mant + 0xFFFu + ((mant >> 13) & 1)) ;
      if (rounded & 0x800000u) {
        rounded = 0;
        exp += 1;
        if (exp >= 0x1F) {
          h = static_cast<uint16_t>(sign | 0x7C00u);
          dst[i] = h;
          continue;
        }
      }
      h = static_cast<uint16_t>(sign | (exp << 10) | (rounded >> 13));
    }
    dst[i] = h;
  }
}

void Float16ToFloat32(const uint16_t* src, float* dst, size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint16_t h = src[i];
    uint32_t sign = static_cast<uint32_t>(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1Fu;
    uint32_t mant = h & 0x3FFu;
    uint32_t bits;
    if (exp == 0) {
      if (mant == 0) {
        bits = sign;
      } else {
        // subnormal: normalize
        int e = -1;
        do {
          mant <<= 1;
          e++;
        } while (!(mant & 0x400u));
        mant &= 0x3FFu;
        bits = sign | ((127 - 15 - e) << 23) | (mant << 13);
      }
    } else if (exp == 0x1F) {
      bits = sign | 0x7F800000u | (mant << 13);
    } else {
      bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    std::memcpy(&dst[i], &bits, 4);
  }
}

void Bfloat16Sum(const uint16_t* a, const uint16_t* b, uint16_t* out,
                 size_t n) {
  for (size_t i = 0; i < n; ++i) {
    uint32_t ba = static_cast<uint32_t>(a[i]) << 16;
    uint32_t bb = static_cast<uint32_t>(b[i]) << 16;
    float fa, fb;
    std::memcpy(&fa, &ba, 4);
    std::memcpy(&fb, &bb, 4);
    float s = fa + fb;
    Float32ToBfloat16(&s, &out[i], 1);
  }
}

}  // namespace hvdtpu
