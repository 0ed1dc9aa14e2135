// 16-bit float conversion (native core).
//
// Reference equivalent: horovod/common/half.{h,cc} — fp16<->fp32 conversion
// plus the custom MPI float16 sum op (with F16C fast path). The port's copy
// of the JAX package's csrc/half.h: f32<->bf16 bulk converters
// (round-to-nearest-even) and fp16 converters, exported through c_api.cc.
// The port's runtime casts with torch; tests/test_torch_native.py holds
// these to torch's casts bit for bit on finite values and pins where they
// differ on NaN. Two faults of the JAX package's fp16 conversion are
// repaired in this copy: a finite value past fp16's range became a NaN (it
// overflows to inf), and a subnormal tie rounded half up (now to even).
#pragma once

#include <cstddef>
#include <cstdint>

namespace hvdtpu {

// bf16: top 16 bits of f32, round-to-nearest-even.
void Float32ToBfloat16(const float* src, uint16_t* dst, size_t n);
void Bfloat16ToFloat32(const uint16_t* src, float* dst, size_t n);

// IEEE fp16 (no F16C requirement; portable bit manipulation).
void Float32ToFloat16(const float* src, uint16_t* dst, size_t n);
void Float16ToFloat32(const uint16_t* src, float* dst, size_t n);

// Elementwise sum in 16-bit-in/16-bit-out with f32 accumulation — the role
// of the reference's float16_sum MPI op (half.h:57).
void Bfloat16Sum(const uint16_t* a, const uint16_t* b, uint16_t* out,
                 size_t n);

}  // namespace hvdtpu
