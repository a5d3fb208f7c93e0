// In-register unpack of int4 weight bytes, shared by the int4 kernels.
//
// A packed byte holds two signed 4-bit values stored as q + 8 in [0, 15]:
// the low nibble and the high nibble. In the planar layout
// (quant.pack_int4_planar) the low nibble is a weight of the first half of
// K and the high nibble the weight at the same place in the second half;
// in the interleaved layout (quant.pack_int4) they are two consecutive k.
// The values are exact small integers, so every variant below is exact.
//
// Variants, by the schedule of csrc/qmatmul_int4.cu that uses them:
//   unpack_nibbles       int -> float conversions (the `general` schedule);
//   unpack_nibbles_f32   the same values by a float bit trick, two full-rate
//                        instructions per nibble (the `small_m` schedule);
//   nibble_pairs_bf16    four bytes -> four bf16x2 mma B registers, each the
//                        (low, high) nibbles of one byte (`mma`, interleaved);
//   nibble_planes_bf16   four bytes -> two bf16x2 registers of low nibbles and
//                        two of high nibbles, bytes (0, 1) and (2, 3) paired
//                        (`mma`, planar).
//
// The port of experiments/cast_probe.py::mk, which probed on the TPU which
// uint8 -> int -> float cast chains a Pallas kernel could compile for this
// unpack; csrc/qmatmul_int4.cu exports `nibble_probe_launch`, a kernel that
// applies one variant to a whole array so that it can be checked alone.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

__device__ __forceinline__ void unpack_nibbles(uint32_t byte, float& lo,
                                               float& hi) {
  lo = __int2float_rn(static_cast<int>(byte & 0xFu) - 8);
  hi = __int2float_rn(static_cast<int>((byte >> 4) & 0xFu) - 8);
}

// 0x4B000000 | v is the float 2^23 + v for v < 2^23, so subtracting
// 2^23 + 8 leaves v - 8 exactly.
__device__ __forceinline__ float nibble_f32(uint32_t v) {
  return __uint_as_float(0x4B000000u | (v & 0xFu)) - 8388616.0f;
}

__device__ __forceinline__ void unpack_nibbles_f32(uint32_t byte, float& lo,
                                                   float& hi) {
  lo = nibble_f32(byte);
  hi = nibble_f32(byte >> 4);
}

// bits holds a nibble in bits [0, 4) and one in [16, 20). 0x4300 | v is the
// bf16 of 128 + v (v < 128), so subtracting 136 (0x4308) leaves v - 8 in
// each half exactly.
__device__ __forceinline__ uint32_t nibble_bf16x2(uint32_t bits) {
  const uint32_t x = bits | 0x43004300u;
  const uint32_t bias = 0x43084308u;
  const __nv_bfloat162 r =
      __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&x),
              *reinterpret_cast<const __nv_bfloat162*>(&bias));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// p[i] = (low nibble of byte i, high nibble of byte i), low half first.
__device__ __forceinline__ void nibble_pairs_bf16(uint32_t w, uint32_t (&p)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = w >> (8 * i);
    p[i] = nibble_bf16x2((b & 0xFu) | ((b << 12) & 0xF0000u));
  }
}

// lo[0] = (low nibbles of bytes 0, 1), lo[1] = (of bytes 2, 3); hi the same
// for the high nibbles.
__device__ __forceinline__ void nibble_planes_bf16(uint32_t w, uint32_t (&lo)[2],
                                                   uint32_t (&hi)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t b = w >> (16 * i);
    lo[i] = nibble_bf16x2((b & 0xFu) | ((b << 8) & 0xF0000u));
    hi[i] = nibble_bf16x2(((b >> 4) & 0xFu) | ((b << 4) & 0xF0000u));
  }
}
