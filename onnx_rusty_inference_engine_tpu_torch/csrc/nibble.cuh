// In-register unpack of one int4 weight byte, shared by the int4 kernels.
//
// A packed byte holds two signed 4-bit values stored as q + 8 in [0, 15]:
// the low nibble and the high nibble. In the planar layout
// (quant.pack_int4_planar) the low nibble is a weight of the first half of
// K and the high nibble the weight at the same place in the second half.
// The values are exact small integers, so they convert to float exactly.
//
// The port of experiments/cast_probe.py::mk, which probed on the TPU which
// uint8 -> int -> float cast chains a Pallas kernel could compile for this
// unpack; csrc/qmatmul_int4.cu exports `nibble_probe_launch`, a kernel that
// applies this function to a whole array so that it can be checked alone.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void unpack_nibbles(uint32_t byte, float& lo,
                                               float& hi) {
  lo = __int2float_rn(static_cast<int>(byte & 0xFu) - 8);
  hi = __int2float_rn(static_cast<int>((byte >> 4) & 0xFu) - 8);
}
