// int8 x int8 matrix product for Hopper (sm_90a) on the int8 tensor cores
// (wgmma), with an exact int32 epilogue or a fused bias + requant epilogue
// that leaves int8.
//
// Replaces the TPU kernels onnx_rusty_inference_engine_tpu/ops/kernels/
// qmatmul.py::qmatmul_int8 (body _mm_kernel) and, in its 2-D form,
// qmatmul.py::qmatmul_int8_requant (body _mm_requant_kernel), which
// QLinearMatMul runs for symmetric zero points:
//
//   a    int8 [M, K], row-major, K a multiple of 16 (TMA's row stride; the
//        wrapper pads other K);
//   bp   int8 [N, K]: b [K, N] transposed to K-contiguous rows
//        (ops/kernels/qmatmul_int8.py::pack_qmatmul_weight, made once per
//        weight when an Engine is built);
//   int32 epilogue:   out int32 [M, N] = a @ b, exact;
//   requant epilogue: out int8 or uint8 [M, N] = clamp(rn((a @ b + bias) *
//        mult) + y_zp, the output type's range), per column n, the TPU
//        kernel's f32 arithmetic with explicit _rn intrinsics (no
//        contraction into an FMA can move a tie) and ONNX's output zero
//        point. A uint8 a, an a zero point and a b zero point are the
//        wrapper's (ops/quantized.py): shifted to int8, folded into the bias
//        or corrected after the int32 epilogue.
//
// The mainloop is csrc/int8_wgmma.cuh: A and B reach a 2-8 slot shared-memory
// ring by TMA, and consumer warpgroups run wgmma.m64nNk32.s32.s8.s8 on it.
//
// What bounds it: at BERT-base's shapes (B = 32, T = 128) each byte of a
// and b is used 768-3072 times, far above the H100's ~590 int8 operations
// per byte of HBM, so with an int8 output the bound is the tensor-core rate
// (0.36 ms of 1,979 TOP/s per forward's 73 products), and with an int32
// output the 4-byte result adds as much again in bytes. The design: wgmma
// from swizzled shared memory (no register staging of operands), TMA loads
// in flight while the tensor cores work, and the requant epilogue in
// registers so only int8 leaves the kernel: the separate requant passes
// over an int32 [M, N] tensor go away.

// the mainloop's kernel, named for this library in profiles
#define I8G_KERNEL qmatmul_int8_kernel
#include "int8_wgmma.cuh"

// epilogue: 0 = int32 (mult, bias unused), 1 = requant (mult f32 [N], bias
// int32 [N] or null, out uint8 where y_u8 else int8, y_zp in its range;
// y_zp_dev: null, or an int32 in device memory that the epilogue reads in
// place of y_zp, saturated to the output type's range: a zero point the
// graph computes at run time).
// (bm, bn, stages, b_resident): the tile the wrapper chose
// (qmatmul_int8.py::int8_tile); one that does not fit is refused with
// cudaErrorInvalidValue. Launches on `stream`; returns the launch's error.
extern "C" cudaError_t qmatmul_int8_launch(const void* a, const void* bp, void* out,
                                           const void* mult, const void* bias, int M,
                                           int N, int K, int epilogue, int y_zp, int y_u8,
                                           const void* y_zp_dev,
                                           int bm, int bn, int stages, int b_resident,
                                           void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int lo = y_u8 ? 0 : -128, hi = y_u8 ? 255 : 127;
  if (K <= 0 || K % 16 != 0 || (epilogue != 0 && epilogue != 1) ||
      (epilogue == 1 && mult == nullptr) || y_zp < lo || y_zp > hi)
    return cudaErrorInvalidValue;
  i8g::Params p = {};
  p.M = M;
  p.N = N;
  p.K = K;
  p.stages = stages;
  p.b_resident = b_resident;
  p.out = out;
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const int32_t*>(bias);
  p.q_lo = (float)(lo - y_zp);
  p.q_hi = (float)(hi - y_zp);
  p.y_zp = y_zp;
  p.y_zp_dev = static_cast<const int32_t*>(y_zp_dev);
  p.y_lo = lo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epilogue == 0)
    return i8g::launch<i8g::A_TMA, i8g::EPI_INT32>(a, bp, K, p, bm, bn, st);
  return i8g::launch<i8g::A_TMA, i8g::EPI_REQUANT>(a, bp, K, p, bm, bn, st);
}
