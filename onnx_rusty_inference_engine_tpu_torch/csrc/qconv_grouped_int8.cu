// int8 grouped convolution (MobileNetV2's depthwise convs, and any
// group > 1) with a fused int32-bias + f32 requant epilogue, for Hopper
// (sm_90a).
//
// No Pallas kernel stands behind it: for group > 1 the JAX package runs
// XLA's lax.conv_general_dilated(feature_group_count=group,
// preferred_element_type=int32), then + bias and _requant
// (onnx_rusty_inference_engine_tpu/ops/quantized.py::qlinear_conv). On the
// card no library call takes int8 operands for a grouped conv, and running
// the int8 values through cuDNN in f32 would let cuDNN pick a rounding
// (Winograd or FFT) algorithm, so this kernel computes it exactly.
//
//   x  int8 [B, H, W, C] channels-last (the previous conv's output as it
//      leaves the int8 kernels), C = group * Cg;
//   w  int8 [KH, KW, Cg, Op]: tap (kh, kw), input channel c of the group,
//      output channel o; Op = O rounded up to 4, zero past O
//      (ops/kernels/qconv_grouped_int8.py::pack_qconv_grouped_weight);
//   y  int8 [M, O], M = B*OH*OW: channels-last output;
//   y[m, o] = sat_int8(rint(float(sum_{kh,kw,c} x[b, ih, iw, g*Cg + c]
//             * w[kh, kw, c, o] + bias[o]) * mult[o])),  g = o / Og,
//   Og = O / group, padding taps contributing 0.
//
// One thread computes a run of 4 output channels of one output pixel; the
// threads of a warp take neighbouring runs of one pixel, so each tap's
// loads of a warp are contiguous. Two forms, chosen by the wrapper:
//   mode 0 (depthwise, Cg = Og = 1, C % 4 == 0, x 4-byte aligned): the 4
//     channels' taps are one char4 load of x and one of w;
//   mode 1 (any other): each output channel reads its own group's bytes.
// The sums are int32 in registers; only int8 leaves the kernel.
//
// What bounds it: a depthwise 3x3 does 18 operations per output byte and
// reads each input byte 9 / stride^2 times (from L1/L2), far below the
// H100's ~590 int8 operations per byte of HBM: the bytes bound it (the
// input read once, the output written once). The design reads x in 4-byte
// runs that coalesce across a warp and writes 4 output bytes a thread; it
// does not stage tiles in shared memory, a later step.
//
// Rounding: __float2int_rn (half to even), as jnp.round does; the multiply
// by __fmul_rn, so no contraction into an FMA can move a tie.
//
// Capturable in a CUDA graph: it launches on the stream it is given,
// allocates nothing and does not synchronise.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* mult;
  const int32_t* bias;  // null: no bias
  int8_t* y;
  long long M;
  int H, W, C, OH, OW, O, Op, Cg, Og, KH, KW, stride_h, stride_w, pad_h, pad_w;
};

template <int MODE>
__global__ void __launch_bounds__(256) qconv_grouped_int8_requant_kernel(const Params p) {
  const int runs = p.Op >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.M * runs) return;
  const int o0 = (int)(t % runs) * 4;
  const long long m = t / runs;
  const int ow = (int)(m % p.OW);
  const long long r = m / p.OW;
  const int oh = (int)(r % p.OH);
  const long long b = r / p.OH;

  int acc[4] = {0, 0, 0, 0};
  const int8_t* xb = p.x + b * p.H * p.W * p.C;
  for (int kh = 0; kh < p.KH; ++kh) {
    const int ih = oh * p.stride_h - p.pad_h + kh;
    if (ih < 0 || ih >= p.H) continue;
    for (int kw = 0; kw < p.KW; ++kw) {
      const int iw = ow * p.stride_w - p.pad_w + kw;
      if (iw < 0 || iw >= p.W) continue;
      const int8_t* px = xb + ((long long)ih * p.W + iw) * p.C;
      const int8_t* pw = p.w + (long long)(kh * p.KW + kw) * p.Cg * p.Op + o0;
      if (MODE == 0) {
        const char4 xv = *reinterpret_cast<const char4*>(px + o0);
        const char4 wv = *reinterpret_cast<const char4*>(pw);
        acc[0] += (int)xv.x * (int)wv.x;
        acc[1] += (int)xv.y * (int)wv.y;
        acc[2] += (int)xv.z * (int)wv.z;
        acc[3] += (int)xv.w * (int)wv.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + j;
          if (o >= p.O) break;
          const int8_t* pg = px + (o / p.Og) * p.Cg;
          int s = 0;
          for (int c = 0; c < p.Cg; ++c) s += (int)pg[c] * (int)pw[(long long)c * p.Op + j];
          acc[j] += s;
        }
      }
    }
  }

  int8_t q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + j;
    int v = 0;
    if (o < p.O) {
      const int s = acc[j] + (p.bias != nullptr ? p.bias[o] : 0);
      v = __float2int_rn(__fmul_rn(__int2float_rn(s), p.mult[o]));
      v = v < -128 ? -128 : (v > 127 ? 127 : v);
    }
    q[j] = (int8_t)v;
  }
  int8_t* dst = p.y + m * p.O + o0;
  if (p.O % 4 == 0) {
    *reinterpret_cast<char4*>(dst) = make_char4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (o0 + j < p.O) dst[j] = q[j];
  }
}

}  // namespace

// x, w (packed), mult f32 [O], bias int32 [O] or null, y int8 [M, O]. mode:
// 0 depthwise char4 (requires Cg = Og = 1, C % 4 == 0 and x 4-byte
// aligned), 1 any. The output
// pointer must be 4-byte aligned when O % 4 == 0. Launches on `stream`;
// returns the launch's error.
extern "C" cudaError_t qconv_grouped_int8_requant_launch(
    const void* x, const void* w, const void* mult, const void* bias, void* y, int B,
    int H, int W, int C, int OH, int OW, int O, int Cg, int KH, int KW, int stride_h,
    int stride_w, int pad_h, int pad_w, int mode, void* stream) {
  const long long M = (long long)B * OH * OW;
  if (M <= 0 || O <= 0) return cudaSuccess;
  if (x == nullptr || w == nullptr || mult == nullptr || y == nullptr || Cg <= 0 ||
      C % Cg != 0 || KH <= 0 || KW <= 0 || stride_h <= 0 || stride_w <= 0 || pad_h < 0 ||
      pad_w < 0)
    return cudaErrorInvalidValue;
  const int group = C / Cg;
  if (O % group != 0) return cudaErrorInvalidValue;
  const int Og = O / group;
  if (O % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 4 != 0) return cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const int32_t*>(bias);
  p.y = static_cast<int8_t*>(y);
  p.M = M;
  p.H = H;
  p.W = W;
  p.C = C;
  p.OH = OH;
  p.OW = OW;
  p.O = O;
  p.Op = (O + 3) / 4 * 4;
  p.Cg = Cg;
  p.Og = Og;
  p.KH = KH;
  p.KW = KW;
  p.stride_h = stride_h;
  p.stride_w = stride_w;
  p.pad_h = pad_h;
  p.pad_w = pad_w;
  const long long threads = M * (p.Op / 4);
  const long long blocks = (threads + 255) / 256;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == 0) {
    if (Cg != 1 || Og != 1 || C % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 4 != 0)
      return cudaErrorInvalidValue;
    qconv_grouped_int8_requant_kernel<0><<<(unsigned)blocks, 256, 0, st>>>(p);
  } else if (mode == 1) {
    qconv_grouped_int8_requant_kernel<1><<<(unsigned)blocks, 256, 0, st>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
