// int8 implicit-GEMM convolution with a fused int32-bias + fp32 requant
// epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel onnx_rusty_inference_engine_tpu/ops/kernels/
// qmatmul.py::qmatmul_int8_requant (body _mm_requant_kernel) and its 1x1-conv
// wrapper qconv1x1_int8_requant. One kernel covers every symmetric,
// group-1 QLinearConv: 1x1, kxk with padding, and strided; a plain
// [M,K] x [K,N] matrix product is the 1x1 case with H = W = 1.
//
//   M = B*OH*OW output pixels, N = O output channels,
//   K = KH*KW*C, ordered (kh, kw, c) so that a run of channels of one tap is
//   contiguous in channels-last activations.
//   y[m, n] = sat_int8(rint(float(sum_k x[m, k] * w[n, k] + bias[n]) * mult[n]))
//
// The im2col matrix is never written to device memory: each block gathers
// its A tile straight from the channels-last input, reading padding taps as
// 0. The int32 sums stay in registers and only int8 leaves the kernel, which
// is what the TPU kernel kept in VMEM.
//
// What bounds it: SqueezeNet's convs at batch 256 do 2*M*N*K operations over
// a few bytes per output, far above the H100's ~590 int8 operations per byte
// of HBM, so the bound is the int8 tensor-core rate. This first version does
// not reach the tensor cores: it multiplies with __dp4a (four int8 products
// per instruction on the CUDA cores) from a 128x64 output tile per block,
// staged through shared memory with the next K slice prefetched into
// registers. wgmma with TMA-fed tiles is the step that moves it toward the
// bound.
//
// Rounding: __float2int_rn (half to even), as jnp.round does; never roundf.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output pixels per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // K bytes per stage; packed weight rows are padded to it
constexpr int THREADS = 256;  // 16 x 16 threads, each owning 8 pixels x 4 channels
constexpr int TM = 8;
constexpr int TN = 4;

struct ConvShape {
  int B, H, W, C;        // input, channels-last [B, H, W, C]
  int OH, OW, N;         // output
  int KH, KW;
  int stride_h, stride_w;
  int pad_h, pad_w;      // top and left padding; bottom/right follow from OH, OW
  int K, Kp;             // K = KH*KW*C; Kp = packed weight row length (multiple of BK)
  int64_t M;             // B*OH*OW
  int64_t plane;         // output layout: y[(m / plane * N + n) * plane + m % plane]
};

// One byte of the implicit im2col row: 0 outside the image or past K.
__device__ __forceinline__ uint32_t gather_byte(const int8_t* __restrict__ xb,
                                                const ConvShape& s, int k,
                                                int ih0, int iw0) {
  if (k >= s.K) return 0;
  const int tap = k / s.C;
  const int c = k - tap * s.C;
  const int kh = tap / s.KW;
  const int ih = ih0 + kh;
  const int iw = iw0 + (tap - kh * s.KW);
  if ((unsigned)ih >= (unsigned)s.H || (unsigned)iw >= (unsigned)s.W) return 0;
  return (uint8_t)xb[((int64_t)ih * s.W + iw) * s.C + c];
}

// 16 consecutive K bytes of one im2col row, packed little-endian into four
// words (byte k + 4w + i in bits 8i of word w, the order __dp4a pairs them).
// VEC: C % 16 == 0, so the 16 bytes are one aligned run of a single tap.
template <bool VEC>
__device__ __forceinline__ int4 load_a(const int8_t* __restrict__ xb,
                                       const ConvShape& s, bool valid, int k,
                                       int ih0, int iw0) {
  int4 v = make_int4(0, 0, 0, 0);
  if (!valid) return v;
  if (VEC) {
    if (k < s.K) {
      const int tap = k / s.C;
      const int c = k - tap * s.C;
      const int kh = tap / s.KW;
      const int ih = ih0 + kh;
      const int iw = iw0 + (tap - kh * s.KW);
      if ((unsigned)ih < (unsigned)s.H && (unsigned)iw < (unsigned)s.W)
        v = *reinterpret_cast<const int4*>(xb + ((int64_t)ih * s.W + iw) * s.C + c);
    }
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[i >> 2] |= gather_byte(xb, s, k + i, ih0, iw0) << (8 * (i & 3));
    v = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
qconv_int8_requant_kernel(const int8_t* __restrict__ x,
                          const int8_t* __restrict__ w,
                          const float* __restrict__ mult,
                          const int32_t* __restrict__ bias,
                          int8_t* __restrict__ y, ConvShape s) {
  __shared__ __align__(16) int32_t As[BK / 4][BM];
  __shared__ __align__(16) int32_t Bs[BK / 4][BN];

  const int tid = threadIdx.x;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // A loader: one im2col row, 16 of the BK bytes.
  const int a_row = tid >> 1;
  const int a_half = tid & 1;
  const int64_t am = m0 + a_row;
  const bool a_valid = am < s.M;
  int ih0 = 0, iw0 = 0;
  const int8_t* xb = x;
  if (a_valid) {
    const int64_t hw = (int64_t)s.OH * s.OW;
    const int64_t b = am / hw;
    const int pix = (int)(am - b * hw);
    const int oh = pix / s.OW;
    ih0 = oh * s.stride_h - s.pad_h;
    iw0 = (pix - oh * s.OW) * s.stride_w - s.pad_w;
    xb = x + b * s.H * s.W * s.C;
  }
  // B loader: threads 0..127, one packed weight row, 16 of the BK bytes.
  const int b_row = (tid >> 1) & (BN - 1);
  const bool b_loader = tid < 2 * BN;
  const bool b_valid = b_loader && (n0 + b_row) < s.N;
  const int8_t* wr = w + (int64_t)(n0 + b_row) * s.Kp + a_half * 16;

  const int tm = tid & 15;  // pixels tm + 16*i
  const int tn = tid >> 4;  // channels tn*4 + j
  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  const int num_k = s.Kp / BK;
  int4 ra = load_a<VEC>(xb, s, a_valid, a_half * 16, ih0, iw0);
  int4 rb = b_valid ? *reinterpret_cast<const int4*>(wr) : make_int4(0, 0, 0, 0);
  for (int kt = 0; kt < num_k; ++kt) {
    As[a_half * 4 + 0][a_row] = ra.x;
    As[a_half * 4 + 1][a_row] = ra.y;
    As[a_half * 4 + 2][a_row] = ra.z;
    As[a_half * 4 + 3][a_row] = ra.w;
    if (b_loader) {
      Bs[a_half * 4 + 0][b_row] = rb.x;
      Bs[a_half * 4 + 1][b_row] = rb.y;
      Bs[a_half * 4 + 2][b_row] = rb.z;
      Bs[a_half * 4 + 3][b_row] = rb.w;
    }
    __syncthreads();
    if (kt + 1 < num_k) {  // next K slice into registers while this one computes
      const int k = (kt + 1) * BK + a_half * 16;
      ra = load_a<VEC>(xb, s, a_valid, k, ih0, iw0);
      rb = b_valid ? *reinterpret_cast<const int4*>(wr + (kt + 1) * BK)
                   : make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int k4 = 0; k4 < BK / 4; ++k4) {
      int a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[k4][tm + 16 * i];
      const int4 bv = *reinterpret_cast<const int4*>(&Bs[k4][tn * TN]);
      const int b[TN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue in registers: + bias (int32), * mult (fp32), rint, saturate.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + tm + 16 * i;
    if (m >= s.M) continue;
    const int64_t img = m / s.plane;
    const int64_t pix = m - img * s.plane;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tn * TN + j;
      if (n >= s.N) continue;
      const int a = acc[i][j] + (bias != nullptr ? bias[n] : 0);
      int q = __float2int_rn(__fmul_rn(__int2float_rn(a), mult[n]));
      q = min(max(q, -128), 127);
      y[(img * s.N + n) * s.plane + pix] = (int8_t)q;
    }
  }
}

}  // namespace

// x: int8 [B, H, W, C] channels-last; w: int8 [N, Kp], row n = weights of
// output channel n in (kh, kw, c) order, zero past K; mult: f32 [N];
// bias: int32 [N] or null; y: int8, NCHW when plane = OH*OW, [M, N] when
// plane = 1. Launches on `stream` and returns the launch's error code.
extern "C" cudaError_t qconv_int8_requant_launch(
    const void* x, const void* w, const void* mult, const void* bias, void* y,
    int B, int H, int W, int C, int OH, int OW, int N, int KH, int KW,
    int stride_h, int stride_w, int pad_h, int pad_w, int Kp, long long plane,
    void* stream) {
  ConvShape s;
  s.B = B; s.H = H; s.W = W; s.C = C;
  s.OH = OH; s.OW = OW; s.N = N;
  s.KH = KH; s.KW = KW;
  s.stride_h = stride_h; s.stride_w = stride_w;
  s.pad_h = pad_h; s.pad_w = pad_w;
  s.K = KH * KW * C;
  s.Kp = Kp;
  s.M = (int64_t)B * OH * OW;
  s.plane = plane;
  if (s.M <= 0 || N <= 0) return cudaSuccess;
  if (Kp % BK != 0 || Kp < s.K) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((s.M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = (C % 16 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (vec)
    qconv_int8_requant_kernel<true><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(mult), static_cast<const int32_t*>(bias),
        static_cast<int8_t*>(y), s);
  else
    qconv_int8_requant_kernel<false><<<grid, THREADS, 0, st>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(mult), static_cast<const int32_t*>(bias),
        static_cast<int8_t*>(y), s);
  return cudaGetLastError();
}
