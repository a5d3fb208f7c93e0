// int8 implicit-GEMM convolution with a fused int32-bias + f32 requant
// epilogue, or an exact int32 output, for Hopper (sm_90a), on the int8
// tensor cores (wgmma).
//
// Replaces the TPU kernel onnx_rusty_inference_engine_tpu/ops/kernels/
// qmatmul.py::qmatmul_int8_requant (body _mm_requant_kernel) and its 1x1-conv
// wrapper qconv1x1_int8_requant. One entry point covers every group-1
// QLinearConv (1x1, kxk with padding, strided, dilated; 3-D, 2-D, and 1-D
// as H = 1) and ConvInteger, with ONNX Runtime's QOperator forms: uint8 or
// int8 activations with a zero point, uint8 or int8 output with one, each
// zero point a launch argument or an int32 in device memory.
//
//   x  int8 or uint8 (x_u8) [B, D, H, W, C] channels-last, C a multiple of
//      4 (the wrapper pads other C with zero channels); a 2-D conv is D = 1;
//   w  int8 [N, Kp]: row n = output channel n's taps in (kd, kh, kw, c)
//      order, K = KD*KH*KW*C, zero past K, Kp = K rounded up to 16
//      (ops/kernels/qconv_int8.py::pack_qconv_weight);
//   requant: y int8 or uint8 [M, N], M = B*OD*OH*OW, channels-last (the
//      next conv reads it as it is):
//      y[m, n] = clamp(rint(float(sum_k x[m, k] * w[n, k] + bias[n]) * mult[n])
//                + y_zp, the output type's range);
//   int32:   y int32 [M, N] = sum_k x[m, k] * w[n, k], exact.
// Padding taps hold pad_byte (the x zero point): ONNX pads a quantized conv
// with it, so with the zero point folded into the bias
// (-zx * sum_k w[n, k], by the caller) every tap of the window is x - zx.
// The depth is a run-time size, not a template parameter: the 3-D form is
// the same instances (a depth tap in the gather's index math and bounds
// test), and a 2-D conv runs it at D = OD = KD = 1.
//
// The mainloop is csrc/int8_wgmma.cuh. Three A producers:
//   producer 0 (TMA): a 1x1, stride-1, unpadded conv with C % 16 == 0 is a
//     plain matrix product over the channels-last input [M, C] (either
//     epilogue: a 1x1 has no padding tap, so the x zero point never enters
//     A);
//   producer 1 (gather): any other conv; the im2col matrix is never
//     written to device memory, each block gathers its A tile straight from
//     x by cp.async into the ring (16-, 8- or 4-byte runs, one tap's
//     channels each), filling padding taps with zeros or the pad byte;
//   producer 2 (staged halo): a 2-D or 3-D conv at unit stride and
//     dilation over C % 16 == 0 channels (C <= 128 or C % 128 == 0), either
//     epilogue (R3D-18's 13 stride-1 3x3x3 convs; SqueezeNet's fires 2-5
//     expands, ResNet-50's and UNet's stride-1 3x3s, as conv_plan's
//     fallback rule gives them): a tile is 2 (bm 128)
//     or 4 (bm 256) patches of 8 x 8 output pixels, stacked along depth (3-D)
//     or rows (2-D: 16 or 32 rows x 8 columns), its input box with the halo
//     lands by TMA once per tile (per 128-channel chunk), and each tap's A
//     is a wgmma descriptor into it.
//     The gather is bound by its instructions per copied run and reads each
//     input byte from L2 once per tap (9 times for a 3x3, 27 for a 3x3x3);
//     this producer has no per-run address arithmetic and reads it ~1.3
//     (2-D 3x3, 32 x 8 tiles) or ~3.1 (3x3x3) times a tile.
// The int32 sums stay in registers and only int8 leaves the kernel, as the
// TPU kernel kept them in VMEM.
//
// What bounds it: SqueezeNet's 3x3 expands and conv10 at batch 256 do
// 2*M*N*K operations on few bytes per output, above the H100's ~590 int8
// operations per byte of HBM: the tensor-core rate bounds them. Its 1x1
// squeezes (N = 16-64) and conv1 move more bytes than they compute: HBM
// bounds those. The design keeps both rates in reach: wgmma fed from a ring
// of asynchronous copies for the first kind, an N tile sized to the layer
// (16-256 wide, so a squeeze wastes no tensor-core columns) and coalesced
// 16-byte int8 stores for the second. The zero points cost nothing per
// multiply: the x zero point lives in the bias and the pad bytes, a uint8 x
// goes to wgmma's .u8 A as it is, and y_zp is one add in the epilogue.
//
// Rounding: __float2int_rn (half to even), as jnp.round does; never roundf.

// the mainloop's kernel, named for this library in profiles
#define I8G_KERNEL qconv_int8_requant_kernel
#include "int8_wgmma.cuh"

// The stems' space-to-depth layout (ops/kernels/qconv_int8.py: stem_s2d,
// s2d_conv): a stride-2 conv over C <= 4 channels runs as a stride-1 conv
// over 16 on y int8 or uint8 [B, D, Hs, Ws, 16], pixel (i, j) channel
// (2 sh + sw) * 4 + c = x[b, c, d, 2 i + sh - mh, 2 j + sw - mw], the pad
// byte where that lies outside x or c >= C (mh, mw: 1 where the conv's
// leading padding is odd, so that its padding covers whole pixels). x is
// [B, C, D, H, W] at any strides (NCHW, or channels-last). It replaces no
// TPU kernel: it is the stems' half of the rewrite (the JAX package runs
// the original conv in lax.conv_general_dilated) and takes the place of
// the copy that padded C to 4. Bound by bytes (x read once, y written
// once): one thread a pixel, its 16 bytes stored at once (a warp's stores
// one 512-byte run), its 4 C bytes loaded at x's strides (from NCHW a
// warp's loads of one channel row are 64 bytes, two a byte pair apart).
// The pad byte is the launch's, or the x zero point in device memory
// (x_zp, saturated to x's type), read in the run, so a captured CUDA graph
// replays with each run's value.
__global__ void __launch_bounds__(256)
    qconv_s2d_kernel(const uint8_t* __restrict__ x, uint4* __restrict__ y,
                     const int32_t* x_zp, int x_lo, uint32_t pad_byte, int C, int D, int H,
                     int W, long long sb, long long sc, long long sd, long long sh,
                     long long sw, int Hs, int Ws, int mh, int mw, long long pixels) {
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= pixels) return;
  const uint32_t pad =
      x_zp != nullptr ? (uint32_t)(i8g::sat8(*x_zp, x_lo) & 0xFF) : pad_byte;
  const int j = (int)(pix % Ws);
  long long t = pix / Ws;
  const int i = (int)(t % Hs);
  t /= Hs;
  const int d = (int)(t % D);
  const uint8_t* xb = x + (t / D) * sb + d * sd;
  uint32_t word[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {  // s = 2 sh + sw
    const int ih = 2 * i + (s >> 1) - mh, iw = 2 * j + (s & 1) - mw;
    const bool in = (unsigned)ih < (unsigned)H && (unsigned)iw < (unsigned)W;
    const uint8_t* px = xb + ih * sh + iw * sw;
    uint32_t v = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      v |= (in && c < C ? (uint32_t)px[c * sc] : pad) << (8 * c);
    word[s] = v;
  }
  y[pix] = make_uint4(word[0], word[1], word[2], word[3]);
}

// x int8 or uint8 (x_u8) [B, C, D, H, W] at element strides (sb, sc, sd,
// sh, sw), C <= 4 -> y [B, D, Hs, Ws, 16] (16-byte aligned); mh, mw 0 or 1;
// pad_byte the pad value's byte, or x_zp an int32 in device memory read in
// its place. Launches on `stream`; returns the launch's error.
extern "C" cudaError_t qconv_s2d_launch(const void* x, void* y, const void* x_zp, int B, int C,
                                        int D, int H, int W, long long sb, long long sc,
                                        long long sd, long long sh, long long sw, int Hs,
                                        int Ws, int mh, int mw, int x_u8, int pad_byte,
                                        void* stream) {
  if (B < 1 || C < 1 || C > 4 || D < 1 || H < 1 || W < 1 || Hs < 1 || Ws < 1 ||
      (mh != 0 && mh != 1) || (mw != 0 && mw != 1) || pad_byte < 0 || pad_byte > 255 ||
      reinterpret_cast<uintptr_t>(y) % 16 != 0)
    return cudaErrorInvalidValue;
  const long long pixels = (long long)B * D * Hs * Ws;
  const long long blocks = (pixels + 255) / 256;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  qconv_s2d_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint4*>(y),
      static_cast<const int32_t*>(x_zp), x_u8 ? 0 : -128, (uint32_t)pad_byte, C, D, H, W, sb,
      sc, sd, sh, sw, Hs, Ws, mh, mw, pixels);
  return cudaGetLastError();
}

// the TMA producer's int32 epilogue (the 1x1 ConvInteger) is instanced at
// this BM alone, the tiles its plans pick (ops/kernels/qconv_int8.py,
// TILE_TMA_INT32_BM, which a test holds equal to it)
constexpr int TMA_INT32_BM = 128;

// x_u8: x is uint8 (wgmma's .u8 A), else int8.
// epilogue: 0 = int32 (mult, bias unused), 1 = requant (mult f32 [N],
// bias int32 [N] or null, y uint8 where y_u8 else int8).
// producer 0 requires KD = KH = KW = 1, unit strides, no padding, OD = D
// and C % 16 == 0 (and bm 128 on the int32 epilogue); producer 1 requires
// C % 4 == 0; producer 2 unit strides and dilations, C % 16 == 0 (C <= 128
// or C % 128 == 0), Kp = K and bm 128 or 256 (bn 64, 96 or 128; a 2-D conv, D
// = KD = 1 without depth padding, stacks the tile along rows). pad_byte: the byte a
// padding tap holds; x_zp: null, or an int32 in device memory that the
// kernel reads in its place (producer 0 has no padding to fill). y_zp_dev: null, or an int32 in
// device memory that the requant epilogue reads in place of y_zp. A value
// read from the device is saturated to its type's range.
// (bm, bn, stages, b_resident): the tile the wrapper chose
// (qmatmul_int8.py::int8_tile); one that does not fit is refused with
// cudaErrorInvalidValue. Launches on `stream`; returns the launch's error.
extern "C" cudaError_t qconv_int8_launch(
    const void* x, const void* w, const void* mult, const void* bias, void* y,
    const void* x_zp, const void* y_zp_dev, int B, int D, int H, int W, int C, int OD,
    int OH, int OW, int N, int KD, int KH, int KW, int stride_d, int stride_h, int stride_w,
    int pad_d, int pad_h, int pad_w, int dil_d, int dil_h, int dil_w, int Kp, int producer,
    int epilogue, int x_u8, int pad_byte, int y_zp, int y_u8, int bm, int bn, int stages,
    int b_resident, void* stream) {
  const long long M = (long long)B * OD * OH * OW;
  if (M <= 0 || N <= 0) return cudaSuccess;
  const long long K = (long long)KD * KH * KW * C;
  if (M >= (1LL << 31) || K <= 0 || Kp < K || Kp - K >= 16 || C % 4 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || dil_d < 1 || dil_h < 1 || dil_w < 1 ||
      D < 1 || KD < 1 || stride_d < 1 || pad_d < 0 || pad_byte < 0 || pad_byte > 255 ||
      (epilogue != 0 && epilogue != 1) || (epilogue == 1 && mult == nullptr))
    return cudaErrorInvalidValue;
  const int lo = y_u8 ? 0 : -128, hi = y_u8 ? 255 : 127;
  if (y_zp < lo || y_zp > hi) return cudaErrorInvalidValue;
  i8g::Params p = {};
  p.M = (int)M;
  p.N = N;
  p.K = (int)K;
  p.stages = stages;
  p.b_resident = b_resident;
  p.out = y;
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const int32_t*>(bias);
  p.q_lo = (float)(lo - y_zp);
  p.q_hi = (float)(hi - y_zp);
  p.y_zp = y_zp;
  p.y_zp_dev = static_cast<const int32_t*>(y_zp_dev);
  p.y_lo = lo;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (producer == 0) {
    if (KD != 1 || KH != 1 || KW != 1 || stride_d != 1 || stride_h != 1 || stride_w != 1 ||
        pad_d != 0 || pad_h != 0 || pad_w != 0 || OD != D || OH != H || OW != W ||
        C % 16 != 0 || Kp != C)
      return cudaErrorInvalidValue;
    if (epilogue == 0)
      return x_u8 ? i8g::launch<i8g::A_TMA, i8g::EPI_INT32, true, TMA_INT32_BM>(
                        x, w, Kp, p, bm, bn, st)
                  : i8g::launch<i8g::A_TMA, i8g::EPI_INT32, false, TMA_INT32_BM>(
                        x, w, Kp, p, bm, bn, st);
    return x_u8 ? i8g::launch<i8g::A_TMA, i8g::EPI_REQUANT, true>(x, w, Kp, p, bm, bn, st)
                : i8g::launch<i8g::A_TMA, i8g::EPI_REQUANT, false>(x, w, Kp, p, bm, bn, st);
  }
  if (producer != 1 && producer != 2) return cudaErrorInvalidValue;
  p.x = static_cast<const int8_t*>(x);
  // the gather's 3-D instance unless the depth is the 2-D conv's (one plane,
  // one tap, no padding): then its 2-D instance gives the same sums
  p.depth3 = !(D == 1 && KD == 1 && pad_d == 0);
  p.D = D;
  p.H = H;
  p.W = W;
  p.C = C;
  p.OD = OD;
  p.OH = OH;
  p.OW = OW;
  p.KW = KW;
  p.KHW = KH * KW;
  p.stride_d = stride_d;
  p.stride_h = stride_h;
  p.stride_w = stride_w;
  p.pad_d = pad_d;
  p.pad_h = pad_h;
  p.pad_w = pad_w;
  p.dil_d = dil_d;
  p.dil_h = dil_h;
  p.dil_w = dil_w;
  p.pad_word = (uint32_t)pad_byte * 0x01010101u;
  p.x_zp = static_cast<const int32_t*>(x_zp);
  p.x_lo = x_u8 ? 0 : -128;
  p.gran = C % 16 == 0 ? 16 : (C % 8 == 0 ? 8 : 4);
  p.div_c = i8g::make_fastdiv((uint32_t)C);
  p.div_khw = i8g::make_fastdiv((uint32_t)(KH * KW));
  p.div_kw = i8g::make_fastdiv((uint32_t)KW);
  if (K * C >= (1LL << 32) || (long long)KD * KH * KW * KH * KW >= (1LL << 32))
    return cudaErrorInvalidValue;  // make_fastdiv's range
  if (producer == 2) {
    // the output box: bm / 64 patches of 8 x 8, as planes (3-D) or as
    // 8-row bands (2-D); its input box with the halo, in chunks of C (<= 128
    // channels) or 128 channels
    if (stride_d != 1 || stride_h != 1 || stride_w != 1 || dil_d != 1 || dil_h != 1 ||
        dil_w != 1 || C % 16 != 0 || (C > 128 && C % 128 != 0) || Kp != K ||
        (bm != 128 && bm != 256) || KD > 64 || KH > 64 || KW > 64)
      return cudaErrorInvalidValue;
    const int patches = bm / 64;
    p.rows2d = !p.depth3;
    p.tile_d = p.rows2d ? 1 : patches;
    p.tile_h = p.rows2d ? 8 * patches : 8;
    p.taps = KD * KH * KW;
    p.box_d = p.tile_d + KD - 1;
    p.box_h = p.tile_h + KH - 1;
    p.box_w = 8 + KW - 1;
    p.cb_pitch = (p.box_d * p.box_h * p.box_w * 16 + 127) / 128 * 128;
    p.chunk = C <= 128 ? C : 128;
    p.n_chunks = C / p.chunk;
    p.chunk_k = p.n_chunks == 1 ? (p.taps * C + i8g::BK - 1) / i8g::BK : p.taps;
    p.n_td = (OD + p.tile_d - 1) / p.tile_d;
    p.n_th = (OH + p.tile_h - 1) / p.tile_h;
    p.n_tw = (OW + 7) / 8;
    const long long m_tiles = (long long)B * p.n_td * p.n_th * p.n_tw;
    if (m_tiles >= (1LL << 31)) return cudaErrorInvalidValue;
    p.m_tiles = (int)m_tiles;
    if (epilogue == 0)
      return x_u8 ? i8g::launch_halo<i8g::EPI_INT32, true>(x, w, Kp, B, p, bm, bn, st)
                  : i8g::launch_halo<i8g::EPI_INT32, false>(x, w, Kp, B, p, bm, bn, st);
    return x_u8 ? i8g::launch_halo<i8g::EPI_REQUANT, true>(x, w, Kp, B, p, bm, bn, st)
                : i8g::launch_halo<i8g::EPI_REQUANT, false>(x, w, Kp, B, p, bm, bn, st);
  }
  if (epilogue == 0)
    return x_u8 ? i8g::launch<i8g::A_GATHER, i8g::EPI_INT32, true>(x, w, Kp, p, bm, bn, st)
                : i8g::launch<i8g::A_GATHER, i8g::EPI_INT32, false>(x, w, Kp, p, bm, bn, st);
  return x_u8 ? i8g::launch<i8g::A_GATHER, i8g::EPI_REQUANT, true>(x, w, Kp, p, bm, bn, st)
              : i8g::launch<i8g::A_GATHER, i8g::EPI_REQUANT, false>(x, w, Kp, p, bm, bn, st);
}
