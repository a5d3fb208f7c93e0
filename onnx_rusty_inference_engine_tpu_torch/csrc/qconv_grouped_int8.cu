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
//   x  int8 or uint8 [B, D, H, W, C] channels-last (the previous conv's
//      output as it leaves the int8 kernels), C = group * Cg; a 2-D conv
//      is D = 1;
//   w  int8 [KD, KH, KW, Cg, Op]: tap (kd, kh, kw), input channel c of the
//      group, output channel o; Op = O rounded up to 4, zero past O
//      (ops/kernels/qconv_grouped_int8.py::pack_qconv_grouped_weight);
//   y  int8 or uint8 [M, O], M = B*OD*OH*OW: channels-last output;
//   y[m, o] = clamp(rint(float(sum_{kd,kh,kw,c} x[b, id, ih, iw, g*Cg + c]
//             * w[kd, kh, kw, c, o] + bias[o]) * mult[o]) + y_zp, y's range),
//   g = o / Og, Og = O / group, ih = oh * stride_h - pad_h + kh * dil_h (id,
//   iw likewise), padding taps holding pad_x (ONNX pads a quantized conv
//   with the x zero point, which the caller folds into the bias as
//   -zx * sum w). The general form can also leave the exact int32 sums
//   (+ bias) instead.
//
// Three forms; the wrapper picks one from the shape
// (qconv_grouped_int8.py::grouped_plan) and counts it:
//
// tile: depthwise 3x3 at stride 1 or 2, C % 16 == 0, x 16-byte
//   aligned (all 17 of MobileNetV2's depthwise convs). What bounds it: a
//   depthwise 3x3 does 18 operations per output byte, far below the H100's
//   ~590 int8 operations per byte of HBM, so the bytes bound it (input read
//   once, output written once). The first design (one thread per output
//   pixel and 4 channels, each tap a 4-byte load of x and one of w) ran
//   every shape at ~41 G threads a second whatever its bytes: bound by
//   instructions, with six 64-bit divisions, 18 bounds-checked 4-byte loads
//   and 36 sign-extending IMADs a thread. This form cuts the instructions
//   per output byte:
//   - Tiles in shared memory. A block owns an output tile: one image, TH
//     rows, TW columns and a run of CR channels (a multiple of 16; all
//     of C where C <= 160, so the box's rows are contiguous). One thread
//     starts a 4-D TMA load of the input tile with its halo,
//     ((TH-1)*s+3) x ((TW-1)*s+3) x CR bytes, over a tensor map of
//     [B, H, W, C]: reads outside the image come back as zeros, which is
//     the padding where the x zero point is 0; for another zero point the
//     block stores it over a border tile's out-of-image bytes in shared
//     memory before it reads them. Blocks are persistent over tiles (channel runs fastest, so
//     blocks in flight together share their halos in L2) and double-
//     buffered: the next tile's load is in flight while this one computes.
//   - Index math per tile: each thread splits the tile id once per tile;
//     nothing is divided per output.
//   - Register blocking. A thread owns 4 channels (one 32-bit word of a
//     column) and 2 adjacent output columns, and walks down all TH rows of
//     the tile. Per input row it reads the 4 (stride 2: 5) column words it
//     needs from shared memory once, and keeps the last rows it read in
//     registers, so at stride 1 each input row is read once per thread, not
//     three times. Its channels' 9 taps stay in registers for the tile.
//   - Packed multiplies. Eight PRMTs transpose the 4 columns x 4 channels
//     of a row into one word per channel, [x(c), x(c+1), x(c+2), x(c+3)];
//     one IDP4A against [w0, w1, w2, 0] of a kernel row gives output column
//     c's three taps of that row, one against [0, w0, w1, w2] column c+1's
//     (at stride 2, a PRMT forms [x(c+2), x(c+3), x(c+4), -] for the
//     second column). The sums start at the bias. A uint8 x takes the
//     mixed-sign dp4a.u32.s32, as fast as the signed one.
//   - Epilogue in registers, with no conversion instruction (each runs at a
//     quarter of the rate of an add): float(s) = (0x4B400000 + s as a float)
//     - 1.5*2^23, exact for |s| < 2^22 (a channel whose bias could leave
//     that range takes __int2float_rn); then __fmul_rn by mult, a clamp to
//     y's range less y_zp and __fadd_rn(v, 1.5*2^23), whose low byte is
//     rint(v), half to even, as __float2int_rn rounds; + y_zp in the
//     integer bits. Three PRMTs pack 4 channels
//     and one 4-byte store writes them: the lanes of a warp hold
//     neighbouring channel words, so a warp's store is contiguous bytes
//     within each output pixel (a 16-byte store per thread would need 16
//     channels a thread: four times the accumulators and weights in
//     registers).
//   Per output byte at stride 1: 3 IDP4A, ~1 PRMT of transpose, 0.5 LDS,
//   ~6.75 epilogue instructions and 0.25 STG, ~12 in all (the first
//   design: ~30); at stride 2, ~15.
//   The wrapper's plan (grouped_plan) owns the tile, the box, the staging
//   buffer, the threads and the grid; the entry point takes them as they
//   are and refuses a plan whose box does not hold its tile's reads, whose
//   tiles do not cover the output or that does not fit a block.
// tile3d: the tile form carried into depth, for a depthwise 3x3x3 (the
//   channel-separated video nets' conv: ir-CSN, X3D) at stride 1 or 2 in
//   depth and stride 1 or 2 in rows and columns, no dilation, C % 16 == 0,
//   x 16-byte aligned, the requant output, zero points known before the
//   run. It does 54 operations per output byte, against the H100's ~590
//   per byte of HBM: bound by bytes, as the 2-D form. A tile is TD planes
//   x TH rows x TW columns x a channel run; one thread stages its input box
//   with the halo, ((TD-1)*sd+3) x ((TH-1)*s+3) x ((TW-1)*s+3) x CR
//   bytes, by one 5-D TMA load over [B, D, H, W, C], double-buffered, in
//   persistent blocks. Where the conv pads with a non-zero byte, each
//   thread reads it in place of the box's bytes outside the volume (its
//   columns' mask once a tile, rows and planes as it reads them), so that
//   no block-wide fill and barrier follows each border box.
//   A thread owns 4 channels x 2 columns, walks the tile's planes and, in
//   each, its rows with the last input rows of the three planes it reads
//   rotating through registers; its channels' 27 taps stay in registers as
//   nine kernel rows of [w0, w1, w2, 0] words (kept across tiles of the
//   same channel run), one IDP4A per kernel row: 9 a column where the 2-D
//   form needs 3. The epilogue is the tile form's.
// general (any other group > 1, dilated and other 3-D convs, and zero
//   points in device memory): one thread per output pixel and run of 4
//   output channels, each output channel reading its own group's bytes, over the
//   taps in depth, rows and columns (the depth a run-time size: a 2-D conv
//   is its D = KD = 1 case). Where x_zp or y_zp_dev is set, the kernel
//   reads that zero point, an int32 in device memory (one the graph
//   computes at run time), saturated to its type's range, in place of the
//   launch's pad_x or y_zp.
// The sums are int32 in registers; only int8 leaves the kernel.
//
// Rounding: round half to even, as jnp.round does; the multiply by
// __fmul_rn, so no contraction into an FMA can move a tie.
//
// Capturable in a CUDA graph: it launches on the stream it is given,
// allocates nothing and does not synchronise.

#include <cuda.h>  // CUtensorMap and its enums, reached through the runtime
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------------------
// general: one thread per output pixel and run of 4 channels
// ---------------------------------------------------------------------------
struct Params {
  const int8_t* x;
  const int8_t* w;
  const float* mult;
  const int32_t* bias;  // null: no bias
  void* y;              // int8 / uint8 [M, O], or int32 where out_i32
  long long M;
  int D, H, W, C, OD, OH, OW, O, Op, Cg, Og, KD, KH, KW, stride_d, stride_h, stride_w, pad_d,
      pad_h, pad_w, dil_d, dil_h, dil_w;
  int pad_x;            // the value a padding tap holds
  int out_i32;
  int q_lo, q_hi, y_zp; // y's range less y_zp, and y_zp
  const int32_t* x_zp;      // null, or pad_x in device memory
  const int32_t* y_zp_dev;  // null, or y_zp in device memory
  int x_lo, y_lo;           // the lowest values of x's and y's types
};

__device__ __forceinline__ int sat8(int v, int lo) {
  return v < lo ? lo : (v > lo + 255 ? lo + 255 : v);
}

template <bool XU8>
__device__ __forceinline__ int xval(int8_t v) {
  return XU8 ? (int)(uint8_t)v : (int)v;
}

template <bool XU8>
__global__ void __launch_bounds__(256) qconv_grouped_int8_requant_kernel(const Params p) {
  const int runs = p.Op >> 2;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= p.M * runs) return;
  const int o0 = (int)(t % runs) * 4;
  const long long m = t / runs;
  const int ow = (int)(m % p.OW);
  const long long r = m / p.OW;
  const int oh = (int)(r % p.OH);
  const long long r2 = r / p.OH;
  const int od = (int)(r2 % p.OD);
  const long long b = r2 / p.OD;
  const int pad_x = p.x_zp != nullptr ? sat8(*p.x_zp, p.x_lo) : p.pad_x;

  int acc[4] = {0, 0, 0, 0};
  const int8_t* xb = p.x + b * p.D * p.H * p.W * p.C;
  for (int kd = 0; kd < p.KD; ++kd) {
    const int id = od * p.stride_d - p.pad_d + kd * p.dil_d;
    const bool plane_in = id >= 0 && id < p.D;
    if (!plane_in && pad_x == 0) continue;
    for (int kh = 0; kh < p.KH; ++kh) {
      const int ih = oh * p.stride_h - p.pad_h + kh * p.dil_h;
      const bool row_in = plane_in && ih >= 0 && ih < p.H;
      if (!row_in && pad_x == 0) continue;
      for (int kw = 0; kw < p.KW; ++kw) {
        const int iw = ow * p.stride_w - p.pad_w + kw * p.dil_w;
        const bool in = row_in && iw >= 0 && iw < p.W;
        if (!in && pad_x == 0) continue;
        const int8_t* px = xb + (in ? (((long long)id * p.H + ih) * p.W + iw) * p.C : 0);
        const int8_t* pw = p.w + (long long)((kd * p.KH + kh) * p.KW + kw) * p.Cg * p.Op + o0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int o = o0 + j;
          if (o >= p.O) break;
          int s = 0;
          if (in) {
            const int8_t* pg = px + (o / p.Og) * p.Cg;
            for (int c = 0; c < p.Cg; ++c)
              s += xval<XU8>(pg[c]) * (int)pw[(long long)c * p.Op + j];
          } else {  // a padding tap: every input channel holds pad_x
            for (int c = 0; c < p.Cg; ++c) s += (int)pw[(long long)c * p.Op + j];
            s *= pad_x;
          }
          acc[j] += s;
        }
      }
    }
  }

  if (p.out_i32) {
    int32_t* dst = static_cast<int32_t*>(p.y) + m * p.O + o0;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (o0 + j < p.O) dst[j] = acc[j] + (p.bias != nullptr ? p.bias[o0 + j] : 0);
    return;
  }
  int q_lo = p.q_lo, q_hi = p.q_hi, y_zp = p.y_zp;
  if (p.y_zp_dev != nullptr) {
    y_zp = sat8(*p.y_zp_dev, p.y_lo);
    q_lo = p.y_lo - y_zp;
    q_hi = p.y_lo + 255 - y_zp;
  }
  int8_t q[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = o0 + j;
    int v = 0;
    if (o < p.O) {
      const int s = acc[j] + (p.bias != nullptr ? p.bias[o] : 0);
      v = __float2int_rn(__fmul_rn(__int2float_rn(s), p.mult[o]));
      v = (v < q_lo ? q_lo : (v > q_hi ? q_hi : v)) + y_zp;
    }
    q[j] = (int8_t)(v & 0xFF);
  }
  int8_t* dst = static_cast<int8_t*>(p.y) + m * p.O + o0;
  if (p.O % 4 == 0) {
    *reinterpret_cast<char4*>(dst) = make_char4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (o0 + j < p.O) dst[j] = q[j];
  }
}

// ---------------------------------------------------------------------------
// tile: depthwise 3x3 over TMA-staged tiles, IDP4A, register blocking
// ---------------------------------------------------------------------------
constexpr int TILE_THREADS = 256;
// |bias| up to this keeps every sum s = bias + TAPS products (each at most
// 128 * 128, or 255 * 128 for a uint8 x) inside [-2^22, 2^22), where the
// float trick is exact
template <bool XU8, int TAPS = 9>
__host__ __device__ constexpr int fast_bias() {
  return (1 << 22) - TAPS * (XU8 ? 255 : 128) * 128 - 1;
}

struct TileParams {
  const int8_t* w;      // packed [9, C]
  const float* mult;    // [C]
  const int32_t* bias;  // [C] or null
  int8_t* y;            // [B, OH, OW, C]
  int C, OH, OW;
  int TH, TW, CR;       // output tile: rows, columns, channel run
  int BH, BW;           // input box: rows, columns
  int n_c, n_w, n_h;    // tiles along channels, columns, rows
  unsigned tiles;       // B * n_h * n_w * n_c
  int pad_h, pad_w;
  unsigned buf_bytes;   // one staging buffer: an input box, rounded up to 128
  int H, W;             // the image, for the border tiles' padding
  // tile3d: output planes a tile, box planes, plane tiles, the depth's
  // stride and padding, the volume's and the output's depth
  int TD, BD, n_d, stride_d, pad_d, D, OD;
  uint32_t pad_word;    // the x zero point's byte, four times (0: none)
  float q_lo, q_hi;     // y's range less y_zp
  int y_zp;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// sum_i x_i * w_i + c over the 4 bytes: x signed, or unsigned (XU8)
template <bool XU8>
__device__ __forceinline__ int dot4(uint32_t x, uint32_t w, int c) {
  if constexpr (XU8) {
    int d;
    asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(x), "r"(w), "r"(c));
    return d;
  } else {
    return __dp4a((int)x, (int)w, c);
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// A tile id split into (image, row tile, column tile, channel run).
struct Tile {
  int b, th, tw, cr;
};

__device__ __forceinline__ Tile split_tile(unsigned t, const TileParams& p) {
  Tile r;
  r.cr = (int)(t % (unsigned)p.n_c);
  t /= (unsigned)p.n_c;
  r.tw = (int)(t % (unsigned)p.n_w);
  t /= (unsigned)p.n_w;
  r.th = (int)(t % (unsigned)p.n_h);
  r.b = (int)(t / (unsigned)p.n_h);
  return r;
}

// Words u[j] = the 4 channels at column j -> t[k] = channel k's bytes of
// columns 0..3 (a 4 x 4 byte transpose in 8 PRMTs).
__device__ __forceinline__ void transpose4(uint32_t u0, uint32_t u1, uint32_t u2, uint32_t u3,
                                           uint32_t (&t)[4]) {
  const uint32_t a_lo = __byte_perm(u0, u1, 0x5140), a_hi = __byte_perm(u0, u1, 0x7362);
  const uint32_t b_lo = __byte_perm(u2, u3, 0x5140), b_hi = __byte_perm(u2, u3, 0x7362);
  t[0] = __byte_perm(a_lo, b_lo, 0x5410);
  t[1] = __byte_perm(a_lo, b_lo, 0x7632);
  t[2] = __byte_perm(a_hi, b_hi, 0x5410);
  t[3] = __byte_perm(a_hi, b_hi, 0x7632);
}

// One row of the staged tile as a thread reads it: at stride 1, a[k] holds
// channel k at the row's 4 columns; at stride 2, a[k] columns 0..3 and
// e[k] columns 2..4 (byte 3 is multiplied by a zero weight).
template <int S>
struct Row {
  uint32_t a[4];
  uint32_t e[S == 2 ? 4 : 1];
};

// PAD (tile3d): the words j whose bit is set in `out` (a column, row or
// plane outside the volume) are read as `pad`, the x zero point four times,
// in place of the box's bytes (TMA's zeros there)
template <int S, bool PAD = false>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ src, int Q, Row<S>& r,
                                         uint32_t out = 0, uint32_t pad = 0) {
  auto word = [&](int j) { return PAD && ((out >> j) & 1) ? pad : src[j * Q]; };
  transpose4(word(0), word(1), word(2), word(3), r.a);
  if constexpr (S == 2) {
    const uint32_t u4 = word(4);
    r.e[0] = __byte_perm(r.a[0], u4, 0x0432);
    r.e[1] = __byte_perm(r.a[1], u4, 0x0532);
    r.e[2] = __byte_perm(r.a[2], u4, 0x0632);
    r.e[3] = __byte_perm(r.a[3], u4, 0x0732);
  }
}

// clamp(rint(float(s) * m), lo, hi) in the low byte (see the note).
__device__ __forceinline__ uint32_t requant_bits(int s, float m, bool fast, float lo, float hi) {
  const float f = fast ? __fsub_rn(__int_as_float(s + 0x4B400000), 12582912.0f)
                       : __int2float_rn(s);
  const float v = fminf(fmaxf(__fmul_rn(f, m), lo), hi);
  return (uint32_t)__float_as_int(__fadd_rn(v, 12582912.0f));
}

__device__ __forceinline__ uint32_t pack4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3) {
  return __byte_perm(__byte_perm(r0, r1, 0x0040), __byte_perm(r2, r3, 0x0040), 0x5410);
}


// What a thread holds for one tile: its channels' kernel-row weight words,
// multipliers and biases, and where its outputs go.
template <int S>
struct Thread {
  uint32_t wa[3][4];                 // kernel row kh, channel k: [w0, w1, w2, 0]
  uint32_t wb[S == 1 ? 3 : 1][4];    // stride 1: [0, w0, w1, w2]
  float m[4];
  int bias[4];
  int8_t* y;        // the tile's output row 0 at this thread's first column
  long long y_row;  // bytes from one output row to the next
  int y_col;        // bytes from one output column to the next (C)
  bool col1;        // the second column lies inside the image
  float lo, hi;     // y's range less y_zp
  int zp;           // y_zp
};

// Loads the thread's weights (packed [9, C], 4 channels from c), mult and
// bias; returns whether every bias keeps the float trick exact.
template <int S, bool XU8>
__device__ __forceinline__ bool load_thread(Thread<S>& th, const TileParams& p, int c) {
  const int cw = p.C >> 2;  // a tap row in words
#pragma unroll
  for (int kh = 0; kh < 3; ++kh) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(p.w + kh * 3 * p.C + c);
    transpose4(__ldg(pw), __ldg(pw + cw), __ldg(pw + 2 * cw), 0u, th.wa[kh]);
    if constexpr (S == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) th.wb[kh][k] = th.wa[kh][k] << 8;
    }
  }
  bool fast = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    th.m[k] = __ldg(p.mult + c + k);
    th.bias[k] = p.bias != nullptr ? __ldg(p.bias + c + k) : 0;
    fast = fast && th.bias[k] >= -fast_bias<XU8>() && th.bias[k] <= fast_bias<XU8>();
  }
  th.lo = p.q_lo;
  th.hi = p.q_hi;
  th.zp = p.y_zp;
  return fast;
}

// Output row i of the tile from staged input rows r0, r1, r2 (kernel rows
// 0, 1, 2): both columns, 4 channels, requantised and stored.
template <int S, bool XU8, bool FAST>
__device__ __forceinline__ void out_row(const Thread<S>& th, const Row<S>& r0, const Row<S>& r1,
                                        const Row<S>& r2, int i) {
  uint32_t q0[4], q1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int s0 = dot4<XU8>(r0.a[k], th.wa[0][k], th.bias[k]);
    s0 = dot4<XU8>(r1.a[k], th.wa[1][k], s0);
    s0 = dot4<XU8>(r2.a[k], th.wa[2][k], s0);
    int s1;
    if constexpr (S == 1) {
      s1 = dot4<XU8>(r0.a[k], th.wb[0][k], th.bias[k]);
      s1 = dot4<XU8>(r1.a[k], th.wb[1][k], s1);
      s1 = dot4<XU8>(r2.a[k], th.wb[2][k], s1);
    } else {
      s1 = dot4<XU8>(r0.e[k], th.wa[0][k], th.bias[k]);
      s1 = dot4<XU8>(r1.e[k], th.wa[1][k], s1);
      s1 = dot4<XU8>(r2.e[k], th.wa[2][k], s1);
    }
    q0[k] = requant_bits(s0, th.m[k], FAST, th.lo, th.hi) + th.zp;
    q1[k] = requant_bits(s1, th.m[k], FAST, th.lo, th.hi) + th.zp;
  }
  int8_t* dst = th.y + i * th.y_row;
  *reinterpret_cast<uint32_t*>(dst) = pack4(q0[0], q0[1], q0[2], q0[3]);
  if (th.col1) *reinterpret_cast<uint32_t*>(dst + th.y_col) = pack4(q1[0], q1[1], q1[2], q1[3]);
}

// The thread's `rows` output rows of one tile. src: its first word in box
// row 0; Q: words a box column; rs: words a box row. The last rows read
// rotate through registers (unrolled so that no row is copied).
template <int S, bool XU8, bool FAST>
__device__ __forceinline__ void run_tile(const uint32_t* __restrict__ src, int Q, int rs,
                                         int rows, const Thread<S>& th) {
  if constexpr (S == 1) {
    Row<1> a, b, c;
    load_row<1>(src, Q, a);
    load_row<1>(src + rs, Q, b);
    const uint32_t* nxt = src + 2 * rs;
    int i = 0;
    for (; i + 3 <= rows; i += 3) {
      load_row<1>(nxt, Q, c);
      out_row<1, XU8, FAST>(th, a, b, c, i);
      load_row<1>(nxt + rs, Q, a);
      out_row<1, XU8, FAST>(th, b, c, a, i + 1);
      load_row<1>(nxt + 2 * rs, Q, b);
      out_row<1, XU8, FAST>(th, c, a, b, i + 2);
      nxt += 3 * rs;
    }
    if (i < rows) {
      load_row<1>(nxt, Q, c);
      out_row<1, XU8, FAST>(th, a, b, c, i);
      if (i + 1 < rows) {
        load_row<1>(nxt + rs, Q, a);
        out_row<1, XU8, FAST>(th, b, c, a, i + 1);
      }
    }
  } else {
    Row<2> e0, o, e1;
    load_row<2>(src, Q, e0);
    const uint32_t* nxt = src + rs;
    int i = 0;
    for (; i + 2 <= rows; i += 2) {
      load_row<2>(nxt, Q, o);
      load_row<2>(nxt + rs, Q, e1);
      out_row<2, XU8, FAST>(th, e0, o, e1, i);
      load_row<2>(nxt + 2 * rs, Q, o);
      load_row<2>(nxt + 3 * rs, Q, e0);
      out_row<2, XU8, FAST>(th, e1, o, e0, i + 1);
      nxt += 4 * rs;
    }
    if (i < rows) {
      load_row<2>(nxt, Q, o);
      load_row<2>(nxt + rs, Q, e1);
      out_row<2, XU8, FAST>(th, e0, o, e1, i);
    }
  }
}

// Persistent blocks over output tiles, two staged input tiles a block: tile
// k + 1's TMA load is in flight while tile k computes. Thread tid owns
// channel quad tid % Q and column pair tid / Q of every tile.
template <int S, bool XU8>
__global__ void __launch_bounds__(TILE_THREADS)
    qconv_grouped_int8_requant_tile_kernel(const __grid_constant__ CUtensorMap xmap,
                                           const TileParams p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t buf0 = smem_u32(smem);
  const uint32_t bar0 = buf0 + 2 * p.buf_bytes, bar1 = bar0 + 8;
  const int Q = p.CR >> 2;
  const int tid = threadIdx.x;
  const int q = tid % Q, pc = tid / Q;
  const uint32_t box = (uint32_t)(p.BH * p.BW * p.CR);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // tile t's input box into staging slot s, by thread 0
  auto load_tile = [&](unsigned t, int s) {
    const Tile tl = split_tile(t, p);
    const uint32_t bar = s ? bar1 : bar0;
    mbar_arrive_tx(bar, box);
    tma_load_4d(buf0 + s * p.buf_bytes, &xmap, bar, tl.cr * p.CR, tl.tw * p.TW * S - p.pad_w,
                tl.th * p.TH * S - p.pad_h, tl.b);
  };
  if (tid == 0 && blockIdx.x < p.tiles) load_tile(blockIdx.x, 0);
  int it = 0;
  for (unsigned t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    if (tid == 0 && t + gridDim.x < p.tiles) load_tile(t + gridDim.x, s ^ 1);
    const Tile tl = split_tile(t, p);
    const int c = tl.cr * p.CR + 4 * q;
    const int ow = tl.tw * p.TW + 2 * pc;
    const int oh0 = tl.th * p.TH;
    const bool active = pc < (p.TW >> 1) && c < p.C && ow < p.OW;
    Thread<S> th;
    bool fast = true;
    if (active) {  // the weights load while the tile's bytes arrive
      fast = load_thread<S, XU8>(th, p, c);
      th.y = p.y + (((long long)tl.b * p.OH + oh0) * p.OW + ow) * p.C + c;
      th.y_row = (long long)p.OW * p.C;
      th.y_col = p.C;
      th.col1 = ow + 1 < p.OW;
    }
    mbar_wait(s ? bar1 : bar0, (it >> 1) & 1);
    if (p.pad_word != 0) {
      // a border tile: its out-of-image bytes hold the x zero point, not
      // TMA's zeros (the condition is the block's, so is the barrier)
      const int r0 = oh0 * S - p.pad_h, c0 = tl.tw * p.TW * S - p.pad_w;
      if (r0 < 0 || c0 < 0 || r0 + p.BH > p.H || c0 + p.BW > p.W) {
        uint32_t* buf = reinterpret_cast<uint32_t*>(smem + s * p.buf_bytes);
        for (int px = tid; px < p.BH * p.BW; px += blockDim.x) {
          const int r = px / p.BW, cc = px - r * p.BW;
          if (r0 + r >= 0 && r0 + r < p.H && c0 + cc >= 0 && c0 + cc < p.W) continue;
          for (int k = 0; k < Q; ++k) buf[px * Q + k] = p.pad_word;
        }
        fence_proxy_async();  // before a later TMA load rewrites these bytes
        __syncthreads();
      }
    }
    if (active) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(smem + s * p.buf_bytes) +
                            2 * S * pc * Q + q;
      const int rows = min(p.TH, p.OH - oh0);
      if (fast)
        run_tile<S, XU8, true>(src, Q, p.BW * Q, rows, th);
      else
        run_tile<S, XU8, false>(src, Q, p.BW * Q, rows, th);
    }
    __syncthreads();  // slot s is read; the next iteration's load may reuse it
  }
}

// ---------------------------------------------------------------------------
// tile3d: depthwise 3x3x3, the tile form carried into depth
// ---------------------------------------------------------------------------
// One input row as a thread reads it in each of the three input planes kd
// of an output plane.
template <int S>
struct Row3 {
  Row<S> k[3];
};

// Where a thread's reads leave the volume (PAD): bit j of `cols` its box
// column j; `planes[kd]` all bits where input plane kd is outside; rows
// from `r0` (the box's first row) against H.
struct Outside {
  uint32_t cols, planes[3];
  int r0, H;
  uint32_t pad;
};

template <int S, bool PAD>
__device__ __forceinline__ void load_row3(const uint32_t* __restrict__ src, int Q, int ps,
                                          Row3<S>& r, const Outside& o, int row) {
  const uint32_t out = PAD ? o.cols | ((unsigned)(o.r0 + row) >= (unsigned)o.H ? 0x1Fu : 0u)
                           : 0u;
#pragma unroll
  for (int kd = 0; kd < 3; ++kd)
    load_row<S, PAD>(src + kd * ps, Q, r.k[kd], PAD ? out | o.planes[kd] : 0u, o.pad);
}

// What a thread holds for the tile3d form: its channels' 27 taps as nine
// kernel rows (kd, kh) of [w0, w1, w2, 0] words (stride 1 also [0, w0, w1,
// w2]), multipliers, biases, and where its outputs go.
template <int S>
struct Thread3 {
  uint32_t wa[9][4];
  uint32_t wb[S == 1 ? 9 : 1][4];
  float m[4];
  int bias[4];
  long long y_row;  // bytes from one output row to the next
  long long y_plane;  // ... one output plane to the next
  int y_col;        // ... one output column to the next (C)
  bool col1;        // the second column lies inside the volume
  float lo, hi;
  int zp;
};

// the thread's weights (packed [27, C], 4 channels from c), mult and bias;
// returns whether every bias keeps the float trick exact (27 taps)
template <int S, bool XU8>
__device__ __forceinline__ bool load_thread3(Thread3<S>& th, const TileParams& p, int c) {
  const int cw = p.C >> 2;
#pragma unroll
  for (int r = 0; r < 9; ++r) {
    const uint32_t* pw = reinterpret_cast<const uint32_t*>(p.w + r * 3 * p.C + c);
    transpose4(__ldg(pw), __ldg(pw + cw), __ldg(pw + 2 * cw), 0u, th.wa[r]);
    if constexpr (S == 1) {
#pragma unroll
      for (int k = 0; k < 4; ++k) th.wb[r][k] = th.wa[r][k] << 8;
    }
  }
  constexpr int lim = fast_bias<XU8, 27>();
  bool fast = true;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    th.m[k] = __ldg(p.mult + c + k);
    th.bias[k] = p.bias != nullptr ? __ldg(p.bias + c + k) : 0;
    fast = fast && th.bias[k] >= -lim && th.bias[k] <= lim;
  }
  th.lo = p.q_lo;
  th.hi = p.q_hi;
  th.zp = p.y_zp;
  return fast;
}

// One output row (both columns, 4 channels) from input rows r0, r1, r2
// (kernel rows kh = 0, 1, 2) of the three planes: 9 IDP4A a column.
template <int S, bool XU8, bool FAST>
__device__ __forceinline__ void out_row3(const Thread3<S>& th, const Row3<S>& r0,
                                         const Row3<S>& r1, const Row3<S>& r2, int8_t* dst) {
  uint32_t q0[4], q1[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int s0 = th.bias[k], s1 = th.bias[k];
#pragma unroll
    for (int kd = 0; kd < 3; ++kd) {
      s0 = dot4<XU8>(r0.k[kd].a[k], th.wa[3 * kd][k], s0);
      s0 = dot4<XU8>(r1.k[kd].a[k], th.wa[3 * kd + 1][k], s0);
      s0 = dot4<XU8>(r2.k[kd].a[k], th.wa[3 * kd + 2][k], s0);
      if constexpr (S == 1) {
        s1 = dot4<XU8>(r0.k[kd].a[k], th.wb[3 * kd][k], s1);
        s1 = dot4<XU8>(r1.k[kd].a[k], th.wb[3 * kd + 1][k], s1);
        s1 = dot4<XU8>(r2.k[kd].a[k], th.wb[3 * kd + 2][k], s1);
      } else {
        s1 = dot4<XU8>(r0.k[kd].e[k], th.wa[3 * kd][k], s1);
        s1 = dot4<XU8>(r1.k[kd].e[k], th.wa[3 * kd + 1][k], s1);
        s1 = dot4<XU8>(r2.k[kd].e[k], th.wa[3 * kd + 2][k], s1);
      }
    }
    q0[k] = requant_bits(s0, th.m[k], FAST, th.lo, th.hi) + th.zp;
    q1[k] = requant_bits(s1, th.m[k], FAST, th.lo, th.hi) + th.zp;
  }
  *reinterpret_cast<uint32_t*>(dst) = pack4(q0[0], q0[1], q0[2], q0[3]);
  if (th.col1) *reinterpret_cast<uint32_t*>(dst + th.y_col) = pack4(q1[0], q1[1], q1[2], q1[3]);
}

// The thread's `rows` output rows of one output plane. src: its first word
// in the plane's first input plane, row 0; Q: words a box column; rs: words
// a box row; ps: words a box plane; y: the plane's output row 0. The last
// rows read rotate through registers, as run_tile's. PAD: the reads outside
// the volume (`o`) hold the pad word.
template <int S, bool XU8, bool FAST, bool PAD>
__device__ __forceinline__ void run_plane3(const uint32_t* __restrict__ src, int Q, int rs,
                                           int ps, int rows, const Thread3<S>& th, int8_t* y,
                                           const Outside& o) {
  if constexpr (S == 1) {
    Row3<1> a, b, c;
    load_row3<1, PAD>(src, Q, ps, a, o, 0);
    load_row3<1, PAD>(src + rs, Q, ps, b, o, 1);
    const uint32_t* nxt = src + 2 * rs;
    int i = 0;
    for (; i + 3 <= rows; i += 3) {
      load_row3<1, PAD>(nxt, Q, ps, c, o, i + 2);
      out_row3<1, XU8, FAST>(th, a, b, c, y + i * th.y_row);
      load_row3<1, PAD>(nxt + rs, Q, ps, a, o, i + 3);
      out_row3<1, XU8, FAST>(th, b, c, a, y + (i + 1) * th.y_row);
      load_row3<1, PAD>(nxt + 2 * rs, Q, ps, b, o, i + 4);
      out_row3<1, XU8, FAST>(th, c, a, b, y + (i + 2) * th.y_row);
      nxt += 3 * rs;
    }
    if (i < rows) {
      load_row3<1, PAD>(nxt, Q, ps, c, o, i + 2);
      out_row3<1, XU8, FAST>(th, a, b, c, y + i * th.y_row);
      if (i + 1 < rows) {
        load_row3<1, PAD>(nxt + rs, Q, ps, a, o, i + 3);
        out_row3<1, XU8, FAST>(th, b, c, a, y + (i + 1) * th.y_row);
      }
    }
  } else {
    Row3<2> e0, m, e1;
    load_row3<2, PAD>(src, Q, ps, e0, o, 0);
    const uint32_t* nxt = src + rs;
    int i = 0;
    for (; i + 2 <= rows; i += 2) {
      load_row3<2, PAD>(nxt, Q, ps, m, o, 2 * i + 1);
      load_row3<2, PAD>(nxt + rs, Q, ps, e1, o, 2 * i + 2);
      out_row3<2, XU8, FAST>(th, e0, m, e1, y + i * th.y_row);
      load_row3<2, PAD>(nxt + 2 * rs, Q, ps, m, o, 2 * i + 3);
      load_row3<2, PAD>(nxt + 3 * rs, Q, ps, e0, o, 2 * i + 4);
      out_row3<2, XU8, FAST>(th, e1, m, e0, y + (i + 1) * th.y_row);
      nxt += 4 * rs;
    }
    if (i < rows) {
      load_row3<2, PAD>(nxt, Q, ps, m, o, 2 * i + 1);
      load_row3<2, PAD>(nxt + rs, Q, ps, e1, o, 2 * i + 2);
      out_row3<2, XU8, FAST>(th, e0, m, e1, y + i * th.y_row);
    }
  }
}

// A tile3d tile id split into (image, plane tile, row tile, column tile,
// channel run).
struct Tile3 {
  int b, td, th, tw, cr;
};

__device__ __forceinline__ Tile3 split_tile3(unsigned t, const TileParams& p) {
  Tile3 r;
  r.cr = (int)(t % (unsigned)p.n_c);
  t /= (unsigned)p.n_c;
  r.tw = (int)(t % (unsigned)p.n_w);
  t /= (unsigned)p.n_w;
  r.th = (int)(t % (unsigned)p.n_h);
  t /= (unsigned)p.n_h;
  r.td = (int)(t % (unsigned)p.n_d);
  r.b = (int)(t / (unsigned)p.n_d);
  return r;
}

// Persistent blocks over output tiles (channel runs fastest, then columns,
// rows, planes, images), two staged input boxes a block: tile k + 1's 5-D
// TMA load is in flight while tile k computes. Thread tid owns channel quad
// tid % Q and column pair tid / Q of every tile and walks its TD planes x
// TH rows; its weights stay in registers while the channel run does. PAD:
// the conv pads with a non-zero byte (a separate instance, so that the
// common zero pad keeps its registers).
template <int S, bool XU8, bool PAD>
__global__ void __launch_bounds__(TILE_THREADS)
    qconv_grouped_int8_requant_tile3d_kernel(const __grid_constant__ CUtensorMap xmap,
                                             const TileParams p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t buf0 = smem_u32(smem);
  const uint32_t bar0 = buf0 + 2 * p.buf_bytes, bar1 = bar0 + 8;
  const int Q = p.CR >> 2;
  const int tid = threadIdx.x;
  const int q = tid % Q, pc = tid / Q;
  const uint32_t box = (uint32_t)(p.BD * p.BH * p.BW * p.CR);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load_tile = [&](unsigned t, int s) {
    const Tile3 tl = split_tile3(t, p);
    const uint32_t bar = s ? bar1 : bar0;
    mbar_arrive_tx(bar, box);
    tma_load_5d(buf0 + s * p.buf_bytes, &xmap, bar, tl.cr * p.CR, tl.tw * p.TW * S - p.pad_w,
                tl.th * p.TH * S - p.pad_h, tl.td * p.TD * p.stride_d - p.pad_d, tl.b);
  };
  if (tid == 0 && blockIdx.x < p.tiles) load_tile(blockIdx.x, 0);
  Thread3<S> th;
  bool fast = true;
  int c_loaded = -1;  // the channel quad whose weights th holds
  int it = 0;
  for (unsigned t = blockIdx.x; t < p.tiles; t += gridDim.x, ++it) {
    const int s = it & 1;
    if (tid == 0 && t + gridDim.x < p.tiles) load_tile(t + gridDim.x, s ^ 1);
    const Tile3 tl = split_tile3(t, p);
    const int c = tl.cr * p.CR + 4 * q;
    const int ow = tl.tw * p.TW + 2 * pc;
    const int oh0 = tl.th * p.TH, od0 = tl.td * p.TD;
    const bool active = pc < (p.TW >> 1) && c < p.C && ow < p.OW;
    if (active && c != c_loaded) {  // the weights load while the box arrives
      fast = load_thread3<S, XU8>(th, p, c);
      th.y_row = (long long)p.OW * p.C;
      th.y_plane = (long long)p.OH * p.OW * p.C;
      th.y_col = p.C;
      c_loaded = c;
    }
    mbar_wait(s ? bar1 : bar0, (it >> 1) & 1);
    if (active) {
      th.col1 = ow + 1 < p.OW;
      const int rs = p.BW * Q, ps = p.BH * rs;
      const uint32_t* src = reinterpret_cast<const uint32_t*>(smem + s * p.buf_bytes) +
                            2 * S * pc * Q + q;
      const int rows = min(p.TH, p.OH - oh0), planes = min(p.TD, p.OD - od0);
      int8_t* y = p.y + ((((long long)tl.b * p.OD + od0) * p.OH + oh0) * p.OW + ow) * p.C + c;
      // where the conv pads with a non-zero byte, the thread reads it in
      // place of the box's bytes outside the volume (TMA's zeros): its
      // columns once a tile, its rows and planes as it reads them
      const int d0 = od0 * p.stride_d - p.pad_d;
      Outside o;
      o.r0 = oh0 * S - p.pad_h;
      o.H = p.H;
      o.pad = p.pad_word;
      o.cols = 0;
      const int c0 = tl.tw * p.TW * S - p.pad_w + 2 * S * pc;
#pragma unroll
      for (int j = 0; j < 5; ++j)
        if ((unsigned)(c0 + j) >= (unsigned)p.W) o.cols |= 1u << j;
      for (int pd = 0; pd < planes; ++pd) {
        const uint32_t* sp = src + pd * p.stride_d * ps;
        int8_t* yp = y + pd * th.y_plane;
        const int ipd = d0 + pd * p.stride_d;  // the plane's first input plane
#pragma unroll
        for (int kd = 0; kd < 3; ++kd)
          o.planes[kd] = (unsigned)(ipd + kd) >= (unsigned)p.D ? 0x1Fu : 0u;
        if (fast)
          run_plane3<S, XU8, true, PAD>(sp, Q, rs, ps, rows, th, yp, o);
        else
          run_plane3<S, XU8, false, PAD>(sp, Q, rs, ps, rows, th, yp, o);
      }
    }
    __syncthreads();  // slot s is read; the next iteration's load may reuse it
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled as the CUDA runtime already loaded it, so the
// library links no libcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(sym);
  }
  return fn;
}

// The largest dynamic shared memory a block may have (227 KB).
constexpr size_t MAX_SMEM = 232448;

// D3: the tile3d form (x [B, D, H, W, C] as a 5-D map, boxes of CR x BW x
// BH x BD x 1), else the tile form (x [B, H, W, C], 4-D, CR x BW x BH x 1);
// reads outside the tensor return zeros
template <int S, bool XU8, bool D3, bool PAD = false>
cudaError_t launch_tile(const void* x, int B, int H, int W, const TileParams& p, size_t smem,
                        int threads, cudaStream_t st) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  // innermost dimension first
  CUtensorMap map;
  const int D = D3 ? p.D : 1;
  const cuuint64_t C = (cuuint64_t)p.C;
  const cuuint64_t dims5[5] = {C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)D, (cuuint64_t)B};
  const cuuint64_t strides5[4] = {C, C * W, C * W * H, C * W * H * D};
  const cuuint32_t box5[5] = {(cuuint32_t)p.CR, (cuuint32_t)p.BW, (cuuint32_t)p.BH,
                              (cuuint32_t)(D3 ? p.BD : 1), 1};
  // the 2-D form's map: the depth dimension left out
  const cuuint64_t dims4[4] = {C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides4[3] = {C, C * W, C * W * H};
  const cuuint32_t box4[4] = {(cuuint32_t)p.CR, (cuuint32_t)p.BW, (cuuint32_t)p.BH, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  if (fn(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, D3 ? 5 : 4, const_cast<void*>(x),
         D3 ? dims5 : dims4, D3 ? strides5 : strides4, D3 ? box5 : box4, elem,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  auto kern = D3 ? qconv_grouped_int8_requant_tile3d_kernel<S, XU8, PAD>
                 : qconv_grouped_int8_requant_tile_kernel<S, XU8>;
  static size_t opted_in = 0;  // the shared memory this instantiation may use
  static size_t occ_smem = 0;  // the (shared memory, threads) occ was taken at
  static int occ_threads = 0;
  static int occ = 0;          // blocks an SM holds there
  cudaError_t e;
  if (smem > opted_in) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  if (smem != occ_smem || threads != occ_threads) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, threads, smem);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    occ_smem = smem;
    occ_threads = threads;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const long long resident = (long long)sms * occ;
  const unsigned blocks = (unsigned)(p.tiles < resident ? p.tiles : resident);
  kern<<<blocks, threads, smem, st>>>(map, p);
  return cudaGetLastError();
}

}  // namespace

// x (uint8 where x_u8, else int8), w (packed), mult f32 [O], bias int32 [O]
// or null, y [M, O]: uint8 where y_u8, else int8, or int32 where out_i32
// (the general form only; mult unused). pad_x: the value a padding tap
// holds, in x's type; y_zp in y's; x_zp, y_zp_dev: null, or int32s in
// device memory read in their place (the general form only). A 2-D conv
// passes D = OD = KD = 1, stride_d = dil_d = 1, pad_d = 0. tile: null for
// the general form (any group > 1), or the tile form's plan (2-D depthwise
// 3x3, stride 1 or 2 in both dimensions, no dilation, C % 16 == 0, x
// 16-byte aligned) as grouped_plan
// gives it (qconv_grouped_int8.py::tile_args): {TH, TW, channel run, box
// rows, box columns, staging buffer bytes, shared memory bytes, threads, row
// tiles, column tiles, channel runs}; for the tile3d form (KD = 3: a
// depthwise 3x3x3, depth stride 1 or 2) three more: {TD, box planes, plane
// tiles}. The output pointer must be 4-byte
// aligned when O % 4 == 0. Launches on `stream`; returns the launch's error,
// or cudaErrorInvalidValue for arguments the form does not take.
extern "C" cudaError_t qconv_grouped_int8_launch(
    const void* x, const void* w, const void* mult, const void* bias, void* y,
    const void* x_zp, const void* y_zp_dev, int B, int D, int H, int W, int C, int OD,
    int OH, int OW, int O, int Cg, int KD, int KH, int KW, int stride_d, int stride_h,
    int stride_w, int pad_d, int pad_h, int pad_w, int dil_d, int dil_h, int dil_w, int x_u8,
    int pad_x, int y_zp, int y_u8, int out_i32, const int* tile, void* stream) {
  const long long M = (long long)B * OD * OH * OW;
  if (M <= 0 || O <= 0) return cudaSuccess;
  const int x_lo = x_u8 ? 0 : -128, y_lo = y_u8 ? 0 : -128;
  if (x == nullptr || w == nullptr || (mult == nullptr && !out_i32) || y == nullptr ||
      Cg <= 0 || C % Cg != 0 || KD <= 0 || KH <= 0 || KW <= 0 || D <= 0 || stride_d <= 0 ||
      stride_h <= 0 || stride_w <= 0 || pad_d < 0 || pad_h < 0 || pad_w < 0 || dil_d < 1 ||
      dil_h < 1 || dil_w < 1 || pad_x < x_lo || pad_x > x_lo + 255 || y_zp < y_lo ||
      y_zp > y_lo + 255)
    return cudaErrorInvalidValue;
  const int group = C / Cg;
  if (O % group != 0) return cudaErrorInvalidValue;
  const int Og = O / group;
  if (O % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 4 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile != nullptr) {
    const int s = stride_h;
    // the tile3d form: a depthwise 3x3x3, its depth stride 1 or 2
    const bool d3 = KD == 3;
    if (Cg != 1 || Og != 1 || KH != 3 || KW != 3 || stride_w != s || (s != 1 && s != 2) ||
        dil_h != 1 || dil_w != 1 || out_i32 || C % 16 != 0 ||
        (d3 ? (stride_d != 1 && stride_d != 2) || dil_d != 1
            : D != 1 || OD != 1 || KD != 1 || pad_d != 0) ||
        x_zp != nullptr || y_zp_dev != nullptr ||
        reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 4 != 0)
      return cudaErrorInvalidValue;
    TileParams p;
    p.w = static_cast<const int8_t*>(w);
    p.mult = static_cast<const float*>(mult);
    p.bias = static_cast<const int32_t*>(bias);
    p.y = static_cast<int8_t*>(y);
    p.C = C;
    p.OH = OH;
    p.OW = OW;
    p.TH = tile[0];
    p.TW = tile[1];
    p.CR = tile[2];
    p.BH = tile[3];
    p.BW = tile[4];
    const long long buf = tile[5], smem = tile[6];
    const int threads = tile[7];
    p.n_h = tile[8];
    p.n_w = tile[9];
    p.n_c = tile[10];
    p.pad_h = pad_h;
    p.pad_w = pad_w;
    p.H = H;
    p.W = W;
    p.TD = d3 ? tile[11] : 1;
    p.BD = d3 ? tile[12] : 1;
    p.n_d = d3 ? tile[13] : 1;
    p.stride_d = stride_d;
    p.pad_d = pad_d;
    p.D = D;
    p.OD = OD;
    p.pad_word = (uint32_t)(pad_x & 0xFF) * 0x01010101u;
    p.q_lo = (float)(y_lo - y_zp);
    p.q_hi = (float)(y_lo + 255 - y_zp);
    p.y_zp = y_zp;
    const long long tiles = (long long)B * p.n_d * p.n_h * p.n_w * p.n_c;
    // the limits: a thread's reads inside the box, tiles covering the
    // output, TMA's box (sides <= 256, rows of 16-byte multiples), the
    // block's threads and shared memory (two buffers, then two barriers)
    if (p.TH < 1 || p.TW < 2 || p.TW % 2 != 0 || p.CR < 16 || p.CR % 16 != 0 ||
        p.CR > 256 || p.BH < (p.TH - 1) * s + 3 || p.BW < (p.TW - 1) * s + 3 || p.BH > 256 ||
        p.BW > 256 || (long long)p.n_h * p.TH < OH || (long long)p.n_w * p.TW < OW ||
        (long long)p.n_c * p.CR < C || p.n_h < 1 || p.n_w < 1 || p.n_c < 1 ||
        p.TD < 1 || p.n_d < 1 || (long long)p.n_d * p.TD < OD ||
        (d3 && (p.BD < (p.TD - 1) * stride_d + 3 || p.BD > 256)) ||
        buf % 128 != 0 || buf < (long long)p.BD * p.BH * p.BW * p.CR || smem < 2 * buf + 16 ||
        smem > (long long)MAX_SMEM || threads % 32 != 0 ||
        threads < (p.CR / 4) * (p.TW / 2) || threads > TILE_THREADS || tiles >= (1LL << 31))
      return cudaErrorInvalidValue;
    p.buf_bytes = (unsigned)buf;
    p.tiles = (unsigned)tiles;
    if (d3 && p.pad_word != 0) {
      if (x_u8)
        return s == 1 ? launch_tile<1, true, true, true>(x, B, H, W, p, smem, threads, st)
                      : launch_tile<2, true, true, true>(x, B, H, W, p, smem, threads, st);
      return s == 1 ? launch_tile<1, false, true, true>(x, B, H, W, p, smem, threads, st)
                    : launch_tile<2, false, true, true>(x, B, H, W, p, smem, threads, st);
    }
    if (d3) {
      if (x_u8)
        return s == 1 ? launch_tile<1, true, true>(x, B, H, W, p, smem, threads, st)
                      : launch_tile<2, true, true>(x, B, H, W, p, smem, threads, st);
      return s == 1 ? launch_tile<1, false, true>(x, B, H, W, p, smem, threads, st)
                    : launch_tile<2, false, true>(x, B, H, W, p, smem, threads, st);
    }
    if (x_u8)
      return s == 1 ? launch_tile<1, true, false>(x, B, H, W, p, (size_t)smem, threads, st)
                    : launch_tile<2, true, false>(x, B, H, W, p, (size_t)smem, threads, st);
    return s == 1 ? launch_tile<1, false, false>(x, B, H, W, p, (size_t)smem, threads, st)
                  : launch_tile<2, false, false>(x, B, H, W, p, (size_t)smem, threads, st);
  }
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.w = static_cast<const int8_t*>(w);
  p.mult = static_cast<const float*>(mult);
  p.bias = static_cast<const int32_t*>(bias);
  p.y = y;
  p.M = M;
  p.D = D;
  p.H = H;
  p.W = W;
  p.C = C;
  p.OD = OD;
  p.OH = OH;
  p.OW = OW;
  p.O = O;
  p.Op = (O + 3) / 4 * 4;
  p.Cg = Cg;
  p.Og = Og;
  p.KD = KD;
  p.KH = KH;
  p.KW = KW;
  p.stride_d = stride_d;
  p.stride_h = stride_h;
  p.stride_w = stride_w;
  p.pad_d = pad_d;
  p.pad_h = pad_h;
  p.pad_w = pad_w;
  p.dil_d = dil_d;
  p.dil_h = dil_h;
  p.dil_w = dil_w;
  p.pad_x = pad_x;
  p.x_zp = static_cast<const int32_t*>(x_zp);
  p.y_zp_dev = static_cast<const int32_t*>(y_zp_dev);
  p.x_lo = x_lo;
  p.y_lo = y_lo;
  p.out_i32 = out_i32;
  p.q_lo = y_lo - y_zp;
  p.q_hi = y_lo + 255 - y_zp;
  p.y_zp = y_zp;
  const long long threads = M * (p.Op / 4);
  const long long blocks = (threads + 255) / 256;
  if (blocks >= (1LL << 31)) return cudaErrorInvalidValue;
  if (x_u8)
    qconv_grouped_int8_requant_kernel<true><<<(unsigned)blocks, 256, 0, st>>>(p);
  else
    qconv_grouped_int8_requant_kernel<false><<<(unsigned)blocks, 256, 0, st>>>(p);
  return cudaGetLastError();
}
