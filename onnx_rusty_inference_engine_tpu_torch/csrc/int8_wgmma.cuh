// One int8 tensor-core mainloop for Hopper (sm_90a), shared by the int8
// GEMM (qmatmul_int8.cu) and the int8 implicit-GEMM convolution
// (qconv_int8.cu).
//
//   out[m, n] = epilogue(sum_k A[m, k] * Bp[n, k])
//
// A is int8 [M, K] (uint8 where the template's AU8 is set: wgmma takes a
// .u8 A against an .s8 B, so uint8 activations reach the tensor cores
// unshifted) and Bp int8 [N, Kp] (a packed weight: K-contiguous rows, zero
// past K). Both are read K-major, the only layout wgmma takes for 8-bit
// types, in 128-byte K slices.
//
// Block: WGM consumer warpgroups (64 output rows each, BM = 64 * WGM) and one
// producer (a warp, or a warpgroup for the im2col gather). The producer keeps
// a ring of `stages` shared-memory slots filled, each holding A's BM x 128
// and Bp's BN x 128 bytes (or A's alone, Bp resident: see Tile) in the
// 128-byte-swizzled layout that both TMA and
// the wgmma descriptors name; an mbarrier pair per slot (full: the bytes
// landed; empty: both warpgroups' products on it are done) hands slots back
// and forth, so loads stay in flight while the tensor cores work. Each
// consumer warpgroup runs wgmma.m64nBNk32.s32.{s8,u8}.s8 (four per slice) into
// BN / 2 int32 registers a thread, and keeps one slice's products in flight
// while it waits on the next slice.
//
// A producers (compile-time):
//   A_TMA     A is a row-major matrix (the GEMM's activations, or a 1x1,
//             stride-1, unpadded conv's channels-last input): TMA, which
//             also fills rows past M and bytes past K with zeros;
//   A_GATHER  the implicit im2col of a conv over channels-last int8 x
//             [B, D, H, W, C], C a multiple of 4, K ordered (kd, kh, kw, c),
//             by 128 threads with cp.async: a thread owns one 16-byte column
//             of the slice for BM / 16 rows and fills it in runs of 16, 8 or
//             4 bytes (one tap's channels each, as C's divisibility allows),
//             taps at dilation (dil_d, dil_h, dil_w). The depth is a run-time
//             size: a 2-D conv is D = OD = KD = 1 of the same code (a depth
//             tap that is always 0 and always inside). A padding tap is
//             zero-filled by the copy, or, where the conv pads with a zero
//             point (Params::pad_word != 0, or the int32 at Params::x_zp in
//             device memory), stored as that byte by the thread.
//             Bp still comes by TMA.
//   A_HALO    a 2-D or 3-D conv at unit stride and dilation over C % 16
//             == 0 channels (the staged-halo producer; either epilogue).
//             A tile is WGM * MB patches of 8 x 8 output pixels (MB a
//             consumer warpgroup, one m64 accumulator each), stacked along
//             depth in a 3-D conv (WGM * MB planes x 8 rows x 8 columns) and
//             along rows in a 2-D one (8 * WGM * MB rows x 8 columns;
//             Params::rows2d). One thread loads the tile's input box with
//             its halo, (tile planes + KD - 1) x (tile rows + KH - 1) x (8 +
//             KW - 1) voxels, by one 5-D TMA load per 16 channels, channel-
//             blocked in shared memory ([C/16][d][h][w][16]); reads outside
//             the volume come back as zeros, and where the conv pads with a
//             zero point (the launch's, or the int32 at Params::x_zp) the
//             consumers store it over a border box's outside bytes. Each
//             tap's A operand is then a wgmma descriptor into the box
//             without swizzle: 8 consecutive columns of 16 channels are
//             one 128-byte core matrix, the next 8-row group one box row
//             further, the next 16 channels one channel block further (the
//             leading offset). A k32 step is two 16-channel blocks: where
//             C % 32 == 16, a tap's last block pairs with the next tap's
//             first, which the box holds a second time after its last
//             block, so that the step's leading offset stays positive
//             (cb_pitch + the two taps' distance in the box). So each input
//             byte leaves L2 about (box / tile) times a tile (~3.1 for a
//             3x3x3, ~1.3 for a 2-D 3x3) instead of once a tap, and the
//             producer issues a bulk copy per 16 channels a tile and no
//             per-run address arithmetic. A box of more than 128 channels
//             is staged in 128-channel chunks (K walked chunk by chunk, tap
//             by tap; Bp stays in (kd, kh, kw, c) order and its TMA loads
//             take the chunk's columns); two box slots, so the next tile's
//             box is in flight while this one's products run.
// Epilogues (compile-time):
//   EPI_INT32    int32 [M, N], exact (the caller keeps |sum| < 2^31);
//   EPI_REQUANT  int8 or uint8 [M, N] = clamp(rn(fmul_rn(i2f_rn(acc +
//                bias[n]), mult[n])), q_lo, q_hi) + y_zp, ONNX's requant
//                with its output zero point ([q_lo, q_hi] is the output
//                type's range less y_zp; where Params::y_zp_dev is set, y_zp
//                is read from device memory and the range derived from it in
//                the kernel), staged through shared memory so that each row
//                leaves in 16-byte stores along N.
// Zero points in device memory (a zero point the graph computes at run
// time, e.g. DynamicQuantizeLinear's): each is one int32 read once per
// thread, so a CUDA graph that captures the launch reads the value of each
// replay. A value outside its type's range is saturated to it (the JAX
// emitters' arithmetic widens and clips the same way; ONNX gives a zero
// point x's or y's own type, so it never is).
// Persistent blocks: each walks output tiles; the producer fills the ring
// for the next tile while the consumers run this one's epilogue.
//
// Tile: BN in {16, 32, 48, 64, 96, 128, 192, 256} (one wgmma N each), BM in
// {64, 128}; the callers pick them (and the ring depth) from the shape in
// Python (ops/kernels/qmatmul_int8.py::int8_tile) and the entry points
// refuse a choice that does not fit. Where N fits one tile and Bp's K
// slices fit beside the ring, Bp is resident: loaded once per block rather
// than once per tile, because every block reading the same few kilobytes of
// weights from L2 for every tile bounded the narrow convs.

#pragma once

#ifndef I8G_KERNEL
#error "define I8G_KERNEL, the kernel's name in the including library"
#endif

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through the runtime
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Everything here has internal linkage: both libraries include it, and a
// function-local static of an inline template (the shared-memory opt-in
// below) would otherwise be one symbol across every loaded library.
namespace i8g {
namespace {

constexpr int BK = 128;             // K bytes per slot: one 128-byte swizzle row
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory an H100 block can opt into
constexpr int MAX_STAGES = 8;

enum { A_TMA = 0, A_GATHER = 1, A_HALO = 2 };

enum { EPI_INT32 = 0, EPI_REQUANT = 1 };

// n / d for 0 <= n, n * d < 2^32: a shift where d is a power of two, else
// the high word of n * m, m = floor(2^32 / d) + 1 (the error n * (m d -
// 2^32) / (d 2^32) stays below 1 / d). A runtime division costs some twenty
// instructions; the gather needs two per run it copies.
struct FastDiv {
  uint32_t m;  // 0: shift
  int s;
};

inline FastDiv make_fastdiv(uint32_t d) {
  FastDiv f = {0, 0};
  if ((d & (d - 1)) == 0) {
    while ((1u << f.s) < d) ++f.s;
  } else {
    f.m = (uint32_t)((1ull << 32) / d + 1);
  }
  return f;
}

__device__ __forceinline__ int fdiv(int n, FastDiv f) {
  return f.m ? (int)__umulhi((uint32_t)n, f.m) : n >> f.s;
}

struct Params {
  int M, N;
  int K;          // A_GATHER: the im2col row length KH * KW * C; bytes past it are 0
  int num_k;      // 128-byte K slices: ceil(Kp / 128)
  int stages;     // ring depth
  void* out;      // int32 or int8 [M, N]
  const float* mult;     // EPI_REQUANT: f32 [N]
  const int32_t* bias;   // EPI_REQUANT: int32 [N] or null
  // A_GATHER: x int8 [B, D, H, W, C] channels-last, output [B, OD, OH, OW]
  // (a 2-D conv: D = OD = KD = 1, stride_d = dil_d = 1, pad_d = 0, and
  // depth3 0, which takes the gather's 2-D instance)
  int depth3;
  const int8_t* x;
  int D, H, W, C, OD, OH, OW, KW, KHW, stride_d, stride_h, stride_w, pad_d, pad_h, pad_w;
  int gran;       // bytes per cp.async: 16, 8 or 4 (divides C)
  FastDiv div_c, div_khw, div_kw;  // k / C, tap / (KH KW), (tap % KH KW) / KW
  int dil_d, dil_h, dil_w;
  // the byte a padding tap holds, four times (the x zero point; 0: the
  // copy zero-fills)
  uint32_t pad_word;
  // where set, the x zero point in device memory (int32), in place of
  // pad_word; x_lo: the lowest value of x's type (0 or -128)
  const int32_t* x_zp;
  int x_lo;
  // EPI_REQUANT: the output type's range less y_zp, and y_zp
  float q_lo, q_hi;
  int y_zp;
  // EPI_REQUANT: where set, y_zp in device memory (int32), in place of the
  // three above; y_lo: the lowest value of y's type (0 or -128)
  const int32_t* y_zp_dev;
  int y_lo;
  // Bp resident: the block's one N tile of Bp (all K) is loaded into shared
  // memory once, and the ring carries A alone
  int b_resident;
  // A_HALO: the input box's depth, rows and columns; bytes from one
  // 16-channel block of the box to the next (a multiple of 128); the
  // channels staged at once (C, or 128) and the chunks of C; the 128-byte
  // K slices of one chunk; output tiles along depth, rows and columns of an
  // image, and the M tiles (images x those); KD x KH x KW taps; a tile's
  // output planes and rows; rows2d: its patches stacked along rows (a 2-D
  // conv), else along depth
  int box_d, box_h, box_w, cb_pitch, chunk, n_chunks, chunk_k;
  int n_td, n_th, n_tw, m_tiles, taps, tile_d, tile_h, rows2d;
};

// A_HALO: the box's 16-channel blocks, a chunk's own and, where they are
// odd, a second copy of its first (for the k32 step that spans two taps)
__host__ __device__ inline int halo_blocks(const Params& p) {
  const int cbs = p.chunk >> 4;
  return cbs + (cbs & 1);
}

inline size_t smem_bytes(int bm, int bn, int stages, int resident_k = 0) {
  // 1024 of slack to align the ring to the 1024-byte swizzle atom, the
  // slots (A and Bp, or A alone with Bp's resident_k slices after them),
  // the requant epilogue's int8 staging tile (rows of bn + 16 bytes), then
  // a full and an empty mbarrier per slot and one for the resident Bp
  const size_t slot = (size_t)(bm + (resident_k ? 0 : bn)) * BK;
  return 1024 + stages * slot + (size_t)resident_k * bn * BK + (size_t)bm * (bn + 16) +
         16 * (size_t)stages + 8;
}

// A_HALO's shared memory: the 1024-byte alignment slack, Bp's ring of
// `stages` slots of bn x 128 bytes (or its resident_k slices), two input
// box slots of box_bytes, the requant staging tile, the ring's barriers,
// the resident Bp's, two full and two empty box barriers, and the A
// descriptors of a chunk's k32 steps (chunk_k * 4 of 8 bytes)
inline size_t halo_smem_bytes(int bm, int bn, int stages, int resident_k, int box_bytes,
                              int chunk_k) {
  return 1024 + (size_t)(resident_k ? resident_k : stages) * bn * BK + 2 * (size_t)box_bytes +
         (size_t)bm * (bn + 16) + 16 * (size_t)stages + 8 + 32 + 32 * (size_t)chunk_k;
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3,
                                            int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// G bytes from src into shared dst, or G zero bytes where !ok (src unread)
template <int G>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src, bool ok) {
  const uint32_t n = ok ? G : 0;
  if (G == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
  else if (G == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src),
                 "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// generic-proxy writes (cp.async, the pad stores) made visible to the async
// proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// min(max(__float2int_rn(y), lo), hi) for a finite y and integer bounds
// inside (-2^22, 2^22), without the conversion unit (16 results a clock on
// an SM, against 128 for the float pipe): clamp first (the same result, as
// rounding is monotonic and the bounds are integers), then add 1.5 * 2^23,
// a float sum that rounds y half to even into the low mantissa bits.
__device__ __forceinline__ int f32_to_q(float y, float lo, float hi) {
  const float c = fminf(fmaxf(y, lo), hi);
  return __float_as_int(__fadd_rn(c, 12582912.f)) - 0x4B400000;
}

// G bytes of shared memory at dst set to the word v, repeated
template <int G>
__device__ __forceinline__ void st_shared_fill(uint32_t dst, uint32_t v) {
  if (G == 16)
    asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};" ::"r"(dst), "r"(v) : "memory");
  else if (G == 8)
    asm volatile("st.shared.v2.u32 [%0], {%1, %1};" ::"r"(dst), "r"(v) : "memory");
  else
    asm volatile("st.shared.u32 [%0], %1;" ::"r"(dst), "r"(v) : "memory");
}

// Keeps the compiler from moving accumulator reads above a wgmma wait.
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma matrix descriptor of a K-major operand in 128-byte-swizzled rows:
// 8-row groups 1024 bytes apart; the leading offset is unused by this layout.
// A step of 32 bytes along K inside the row adds 2 to the address field.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma matrix descriptor of a K-major operand without swizzle (A_HALO's
// box): each core matrix 8 rows x 16 bytes, contiguous; `lbo` bytes from
// one core matrix to the next along K (the leading offset), `sbo` from one
// 8-row group to the next (the stride offset); both multiples of 16.
__device__ __forceinline__ uint64_t plain_desc_hi(uint32_t lbo, uint32_t sbo) {
  return ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) | ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}


// wgmma.m64nNk32.s32.{s8,u8}.s8 (int8_wgmma_mma.cuh): Wgmma<N, AU8>::mma,
// A uint8 where AU8 (wgmma takes a .u8 A against an .s8 B), else int8.
#define I8G_WGMMA WgmmaS8
#define I8G_ATYPE ".s8"
#include "int8_wgmma_mma.cuh"
#undef I8G_WGMMA
#undef I8G_ATYPE
#define I8G_WGMMA WgmmaU8
#define I8G_ATYPE ".u8"
#include "int8_wgmma_mma.cuh"
#undef I8G_WGMMA
#undef I8G_ATYPE

template <int N, bool AU8>
struct Wgmma : WgmmaS8<N> {};
template <int N>
struct Wgmma<N, true> : WgmmaU8<N> {};

// ---------------------------------------------------------------------------
// the producers
// ---------------------------------------------------------------------------
// One 128-byte K slice of the im2col rows of A into the slot at `slot`
// (A_GATHER): this thread's 16-byte column c, in runs of G bytes, for rows
// r0 + 16 i. `img`, `id0`, `ih0`, `iw0` locate each row's output pixel
// (img < 0: a row past M). Padding taps, bytes past K and rows past M are
// zero-filled: the lanes of a warp hold different columns, and one
// predicated copy for all of them runs faster than lanes that skip theirs.
// With a pad word they hold it instead: the padding's zero point; past K
// and past M it meets a zero weight or a row no one stores.
// D3: a 3-D conv (a depth tap and a depth bound); otherwise the 2-D code,
// whose instructions a 2-D conv pays no more for the 3-D form (the gather
// is bound by its instructions per copied run).
template <int G, int RPT, bool D3>
__device__ __forceinline__ void gather_slice(const Params& p, uint32_t pad_word, uint32_t slot,
                                             int kt, int c, int r0,
                                             const int64_t (&img)[RPT],
                                             const int (&id0)[RPT], const int (&ih0)[RPT],
                                             const int (&iw0)[RPT]) {
  const uint32_t col = (uint32_t)((c ^ (r0 & 7)) * 16);  // swizzled 16-byte column
#pragma unroll
  for (int j = 0; j < 16 / G; ++j) {
    const int k = kt * BK + c * 16 + j * G;
    const bool k_ok = k < p.K;
    const int tap = fdiv(k, p.div_c);
    const int ch = k - tap * p.C;
    const int kd = D3 ? fdiv(tap, p.div_khw) : 0;
    const int t2 = tap - kd * p.KHW;
    const int kh = fdiv(t2, p.div_kw);
    const int dd = kd * p.dil_d;
    const int dh = kh * p.dil_h;
    const int dw = (t2 - kh * p.KW) * p.dil_w;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int id = D3 ? id0[i] + dd : 0;
      const int ih = ih0[i] + dh;
      const int iw = iw0[i] + dw;
      const bool ok = k_ok && img[i] >= 0 && (!D3 || (unsigned)id < (unsigned)p.D) &&
                      (unsigned)ih < (unsigned)p.H && (unsigned)iw < (unsigned)p.W;
      const int64_t pix = D3 ? ((int64_t)id * p.H + ih) * p.W + iw : (int64_t)ih * p.W + iw;
      const int8_t* src = ok ? p.x + img[i] + pix * p.C + ch : p.x;
      const uint32_t dst = slot + (uint32_t)(r0 + 16 * i) * BK + col + j * G;
      if (ok || pad_word == 0)
        cp_async_zfill<G>(dst, src, ok);
      else
        st_shared_fill<G>(dst, pad_word);
    }
  }
}

// Where output row m reads its input: x offset of its image (-1 past M) and
// the first tap's (id, ih, iw) (id 0 for a 2-D conv).
template <bool D3>
__device__ __forceinline__ void row_origin(const Params& p, int m, int64_t& img, int& id0,
                                           int& ih0, int& iw0) {
  if (m >= p.M) {
    img = -1;
    id0 = ih0 = iw0 = 0;
    return;
  }
  const int plane = p.OH * p.OW;
  const int vol = D3 ? p.OD * plane : plane;
  const int b = m / vol;
  const int vox = m - b * vol;
  const int od = D3 ? vox / plane : 0;
  const int pix = vox - od * plane;
  const int oh = pix / p.OW;
  img = (int64_t)b * (D3 ? p.D : 1) * p.H * p.W * p.C;
  id0 = D3 ? od * p.stride_d - p.pad_d : 0;
  ih0 = oh * p.stride_h - p.pad_h;
  iw0 = (pix - oh * p.OW) * p.stride_w - p.pad_w;
}

// Waits until this thread's cp.async groups but the newest `lag` have landed.
__device__ __forceinline__ void cp_async_wait_lag(int lag) {
  if (lag >= 3)
    cp_async_wait<3>();
  else if (lag == 2)
    cp_async_wait<2>();
  else if (lag == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// The gather producer's walk over the block's tiles (A_GATHER): each tile's
// rows located once, then every 128-byte K slice gathered into the ring,
// published `lag` slices behind. Returns the slot counter it reached.
template <bool D3, int RPT>
__device__ __forceinline__ int gather_tiles(const Params& p, uint32_t pad_word,
                                            const CUtensorMap& tm_b, uint32_t ring,
                                            int SLOT, int A_BYTES, int B_BYTES,
                                            uint32_t full0, uint32_t empty0, bool bres,
                                            int tiles, int n_tiles, int BM, int BN, int S,
                                            int pt, int lag) {
  const int c = pt & 7;
  const int r0 = pt >> 3;
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * BM;
    const int n0 = tile % n_tiles * BN;
    int64_t img[RPT];
    int id0[RPT], ih0[RPT], iw0[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      row_origin<D3>(p, m0 + r0 + 16 * i, img[i], id0[i], ih0[i], iw0[i]);
    for (int kt = 0; kt < p.num_k; ++kt, ++it) {
      const int s = it % S;
      if (it >= S) mbar_wait(empty0 + 8 * s, (it / S - 1) & 1);
      const uint32_t slot = ring + s * SLOT;
      if (pt == 0 && bres) {
        mbar_arrive(full0 + 8 * s);
      } else if (pt == 0) {
        mbar_arrive_tx(full0 + 8 * s, B_BYTES);
        tma_load_2d(slot + A_BYTES, &tm_b, full0 + 8 * s, kt * BK, n0);
      }
      if (p.gran == 16)
        gather_slice<16, RPT, D3>(p, pad_word, slot, kt, c, r0, img, id0, ih0, iw0);
      else if (p.gran == 8)
        gather_slice<8, RPT, D3>(p, pad_word, slot, kt, c, r0, img, id0, ih0, iw0);
      else
        gather_slice<4, RPT, D3>(p, pad_word, slot, kt, c, r0, img, id0, ih0, iw0);
      cp_async_commit();
      if (it >= lag) {  // slice it - lag has landed: publish it
        cp_async_wait_lag(lag);
        fence_proxy_async();
        mbar_arrive(full0 + 8 * ((it - lag) % S));
      }
    }
  }
  return it;
}

// The tiles whose instances carry the gather's 3-D form: BM 128 (WGM 2), BN
// 64 or 128 (ops/kernels/qconv_int8.py, TILE_3D_BM / TILE_3D_BN). The 3-D
// form is a second copy of the producer's loop; in every instance it
// would cost the build as much again.
template <int BN, int WGM>
constexpr bool D3_TILE = WGM == 2 && (BN == 64 || BN == 128);

inline bool d3_tile(int bm, int bn) { return bm == 128 && (bn == 64 || bn == 128); }

// v saturated to the 8-bit type whose lowest value is lo
__device__ __forceinline__ int sat8(int v, int lo) {
  return v < lo ? lo : (v > lo + 255 ? lo + 255 : v);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------
// The epilogue of one tile: warpgroup wg's 64 x BN accumulator fragment to
// the output rows row_m(r) names for the tile's rows r (-1: a row no one
// stores), columns n0 + [0, BN) of N.
template <int EPI, int BN, typename RowM>
__device__ __forceinline__ void store_tile(const Params& p, const int (&acc)[BN / 2],
                                           uint8_t* staging, int wg, int tid, int n0,
                                           float q_lo, float q_hi, int y_zp, RowM row_m) {
  constexpr int LDS = BN + 16;  // staging row stride (bytes)
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  // accumulator fragment (wgmma m64nN): acc[4j + 2h + e] is row
  // 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e of the
  // warpgroup's 64 x BN tile
  const int row_in_wg = warp * 16 + (lane >> 2);
  const int col_in_j = 2 * (lane & 3);
  if constexpr (EPI == EPI_INT32) {
    int32_t* out = static_cast<int32_t*>(p.out);
    const bool vec = (p.N % 2 == 0) && (reinterpret_cast<uintptr_t>(out) % 8 == 0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row_m(wg * 64 + row_in_wg + 8 * h);
      if (m < 0) continue;
      int32_t* orow = out + (int64_t)m * p.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + col_in_j;
        const int v0 = acc[4 * j + 2 * h];
        const int v1 = acc[4 * j + 2 * h + 1];
        if (vec && n + 1 < p.N) {
          *reinterpret_cast<int2*>(orow + n) = make_int2(v0, v1);
        } else {
          if (n < p.N) orow[n] = v0;
          if (n + 1 < p.N) orow[n + 1] = v1;
        }
      }
    }
  } else {
    uint8_t* stage = staging + wg * 64 * LDS;
    named_barrier(2 + wg, 128);  // the warpgroup's previous tile has left
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + col_in_j;
      const float mu0 = n < p.N ? p.mult[n] : 0.f;
      const float mu1 = n + 1 < p.N ? p.mult[n + 1] : 0.f;
      const int b0 = (p.bias != nullptr && n < p.N) ? p.bias[n] : 0;
      const int b1 = (p.bias != nullptr && n + 1 < p.N) ? p.bias[n + 1] : 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q0 = f32_to_q(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h] + b0), mu0),
                                q_lo, q_hi) + y_zp;
        const int q1 = f32_to_q(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1] + b1), mu1),
                                q_lo, q_hi) + y_zp;
        *reinterpret_cast<uint16_t*>(stage + (row_in_wg + 8 * h) * LDS + 8 * j + col_in_j) =
            (uint16_t)((q0 & 0xFF) | ((q1 & 0xFF) << 8));
      }
    }
    named_barrier(2 + wg, 128);
    int8_t* out = static_cast<int8_t*>(p.out);
    const int wtid = tid & 127;
    const bool vec16 = (p.N % 16 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    const bool vec8 = (p.N % 8 == 0) && (reinterpret_cast<uintptr_t>(out) % 8 == 0);
    constexpr int CPR = BN / 16;  // 16-byte chunks per row
    for (int idx = wtid; idx < 64 * CPR; idx += 128) {
      const int r = idx / CPR;
      const int ch = idx - r * CPR;
      const int n = n0 + 16 * ch;
      if (n >= p.N) continue;
      const int m = row_m(wg * 64 + r);
      if (m < 0) continue;
      const uint8_t* src = stage + r * LDS + 16 * ch;
      int8_t* dst = out + (int64_t)m * p.N + n;
      if (vec16 && n + 16 <= p.N) {
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
      } else if (vec8) {
        *reinterpret_cast<int2*>(dst) = *reinterpret_cast<const int2*>(src);
        if (n + 16 <= p.N)
          *reinterpret_cast<int2*>(dst + 8) = *reinterpret_cast<const int2*>(src + 8);
      } else {
        for (int b = 0; b < 16 && n + b < p.N; ++b) dst[b] = (int8_t)src[b];
      }
    }
  }
}

// the requant's y_zp and range: the launch's, or derived from y_zp in
// device memory
template <int EPI>
__device__ __forceinline__ void requant_range(const Params& p, float& q_lo, float& q_hi,
                                              int& y_zp) {
  q_lo = p.q_lo;
  q_hi = p.q_hi;
  y_zp = p.y_zp;
  if (EPI == EPI_REQUANT && p.y_zp_dev != nullptr) {
    y_zp = sat8(*p.y_zp_dev, p.y_lo);
    q_lo = (float)(p.y_lo - y_zp);
    q_hi = (float)(p.y_lo + 255 - y_zp);
  }
}

// A_HALO (the producer's note at the top of this file). Shared memory: Bp's
// ring (or the resident Bp), two box slots, the staging tile, the barriers,
// the k32 steps' A descriptors. Two threads produce (the boxes; Bp's slices, or
// the block's resident N tile of it); each consumer warpgroup runs
// MB patches of the tile's output box (WGM * MB patches of 8 x 8: planes,
// or 8-row bands in a 2-D conv), one m64 accumulator a patch, so that each
// Bp slice in shared memory serves MB products and each Bp byte leaves L2
// once per WGM * MB * 64 outputs. Blocks are persistent over tiles (N
// tiles fastest, then columns, rows, planes, images).
template <int EPI, int BN, int WGM, int MB, bool AU8>
__device__ __forceinline__ void halo_body(const CUtensorMap& tm_x, const CUtensorMap& tm_b,
                                          const Params& p) {
  constexpr int BM = 64 * WGM;
  constexpr int CONSUMERS = 128 * WGM;
  constexpr int B_BYTES = BN * BK;
  constexpr int R = BN / 2;
  const bool bres = p.b_resident != 0;
  const int S = p.stages;
  const int cbs = p.chunk >> 4;       // 16-channel blocks a chunk
  const int blocks = halo_blocks(p);  // the box's: cbs, + a copy of block 0 where odd
  const int box_bytes = blocks * p.cb_pitch;
  const int plane = p.box_h * p.box_w;  // voxels of one box plane
  const uint32_t box_tx = (uint32_t)(blocks * p.box_d * plane * 16);
  // bytes from one patch (m64 accumulator) of the box to the next: a plane,
  // or 8 rows (rows2d)
  const int patch = (p.rows2d ? 8 * p.box_w : plane) * 16;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const int ring_bytes = (bres ? p.num_k : S) * B_BYTES;
  const uint32_t box0 = ring + ring_bytes;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  uint8_t* staging = ring_ptr + ring_bytes + 2 * box_bytes;  // BM x (BN + 16)
  const uint32_t full0 = box0 + 2 * box_bytes + BM * (BN + 16);
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t b_full = empty0 + 8 * S;
  const uint32_t box_full0 = b_full + 8;  // a box slot has landed
  const uint32_t box_empty0 = box_full0 + 16;  // a box slot's readers are done
  uint64_t* step_desc = reinterpret_cast<uint64_t*>(ring_ptr + (box_empty0 + 16 - ring));

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * WGM);  // one arrival per consumer warp
    }
    mbar_init(b_full, 1);
    for (int u = 0; u < 2; ++u) {
      mbar_init(box_full0 + 8 * u, 1);
      mbar_init(box_empty0 + 8 * u, 4 * WGM);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // The K walk of a chunk is the same for every tile: the A descriptor of
  // each k32 step, less the box's address, is made once. Step s reads the
  // chunk's K bytes [32 s, 32 s + 32): tap t = 32 s / chunk (taps past the
  // last, a slice's tail against zero weights, read the last tap's place)
  // at its offset in a channel block of the box ((kd, kh, kw) in box
  // planes, rows and columns), block cb of it; its second 16 bytes are
  // the next block (the leading offset, one block), or after an odd
  // chunk's last block the next tap's first, read from the box's copy of
  // block 0 past the last (one block + the two taps' distance). 8-row
  // groups are one box row apart (the stride offset).
  {
    auto tap_off = [&](int t) {
      const int u = t < p.taps ? t : p.taps - 1;
      const int kd = u / p.KHW, r = u - kd * p.KHW, kh = r / p.KW, kw = r - kh * p.KW;
      return ((kd * p.box_h + kh) * p.box_w + kw) * 16;
    };
    for (int st = tid; st < p.chunk_k * (BK / 32); st += blockDim.x) {
      const int kl = st * 32, t = kl / p.chunk, cb = (kl - t * p.chunk) >> 4;
      const int off = cb * p.cb_pitch + tap_off(t);
      const int lbo = p.cb_pitch + (cb == cbs - 1 ? tap_off(t + 1) - tap_off(t) : 0);
      step_desc[st] = (uint64_t)(off >> 4) |
                      plain_desc_hi((uint32_t)lbo, (uint32_t)(p.box_w * 16));
    }
  }
  __syncthreads();

  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = p.m_tiles * n_tiles;
  // a tile's image and first output voxel
  auto locate = [&](int tile, int& b, int& od0, int& oh0, int& ow0) {
    int mt = tile / n_tiles;
    ow0 = mt % p.n_tw * 8;
    mt /= p.n_tw;
    oh0 = mt % p.n_th * p.tile_h;
    mt /= p.n_th;
    od0 = mt % p.n_td * p.tile_d;
    b = mt / p.n_td;
  };
  // K slice j of chunk q: its first column of Bp ((kd, kh, kw, c) order)
  auto b_col = [&](int q, int j) { return p.n_chunks == 1 ? j * BK : j * p.C + q * p.chunk; };

  if (tid >= CONSUMERS) {
    // ----------------------------------------------------------- producers
    // two threads, one a warp, so that neither pipeline waits on the
    // other's barriers: warp 0 loads the boxes, warp 1 Bp (its slices
    // into the ring, or its N tile once where it is resident)
    if ((tid & 31) != 0) return;
    if (tid != CONSUMERS) {
      const int n0 = (int)blockIdx.x % n_tiles * BN;  // the block's N tile, where resident
      if (bres) {
        mbar_arrive_tx(b_full, p.num_k * B_BYTES);
        for (int kt = 0; kt < p.num_k; ++kt)
          tma_load_2d(ring + kt * B_BYTES, &tm_b, b_full, kt * BK, n0);
        return;
      }
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x)
        for (int q = 0; q < p.n_chunks; ++q)
          for (int j = 0; j < p.chunk_k; ++j, ++it) {
            const int s = it % S;
            if (it >= S) mbar_wait(empty0 + 8 * s, (it / S - 1) & 1);
            mbar_arrive_tx(full0 + 8 * s, B_BYTES);
            tma_load_2d(ring + s * B_BYTES, &tm_b, full0 + 8 * s, b_col(q, j),
                        tile % n_tiles * BN);
          }
      return;
    }
    // chunk q of a tile's input box into box slot u % 2
    auto load_box = [&](int tile, int q, int u) {
      int b, od0, oh0, ow0;
      locate(tile, b, od0, oh0, ow0);
      const uint32_t dst = box0 + (u & 1) * box_bytes;
      const uint32_t bar = box_full0 + 8 * (u & 1);
      mbar_arrive_tx(bar, box_tx);
      for (int i = 0; i < blocks; ++i)
        tma_load_5d(dst + i * p.cb_pitch, &tm_x, bar, q * p.chunk + 16 * (i < cbs ? i : 0),
                    ow0 - p.pad_w, oh0 - p.pad_h, od0 - p.pad_d, b);
    };
    if ((int)blockIdx.x < tiles) load_box(blockIdx.x, 0, 0);
    int u = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int q = 0; q < p.n_chunks; ++q, ++u) {
        // the next chunk's box, as soon as its slot's readers are done
        const bool last = q + 1 == p.n_chunks;
        const int nt = last ? tile + (int)gridDim.x : tile;
        if (nt < tiles) {
          const int v = u + 1;
          if (v >= 2) mbar_wait(box_empty0 + 8 * (v & 1), ((v >> 1) - 1) & 1);
          load_box(nt, last ? 0 : q + 1, v);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = tid >> 7;
  const int lane = tid & 31;
  float q_lo, q_hi;
  int y_zp;
  requant_range<EPI>(p, q_lo, q_hi, y_zp);
  // the pad byte: the launch's, or the x zero point in device memory
  const uint32_t pad_word =
      p.x_zp != nullptr ? (uint32_t)(sat8(*p.x_zp, p.x_lo) & 0xFF) * 0x01010101u : p.pad_word;
  int acc[MB][R] = {};
  if (bres) mbar_wait(b_full, 0);
  int u = 0, it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int b, od0, oh0, ow0;
    locate(tile, b, od0, oh0, ow0);
    const int d0 = od0 - p.pad_d, h0 = oh0 - p.pad_h, w0 = ow0 - p.pad_w;  // box origin
    const bool border = d0 < 0 || h0 < 0 || w0 < 0 || d0 + p.box_d > p.D ||
                        h0 + p.box_h > p.H || w0 + p.box_w > p.W;
    for (int q = 0; q < p.n_chunks; ++q, ++u) {
      const int slot = u & 1;
      const uint32_t box = box0 + slot * box_bytes;
      mbar_wait(box_full0 + 8 * slot, (u >> 1) & 1);
      if (pad_word != 0 && border) {
        // the box's bytes outside the volume hold the pad byte, not TMA's
        // zeros (the condition is the block's, so is the barrier): a
        // thread a box row of a 16-channel block, which it fills whole
        // where the row lies outside, else its columns before and after
        // the image
        const int rows = blocks * p.box_d * p.box_h;
        for (int e = tid; e < rows; e += CONSUMERS) {
          const int hh = e % p.box_h, e2 = e / p.box_h;
          const int dd = e2 % p.box_d, cb = e2 / p.box_d;
          const uint32_t row = box + cb * p.cb_pitch + (dd * p.box_h + hh) * p.box_w * 16;
          const bool inside =
              (unsigned)(d0 + dd) < (unsigned)p.D && (unsigned)(h0 + hh) < (unsigned)p.H;
          const int lo = inside ? min(max(-w0, 0), p.box_w) : p.box_w;
          const int hi = inside ? max(min(p.W - w0, p.box_w), lo) : p.box_w;
          for (int ww = 0; ww < lo; ++ww) st_shared_fill<16>(row + ww * 16, pad_word);
          for (int ww = hi; ww < p.box_w; ++ww) st_shared_fill<16>(row + ww * 16, pad_word);
        }
        fence_proxy_async();
        named_barrier(1, CONSUMERS);
      }
      // this warpgroup's first patch's address field; the next MB - 1
      // follow it
      const uint64_t a_base = ((box + wg * MB * patch) & 0x3FFFF) >> 4;
      if (bres) {
        // Bp resident: the chunk's k32 steps back to back, each a commit
        // group of its own, and none past the chunk's K (a slice's tail of
        // zero weights: C 16's 144-byte taps leave 3 of 8 steps, C 32's
        // 288 3 of 12); no wait until the chunk's end
        const int steps = (p.taps * p.chunk + 31) / 32;
        for (int st = 0; st < steps; ++st) {
          const uint64_t a = step_desc[st] + a_base;
          const uint32_t b = ring + (b_col(q, st >> 2) / BK) * B_BYTES + (st & 3) * 32;
          wgmma_fence();
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            Wgmma<BN, AU8>::mma(acc[mb], a + (uint64_t)(mb * (patch >> 4)), sw128_desc(b),
                                (q | st) != 0);
          wgmma_commit();
        }
      } else {
        for (int j = 0; j < p.chunk_k; ++j, ++it) {
          const int s = it % S;
          mbar_wait(full0 + 8 * s, (it / S) & 1);
          const uint32_t b_slot = ring + s * B_BYTES;
          wgmma_fence();
          // every step of the slice (those past the chunk's K against zero
          // weights: a branch among the products serializes them all)
#pragma unroll
          for (int kk = 0; kk < BK / 32; ++kk) {
            const uint64_t a = step_desc[j * (BK / 32) + kk] + a_base;
#pragma unroll
            for (int mb = 0; mb < MB; ++mb)
              Wgmma<BN, AU8>::mma(acc[mb], a + (uint64_t)(mb * (patch >> 4)),
                                  sw128_desc(b_slot + kk * 32), (q | j | kk) != 0);
          }
          wgmma_commit();
          // once the previous slice's products are done, free its slot
          wgmma_wait<1>();
          if (j > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % S));
        }
      }
      wgmma_wait<0>();
      if (lane == 0) {
        if (!bres) mbar_arrive(empty0 + 8 * ((it - 1) % S));
        mbar_arrive(box_empty0 + 8 * slot);
      }
    }
    // accumulator mb of warpgroup wg holds patch wg * MB + mb: output plane
    // od0 + that (3-D), or rows oh0 + 8 x that (rows2d); row r of the
    // warpgroup is the patch's row (r / 8) % 8, column r % 8
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      fence_acc(acc[mb]);
      store_tile<EPI, BN>(p, acc[mb], staging, wg, tid, tile % n_tiles * BN, q_lo, q_hi, y_zp,
                          [&](int r) {
                            const int a = (r >> 6) * MB + mb;
                            const int d = od0 + (p.rows2d ? 0 : a),
                                      h = oh0 + (p.rows2d ? 8 * a : 0) + ((r >> 3) & 7),
                                      w = ow0 + (r & 7);
                            return (d < p.OD && h < p.OH && w < p.OW)
                                       ? ((b * p.OD + d) * p.OH + h) * p.OW + w
                                       : -1;
                          });
    }
  }
}

// Persistent: block b takes output tiles b, b + gridDim.x, ... (N tiles
// fastest, so the blocks in flight share A's rows in L2). The producer runs
// through every slice of every tile on one slot counter `it`, so it fills
// the ring for the next tile while the consumers run this one's epilogue.
// A_HALO runs halo_body (MB planes a warpgroup); tm_a is then x's 5-D map.
// Two blocks an SM where BN < 96 with one patch a warpgroup, and for
// A_HALO at BN 96 too (<= 102 registers; SqueezeNet's conv1 as its
// space-to-depth rewrite): its K is two 128-byte slices, so a tile's
// epilogue is half its time, and the second block's products run under
// the first's epilogue (0.539 -> 0.430 ms on the H100 against one block;
// PERF.md section 6, the space-to-depth stem findings).
template <int PROD, int EPI, int BN, int WGM, bool AU8, int MB = 1>
__global__ void __launch_bounds__(WGM * 128 + (PROD == A_GATHER ? 128 : PROD == A_HALO ? 64 : 32),
                                  (PROD == A_HALO ? BN > 96 : BN >= 96) || MB > 1 ? 1 : 2)
I8G_KERNEL(const __grid_constant__ CUtensorMap tm_a,
           const __grid_constant__ CUtensorMap tm_b, const Params p) {
  if constexpr (PROD == A_HALO) {
    halo_body<EPI, BN, WGM, MB, AU8>(tm_a, tm_b, p);
  } else {
  constexpr int BM = 64 * WGM;
  constexpr int CONSUMERS = 128 * WGM;
  constexpr int PRODUCERS = PROD == A_TMA ? 32 : 128;
  constexpr int A_BYTES = BM * BK;
  constexpr int B_BYTES = BN * BK;
  constexpr int R = BN / 2;                // accumulators per thread
  constexpr int LDS = BN + 16;             // staging row stride (bytes)
  const bool bres = p.b_resident != 0;
  const int SLOT = A_BYTES + (bres ? 0 : B_BYTES);  // a multiple of 1024

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const int S = p.stages;
  const uint32_t b_res = ring + S * SLOT;  // resident Bp: num_k slices of B_BYTES
  const int b_res_bytes = bres ? p.num_k * B_BYTES : 0;
  uint8_t* ring_ptr = smem_raw + (ring - raw);
  uint8_t* staging = ring_ptr + S * SLOT + b_res_bytes;  // BM x LDS bytes (requant)
  const uint32_t full0 = ring + S * SLOT + b_res_bytes + BM * LDS;
  const uint32_t empty0 = full0 + 8 * S;
  const uint32_t b_full = empty0 + 8 * S;  // the resident Bp has landed

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // full: the TMA thread's expect-tx arrival (+ one per gather thread)
      mbar_init(full0 + 8 * s, PROD == A_TMA ? 1 : PRODUCERS + 1);
      mbar_init(empty0 + 8 * s, 4 * WGM);  // one arrival per consumer warp
    }
    mbar_init(b_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = (p.N + BN - 1) / BN;
  const int tiles = ((p.M + BM - 1) / BM) * n_tiles;

  if (tid >= CONSUMERS) {
    // ------------------------------------------------------------ producer
    const int pt = tid - CONSUMERS;
    if (bres && pt == 0) {  // the one N tile (n0 = 0) of Bp, all of K, once
      mbar_arrive_tx(b_full, b_res_bytes);
      for (int kt = 0; kt < p.num_k; ++kt)
        tma_load_2d(b_res + kt * B_BYTES, &tm_b, b_full, kt * BK, 0);
    }
    if constexpr (PROD == A_TMA) {
      if (pt != 0) return;
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / n_tiles * BM;
        const int n0 = tile % n_tiles * BN;
        for (int kt = 0; kt < p.num_k; ++kt, ++it) {
          const int s = it % S;
          if (it >= S) mbar_wait(empty0 + 8 * s, (it / S - 1) & 1);
          const uint32_t slot = ring + s * SLOT;
          mbar_arrive_tx(full0 + 8 * s, SLOT);
          tma_load_2d(slot, &tm_a, full0 + 8 * s, kt * BK, m0);
          if (!bres) tma_load_2d(slot + A_BYTES, &tm_b, full0 + 8 * s, kt * BK, n0);
        }
      }
    } else {
      // thread pt owns 16-byte column pt % 8 of rows pt / 8 + 16 i
      constexpr int RPT = BM / 16;
      // slices a thread keeps in flight before it publishes the oldest. A
      // consumer frees slot j once it has slice j + 1, so the producer,
      // waiting for slot it - S, must have published it - S + 1: lag <= S - 2
      const int lag = S - 2 < 3 ? S - 2 : 3;
      // the pad byte: the launch's, or the x zero point in device memory
      const uint32_t pad_word =
          p.x_zp != nullptr ? (uint32_t)(sat8(*p.x_zp, p.x_lo) & 0xFF) * 0x01010101u
                            : p.pad_word;
      // the 3-D form only in the D3_TILE instances (launch refuses it
      // elsewhere), so the build compiles it into few of them
      const int it =
          (D3_TILE<BN, WGM> && p.depth3)
              ? gather_tiles<D3_TILE<BN, WGM>, RPT>(p, pad_word, tm_b, ring, SLOT, A_BYTES,
                                                    B_BYTES, full0, empty0, bres, tiles,
                                                    n_tiles, BM, BN, S, pt, lag)
              : gather_tiles<false, RPT>(p, pad_word, tm_b, ring, SLOT, A_BYTES, B_BYTES,
                                         full0, empty0, bres, tiles, n_tiles, BM, BN, S, pt,
                                         lag);
      cp_async_wait<0>();
      fence_proxy_async();
      for (int j = it - lag > 0 ? it - lag : 0; j < it; ++j) mbar_arrive(full0 + 8 * (j % S));
    }
    return;
  }

  // -------------------------------------------------------------- consumers
  const int wg = tid >> 7;  // rows 64 * wg of each tile
  const int lane = tid & 31;
  int acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0;
  float q_lo, q_hi;
  int y_zp;
  requant_range<EPI>(p, q_lo, q_hi, y_zp);

  if (bres) mbar_wait(b_full, 0);
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / n_tiles * BM;
    const int rows = p.M - m0 < BM ? p.M - m0 : BM;
    const int n0 = tile % n_tiles * BN;
    for (int kt = 0; kt < p.num_k; ++kt, ++it) {
      const int s = it % S;
      mbar_wait(full0 + 8 * s, (it / S) & 1);
      const uint32_t a_slot = ring + s * SLOT + wg * 64 * BK;
      const uint32_t b_slot = bres ? b_res + kt * B_BYTES : ring + s * SLOT + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        Wgmma<BN, AU8>::mma(acc, sw128_desc(a_slot + kk * 32), sw128_desc(b_slot + kk * 32),
                       (kt | kk) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: free its slot
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % S));
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % S));
    fence_acc(acc);
    store_tile<EPI, BN>(p, acc, staging, wg, tid, n0, q_lo, q_hi, y_zp,
                        [&](int r) { return r < rows ? m0 + r : -1; });
  }
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

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no libcuda
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* sym = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &sym,
                                                     12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &sym,
                                            cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(sym);
  }
  return fn;
}

// A TMA map of a row-major int8 [rows, cols] matrix (cols a multiple of 16,
// base 16-byte aligned), loaded in boxes of box_rows x 128 bytes with the
// 128-byte swizzle; reads outside the matrix return zeros.
inline cudaError_t encode_rows(CUtensorMap* map, const void* base, uint64_t rows,
                               uint64_t cols, uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols};
  const cuuint32_t box[2] = {(cuuint32_t)BK, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
                        dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int PROD, int EPI, int BN, int WGM, bool AU8, int MB = 1>
cudaError_t launch_tile(const CUtensorMap& a, const CUtensorMap& b, const Params& p,
                        cudaStream_t st) {
  constexpr int BM = 64 * WGM;
  constexpr int THREADS = WGM * 128 + (PROD == A_GATHER ? 128 : PROD == A_HALO ? 64 : 32);
  const size_t smem =
      PROD == A_HALO ? halo_smem_bytes(BM, BN, p.stages, p.b_resident ? p.num_k : 0,
                                       halo_blocks(p) * p.cb_pitch, p.chunk_k)
                     : smem_bytes(BM, BN, p.stages, p.b_resident ? p.num_k : 0);
  auto kern = I8G_KERNEL<PROD, EPI, BN, WGM, AU8, MB>;
  static size_t opted_in = 0;  // the shared memory this instantiation may use
  static size_t occ_smem = 0;  // blocks an SM holds at that shared memory
  static int occ = 0;
  cudaError_t e;
  if (smem > opted_in) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  if (smem != occ_smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern, THREADS, smem);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    occ_smem = smem;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
  }
  const long long m_tiles = PROD == A_HALO ? p.m_tiles : (p.M + BM - 1) / BM;
  const long long n_tiles = (p.N + BN - 1) / BN;
  const long long tiles = m_tiles * n_tiles;
  long long blocks = (long long)sms * occ;
  // A_HALO with Bp resident over more than one N tile: each block keeps
  // one N tile's slices, so the grid is a multiple of the N tiles (a
  // block's tiles are then all of its N tile; tiles is one too)
  if (PROD == A_HALO && p.b_resident && n_tiles > 1) {
    blocks = blocks / n_tiles * n_tiles;
    if (blocks == 0) return cudaErrorInvalidConfiguration;
  }
  if (blocks > tiles) blocks = tiles;
  kern<<<(unsigned)blocks, THREADS, smem, st>>>(a, b, p);
  return cudaGetLastError();
}

template <int PROD, int EPI, int WGM, bool AU8>
cudaError_t launch_bn(int bn, const CUtensorMap& a, const CUtensorMap& b, const Params& p,
                      cudaStream_t st) {
  switch (bn) {
    case 16: return launch_tile<PROD, EPI, 16, WGM, AU8>(a, b, p, st);
    case 32: return launch_tile<PROD, EPI, 32, WGM, AU8>(a, b, p, st);
    case 48: return launch_tile<PROD, EPI, 48, WGM, AU8>(a, b, p, st);
    case 64: return launch_tile<PROD, EPI, 64, WGM, AU8>(a, b, p, st);
    case 96: return launch_tile<PROD, EPI, 96, WGM, AU8>(a, b, p, st);
    case 128: return launch_tile<PROD, EPI, 128, WGM, AU8>(a, b, p, st);
    case 192: return launch_tile<PROD, EPI, 192, WGM, AU8>(a, b, p, st);
    case 256: return launch_tile<PROD, EPI, 256, WGM, AU8>(a, b, p, st);
    default: return cudaErrorInvalidValue;
  }
}

inline bool tile_fits(int bm, int bn, int stages, int resident_k) {
  const bool bn_ok = bn == 16 || bn == 32 || bn == 48 || bn == 64 || bn == 96 ||
                     bn == 128 || bn == 192 || bn == 256;
  return (bm == 64 || bm == 128) && bn_ok && stages >= 2 && stages <= MAX_STAGES &&
         smem_bytes(bm, bn, stages, resident_k) <= (size_t)SMEM_LIMIT;
}

// Encodes Bp's map (and A's, for A_TMA: a [M, K] with K a multiple of 16)
// and launches the tile (bm, bn, stages; p.b_resident: Bp resident, which
// needs N <= bn), after checking that it fits. ONLY_BM: 0 instances BM 64
// and 128; 64 or 128 that BM alone (a call site's tiles at half the build),
// any other bm refused.
template <int PROD, int EPI, bool AU8 = false, int ONLY_BM = 0>
cudaError_t launch(const void* a, const void* bp, int Kp, Params p, int bm, int bn,
                   cudaStream_t st) {
  p.num_k = (Kp + BK - 1) / BK;
  if (!tile_fits(bm, bn, p.stages, p.b_resident ? p.num_k : 0) ||
      (PROD == A_GATHER && p.depth3 && !d3_tile(bm, bn)) ||
      p.M <= 0 || p.N <= 0 || Kp <= 0 || Kp % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bp) % 16 != 0 || (p.b_resident && p.N > bn) ||
      (long long)((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn) >= (1LL << 31))
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  memset(&ta, 0, sizeof(ta));
  cudaError_t e = encode_rows(&tb, bp, (uint64_t)p.N, (uint64_t)Kp, (uint32_t)bn);
  if (e != cudaSuccess) return e;
  if (PROD == A_TMA) {
    if (reinterpret_cast<uintptr_t>(a) % 16 != 0) return cudaErrorInvalidValue;
    e = encode_rows(&ta, a, (uint64_t)p.M, (uint64_t)Kp, (uint32_t)bm);
    if (e != cudaSuccess) return e;
  }
  if constexpr (ONLY_BM != 0) {
    static_assert(ONLY_BM == 64 || ONLY_BM == 128, "ONLY_BM: 0, 64 or 128");
    if (bm != ONLY_BM) return cudaErrorInvalidValue;
    return launch_bn<PROD, EPI, ONLY_BM / 64, AU8>(bn, ta, tb, p, st);
  } else {
    return bm == 64 ? launch_bn<PROD, EPI, 1, AU8>(bn, ta, tb, p, st)
                    : launch_bn<PROD, EPI, 2, AU8>(bn, ta, tb, p, st);
  }
}

// A map of channels-last x [B, D, H, W, C] (bytes; C a multiple of 16,
// base 16-byte aligned), loaded in boxes of 16 channels x box_w x box_h x
// box_d x 1 image without swizzle (A_HALO's input box, one 16-channel block
// a load); reads outside the tensor return zeros.
inline cudaError_t encode_box5(CUtensorMap* map, const void* x, int B, const Params& p) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t C = (cuuint64_t)p.C;
  const cuuint64_t dims[5] = {C, (cuuint64_t)p.W, (cuuint64_t)p.H, (cuuint64_t)p.D,
                              (cuuint64_t)B};
  const cuuint64_t strides[4] = {C, C * p.W, C * p.W * p.H, C * p.W * p.H * p.D};
  const cuuint32_t box[5] = {16, (cuuint32_t)p.box_w, (cuuint32_t)p.box_h,
                             (cuuint32_t)p.box_d, 1};
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 5, const_cast<void*>(x), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A_HALO: encodes Bp's map and x's 5-D map (B images) and launches the
// bm x bn tile (bm 128: a patch a consumer warpgroup, or 256: two; bn 64,
// 96 (SqueezeNet's conv1, N 96, as its space-to-depth rewrite) or 128;
// p.b_resident: Bp resident, each block's N tile of it where N > bn),
// after checking that it fits.
template <int EPI, bool AU8>
cudaError_t launch_halo(const void* x, const void* bp, int Kp, int B, Params p, int bm,
                        int bn, cudaStream_t st) {
  p.num_k = (Kp + BK - 1) / BK;
  const size_t smem = halo_smem_bytes(128, bn, p.stages, p.b_resident ? p.num_k : 0,
                                      halo_blocks(p) * p.cb_pitch, p.chunk_k);
  if ((bm != 128 && bm != 256) || (bn != 64 && bn != 96 && bn != 128) || p.stages < 2 ||
      p.stages > MAX_STAGES ||
      smem > (size_t)SMEM_LIMIT || p.M <= 0 || p.N <= 0 || Kp <= 0 || Kp % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bp) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (long long)p.m_tiles * ((p.N + bn - 1) / bn) >= (1LL << 31))
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  cudaError_t e = encode_rows(&tb, bp, (uint64_t)p.N, (uint64_t)Kp, (uint32_t)bn);
  if (e == cudaSuccess) e = encode_box5(&ta, x, B, p);
  if (e != cudaSuccess) return e;
  if (bm == 256)
    return bn == 64   ? launch_tile<A_HALO, EPI, 64, 2, AU8, 2>(ta, tb, p, st)
           : bn == 96 ? launch_tile<A_HALO, EPI, 96, 2, AU8, 2>(ta, tb, p, st)
                      : launch_tile<A_HALO, EPI, 128, 2, AU8, 2>(ta, tb, p, st);
  return bn == 64   ? launch_tile<A_HALO, EPI, 64, 2, AU8, 1>(ta, tb, p, st)
         : bn == 96 ? launch_tile<A_HALO, EPI, 96, 2, AU8, 1>(ta, tb, p, st)
                    : launch_tile<A_HALO, EPI, 128, 2, AU8, 1>(ta, tb, p, st);
}

}  // namespace
}  // namespace i8g
