// int4 weight-only matrix products for Hopper (sm_90a), in the two nibble
// layouts of the JAX package's TPU kernels.
//
// Planar: replaces onnx_rusty_inference_engine_tpu/ops/kernels/
// qmatmul_int4.py::qmatmul_int4_planar (body _int4_mm_planar_kernel).
//
//   A      f32 or bf16 [M, K] activations; f32 is rounded to bf16 (round to
//          nearest even) as the TPU kernel casts them in-kernel, bf16 (the
//          bf16 Engine's activations) is read as it is, the same values in
//          half the bytes;
//   packed uint8 [Nw, K/2]: byte j of row n = (q[n, j] + 8) | (q[n, j + K/2] + 8) << 4
//          (quant.pack_int4_planar; Nw >= N, rows past N are padding);
//   scales f32 [2*nbh, Nw], k-major: row t = block t of the low half,
//          row nbh + t = block t of the high half; a block is bs = (K/2)/nbh
//          consecutive k.
//   out    f32 [M, N] = sum_t dlo_t * s_lo[t] + dhi_t * s_hi[t], where
//          dlo_t = sum over block t of A[m, k] * q[n, k] (low half) and dhi_t
//          the same over the high half, each accumulated in f32.
//
// Interleaved (the ORT MatMulNBits layout): replaces qmatmul_int4.py::
// qmatmul_int4_bf16 (body _int4_mm_kernel).
//
//   packed uint8 [Nw, K/2]: byte j of row n = (q[n, 2j] + 8) | (q[n, 2j + 1] + 8) << 4
//          (quant.pack_int4);
//   scales f32 [Nw, nb], n-major: column t scales the quant block of
//          qblock = K/nb consecutive k, i.e. qbh = qblock/2 bytes;
//   out    f32 [M, N] = sum_t (deven_t + dodd_t) * s[n, t], where deven_t
//          sums A[m, 2j] * LO[n, j] over the bytes j of block t and dodd_t
//          A[m, 2j + 1] * HI[n, j], each in f32: the TPU kernel's
//          A_even @ LO^T + A_odd @ HI^T per block, then its scale. The TPU
//          wrapper's strided a[:, 0::2], a[:, 1::2] copies become a pair of
//          loads per byte here.
//
// Every schedule is a template on A's type (TA: float or __nv_bfloat16);
// only A's loads differ between the two, the arithmetic is the same.
//
// The weights stay packed in device memory; each byte is unpacked in
// registers (nibble.cuh). Every product is exact (a bf16 value times an
// integer in [-8, 7]); block t's dots are summed in f32, then scaled, as the
// TPU kernels apply the scale to each block's dot result, and added with
// __fmul_rn / __fadd_rn (no FMA contraction): planar acc + dlo * s_lo +
// dhi * s_hi, interleaved acc + d * s. Only the order of the f32 sums
// differs between the schedules below and the plain versions.
//
// Three schedules, chosen by shape before the launch (the wrapper's
// int4_schedule; the entry points refuse a schedule whose constraints fail):
//
// small_m (decode, M <= 16). At M = 8 a product does 32 operations per
// weight byte, far below the H100's ~295 bf16 operations per byte of HBM:
// the weight bytes over 3.35 TB/s bound it, and below a few MB of weights
// the launch and a memory round trip do. The schedule streams the weights
// with many loads in flight and adds as little across lanes as it can. A
// warp owns 32 / LPR packed rows (output columns); the LPR lanes of a row
// walk it along K with 16-byte loads, lane sub on chunks sub, sub + LPR, ...
// of each quant block, 8 chunks of a row in flight (all loaded before the
// FMAs); LPR is 8 for narrow N, 2 for the lm_head's N = 50,257 (fewer lane
// sums to add; by an H100's timings). KS warps share a row tile and split
// its quant blocks, so that N = 768 still gives some 8 warps per SM. A is
// staged once per block in shared memory by 16-byte cp.async, all in flight
// together (the first weight batch too), and rounded to bf16 in place (f32
// holding bf16 values: the FMAs need no conversion); the lanes of a warp
// read it nearly as broadcasts (interleaved: the pairs A[2j], A[2j + 1]
// together), their quarter order rotated by sub so that the reads fall in
// distinct banks. Blocks loop over row tiles, so A is staged once per
// block. Sums: a lane sums its chunks' products in f32; the LPR lanes of a
// row add theirs by an xor butterfly (all end with the same total); the
// block's dot is scaled into the warp's accumulator, its blocks in order;
// the KS warps' accumulators are added in order 0, 1, ... .
//
// mma (prefill, M > 16). At M = 512 the product does 2,048 operations per
// weight byte: the tensor cores bound it. mma.sync.m16n8k16 bf16 x bf16 ->
// f32 on 64 x 128 output tiles of 8 warps (warp tile 32 x 32). Weight tiles
// of 128 rows x 32 bytes arrive by 16-byte cp.async into a 3-stage ring; A
// tiles are loaded as f32 a stage ahead into registers, rounded to bf16 and
// stored to shared memory. A thread's B fragment is one 32-bit word of its
// column's packed row, unpacked in registers (nibble.cuh): the mma's k slots
// are permuted alike in A and B, so that the word's bytes are its k and no
// shuffle is needed. Interleaved: a byte's two nibbles are consecutive k,
// one bf16x2 register each. Planar: the word feeds two mma's, its low
// nibbles against A[:, j] and its high nibbles against A[:, K/2 + j]. Sums:
// each quant block's dot goes to its own f32 fragment (the tensor core's
// order within it), folded into the accumulator with the block's scale at
// the block's end, blocks in order. Ragged M, N and K edges are masked in
// the kernel (zero-filled copies, guarded stores).
//
// general (any shape: odd quant blocks, unaligned pointers, byte loads):
// a block of 4 warps owns 32 output columns (one per lane) and 8 rows. Warp
// w takes quant blocks t = w, w + 4, ... (split-K inside the block); each
// warp stages 32 half-K bytes of its 32 weight rows and the matching
// bf16-rounded activations through shared memory, then every lane unpacks
// its own row with f32 FMAs. The four warps' sums are added in order 0..3.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "nibble.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BN = 32;   // output columns per block, one per lane
constexpr int BM = 8;    // output rows per block
constexpr int CK = 32;   // half-K bytes staged per step
constexpr int PKW = CK / 4 + 1;  // words per staged weight row (+1: no bank conflicts)

struct Staging {
  uint32_t pk[BN][PKW];             // packed bytes, row = output column
  alignas(16) float alo[CK][BM];    // bf16-rounded A, low half, [k][m]
  alignas(16) float ahi[CK][BM];    // high half
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one activation as the f32 the FMAs take: f32 rounded to bf16, bf16 widened
__device__ __forceinline__ float a_value(float x) { return bf16_round(x); }
__device__ __forceinline__ float a_value(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// nblk quant blocks of blk half-K bytes: (nbh, bs) planar, (nb, qbh)
// interleaved.
template <bool kInterleaved, bool kWordLoads, typename TA>
__global__ void __launch_bounds__(THREADS)
qmatmul_int4_kernel(const TA* __restrict__ a,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int M, int K, int N, int Nw,
                    int nblk, int blk) {
  __shared__ Staging stage[WARPS];
  __shared__ float red[WARPS][BM][BN];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int Kh = K / 2;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int n = n0 + lane;
  Staging& st = stage[warp];
  uint8_t* pk_bytes = reinterpret_cast<uint8_t*>(&st.pk[0][0]);

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int t = warp; t < nblk; t += WARPS) {
    float dlo[BM], dhi[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) dlo[r] = dhi[r] = 0.f;

    for (int c0 = 0; c0 < blk; c0 += CK) {
      const int jn = min(CK, blk - c0);
      const int k0 = t * blk + c0;  // half-K index of this step's first byte

      // activations: lane j loads the pair that byte k0 + j multiplies:
      // k0 + j in both halves (planar), 2(k0 + j) and 2(k0 + j) + 1
      // (interleaved)
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const int m = m0 + r;
        float lo = 0.f, hi = 0.f;
        if (lane < jn && m < M) {
          const TA* row = a + static_cast<int64_t>(m) * K;
          const int j = k0 + lane;
          lo = a_value(row[kInterleaved ? 2 * j : j]);
          hi = a_value(row[kInterleaved ? 2 * j + 1 : Kh + j]);
        }
        st.alo[lane][r] = lo;
        st.ahi[lane][r] = hi;
      }
      // weights: 32 rows x jn bytes; bytes past jn or rows past N read as
      // 0x88, which unpacks to 0
      if (kWordLoads) {
#pragma unroll
        for (int i = 0; i < BN * (CK / 4) / 32; ++i) {
          const int idx = i * 32 + lane;
          const int row = idx / (CK / 4);
          const int w = idx % (CK / 4);
          const int nn = n0 + row;
          uint32_t v = 0x88888888u;
          if (4 * w < jn && nn < N)
            v = *reinterpret_cast<const uint32_t*>(
                packed + static_cast<int64_t>(nn) * Kh + k0 + 4 * w);
          st.pk[row][w] = v;
        }
      } else {
        for (int row = 0; row < BN; ++row) {
          const int nn = n0 + row;
          uint8_t v = 0x88;
          if (lane < jn && nn < N)
            v = packed[static_cast<int64_t>(nn) * Kh + k0 + lane];
          pk_bytes[row * PKW * 4 + lane] = v;
        }
      }
      __syncwarp();

      for (int jw = 0; jw < jn; jw += 4) {
        const uint32_t word = st.pk[lane][jw / 4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = jw + b;
          if (j < jn) {
            float wlo, whi;
            unpack_nibbles(word >> (8 * b), wlo, whi);
            const float4 l0 = *reinterpret_cast<const float4*>(&st.alo[j][0]);
            const float4 l1 = *reinterpret_cast<const float4*>(&st.alo[j][4]);
            const float4 h0 = *reinterpret_cast<const float4*>(&st.ahi[j][0]);
            const float4 h1 = *reinterpret_cast<const float4*>(&st.ahi[j][4]);
            dlo[0] = fmaf(l0.x, wlo, dlo[0]);
            dlo[1] = fmaf(l0.y, wlo, dlo[1]);
            dlo[2] = fmaf(l0.z, wlo, dlo[2]);
            dlo[3] = fmaf(l0.w, wlo, dlo[3]);
            dlo[4] = fmaf(l1.x, wlo, dlo[4]);
            dlo[5] = fmaf(l1.y, wlo, dlo[5]);
            dlo[6] = fmaf(l1.z, wlo, dlo[6]);
            dlo[7] = fmaf(l1.w, wlo, dlo[7]);
            dhi[0] = fmaf(h0.x, whi, dhi[0]);
            dhi[1] = fmaf(h0.y, whi, dhi[1]);
            dhi[2] = fmaf(h0.z, whi, dhi[2]);
            dhi[3] = fmaf(h0.w, whi, dhi[3]);
            dhi[4] = fmaf(h1.x, whi, dhi[4]);
            dhi[5] = fmaf(h1.y, whi, dhi[5]);
            dhi[6] = fmaf(h1.z, whi, dhi[6]);
            dhi[7] = fmaf(h1.w, whi, dhi[7]);
          }
        }
      }
      __syncwarp();
    }

    // each step rounded (no FMA contraction), in the TPU kernels' order:
    // planar acc + dlo * s_lo + dhi * s_hi, interleaved acc + (dlo + dhi) * s
    if (kInterleaved) {
      const float s = n < N ? scales[static_cast<int64_t>(n) * nblk + t] : 0.f;
#pragma unroll
      for (int r = 0; r < BM; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(__fadd_rn(dlo[r], dhi[r]), s));
    } else {
      float s_lo = 0.f, s_hi = 0.f;
      if (n < N) {
        s_lo = scales[static_cast<int64_t>(t) * Nw + n];
        s_hi = scales[static_cast<int64_t>(nblk + t) * Nw + n];
      }
#pragma unroll
      for (int r = 0; r < BM; ++r)
        acc[r] = __fadd_rn(__fadd_rn(acc[r], __fmul_rn(dlo[r], s_lo)),
                           __fmul_rn(dhi[r], s_hi));
    }
  }

#pragma unroll
  for (int r = 0; r < BM; ++r) red[warp][r][lane] = acc[r];
  __syncthreads();
  // warp w writes rows 2w and 2w + 1: the four warps' sums in a fixed order
#pragma unroll
  for (int rr = 0; rr < BM / WARPS; ++rr) {
    const int r = warp * (BM / WARPS) + rr;
    const int m = m0 + r;
    if (m < M && n < N) {
      float s = red[0][r][lane];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s = __fadd_rn(s, red[w][r][lane]);
      out[static_cast<int64_t>(m) * N + n] = s;
    }
  }
}

// ---------------------------------------------------------------- helpers
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t word_of(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xFFFF0000u);
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- mma
constexpr int MM_BM = 64;               // output rows per block
constexpr int MM_BN = 128;              // output columns (packed rows) per block
constexpr int MM_WARPS_M = 2;
constexpr int MM_WARPS_N = 4;
constexpr int MM_THREADS = 32 * MM_WARPS_M * MM_WARPS_N;
constexpr int MM_MT = MM_BM / MM_WARPS_M / 16;  // m16 tiles per warp (2)
constexpr int MM_NT = MM_BN / MM_WARPS_N / 8;   // n8 tiles per warp (4)
constexpr int MM_STAGE = 32;  // packed bytes per row per stage: two 16-byte steps
constexpr int MM_RING = 3;    // weight stages in flight
constexpr int MM_LDB = MM_STAGE + 16;  // weight row stride: word reads hit 32 banks
constexpr int MM_LDA = 128 + 64;       // A row stride (64 bf16 + pad): 16-byte reads conflict-free
constexpr int MM_A_VECS = MM_BM * 16 / MM_THREADS;  // 4-element A vectors per thread per stage

// 4 consecutive activations in registers, as loaded: float4 (f32 A) or
// uint2 (bf16 A, four bf16 in order)
template <typename TA> struct AVec;
template <> struct AVec<float> { using T = float4; };
template <> struct AVec<__nv_bfloat16> { using T = uint2; };

// 4 activations as the 4 bf16 an mma reads, low k in the low half
__device__ __forceinline__ uint2 bf16x4(const float4& v) {
  return make_uint2(bits_of(__floats2bfloat162_rn(v.x, v.y)),
                    bits_of(__floats2bfloat162_rn(v.z, v.w)));
}
__device__ __forceinline__ uint2 bf16x4(const uint2& v) { return v; }

static_assert(MM_BN * MM_STAGE / 16 == MM_THREADS, "one weight copy per thread");

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; ok false fills zeros and reads nothing
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A for the stage at packed byte kb0, as loaded into registers. Vector v
// of thread tid is row (tid + v * THREADS) / 16, quarter q = (...) % 16 of
// the stage's 64 k: interleaved k = 2 kb0 + 4q; planar q < 8 low half
// k = kb0 + 4q, q >= 8 high half K/2 + kb0 + 4(q - 8). Zero past M or K.
template <bool kInterleaved, typename TA>
__device__ __forceinline__ void mma_fetch_a(typename AVec<TA>::T (&ra)[MM_A_VECS],
                                            const TA* __restrict__ a, int tid,
                                            int m0, int kb0, int M, int K) {
  using V = typename AVec<TA>::T;
#pragma unroll
  for (int v = 0; v < MM_A_VECS; ++v) {
    const int idx = tid + v * MM_THREADS;
    const int m = m0 + (idx >> 4);
    const int q = idx & 15;
    int k;
    bool ok;
    if (kInterleaved) {
      k = 2 * kb0 + 4 * q;
      ok = k < K;
    } else {
      const int kh = kb0 + 4 * (q & 7);
      ok = kh < K / 2;
      k = (q < 8 ? 0 : K / 2) + kh;
    }
    ra[v] = V{};
    if (ok && m < M)
      ra[v] = *reinterpret_cast<const V*>(a + static_cast<int64_t>(m) * K + k);
  }
}

// The fetched A, bf16-rounded, into a stage row of 64 bf16 laid out per
// 16-byte step s and thread column t as the fragments read it: interleaved
// k in order (bytes 8q); planar [low k 4t..4t+3][high k 4t..4t+3] at
// bytes 64 s + 16 t.
template <bool kInterleaved, typename V>
__device__ __forceinline__ void mma_store_a(uint8_t* As, const V (&ra)[MM_A_VECS],
                                            int tid) {
#pragma unroll
  for (int v = 0; v < MM_A_VECS; ++v) {
    const int idx = tid + v * MM_THREADS;
    const int q = idx & 15;
    const int off = kInterleaved
        ? 8 * q
        : 64 * ((q & 7) >> 2) + 16 * (q & 3) + (q < 8 ? 0 : 8);
    *reinterpret_cast<uint2*>(As + (idx >> 4) * MM_LDA + off) = bf16x4(ra[v]);
  }
}

// The weight stage at packed byte kb0: row tid / 2 of the tile, 16 bytes
// (tid & 1); rows past N and bytes past K/2 are zero-filled.
__device__ __forceinline__ void mma_fill_b(uint8_t* Bs,
                                           const uint8_t* __restrict__ packed,
                                           int tid, int n0, int kb0, int N,
                                           int Kh) {
  const int row = tid >> 1;
  const int kb = kb0 + 16 * (tid & 1);
  const bool ok = n0 + row < N && kb < Kh;
  cp_async16(Bs + row * MM_LDB + 16 * (tid & 1),
             ok ? packed + static_cast<int64_t>(n0 + row) * Kh + kb : packed, ok);
}

template <bool kInterleaved, typename TA>
__global__ void __launch_bounds__(MM_THREADS)
int4_mma_kernel(const TA* __restrict__ a, const uint8_t* __restrict__ packed,
                const float* __restrict__ scales, float* __restrict__ out,
                int M, int K, int N, int Nw, int nblk, int blk) {
  __shared__ __align__(16) uint8_t As[2][MM_BM * MM_LDA];
  __shared__ __align__(16) uint8_t Bs[MM_RING][MM_BN * MM_LDB];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / MM_WARPS_N;
  const int wn = warp % MM_WARPS_N;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int m0 = blockIdx.y * MM_BM;
  const int n0 = blockIdx.x * MM_BN;
  const int Kh = K / 2;
  const int nsteps = Kh / 16;
  const int nstages = (nsteps + 1) / 2;
  const int spb = blk / 16;  // steps per quant block

  float acc[MM_MT][MM_NT][4], dlo[MM_MT][MM_NT][4], dhi[MM_MT][MM_NT][4];
#pragma unroll
  for (int i = 0; i < MM_MT; ++i)
#pragma unroll
    for (int j = 0; j < MM_NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = dlo[i][j][e] = dhi[i][j][e] = 0.f;
  float s0[MM_NT][2], s1[MM_NT][2];  // this quant block's scales, cols 2t, 2t + 1

#pragma unroll
  for (int s = 0; s < MM_RING - 1; ++s) {
    if (s < nstages) mma_fill_b(Bs[s], packed, tid, n0, s * MM_STAGE, N, Kh);
    cp_async_commit();
  }
  typename AVec<TA>::T ra[MM_A_VECS];
  mma_fetch_a<kInterleaved>(ra, a, tid, m0, 0, M, K);

  for (int st = 0; st < nstages; ++st) {
    uint8_t* Ab = As[st & 1];
    mma_store_a<kInterleaved>(Ab, ra, tid);
    const int ahead = st + MM_RING - 1;
    if (ahead < nstages)
      mma_fill_b(Bs[ahead % MM_RING], packed, tid, n0, ahead * MM_STAGE, N, Kh);
    cp_async_commit();
    if (st + 1 < nstages)  // in flight during the mma's
      mma_fetch_a<kInterleaved>(ra, a, tid, m0, (st + 1) * MM_STAGE, M, K);
    cp_async_wait<MM_RING - 1>();
    __syncthreads();

    const uint8_t* Bb = Bs[st % MM_RING];
#pragma unroll
    for (int ls = 0; ls < 2; ++ls) {
      const int step = 2 * st + ls;
      if (step >= nsteps) break;
      if (step % spb == 0) {  // a quant block starts: its scales, read early
        const int tb = step / spb;
#pragma unroll
        for (int j = 0; j < MM_NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int n = n0 + wn * 32 + j * 8 + 2 * t + h;
            s0[j][h] = s1[j][h] = 0.f;
            if (n < N) {
              if (kInterleaved) {
                s0[j][h] = scales[static_cast<int64_t>(n) * nblk + tb];
              } else {
                s0[j][h] = scales[static_cast<int64_t>(tb) * Nw + n];
                s1[j][h] = scales[static_cast<int64_t>(nblk + tb) * Nw + n];
              }
            }
          }
      }
      uint4 xa[MM_MT], ya[MM_MT];  // A rows g and g + 8 of each m16 tile
#pragma unroll
      for (int i = 0; i < MM_MT; ++i) {
        const uint8_t* p = Ab + (wm * 32 + i * 16 + g) * MM_LDA + 64 * ls + 16 * t;
        xa[i] = *reinterpret_cast<const uint4*>(p);
        ya[i] = *reinterpret_cast<const uint4*>(p + 8 * MM_LDA);
      }
#pragma unroll
      for (int j = 0; j < MM_NT; ++j) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(
            Bb + (wn * 32 + j * 8 + g) * MM_LDB + 16 * ls + 4 * t);
        if (kInterleaved) {
          // mma k slots (2t, 2t + 1) and (2t + 8, 2t + 9) carry k 8t + 0..3,
          // then 8t + 4..7: the word's bytes 0, 1 and 2, 3
          uint32_t p[4];
          nibble_pairs_bf16(word, p);
#pragma unroll
          for (int i = 0; i < MM_MT; ++i) {
            mma_bf16(dlo[i][j], xa[i].x, ya[i].x, xa[i].y, ya[i].y, p[0], p[1]);
            mma_bf16(dlo[i][j], xa[i].z, ya[i].z, xa[i].w, ya[i].w, p[2], p[3]);
          }
        } else {
          // slots (2t, 2t + 1), (2t + 8, 2t + 9) carry k 4t + 0..3 of each
          // half: the low nibbles against A's low half, the high nibbles
          // against its high half
          uint32_t lo[2], hi[2];
          nibble_planes_bf16(word, lo, hi);
#pragma unroll
          for (int i = 0; i < MM_MT; ++i) {
            mma_bf16(dlo[i][j], xa[i].x, ya[i].x, xa[i].y, ya[i].y, lo[0], lo[1]);
            mma_bf16(dhi[i][j], xa[i].z, ya[i].z, xa[i].w, ya[i].w, hi[0], hi[1]);
          }
        }
      }
      if ((step + 1) % spb == 0) {  // the quant block ends: fold it in
#pragma unroll
        for (int i = 0; i < MM_MT; ++i)
#pragma unroll
          for (int j = 0; j < MM_NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {  // c0, c1 row g; c2, c3 row g + 8
              const int h = e & 1;
              acc[i][j][e] = kInterleaved
                  ? __fadd_rn(acc[i][j][e], __fmul_rn(dlo[i][j][e], s0[j][h]))
                  : __fadd_rn(__fadd_rn(acc[i][j][e],
                                        __fmul_rn(dlo[i][j][e], s0[j][h])),
                              __fmul_rn(dhi[i][j][e], s1[j][h]));
              dlo[i][j][e] = dhi[i][j][e] = 0.f;
            }
      }
    }
    __syncthreads();
  }

  const bool vec_out = N % 2 == 0;
#pragma unroll
  for (int i = 0; i < MM_MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      float* orow = out + static_cast<int64_t>(m) * N;
#pragma unroll
      for (int j = 0; j < MM_NT; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (vec_out && n + 1 < N) {
          *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          if (n < N) orow[n] = v0;
          if (n + 1 < N) orow[n + 1] = v1;
        }
      }
    }
}

// ---------------------------------------------------------------- small_m
constexpr int SM_WARPS = 8;    // at most, per block
constexpr int SM_MAX_M = 16;  // rows of A the schedule takes
constexpr int SM_BATCH = 8;   // 16-byte chunks a row has in flight at once

// Shared memory: A [MB][K] f32 (bf16-rounded), then the warps' partial
// sums [SM_WARPS][MB][32].
constexpr size_t small_m_smem(int MB, int K) {
  return (static_cast<size_t>(MB) * K + SM_WARPS * MB * 32) * sizeof(float);
}

// MB: rows of A staged (M <= MB). LPR lanes per packed row: a warp owns
// 32 / LPR rows (output columns) and lane sub = lane % LPR of a row takes
// its chunks sub, sub + LPR, ... of each quant block. KS warps share a row
// tile and split its quant blocks (warp kw takes t = kw, kw + KS, ...); a
// block of blockDim.x / 32 warps works on that many / KS row tiles at once.
template <bool kInterleaved, int MB, int LPR, typename TA>
__global__ void __launch_bounds__(32 * SM_WARPS)
int4_small_m_kernel(const TA* __restrict__ a,
                    const uint8_t* __restrict__ packed,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int M, int K, int N, int Nw,
                    int nblk, int blk, int KS) {
  constexpr int RPW = 32 / LPR;  // rows per warp
  constexpr int CB = SM_BATCH / LPR;  // chunks in flight per lane
  extern __shared__ __align__(16) float smf[];
  float* as = smf;               // [MB][K]
  float* red = smf + MB * K;     // [SM_WARPS][MB][32]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sub = lane % LPR;
  const int rloc = lane / LPR;
  const int kw = warp % KS;      // this warp's share of the quant blocks
  const int tw = warp / KS;      // its row tile within the block's
  const int threads = blockDim.x;
  const int tpb = threads / 32 / KS;  // row tiles a block works on at once
  const int Kh = K / 2;
  const int cpb = blk / 16;      // 16-byte chunks per quant block
  const int ntiles = (N + RPW - 1) / RPW;

  // f32 A: every 16-byte copy in flight at once, then each thread rounds
  // its own copies to bf16 (round to nearest even) in place; rows past M
  // zero. bf16 A: loaded 8 at a time after the first weight batch is in
  // flight, and widened on its way into shared memory.
  constexpr bool kF32 = std::is_same<TA, float>::value;
  const int K4 = K / 4;
  if constexpr (kF32) {
    for (int idx = tid; idx < MB * K4; idx += threads) {
      const int m = idx / K4;
      cp_async16(as + 4 * idx,
                 m < M ? a + static_cast<int64_t>(m) * K + 4 * (idx - m * K4) : a,
                 m < M);
    }
    cp_async_commit();
  }

  // the first row tile's first batch of weights, in flight while A lands
  uint4 x[CB];
  auto load_batch = [&](const uint8_t* prow, bool row_ok, int t, int c0) {
#pragma unroll
    for (int u = 0; u < CB; ++u) {
      const int c = c0 + u * LPR + sub;
      x[u] = make_uint4(0x88888888u, 0x88888888u, 0x88888888u, 0x88888888u);
      if (row_ok && c < cpb)
        x[u] = *reinterpret_cast<const uint4*>(prow + t * blk + 16 * c);
    }
  };
  const int n_first = (blockIdx.x * tpb + tw) * RPW + rloc;
  bool have = kw < nblk;
  if (have)
    load_batch(packed + static_cast<int64_t>(n_first < N ? n_first : 0) * Kh,
               n_first < N, kw, 0);

  if constexpr (kF32) {
    cp_async_wait<0>();
    for (int idx = tid; idx < MB * K4; idx += threads) {
      float4 v = *reinterpret_cast<float4*>(as + 4 * idx);
      v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z),
                      bf16_round(v.w));
      *reinterpret_cast<float4*>(as + 4 * idx) = v;
    }
  } else {
    const int K8 = K / 8;
    for (int idx = tid; idx < MB * K8; idx += threads) {
      const int m = idx / K8;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (m < M)
        w = *reinterpret_cast<const uint4*>(a + static_cast<int64_t>(m) * K +
                                            8 * (idx - m * K8));
      float* dst = as + 8 * idx;
      *reinterpret_cast<float4*>(dst) =
          make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
    }
  }
  __syncthreads();

  for (int tb = blockIdx.x * tpb; tb < ntiles; tb += gridDim.x * tpb) {
    const int n = (tb + tw) * RPW + rloc;
    const bool row_ok = n < N;
    const uint8_t* prow = packed + static_cast<int64_t>(row_ok ? n : 0) * Kh;
    float acc[MB];
#pragma unroll
    for (int m = 0; m < MB; ++m) acc[m] = 0.f;

    for (int t = kw; t < nblk; t += KS) {
      float s_lo = 0.f, s_hi = 0.f;  // read early, used at the block's end
      if (row_ok) {
        if (kInterleaved) {
          s_lo = scales[static_cast<int64_t>(n) * nblk + t];
        } else {
          s_lo = scales[static_cast<int64_t>(t) * Nw + n];
          s_hi = scales[static_cast<int64_t>(nblk + t) * Nw + n];
        }
      }
      float dlo[MB], dhi[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m) dlo[m] = dhi[m] = 0.f;

      for (int c0 = 0; c0 < cpb; c0 += SM_BATCH) {
        // every load of the batch before the FMAs
        if (!have) load_batch(prow, row_ok, t, c0);
        have = false;
#pragma unroll
        for (int u = 0; u < CB; ++u) {
          const int c = c0 + u * LPR + sub;
          if (c >= cpb) break;  // past the quant block's last chunk
          const int j0 = t * blk + 16 * c;  // the chunk's first byte
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            // the lanes of a row start on different quarters: their A
            // reads (16 bytes apart per sub) fall in distinct banks
            const int qq = (q + sub) & 3;
            const uint32_t word = word_of(x[u], qq);
            if (kInterleaved) {
              // bytes j0 + 4qq .. + 3 hold k = 2 (j0 + 4qq) .. + 7 in order
              float wf[8];
#pragma unroll
              for (int b = 0; b < 4; ++b)
                unpack_nibbles_f32(word >> (8 * b), wf[2 * b], wf[2 * b + 1]);
#pragma unroll
              for (int m = 0; m < MB; ++m) {
                const float* ap = as + m * K + 2 * (j0 + 4 * qq);
                const float4 v0 = *reinterpret_cast<const float4*>(ap);
                const float4 v1 = *reinterpret_cast<const float4*>(ap + 4);
                float d = dlo[m];
                d = fmaf(v0.x, wf[0], d); d = fmaf(v0.y, wf[1], d);
                d = fmaf(v0.z, wf[2], d); d = fmaf(v0.w, wf[3], d);
                d = fmaf(v1.x, wf[4], d); d = fmaf(v1.y, wf[5], d);
                d = fmaf(v1.z, wf[6], d); d = fmaf(v1.w, wf[7], d);
                dlo[m] = d;
              }
            } else {
              // bytes j0 + 4qq .. + 3: low nibbles k = j0 + 4qq .. + 3,
              // high nibbles K/2 + the same
              float wl[4], wh[4];
#pragma unroll
              for (int b = 0; b < 4; ++b)
                unpack_nibbles_f32(word >> (8 * b), wl[b], wh[b]);
#pragma unroll
              for (int m = 0; m < MB; ++m) {
                const float* ap = as + m * K + j0 + 4 * qq;
                const float4 l = *reinterpret_cast<const float4*>(ap);
                const float4 h = *reinterpret_cast<const float4*>(ap + Kh);
                float dl = dlo[m], dh = dhi[m];
                dl = fmaf(l.x, wl[0], dl); dl = fmaf(l.y, wl[1], dl);
                dl = fmaf(l.z, wl[2], dl); dl = fmaf(l.w, wl[3], dl);
                dh = fmaf(h.x, wh[0], dh); dh = fmaf(h.y, wh[1], dh);
                dh = fmaf(h.z, wh[2], dh); dh = fmaf(h.w, wh[3], dh);
                dlo[m] = dl;
                dhi[m] = dh;
              }
            }
          }
        }
      }
      // the block's dot: the LPR lanes of a row add theirs (xor butterfly:
      // every one ends with the same total), then its scale
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          dlo[m] += __shfl_xor_sync(FULL, dlo[m], off);
          if (!kInterleaved) dhi[m] += __shfl_xor_sync(FULL, dhi[m], off);
        }
#pragma unroll
      for (int m = 0; m < MB; ++m)
        acc[m] = kInterleaved
            ? __fadd_rn(acc[m], __fmul_rn(dlo[m], s_lo))
            : __fadd_rn(__fadd_rn(acc[m], __fmul_rn(dlo[m], s_lo)),
                        __fmul_rn(dhi[m], s_hi));
    }

    // the KS warps of a row tile: their sums added in order kw = 0, 1, ...
    if (KS == 1) {
      if (sub == 0 && row_ok)
#pragma unroll
        for (int m = 0; m < MB; ++m)
          if (m < M) out[static_cast<int64_t>(m) * N + n] = acc[m];
    } else {
      if (sub == 0)
#pragma unroll
        for (int m = 0; m < MB; ++m) red[(warp * MB + m) * 32 + rloc] = acc[m];
      __syncthreads();
      if (kw == 0 && sub == 0 && row_ok)
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          float s = red[(warp * MB + m) * 32 + rloc];
          for (int k = 1; k < KS; ++k)
            s = __fadd_rn(s, red[((warp + k) * MB + m) * 32 + rloc]);
          if (m < M) out[static_cast<int64_t>(m) * N + n] = s;
        }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- probe
// Each thread unpacks 4 bytes (a word, 0x88 past n) with variant kVariant:
// 0 unpack_nibbles, 1 unpack_nibbles_f32, 2 nibble_pairs_bf16,
// 3 nibble_planes_bf16.
template <int kVariant>
__global__ void nibble_probe_kernel(const uint8_t* __restrict__ p,
                                    float* __restrict__ lo,
                                    float* __restrict__ hi, int64_t n) {
  const int64_t i0 =
      4 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i0 >= n) return;
  uint32_t w = 0x88888888u;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (i0 + b < n)
      w = (w & ~(0xFFu << (8 * b))) | (static_cast<uint32_t>(p[i0 + b]) << (8 * b));
  float l[4], h[4];
  if (kVariant == 0 || kVariant == 1) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      if (kVariant == 0) unpack_nibbles(w >> (8 * b), l[b], h[b]);
      else unpack_nibbles_f32(w >> (8 * b), l[b], h[b]);
    }
  } else if (kVariant == 2) {
    uint32_t q[4];
    nibble_pairs_bf16(w, q);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      l[b] = bf16_lo(q[b]);
      h[b] = bf16_hi(q[b]);
    }
  } else {
    uint32_t lo2[2], hi2[2];
    nibble_planes_bf16(w, lo2, hi2);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      l[b] = (b & 1) ? bf16_hi(lo2[b >> 1]) : bf16_lo(lo2[b >> 1]);
      h[b] = (b & 1) ? bf16_hi(hi2[b >> 1]) : bf16_lo(hi2[b >> 1]);
    }
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (i0 + b < n) {
      lo[i0 + b] = l[b];
      hi[i0 + b] = h[b];
    }
}

// Schedule ids, as ops/kernels/qmatmul_int4.py::SCHEDULES numbers them.
enum Schedule : int { kGeneral = 0, kSmallM = 1, kMma = 2 };

template <bool kInterleaved, typename TA>
cudaError_t launch_general(const TA* a, const uint8_t* packed,
                           const float* scales, float* out, int M, int K, int N,
                           int Nw, int nblk, int blk, cudaStream_t st) {
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  const bool words = (K / 2) % 4 == 0 && blk % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(packed) % 4 == 0;
  if (words)
    qmatmul_int4_kernel<kInterleaved, true, TA><<<grid, THREADS, 0, st>>>(
        a, packed, scales, out, M, K, N, Nw, nblk, blk);
  else
    qmatmul_int4_kernel<kInterleaved, false, TA><<<grid, THREADS, 0, st>>>(
        a, packed, scales, out, M, K, N, Nw, nblk, blk);
  return cudaGetLastError();
}

// Blocks loop over row tiles, at most as many as fit on the card at once,
// so that A is staged once per block.
template <bool kInterleaved, int MB, int LPR, typename TA>
cudaError_t launch_small_m(const TA* a, const uint8_t* packed,
                           const float* scales, float* out, int M, int K, int N,
                           int Nw, int nblk, int blk, cudaStream_t st) {
  auto kern = int4_small_m_kernel<kInterleaved, MB, LPR, TA>;
  const size_t smem = small_m_smem(MB, K);
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // KS warps per row tile where the tiles alone give fewer than some 8
  // warps per SM, at most one per quant block, then evened out so that
  // every warp of a tile takes the same number of blocks
  const int ntiles = (N + 32 / LPR - 1) / (32 / LPR);
  int KS = std::min({nblk, SM_WARPS, (8 * sms + ntiles - 1) / ntiles});
  KS = (nblk + (nblk + KS - 1) / KS - 1) / ((nblk + KS - 1) / KS);
  const int tpb = std::max(1, SM_WARPS / KS);
  const int threads = 32 * KS * tpb;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  const int blocks = std::min((ntiles + tpb - 1) / tpb, std::max(1, per_sm) * sms);
  kern<<<blocks, threads, smem, st>>>(a, packed, scales, out, M, K, N, Nw,
                                      nblk, blk, KS);
  return cudaGetLastError();
}

// LPR lanes per packed row, by shape: more lanes a row for narrow N (more
// warps), fewer for wide N (fewer lane sums to add). The rule is what an
// H100 measured fastest at GPT-2 124M's decode shapes among 1, 2, 4 and 8
// (PERF.md).
template <bool kInterleaved, int MB, typename TA>
cudaError_t launch_small_m_rows(const TA* a, const uint8_t* packed,
                                const float* scales, float* out, int M, int K,
                                int N, int Nw, int nblk, int blk,
                                cudaStream_t st) {
  if (N >= 16384 || (N >= 2048 && !kInterleaved))
    return launch_small_m<kInterleaved, MB, 2, TA>(a, packed, scales, out, M, K,
                                               N, Nw, nblk, blk, st);
  if (N >= 2048 || K > 1024)
    return launch_small_m<kInterleaved, MB, 4, TA>(a, packed, scales, out, M, K,
                                               N, Nw, nblk, blk, st);
  return launch_small_m<kInterleaved, MB, 8, TA>(a, packed, scales, out, M, K, N,
                                             Nw, nblk, blk, st);
}

template <bool kInterleaved, typename TA>
cudaError_t launch_int4(const void* av, const void* pv, const void* sv,
                        void* ov, int M, int K, int N, int Nw, int nblk,
                        int blk, int schedule, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 2 || nblk <= 0 || blk <= 0 || nblk * blk != K / 2 ||
      N > Nw)
    return cudaErrorInvalidValue;
  const TA* a = static_cast<const TA*>(av);
  const uint8_t* packed = static_cast<const uint8_t*>(pv);
  const float* scales = static_cast<const float*>(sv);
  float* out = static_cast<float*>(ov);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // small_m and mma read A as float4 and the weights as 16-byte vectors
  const bool aligned = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  switch (schedule) {
    case kGeneral:
      return launch_general<kInterleaved, TA>(a, packed, scales, out, M, K, N, Nw,
                                          nblk, blk, st);
    case kSmallM: {
      if (M > SM_MAX_M || blk % 16 || !aligned) return cudaErrorInvalidValue;
      if (M <= 8)
        return launch_small_m_rows<kInterleaved, 8, TA>(a, packed, scales, out, M,
                                                    K, N, Nw, nblk, blk, st);
      return launch_small_m_rows<kInterleaved, 16, TA>(a, packed, scales, out, M, K,
                                                   N, Nw, nblk, blk, st);
    }
    case kMma: {
      if (blk % 16 || !aligned) return cudaErrorInvalidValue;
      const dim3 grid((unsigned)((N + MM_BN - 1) / MM_BN),
                      (unsigned)((M + MM_BM - 1) / MM_BM));
      if (grid.y > 65535u) return cudaErrorInvalidValue;
      int4_mma_kernel<kInterleaved, TA><<<grid, MM_THREADS, 0, st>>>(
          a, packed, scales, out, M, K, N, Nw, nblk, blk);
      return cudaGetLastError();
    }
    default:
      return cudaErrorInvalidValue;
  }
}

// A's type by the id the entry points take: 0 f32, 1 bf16
template <bool kInterleaved>
cudaError_t launch_int4_a(const void* a, const void* packed, const void* scales,
                          void* out, int M, int K, int N, int Nw, int nblk,
                          int blk, int schedule, int a_dtype, void* stream) {
  if (a_dtype == 0)
    return launch_int4<kInterleaved, float>(a, packed, scales, out, M, K, N,
                                            Nw, nblk, blk, schedule, stream);
  if (a_dtype == 1)
    return launch_int4<kInterleaved, __nv_bfloat16>(
        a, packed, scales, out, M, K, N, Nw, nblk, blk, schedule, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// a: [M, K], f32 (a_dtype 0) or bf16 (a_dtype 1); packed: uint8 [Nw, K/2];
// scales: f32 [2*nbh, Nw]; out: f32 [M, N] with N <= Nw. nbh * bs must
// equal K/2. schedule: 0
// general, 1 small_m (M <= 16, bs a power-of-2 multiple of 16, a and packed
// 16-byte aligned, 2 * K * (8 or 16) bytes of shared memory), 2 mma (bs a
// multiple of 16, a and packed 16-byte aligned); cudaErrorInvalidValue
// where the schedule's constraints fail. Launches on `stream` and returns
// the launch's error code.
extern "C" cudaError_t qmatmul_int4_planar_launch(
    const void* a, const void* packed, const void* scales, void* out, int M,
    int K, int N, int Nw, int nbh, int bs, int schedule, int a_dtype,
    void* stream) {
  return launch_int4_a<false>(a, packed, scales, out, M, K, N, Nw, nbh, bs,
                              schedule, a_dtype, stream);
}

// a: [M, K], f32 or bf16 as a_dtype says; packed: uint8 [Nw, K/2]
// (interleaved); scales: f32 [Nw, nb];
// out: f32 [M, N] with N <= Nw. nb * qbh must equal K/2. schedule as for
// the planar entry point, with qbh in the place of bs. Launches on `stream`
// and returns the launch's error code.
extern "C" cudaError_t qmatmul_int4_bf16_launch(
    const void* a, const void* packed, const void* scales, void* out, int M,
    int K, int N, int Nw, int nb, int qbh, int schedule, int a_dtype,
    void* stream) {
  return launch_int4_a<true>(a, packed, scales, out, M, K, N, Nw, nb, qbh,
                             schedule, a_dtype, stream);
}

// p: uint8 [n]; lo, hi: f32 [n] = the two nibbles of each byte, minus 8, by
// unpack variant `variant` (0 int, 1 f32, 2 bf16 pairs, 3 bf16 planes).
extern "C" cudaError_t nibble_probe_launch(const void* p, void* lo, void* hi,
                                           long long n, int variant,
                                           void* stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + 4 * threads - 1) / (4 * threads));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* pp = static_cast<const uint8_t*>(p);
  float* l = static_cast<float*>(lo);
  float* h = static_cast<float*>(hi);
  switch (variant) {
    case 0: nibble_probe_kernel<0><<<blocks, threads, 0, st>>>(pp, l, h, n); break;
    case 1: nibble_probe_kernel<1><<<blocks, threads, 0, st>>>(pp, l, h, n); break;
    case 2: nibble_probe_kernel<2><<<blocks, threads, 0, st>>>(pp, l, h, n); break;
    case 3: nibble_probe_kernel<3><<<blocks, threads, 0, st>>>(pp, l, h, n); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
