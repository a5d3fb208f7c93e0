// int4 weight-only matrix products for Hopper (sm_90a), in the two nibble
// layouts of the JAX package's TPU kernels.
//
// Planar: replaces onnx_rusty_inference_engine_tpu/ops/kernels/
// qmatmul_int4.py::qmatmul_int4_planar (body _int4_mm_planar_kernel).
//
//   A      f32 [M, K] activations, rounded to bf16 (round to nearest even)
//          as the TPU kernel casts them in-kernel;
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
// The weights stay packed in device memory; each byte is unpacked in
// registers (nibble.cuh). Block t's dots are summed in f32, then scaled, as
// the TPU kernels apply the scale to each block's dot result, and added with
// __fmul_rn / __fadd_rn in the TPU kernels' order (no FMA contraction).
//
// What bounds it: at decode (M = 8) the product does 2*M*N*K operations over
// N*K/2 weight bytes, 32 operations per byte, far below the H100's ~295 bf16
// operations per byte of HBM: the bound is the weight bytes over 3.35 TB/s.
// At prefill (M = 512) it is 2,048 operations per byte and the bound is the
// tensor-core rate, which this first version does not use: it multiplies
// with f32 FMAs on the CUDA cores.
//
// Schedule (both layouts): a block of 4 warps owns 32 output columns (one
// per lane) and 8 rows. Warp w takes quant blocks t = w, w + 4, ..., so a
// decode-sized product still spreads its K over 4 warps (split-K inside the
// block); the four partial sums are added in a fixed order at the end, so
// the result does not depend on timing. Each warp stages 32 half-K bytes of
// its 32 weight rows and the matching bf16-rounded activations through
// shared memory, then every lane unpacks its own row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// nblk quant blocks of blk half-K bytes: (nbh, bs) planar, (nb, qbh)
// interleaved.
template <bool kInterleaved, bool kWordLoads>
__global__ void __launch_bounds__(THREADS)
qmatmul_int4_kernel(const float* __restrict__ a,
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
          const float* row = a + static_cast<int64_t>(m) * K;
          const int j = k0 + lane;
          lo = bf16_round(row[kInterleaved ? 2 * j : j]);
          hi = bf16_round(row[kInterleaved ? 2 * j + 1 : Kh + j]);
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

__global__ void nibble_probe_kernel(const uint8_t* __restrict__ p,
                                    float* __restrict__ lo,
                                    float* __restrict__ hi, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) unpack_nibbles(p[i], lo[i], hi[i]);
}

template <bool kInterleaved>
cudaError_t launch_int4(const void* a, const void* packed, const void* scales,
                        void* out, int M, int K, int N, int Nw, int nblk,
                        int blk, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 2 || nblk <= 0 || blk <= 0 || nblk * blk != K / 2 ||
      N > Nw)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool words = (K / 2) % 4 == 0 && blk % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(packed) % 4 == 0;
  if (words)
    qmatmul_int4_kernel<kInterleaved, true><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(a), static_cast<const uint8_t*>(packed),
        static_cast<const float*>(scales), static_cast<float*>(out), M, K, N,
        Nw, nblk, blk);
  else
    qmatmul_int4_kernel<kInterleaved, false><<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(a), static_cast<const uint8_t*>(packed),
        static_cast<const float*>(scales), static_cast<float*>(out), M, K, N,
        Nw, nblk, blk);
  return cudaGetLastError();
}

}  // namespace

// a: f32 [M, K]; packed: uint8 [Nw, K/2]; scales: f32 [2*nbh, Nw];
// out: f32 [M, N] with N <= Nw. nbh * bs must equal K/2. Launches on
// `stream` and returns the launch's error code.
extern "C" cudaError_t qmatmul_int4_planar_launch(
    const void* a, const void* packed, const void* scales, void* out, int M,
    int K, int N, int Nw, int nbh, int bs, void* stream) {
  return launch_int4<false>(a, packed, scales, out, M, K, N, Nw, nbh, bs,
                            stream);
}

// a: f32 [M, K]; packed: uint8 [Nw, K/2] (interleaved); scales: f32 [Nw, nb];
// out: f32 [M, N] with N <= Nw. nb * qbh must equal K/2. Launches on
// `stream` and returns the launch's error code.
extern "C" cudaError_t qmatmul_int4_bf16_launch(
    const void* a, const void* packed, const void* scales, void* out, int M,
    int K, int N, int Nw, int nb, int qbh, void* stream) {
  return launch_int4<true>(a, packed, scales, out, M, K, N, Nw, nb, qbh,
                           stream);
}

// p: uint8 [n]; lo, hi: f32 [n] = the two nibbles of each byte, minus 8.
extern "C" cudaError_t nibble_probe_launch(const void* p, void* lo, void* hi,
                                           long long n, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int threads = 256;
  nibble_probe_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p), static_cast<float*>(lo),
      static_cast<float*>(hi), n);
  return cudaGetLastError();
}
