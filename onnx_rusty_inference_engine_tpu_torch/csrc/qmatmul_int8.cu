// int8 x int8 -> int32 matrix product for Hopper (sm_90a), on the int8
// tensor cores through mma.sync.
//
// Replaces the TPU kernel onnx_rusty_inference_engine_tpu/ops/kernels/
// qmatmul.py::qmatmul_int8 (body _mm_kernel), which QLinearMatMul runs for
// symmetric zero points:
//
//   a    int8 [M, K], row-major, as the caller has it: no padding copy; rows
//        past M and columns past K are masked in the kernel;
//   bp   int8 [N, Kp]: b [K, N] transposed to K-contiguous rows, zero past K,
//        Kp a multiple of BK (ops/kernels/qmatmul_int8.py::
//        pack_qmatmul_weight, made once per weight when an Engine is built);
//   out  int32 [M, N] = a @ b, exact: |sum| <= K * 128 * 128, which the
//        wrapper keeps below 2^31.
//
// What bounds it: the int32 output. Each input byte read once and each
// output written once, at BERT-base's shapes (B = 32, T = 128):
//
//   M x K x N         per forward   bytes/3.35 TB/s   ops/1,979 TOP/s
//   4096 x 768 x 768       48         0.0049 ms         0.0024 ms
//   4096 x 768 x 3072      12         0.0167 ms         0.0098 ms
//   4096 x 3072 x 768      12         0.0082 ms         0.0098 ms
//   32 x 768 x 768          1         0.0002 ms         0.00002 ms
//
// about 0.55 ms per INT8 forward, against 0.35 ms of tensor-core time: the
// bytes bound it. The kernel writes each int32 once, straight from the
// accumulator registers, 8 bytes per lane; A and B are read once per block
// tile and reused from shared memory. Fusing the requant epilogue (as kernel
// qconv_int8_requant does) would cut the output 4x; that changes the TPU
// kernel's contract and is left to a later change.
//
// Schedule: a block of 8 warps owns a 128 x 128 output tile; warp (wm, wn)
// owns 64 x 32 of it, as 4 x 4 tiles of mma.m16n8k32 (int8 in, int32
// accumulate). The K loop stages 128 x 64-byte slices of A and B through
// shared memory (rows padded to 80 bytes, so the fragment reads hit 32
// distinct banks) and prefetches the next slice into registers while the
// tensor cores work on this one. This is a first, simple version: wgmma and
// TMA-fed rings are the steps toward the bound.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // output rows per block
constexpr int BN = 128;                 // output columns per block
constexpr int BK = 64;                  // K bytes per stage; packed rows are padded to it
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int MT = BM / WARPS_M / 16;   // m16 tiles per warp (4)
constexpr int NT = BN / WARPS_N / 8;    // n8 tiles per warp (4)
constexpr int LDS = BK + 16;            // shared row stride in bytes
constexpr int CHUNKS = BM * BK / 16 / THREADS;  // 16-byte loads per thread per operand (2)

static_assert(BM == BN, "one loader shape serves both operands");
static_assert(CHUNKS * THREADS * 16 == BM * BK, "loader covers the tile");

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes of row m of A from column k: zero past M or K. VEC: K % 16 == 0
// and A 16-byte aligned, so the run is one aligned vector inside the row.
template <bool VEC>
__device__ __forceinline__ int4 load_a(const int8_t* __restrict__ a, int64_t m,
                                       int k, int M, int K) {
  int4 v = make_int4(0, 0, 0, 0);
  if (m >= M) return v;
  const int8_t* row = a + m * K;
  if (VEC) {
    if (k < K) v = *reinterpret_cast<const int4*>(row + k);
  } else {
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (k + i < K) w[i >> 2] |= (uint32_t)(uint8_t)row[k + i] << (8 * (i & 3));
    v = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
  }
  return v;
}

// One K slice of both operands into registers. Chunk c = tid + i * THREADS
// is row c / 4 of the tile, bytes 16 * (c % 4) of the slice; B's rows are
// padded to Kp, so only rows past N are masked.
template <bool VEC>
__device__ __forceinline__ void fetch(int4 (&ra)[CHUNKS], int4 (&rb)[CHUNKS],
                                      const int8_t* __restrict__ a,
                                      const int8_t* __restrict__ bp, int tid,
                                      int64_t m0, int n0, int k0, int M, int N,
                                      int K, int Kp) {
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    const int c = tid + i * THREADS;
    const int row = c >> 2;
    const int kc = (c & 3) * 16;
    ra[i] = load_a<VEC>(a, m0 + row, k0 + kc, M, K);
    const int n = n0 + row;
    rb[i] = n < N ? *reinterpret_cast<const int4*>(bp + (int64_t)n * Kp + k0 + kc)
                  : make_int4(0, 0, 0, 0);
  }
}

template <bool VEC_A, bool VEC_OUT>
__global__ void __launch_bounds__(THREADS)
qmatmul_int8_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ bp,
                    int32_t* __restrict__ out, int M, int N, int K, int Kp) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;  // mma fragment row group
  const int t = lane & 3;   // thread in group
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  int4 ra[CHUNKS], rb[CHUNKS];
  const int num_k = Kp / BK;
  fetch<VEC_A>(ra, rb, a, bp, tid, m0, n0, 0, M, N, K, Kp);
  for (int kt = 0; kt < num_k; ++kt) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int c = tid + i * THREADS;
      const int off = (c >> 2) * LDS + (c & 3) * 16;
      *reinterpret_cast<int4*>(As + off) = ra[i];
      *reinterpret_cast<int4*>(Bs + off) = rb[i];
    }
    __syncthreads();
    if (kt + 1 < num_k)  // in flight during the mma's
      fetch<VEC_A>(ra, rb, a, bp, tid, m0, n0, (kt + 1) * BK, M, N, K, Kp);

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int8_t* p = As + (wm * (BM / WARPS_M) + i * 16 + g) * LDS + kk + 4 * t;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * LDS);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int8_t* p = Bs + (wn * (BN / WARPS_N) + j * 8 + g) * LDS + kk + 4 * t;
        const uint32_t b0 = lds32(p);
        const uint32_t b1 = lds32(p + 16);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], af[i], b0, b1);
      }
    }
    __syncthreads();
  }

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t + 1); c2, c3 at row g + 8
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm * (BM / WARPS_M) + i * 16 + g + 8 * h;
      if (m >= M) continue;
      int32_t* orow = out + m * N;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = n0 + wn * (BN / WARPS_N) + j * 8 + 2 * t;
        const int v0 = acc[i][j][2 * h];
        const int v1 = acc[i][j][2 * h + 1];
        if (VEC_OUT && n + 1 < N) {
          *reinterpret_cast<int2*>(orow + n) = make_int2(v0, v1);
        } else {
          if (n < N) orow[n] = v0;
          if (n + 1 < N) orow[n + 1] = v1;
        }
      }
    }
  }
}

template <bool VEC_A, bool VEC_OUT>
void launch(dim3 grid, cudaStream_t st, const void* a, const void* bp,
            void* out, int M, int N, int K, int Kp) {
  qmatmul_int8_kernel<VEC_A, VEC_OUT><<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bp),
      static_cast<int32_t*>(out), M, N, K, Kp);
}

}  // namespace

// a: int8 [M, K]; bp: int8 [N, Kp], row n = column n of b, zero past K, Kp a
// multiple of 64, 16-byte aligned; out: int32 [M, N]. Launches on `stream`
// and returns the launch's error code.
extern "C" cudaError_t qmatmul_int8_launch(const void* a, const void* bp,
                                           void* out, int M, int N, int K,
                                           int Kp, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || Kp < K || Kp % BK != 0 ||
      reinterpret_cast<uintptr_t>(bp) % 16 != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  if (grid.y > 65535u) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec_a = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const bool vec_out = N % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (vec_a && vec_out) launch<true, true>(grid, st, a, bp, out, M, N, K, Kp);
  else if (vec_a) launch<true, false>(grid, st, a, bp, out, M, N, K, Kp);
  else if (vec_out) launch<false, true>(grid, st, a, bp, out, M, N, K, Kp);
  else launch<false, false>(grid, st, a, bp, out, M, N, K, Kp);
  return cudaGetLastError();
}
