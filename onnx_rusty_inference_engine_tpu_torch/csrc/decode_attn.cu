// Single-token (decode) attention over an int8 KV cache, for Hopper (sm_90a).
//
// Replaces the TPU kernels onnx_rusty_inference_engine_tpu/ops/kernels/
// decode_attn.py::decode_attention_int8 (body _decode_attn_kernel) and
// ::decode_attention_int8_mxu (body _decode_attn_i8_kernel).
//
//   q     f32 [B*H, hd]   query, pre-scaled by k_scale[h] / sqrt(hd)
//   k8,v8 int8 [B*Hkv, L, hd]  the updated cache; query head h reads kv head
//         h / (H / Hkv) in place (GQA: no copy of the cache)
//   bias  f32 [B, L]      additive validity mask (0 or -1e9)
//   out   f32 [B*H, hd]   softmax(q . k^T + bias) . v; the caller applies
//         v_scale[h]
//
// decode_attention_int8 computes in f32 throughout: the dequantized cache
// values are exact small integers, the scores and p . V are f32 sums, and
// the softmax is exp(s - max) / sum with the accurate expf. (The TPU kernel
// rounded q and p to bf16 for its MXU dots; this kernel does not.)
//
// decode_attention_int8_mxu is the TPU kernel's int8 x int8 form, step for
// step: per (batch, kv group) a dynamic q scale sq = max(amax|q|, 1e-9) / 127
// and q8 = rint(q / sq); exact int32 scores with __dp4a; s = s32 * sq + bias;
// softmax in f32; a per-call prob scale sp = max(max p, 1e-9) / 127 over the
// group's rows, p8 = rint(p / sp); exact int32 p8 . v; out = c32 * sp.
// Rounding is half to even (__float2int_rn, as jnp.round), each product and
// sum rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn: no FMA
// contraction), as the plain version computes it.
//
// What bounds them: at decode each query row reads its kv head's L*hd int8
// keys and values once and does 4*L*hd operations on them, about 2
// operations per byte. The bound is the cache bytes over 3.35 TB/s. One
// block per query head (f32 form) or per kv group (int8 form) reads its
// cache rows with 4-byte loads, keeps scores and probabilities in shared
// memory, and never writes a dequantized cache to device memory.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide max or sum of v; every thread gets the result. `scratch` holds
// THREADS / 32 floats.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by an earlier reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < THREADS / 32; ++w)
    r = kMax ? fmaxf(r, scratch[w]) : __fadd_rn(r, scratch[w]);
  return r;
}

// int8 row . f32 vector over hd, in order.
__device__ __forceinline__ float dot_i8_f32(const int8_t* __restrict__ k,
                                            const float* q, int hd, bool words) {
  float acc = 0.f;
  if (words) {
    const char4* k4 = reinterpret_cast<const char4*>(k);
    for (int d = 0; d < hd / 4; ++d) {
      const char4 c = k4[d];
      acc = fmaf(q[4 * d], static_cast<float>(c.x), acc);
      acc = fmaf(q[4 * d + 1], static_cast<float>(c.y), acc);
      acc = fmaf(q[4 * d + 2], static_cast<float>(c.z), acc);
      acc = fmaf(q[4 * d + 3], static_cast<float>(c.w), acc);
    }
  } else {
    for (int d = 0; d < hd; ++d) acc = fmaf(q[d], static_cast<float>(k[d]), acc);
  }
  return acc;
}

struct Dims {
  int B, H, Hkv, L, hd;
};

// ---------------------------------------------------------------------------
// f32 form: one block per query row b*H + h
// shared: q[hd] | p[L] | partial[THREADS] | scratch[THREADS/32]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
decode_attn_f32_kernel(const float* __restrict__ q, const int8_t* __restrict__ k8,
                       const int8_t* __restrict__ v8, const float* __restrict__ bias,
                       float* __restrict__ out, Dims s, bool words) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ps = qs + s.hd;
  float* part = ps + s.L;
  float* scratch = part + THREADS;

  const int bh = blockIdx.x;
  const int b = bh / s.H, h = bh % s.H;
  const int64_t kv = static_cast<int64_t>(b) * s.Hkv + h / (s.H / s.Hkv);
  const int8_t* kb = k8 + kv * s.L * s.hd;
  const int8_t* vb = v8 + kv * s.L * s.hd;
  const float* bb = bias + static_cast<int64_t>(b) * s.L;

  for (int d = threadIdx.x; d < s.hd; d += THREADS) qs[d] = q[static_cast<int64_t>(bh) * s.hd + d];
  __syncthreads();

  float m = -FLT_MAX;
  for (int l = threadIdx.x; l < s.L; l += THREADS) {
    const float v = __fadd_rn(dot_i8_f32(kb + static_cast<int64_t>(l) * s.hd, qs, s.hd, words), bb[l]);
    ps[l] = v;
    m = fmaxf(m, v);
  }
  m = block_reduce<true>(m, scratch);
  float sum = 0.f;
  for (int l = threadIdx.x; l < s.L; l += THREADS) {
    const float e = expf(__fsub_rn(ps[l], m));
    ps[l] = e;
    sum = __fadd_rn(sum, e);
  }
  sum = block_reduce<false>(sum, scratch);
  for (int l = threadIdx.x; l < s.L; l += THREADS) ps[l] = __fdiv_rn(ps[l], sum);
  __syncthreads();

  // p . V: thread (part, d) sums l = part, part + parts, ...
  const int parts = THREADS / s.hd;
  const int d = threadIdx.x % s.hd, pi = threadIdx.x / s.hd;
  float acc = 0.f;
  if (pi < parts)
    for (int l = pi; l < s.L; l += parts)
      acc = fmaf(ps[l], static_cast<float>(vb[static_cast<int64_t>(l) * s.hd + d]), acc);
  part[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < s.hd) {
    float r = part[threadIdx.x];
    for (int i = 1; i < parts; ++i) r = __fadd_rn(r, part[i * s.hd + threadIdx.x]);
    out[static_cast<int64_t>(bh) * s.hd + threadIdx.x] = r;
  }
}

// ---------------------------------------------------------------------------
// int8 x int8 form: one block per (b, kv group g); the group's rep = H/Hkv
// query rows share one q scale and one prob scale.
// shared: q8[rep*hd] (bytes, padded to 4) | p[rep*L] | partial[THREADS] (int)
//         | scratch[THREADS/32]
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
decode_attn_i8_kernel(const float* __restrict__ q, const int8_t* __restrict__ k8,
                      const int8_t* __restrict__ v8, const float* __restrict__ bias,
                      float* __restrict__ out, Dims s, bool words) {
  extern __shared__ float smem[];
  const int rep = s.H / s.Hkv;
  const int qn = rep * s.hd;
  int8_t* q8 = reinterpret_cast<int8_t*>(smem);
  float* ps = smem + (qn + 3) / 4;
  int* part = reinterpret_cast<int*>(ps + rep * s.L);
  float* scratch = reinterpret_cast<float*>(part + THREADS);

  const int bg = blockIdx.x;
  const int b = bg / s.Hkv;
  const int64_t row0 = static_cast<int64_t>(b) * s.H + static_cast<int64_t>(bg % s.Hkv) * rep;
  const int8_t* kb = k8 + static_cast<int64_t>(bg) * s.L * s.hd;
  const int8_t* vb = v8 + static_cast<int64_t>(bg) * s.L * s.hd;
  const float* bb = bias + static_cast<int64_t>(b) * s.L;
  const float* qg = q + row0 * s.hd;  // the group's rep rows are contiguous

  float amax = 0.f;
  for (int i = threadIdx.x; i < qn; i += THREADS) amax = fmaxf(amax, fabsf(qg[i]));
  amax = fmaxf(block_reduce<true>(amax, scratch), 1e-9f);
  const float sq = __fdiv_rn(amax, 127.f);
  for (int i = threadIdx.x; i < qn; i += THREADS) {
    const int v = __float2int_rn(__fdiv_rn(qg[i], sq));
    q8[i] = static_cast<int8_t>(min(max(v, -128), 127));
  }
  __syncthreads();

  // scores, one (r, l) per thread step
  for (int i = threadIdx.x; i < rep * s.L; i += THREADS) {
    const int r = i / s.L, l = i % s.L;
    const int8_t* kr = kb + static_cast<int64_t>(l) * s.hd;
    const int8_t* qr = q8 + r * s.hd;
    int acc = 0;
    if (words) {
      const int* k4 = reinterpret_cast<const int*>(kr);
      const int* q4 = reinterpret_cast<const int*>(qr);
      for (int w = 0; w < s.hd / 4; ++w) acc = __dp4a(q4[w], k4[w], acc);
    } else {
      for (int dd = 0; dd < s.hd; ++dd) acc += static_cast<int>(qr[dd]) * kr[dd];
    }
    ps[i] = __fadd_rn(__fmul_rn(__int2float_rn(acc), sq), bb[l]);
  }
  __syncthreads();

  // softmax per row; then the group's largest probability
  float pmax = 0.f;
  for (int r = 0; r < rep; ++r) {
    float* pr = ps + static_cast<int64_t>(r) * s.L;
    float m = -FLT_MAX;
    for (int l = threadIdx.x; l < s.L; l += THREADS) m = fmaxf(m, pr[l]);
    m = block_reduce<true>(m, scratch);
    float sum = 0.f;
    for (int l = threadIdx.x; l < s.L; l += THREADS) {
      const float e = expf(__fsub_rn(pr[l], m));
      pr[l] = e;
      sum = __fadd_rn(sum, e);
    }
    sum = block_reduce<false>(sum, scratch);
    for (int l = threadIdx.x; l < s.L; l += THREADS) {
      const float p = __fdiv_rn(pr[l], sum);
      pr[l] = p;
      pmax = fmaxf(pmax, p);
    }
  }
  pmax = fmaxf(block_reduce<true>(pmax, scratch), 1e-9f);
  const float sp = __fdiv_rn(pmax, 127.f);
  // p8 = rint(p / sp), kept as exact floats
  for (int i = threadIdx.x; i < rep * s.L; i += THREADS)
    ps[i] = static_cast<float>(__float2int_rn(__fdiv_rn(ps[i], sp)));
  __syncthreads();

  // exact int32 p8 . V per (r, d); thread (part, d) sums l = part, part + parts, ...
  const int parts = THREADS / s.hd;
  const int d = threadIdx.x % s.hd, pi = threadIdx.x / s.hd;
  for (int r = 0; r < rep; ++r) {
    const float* pr = ps + static_cast<int64_t>(r) * s.L;
    int acc = 0;
    if (pi < parts)
      for (int l = pi; l < s.L; l += parts)
        acc += static_cast<int>(pr[l]) * static_cast<int>(vb[static_cast<int64_t>(l) * s.hd + d]);
    part[threadIdx.x] = acc;
    __syncthreads();
    if (threadIdx.x < s.hd) {
      int c = part[threadIdx.x];
      for (int i = 1; i < parts; ++i) c += part[i * s.hd + threadIdx.x];
      out[(row0 + r) * s.hd + threadIdx.x] = __fmul_rn(__int2float_rn(c), sp);
    }
    __syncthreads();
  }
}

cudaError_t check_dims(const Dims& s) {
  if (s.B <= 0 || s.H <= 0 || s.Hkv <= 0 || s.L <= 0 || s.hd <= 0 ||
      s.H % s.Hkv || s.hd > THREADS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, unsigned blocks, size_t smem, const void* q,
                   const void* k8, const void* v8, const void* bias, void* out,
                   const Dims& s, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const bool words = s.hd % 4 == 0 && reinterpret_cast<uintptr_t>(k8) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(v8) % 4 == 0;
  kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(bias),
      static_cast<float*>(out), s, words);
  return cudaGetLastError();
}

}  // namespace

// q: f32 [B*H, hd]; k8, v8: int8 [B*Hkv, L, hd]; bias: f32 [B, L];
// out: f32 [B*H, hd]. Launches on `stream`, returns the launch's error code.
extern "C" cudaError_t decode_attention_int8_launch(
    const void* q, const void* k8, const void* v8, const void* bias, void* out,
    int B, int H, int Hkv, int L, int hd, void* stream) {
  const Dims s{B, H, Hkv, L, hd};
  const cudaError_t e = check_dims(s);
  if (e != cudaSuccess) return e;
  const size_t smem = sizeof(float) * (hd + L + THREADS + THREADS / 32);
  return launch(decode_attn_f32_kernel, (unsigned)(B * H), smem, q, k8, v8,
                bias, out, s, stream);
}

extern "C" cudaError_t decode_attention_int8_mxu_launch(
    const void* q, const void* k8, const void* v8, const void* bias, void* out,
    int B, int H, int Hkv, int L, int hd, void* stream) {
  const Dims s{B, H, Hkv, L, hd};
  const cudaError_t e = check_dims(s);
  if (e != cudaSuccess) return e;
  const int rep = H / Hkv;
  const size_t smem = sizeof(float) * ((rep * hd + 3) / 4 + (size_t)rep * L +
                                       THREADS + THREADS / 32);
  return launch(decode_attn_i8_kernel, (unsigned)(B * Hkv), smem, q, k8, v8,
                bias, out, s, stream);
}
