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
// the softmax is exp(s - max) / sum with the accurate expf against the
// row's true max. (The TPU kernel rounded q and p to bf16 for its MXU dots;
// this kernel does not.)
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
// What bounds them: each (batch, kv group) reads its live cache rows of K
// and V once, hd bytes each, and does about 4 * rep * hd operations a row:
// at rep = 1 about 2 operations per byte, so the bound is the live cache
// bytes over 3.35 TB/s. Tensor cores do not help: at rep = 1 each head is
// a GEMV, and wgmma's 64-row tiles would be 63/64 empty.
//
// What the design does about it. At decode sizes the bytes are few (GPT-2
// 124M at batch 8: 65 live rows of 64 bytes per head at pos 64), so the
// kernel's time is its chain of dependent steps as much as its bytes:
// - One cluster of C CTAs per (batch, kv group) (C = 1, 2, 4 or 8, chosen by
//   the wrapper's attn_split) splits L into C contiguous chunks, so that
//   B * Hkv * C CTAs of 128 threads, two or more resident on an SM, cover
//   the card's 132 SMs in one wave. The maxima, sums, the int8 form's
//   largest probability and the p . V partials cross the CTAs through
//   distributed shared memory: each warp stores its part into a slot per
//   (rank, warp) in every CTA (the p . V partials in rank 0 only), one
//   cluster.sync ends the exchange, and every thread combines the slots in
//   the same order, so every CTA holds the same max, sum and scale. One
//   launch, no global scratch, no atomics, capturable in a CUDA graph; no
//   CTA reads another's shared memory, and there is no barrier but these.
// - Rows that provably add exactly 0 are never loaded. With M the largest
//   bias of the batch row and Bq a bound of |score - bias| for the group
//   (128 * max_r |q_r|_1 for the f32 form, 128 * max_r |q8_r|_1 * sq for the
//   int8 form), row l is skipped when
//       bias[l] + Bq < M - Bq - 128 - 2^-22 (|bias[l]| + |M| + 2 Bq):
//   its scores then sit more than 128 below the row's max, where expf is
//   0.0f, so the plain version's term is 0 (and p8 = 0). The wrapper's
//   attn_live_chunks computes the same predicate in the same order. Each
//   warp finds M, sq and Bq itself from q and the bias row (no barrier), and
//   then issues its K and V loads together.
// - K and V rows are read 16 bytes a lane, neighbouring lanes on
//   neighbouring addresses (hd / 16 lanes a row, rounded up to a power of
//   two); a row's dot is a shuffle-sum over its lanes; each thread has NK
//   K and NK V loads in flight before it uses the first. Lane 0 of a row's
//   lanes owns its score and e (and the int8 form's p) in shared memory,
//   and every lane divides by the sum (or by sp) itself in p . V, so they
//   need no barrier. q stays in registers (RB query rows of the group at a time);
//   the group's rep query rows share every K and V load. Bytes become
//   floats by two full-rate instructions (prmt into 2^23's mantissa, then
//   a subtraction), not the quarter-rate conversion.
// - hd not a multiple of 16, or a cache pointer not 16-byte aligned, takes
//   byte loads in the same kernel (kVec = false).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int NK = 4;       // 16-byte K (and V) loads a thread has in flight
constexpr int MAX_CLUSTER = 8;
constexpr size_t SMEM_LIMIT = 227 * 1024;

struct Dims {
  int B, H, Hkv, L, hd, C;
};

// Shared memory of one CTA, in 4-byte words from the start. The *_s arrays
// take one slot per (source rank, warp): every warp of the cluster stores
// its part there in every CTA (po: in rank 0 only) before the barrier that
// ends the exchange, so no CTA reads another's shared memory, and every
// thread then combines the slots in the same order.
struct Layout {
  int rep, lpr, hdp, n_cap;
  int ps;    // f32 [rep][n_cap] scores, then e (then p, int8 form)
  int po;    // [C * WARPS][rep][hdp] the warps' p . V partials (f32 or int)
  int gm_s;  // [C * WARPS][rep] the warps' row maxima
  int gs_s;  // [C * WARPS][rep] the warps' row sums
  int pm_s;  // [C * WARPS] the warps' largest probability (int8 form)
  int words;
};

Layout make_layout(const Dims& s) {
  Layout y;
  y.rep = s.H / s.Hkv;
  const int slots = (s.hd + 15) / 16;
  y.lpr = 1;
  while (y.lpr < slots) y.lpr <<= 1;
  y.hdp = 16 * y.lpr;
  y.n_cap = (s.L + s.C - 1) / s.C;
  const int parts = s.C * WARPS;
  y.ps = 0;
  y.po = y.ps + y.rep * y.n_cap;
  y.gm_s = y.po + parts * y.rep * y.hdp;
  y.gs_s = y.gm_s + parts * y.rep;
  y.pm_s = y.gs_s + parts * y.rep;
  y.words = y.pm_s + parts;
  return y;
}

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

// Byte t of w: sign-extended (the int8 value), or as the exact float of
// that value (2^23 + (b + 128) built in the bits, less 2^23 + 128: two
// full-rate instructions instead of a quarter-rate conversion).
__device__ __forceinline__ int sbyte(uint32_t w, int t) {
  uint32_t r;
  const uint32_t sel = t | ((t | 8) << 4) | ((t | 8) << 8) | ((t | 8) << 12);
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(w), "r"(0u), "r"(sel));
  return static_cast<int>(r);
}

__device__ __forceinline__ void bytes_to_float(const uint4& v, float (&f)[16]) {
  const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                         v.w ^ 0x80808080u};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    f[c] = __fsub_rn(__int_as_float(static_cast<int>(__byte_perm(w[c >> 2], 0x4B000000u,
                                                                 0x7540u | (c & 3)))),
                     8388736.f);
}

// Bytes col0 .. col0 + 15 of a cache row, zero past hd.
template <bool kVec>
__device__ __forceinline__ uint4 load16(const int8_t* __restrict__ row, int col0, int hd) {
  if (kVec) {
    if (col0 < hd) return __ldg(reinterpret_cast<const uint4*>(row + col0));
    return make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 16; ++c)
    if (col0 + c < hd)
      w[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(row + col0 + c)))
                   << (8 * (c & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Row l may add a non-zero term (see the note at the top). The wrapper's
// attn_live_chunks evaluates the same expression in the same order.
__device__ __forceinline__ bool row_live(float b, float M, float Bq) {
  const float lhs = __fadd_rn(b, Bq);
  const float eps = __fmul_rn(2.384185791015625e-07f,  // 2^-22
                              __fadd_rn(__fadd_rn(fabsf(b), fabsf(M)), __fmul_rn(2.f, Bq)));
  const float rhs = __fsub_rn(__fsub_rn(__fsub_rn(M, Bq), 128.f), eps);
  return !(lhs < rhs);
}

// The biases of rows i0, i0 + step, ... (NK of them, -inf past n) of a
// chunk, all loads issued first, and which of the rows are live.
__device__ __forceinline__ void live_rows(bool (&live)[NK], float (&bv)[NK],
                                          const float* __restrict__ bc, int i0, int step, int n,
                                          float M, float Bq) {
#pragma unroll
  for (int u = 0; u < NK; ++u) bv[u] = i0 + u * step < n ? __ldg(bc + i0 + u * step) : -INFINITY;
#pragma unroll
  for (int u = 0; u < NK; ++u) live[u] = i0 + u * step < n && row_live(bv[u], M, Bq);
}

// The live ones of those rows, 16 bytes a lane from col0 (zero for the
// others); every load issued before any use.
template <bool kVec>
__device__ __forceinline__ void load_rows(uint4 (&x)[NK], const bool (&live)[NK],
                                          const int8_t* __restrict__ rows, int i0, int step,
                                          int hd, int col0) {
#pragma unroll
  for (int u = 0; u < NK; ++u)
    x[u] = live[u] ? load16<kVec>(rows + static_cast<int64_t>(i0 + u * step) * hd, col0, hd)
                   : make_uint4(0u, 0u, 0u, 0u);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A barrier over the cluster (its shared-memory stores visible after it),
// or over the CTA when it is alone.
__device__ __forceinline__ void csync(const cg::cluster_group& cluster, int C) {
  if (C > 1)
    cluster.sync();
  else
    __syncthreads();
}

// Store v at local[idx] in every CTA of the cluster.
__device__ __forceinline__ void push(const cg::cluster_group& cluster, int C, float* local,
                                     int idx, float v) {
  if (C == 1) {
    local[idx] = v;
    return;
  }
  for (int k = 0; k < C; ++k) cluster.map_shared_rank(local, k)[idx] = v;
}

// ---------------------------------------------------------------------------
// One CTA of the cluster for (b, kv group g) = blockIdx.x / C; it owns rows
// [rank * n_cap, min(L, (rank + 1) * n_cap)) of the cache. Lane j of each
// group of lpr lanes reads columns 16 j .. 16 j + 15 of one row; lane 0 of
// the group owns the row's score, e (and the int8 form's p) in ps, and each
// lane divides by the sum (and by sp) itself in p . V, so only the
// exchanges need a barrier.
// kInt8: the int8 x int8 form. RB: query rows in registers at once (divides
// rep). kVec: 16-byte vector loads.
// ---------------------------------------------------------------------------
template <bool kInt8, int RB, bool kVec>
__global__ void __launch_bounds__(THREADS, 2)
decode_attn_kernel(const float* __restrict__ q, const int8_t* __restrict__ k8,
                   const int8_t* __restrict__ v8, const float* __restrict__ bias,
                   float* __restrict__ out, int* __restrict__ rows_read, Dims s, Layout y) {
  extern __shared__ float smem[];
  const int C = s.C;
  // the matching wait comes before the first store to a peer's shared
  // memory: every CTA of the cluster has started by then
  if (C > 1) cluster_arrive_relaxed();
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = C > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int grp = blockIdx.x / C;
  const int b = grp / s.Hkv;
  const int rep = y.rep, hd = s.hd, hdp = y.hdp, lpr = y.lpr, n_cap = y.n_cap;
  const int parts = C * WARPS;
  const int64_t row0 = static_cast<int64_t>(b) * s.H + static_cast<int64_t>(grp % s.Hkv) * rep;
  const int l0 = rank * n_cap;
  const int n = max(0, min(s.L, l0 + n_cap) - l0);
  const int8_t* kb = k8 + (static_cast<int64_t>(grp) * s.L + l0) * hd;
  const int8_t* vb = v8 + (static_cast<int64_t>(grp) * s.L + l0) * hd;
  const float* bb = bias + static_cast<int64_t>(b) * s.L;
  const float* qg = q + row0 * hd;  // the group's rep rows are contiguous

  float* ps = smem + y.ps;
  float* po = smem + y.po;
  float* gm_s = smem + y.gm_s;
  float* gs_s = smem + y.gs_s;
  float* pm_s = smem + y.pm_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = tid % lpr;      // this lane's 16 columns: 16 j .. 16 j + 15
  const int rr = tid / lpr;     // its row within a pass of the CTA
  const int rpb = THREADS / lpr;
  const int col0 = 16 * j;
  const int slot = rank * WARPS + warp;

  // --- every warp on its own (no barrier): the bias row's max M, amax|q|
  // and sq, and Bq from |q_r|_1 (in double, so that its rounding to f32
  // does not depend on the order) or |q8_r|_1 (exact) ---
  float M = -INFINITY;
#pragma unroll 8
  for (int l = lane; l < s.L; l += 32) M = fmaxf(M, __ldg(bb + l));
  M = warp_max(M);
  float amax = 0.f;
#pragma unroll 4
  for (int i = lane; i < rep * hd; i += 32) amax = fmaxf(amax, fabsf(__ldg(qg + i)));
  amax = warp_max(amax);
  const float sq = __fdiv_rn(fmaxf(amax, 1e-9f), 127.f);
  float Bq = 0.f;
  for (int r = 0; r < rep; ++r) {
    float norm;
    if (kInt8) {
      int a = 0;
#pragma unroll 4
      for (int d = lane; d < hd; d += 32)
        a += abs(min(max(__float2int_rn(__fdiv_rn(__ldg(qg + r * hd + d), sq)), -128), 127));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      norm = __fmul_rn(__int2float_rn(a), sq);
    } else {
      double a = 0.0;
#pragma unroll 4
      for (int d = lane; d < hd; d += 32) a += fabs(static_cast<double>(__ldg(qg + r * hd + d)));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      norm = __double2float_rn(a);
    }
    Bq = fmaxf(Bq, norm);
  }
  Bq = __fmul_rn(Bq, 128.f);

  // the first batch of K and V rows, both in flight at once
  uint4 kv[NK], vv[NK];
  bool live[NK], vlive[NK];
  float bv[NK], vbv[NK];
  live_rows(live, bv, bb + l0, rr, rpb, n, M, Bq);
  load_rows<kVec>(kv, live, kb, rr, rpb, hd, col0);
  load_rows<kVec>(vv, live, vb, rr, rpb, hd, col0);
#pragma unroll
  for (int u = 0; u < NK; ++u) vlive[u] = live[u];
  if (C > 1) cluster_wait();  // every peer has started: its shared memory may be written

  // --- scores: s = q . k + bias into ps; dead rows -inf, never loaded ---
  int nrows = 0;
  for (int rb = 0; rb < rep; rb += RB) {
    float qv[RB][16];
    int qi[RB][4];
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float v = col0 + c < hd ? __ldg(qg + (rb + r) * hd + col0 + c) : 0.f;
        if (kInt8) {
          const int v8q = min(max(__float2int_rn(__fdiv_rn(v, sq)), -128), 127);
          const uint32_t byte = static_cast<uint32_t>(v8q & 0xff) << (8 * (c & 3));
          qi[r][c >> 2] = (c & 3) ? (qi[r][c >> 2] | static_cast<int>(byte))
                                  : static_cast<int>(byte);
        } else {
          qv[r][c] = v;
        }
      }
    float runmax[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) runmax[r] = -INFINITY;
    for (int base = 0; base < n; base += NK * rpb) {
      if (rb > 0 || base > 0) {
        live_rows(live, bv, bb + l0, base + rr, rpb, n, M, Bq);
        load_rows<kVec>(kv, live, kb, base + rr, rpb, hd, col0);
      }
#pragma unroll
      for (int u = 0; u < NK; ++u) {
        if (base + u * rpb >= n) break;  // uniform over the CTA
        const int i = base + u * rpb + rr;
        if (rb == 0 && j == 0 && live[u]) ++nrows;
        float kf[16];
        if (!kInt8) bytes_to_float(kv[u], kf);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          float sc;
          if (kInt8) {
            int acc = __dp4a(static_cast<int>(kv[u].y), qi[r][1],
                             __dp4a(static_cast<int>(kv[u].x), qi[r][0], 0));
            acc += __dp4a(static_cast<int>(kv[u].w), qi[r][3],
                          __dp4a(static_cast<int>(kv[u].z), qi[r][2], 0));
            for (int o = 1; o < lpr; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
            sc = __fadd_rn(__fmul_rn(__int2float_rn(acc), sq), bv[u]);
          } else {
            float part[4] = {0.f, 0.f, 0.f, 0.f};  // four short chains
#pragma unroll
            for (int c = 0; c < 16; ++c) part[c & 3] = fmaf(qv[r][c], kf[c], part[c & 3]);
            float acc = __fadd_rn(__fadd_rn(part[0], part[1]), __fadd_rn(part[2], part[3]));
            for (int o = 1; o < lpr; o <<= 1) acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
            sc = __fadd_rn(acc, bv[u]);
          }
          if (j == 0 && i < n) {
            const float v = live[u] ? sc : -INFINITY;
            ps[(rb + r) * n_cap + i] = v;
            runmax[r] = fmaxf(runmax[r], v);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const float m = warp_max(runmax[r]);
      if (lane == 0) push(cluster, C, gm_s, slot * rep + rb + r, m);
    }
  }
  if (rows_read != nullptr) {
    const int c = __reduce_add_sync(0xffffffffu, nrows);
    if (lane == 0 && c) atomicAdd(rows_read, c);
  }
  csync(cluster, C);

  // --- e = exp(s - m) against the row's max over the cluster, and the
  // sums; lane 0 of each row's lanes on its own rows ---
  for (int r = 0; r < rep; ++r) {
    float m = gm_s[r];
#pragma unroll 8
    for (int k = 1; k < parts; ++k) m = fmaxf(m, gm_s[k * rep + r]);
    float sum = 0.f;
    if (j == 0) {
#pragma unroll 4
      for (int i = rr; i < n; i += rpb) {
        const float e = expf(__fsub_rn(ps[r * n_cap + i], m));
        ps[r * n_cap + i] = e;
        sum = __fadd_rn(sum, e);
      }
    }
    sum = warp_sum(sum);
    if (lane == 0) push(cluster, C, gs_s, slot * rep + r, sum);
  }
  csync(cluster, C);

  // --- the int8 form: p = e / sum, its largest over the cluster, and the
  // scale sp (p8 = rint(p / sp) is taken in p . V). The f32 form divides
  // in p . V. ---
  float sp = 0.f;
  if (kInt8) {
    float pmax = 0.f;
    for (int r = 0; r < rep; ++r) {
      float t = gs_s[r];
#pragma unroll 8
      for (int k = 1; k < parts; ++k) t = __fadd_rn(t, gs_s[k * rep + r]);
      if (j == 0) {
#pragma unroll 4
        for (int i = rr; i < n; i += rpb) {
          const float p = __fdiv_rn(ps[r * n_cap + i], t);
          ps[r * n_cap + i] = p;
          pmax = fmaxf(pmax, p);
        }
      }
    }
    pmax = warp_max(pmax);
    if (lane == 0) push(cluster, C, pm_s, slot, pmax);
    csync(cluster, C);
    float g = pm_s[0];
#pragma unroll 8
    for (int k = 1; k < parts; ++k) g = fmaxf(g, pm_s[k]);
    sp = __fdiv_rn(fmaxf(g, 1e-9f), 127.f);
  }

  // --- p . V: each lane sums its 16 columns over its rows; the warp's
  // partial goes to its slot in rank 0 ---
  float* po0 = C > 1 ? cluster.map_shared_rank(po, 0) : po;
  for (int rb = 0; rb < rep; rb += RB) {
    float acc[RB][16];
    int iacc[RB][16];
    float tsum[RB];  // the f32 form's row sums over the cluster
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      tsum[r] = gs_s[rb + r];
      if (!kInt8) {
#pragma unroll 8
        for (int k = 1; k < parts; ++k) tsum[r] = __fadd_rn(tsum[r], gs_s[k * rep + rb + r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        acc[r][c] = 0.f;
        iacc[r][c] = 0;
      }
    for (int base = 0; base < n; base += NK * rpb) {
      if (rb > 0 || base > 0) {
        live_rows(vlive, vbv, bb + l0, base + rr, rpb, n, M, Bq);
        load_rows<kVec>(vv, vlive, vb, base + rr, rpb, hd, col0);
      }
#pragma unroll
      for (int u = 0; u < NK; ++u) {
        if (base + u * rpb >= n) break;
        if (!vlive[u]) continue;
        const int i = base + u * rpb + rr;
        if (kInt8) {
          const uint32_t w[4] = {vv[u].x, vv[u].y, vv[u].z, vv[u].w};
          int vi[16];
#pragma unroll
          for (int c = 0; c < 16; ++c) vi[c] = sbyte(w[c >> 2], c & 3);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const int p8 = __float2int_rn(__fdiv_rn(ps[(rb + r) * n_cap + i], sp));
#pragma unroll
            for (int c = 0; c < 16; ++c) iacc[r][c] += p8 * vi[c];
          }
        } else {
          float vf[16];
          bytes_to_float(vv[u], vf);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const float p = __fdiv_rn(ps[(rb + r) * n_cap + i], tsum[r]);
#pragma unroll
            for (int c = 0; c < 16; ++c) acc[r][c] = fmaf(p, vf[c], acc[r][c]);
          }
        }
      }
    }
    // over the lanes of the warp that hold the same columns
#pragma unroll
    for (int r = 0; r < RB; ++r)
#pragma unroll
      for (int c = 0; c < 16; ++c)
        for (int o = lpr; o < 32; o <<= 1) {
          if (kInt8)
            iacc[r][c] += __shfl_xor_sync(0xffffffffu, iacc[r][c], o);
          else
            acc[r][c] = __fadd_rn(acc[r][c], __shfl_xor_sync(0xffffffffu, acc[r][c], o));
        }
    if (lane < lpr) {
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          float* at = po0 + (slot * rep + rb + r) * hdp + col0 + c;
          if (kInt8)
            *reinterpret_cast<int*>(at) = iacc[r][c];
          else
            *at = acc[r][c];
        }
    }
  }

  // --- rank 0 sums the partials in (rank, warp) order and writes out ---
  csync(cluster, C);
  if (rank != 0) return;
  for (int idx = tid; idx < rep * hd; idx += THREADS) {
    const int r = idx / hd, d = idx % hd;
    if (kInt8) {
      int t = 0;
#pragma unroll 8
      for (int k = 0; k < parts; ++k) t += reinterpret_cast<const int*>(po)[(k * rep + r) * hdp + d];
      out[(row0 + r) * hd + d] = __fmul_rn(__int2float_rn(t), sp);
    } else {
      float t = po[r * hdp + d];
#pragma unroll 8
      for (int k = 1; k < parts; ++k) t = __fadd_rn(t, po[(k * rep + r) * hdp + d]);
      out[(row0 + r) * hd + d] = t;
    }
  }
}

using KernelFn = void (*)(const float*, const int8_t*, const int8_t*, const float*, float*,
                          int*, Dims, Layout);

template <bool kInt8, int RB>
KernelFn pick_vec(bool vec) {
  return vec ? decode_attn_kernel<kInt8, RB, true> : decode_attn_kernel<kInt8, RB, false>;
}

template <bool kInt8>
KernelFn pick(int rep, bool vec) {
  if (rep % 4 == 0) return pick_vec<kInt8, 4>(vec);
  if (rep % 2 == 0) return pick_vec<kInt8, 2>(vec);
  return pick_vec<kInt8, 1>(vec);
}

template <bool kInt8>
cudaError_t launch(const void* q, const void* k8, const void* v8, const void* bias, void* out,
                   int B, int H, int Hkv, int L, int hd, int C, void* rows_read, void* stream) {
  const Dims s{B, H, Hkv, L, hd, C};
  if (B <= 0 || H <= 0 || Hkv <= 0 || L <= 0 || hd <= 0 || hd > 256 || H % Hkv ||
      (C != 1 && C != 2 && C != 4 && C != 8) || C > MAX_CLUSTER)
    return cudaErrorInvalidValue;
  const Layout y = make_layout(s);
  const size_t smem = sizeof(float) * static_cast<size_t>(y.words);
  if (smem > SMEM_LIMIT) return cudaErrorInvalidValue;
  const bool vec = hd % 16 == 0 && reinterpret_cast<uintptr_t>(k8) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v8) % 16 == 0;
  const KernelFn kernel = pick<kInt8>(y.rep, vec);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * Hkv * C), 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(C);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(q), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(bias), static_cast<float*>(out),
      static_cast<int*>(rows_read), s, y);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// q: f32 [B*H, hd]; k8, v8: int8 [B*Hkv, L, hd]; bias: f32 [B, L];
// out: f32 [B*H, hd]; C: CTAs per cluster (1, 2, 4, 8); rows_read: null, or
// an int the kernel adds the K rows it loaded to. Launches on `stream`,
// returns the launch's error code (cudaErrorInvalidValue for a shape or
// split it does not take).
extern "C" cudaError_t decode_attention_int8_launch(
    const void* q, const void* k8, const void* v8, const void* bias, void* out,
    int B, int H, int Hkv, int L, int hd, int C, void* rows_read, void* stream) {
  return launch<false>(q, k8, v8, bias, out, B, H, Hkv, L, hd, C, rows_read, stream);
}

extern "C" cudaError_t decode_attention_int8_mxu_launch(
    const void* q, const void* k8, const void* v8, const void* bias, void* out,
    int B, int H, int Hkv, int L, int hd, int C, void* rows_read, void* stream) {
  return launch<true>(q, k8, v8, bias, out, B, H, Hkv, L, hd, C, rows_read, stream);
}
