// Causal GQA flash attention with per-lane offsets, for paged prefill.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::flash_prefill
// (Pallas body _kernel).  q [B, Sq, nh, dh], k/v [B, Sk, nkv, dh],
// q_offsets/kv_lens [B] int32 -> o [B, Sq, nh, dh].  Key j is visible to
// query i of lane b iff j <= i + q_offsets[b] and j < kv_lens[b]; query head
// h reads kv head h / G through the index (K/V are never repeated).  Masked
// scores are -1e30, and the finish is acc / max(l, 1e-30), so a query with no
// visible key (kv_len = 0) writes exact zeros.  Sq and Sk need not be
// multiples of the tiles: the ragged edges are masked here.
//
// What bounds it on the H100: operations.  A 256-token chunk does about
// 4 * dh flops per visible (query, key) pair on 4 * dh bytes per row, so with
// plain f32 FMA (67 TFLOP/s) the arithmetic, not the 3.35 TB/s of memory, is
// the floor.
//
// What the design does about it: one CTA of 128 threads per (lane, query
// head, 64-query tile) keeps the Q tile in shared memory and loops over
// 32-key tiles only up to min(last query + q_offset + 1, kv_len), so key
// tiles above the diagonal or past the live keys are never loaded.  Each
// thread holds a 4x4 register tile of scores and a 4 x dh/8 tile of the
// output, so every shared-memory value it loads feeds 4 FMAs; shared rows
// are padded by one float against bank conflicts.  Tensor cores (wgmma,
// TMA-fed pipelines) are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 32;  // keys per tile
constexpr int TX = 8;   // threads across keys / output columns
constexpr int RM = 4;   // query rows per thread (16 row groups x 4 = BQ)
constexpr int CN = 4;   // keys per thread (TX x CN = BK)

__device__ __forceinline__ float row_max(float v) {  // over the 8 tx lanes
  for (int o = 1; o < TX; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
  for (int o = 1; o < TX; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const int* __restrict__ q_offsets,
    const int* __restrict__ kv_lens, float* __restrict__ o, int Sq, int Sk,
    int nh, int nkv, int G, float scale) {
  constexpr int DN = DH / TX;  // output columns per thread
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int off = q_offsets[b], kvl = kv_lens[b];
  extern __shared__ float sm[];
  float* Qs = sm;                  // [BQ][DH + 1]
  float* Ks = Qs + BQ * (DH + 1);  // [BK][DH + 1]
  float* Vs = Ks + BK * (DH + 1);  // [BK][DH]
  float* Ps = Vs + BK * DH;        // [BQ][BK + 1]

  for (int i = tid; i < BQ * DH; i += kThreads) {
    const int r = i / DH, d = i - r * DH, qp = q0 + r;
    Qs[r * (DH + 1) + d] = qp < Sq ? q[(((long)b * Sq + qp) * nh + h) * DH + d] : 0.f;
  }
  float acc[RM][DN];
  float m_i[RM], l_i[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = -1e30f;
    l_i[i] = 0.f;
#pragma unroll
    for (int jd = 0; jd < DN; ++jd) acc[i][jd] = 0.f;
  }
  // keys any row of this tile can see
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int kend = min(min(last_q + off + 1, kvl), Sk);
  const int n_kt = kend > 0 ? (kend + BK - 1) / BK : 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // Q loaded / previous tile consumed
    for (int i = tid; i < BK * DH; i += kThreads) {
      const int c = i / DH, d = i - c * DH, kp = k0 + c;
      const long idx = (((long)b * Sk + kp) * nkv + hk) * DH + d;
      Ks[c * (DH + 1) + d] = kp < Sk ? k[idx] : 0.f;
      Vs[c * DH + d] = kp < Sk ? v[idx] : 0.f;
    }
    __syncthreads();
    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qv[i] = Qs[(ty * RM + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kv[j] = Ks[(tx + TX * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] += qv[i] * kv[j];
    }
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qp = q0 + ty * RM + i;
      bool vis[CN];
      float mx = -1e30f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kp = k0 + tx + TX * j;
        vis[j] = kp <= qp + off && kp < kvl && kp < Sk;
        sc[i][j] = vis[j] ? sc[i][j] * scale : -1e30f;
        mx = fmaxf(mx, sc[i][j]);
      }
      mx = row_max(mx);
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = vis[j] ? expf(sc[i][j] - m_new) : 0.f;
        Ps[(ty * RM + i) * (BK + 1) + tx + TX * j] = p;
        sum += p;
      }
      sum = row_sum(sum);
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int jd = 0; jd < DN; ++jd) acc[i][jd] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) pv[i] = Ps[(ty * RM + i) * (BK + 1) + c];
#pragma unroll
      for (int jd = 0; jd < DN; ++jd) {
        const float vv = Vs[c * DH + tx + TX * jd];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][jd] += pv[i] * vv;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qp = q0 + ty * RM + i;
    if (qp >= Sq) continue;
    const float den = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int jd = 0; jd < DN; ++jd)
      o[(((long)b * Sq + qp) * nh + h) * DH + tx + TX * jd] = acc[i][jd] / den;
  }
}

template <int DH>
int launch(const float* q, const float* k, const float* v, const int* q_offsets,
           const int* kv_lens, float* o, int B, int Sq, int Sk, int nh, int nkv,
           float scale, cudaStream_t stream) {
  const size_t bytes =
      ((size_t)BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1)) * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, nh, B);
  flash_kernel<DH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, q_offsets, kv_lens, o, Sq, Sk, nh, nkv, nh / nkv, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head dim this file does not instantiate.
extern "C" int flash_prefill(const float* q, const float* k, const float* v,
                             const int* q_offsets, const int* kv_lens, float* o,
                             int B, int Sq, int Sk, int nh, int nkv, int dh,
                             float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 32: return launch<32>(q, k, v, q_offsets, kv_lens, o, B, Sq, Sk, nh, nkv, scale, s);
    case 64: return launch<64>(q, k, v, q_offsets, kv_lens, o, B, Sq, Sk, nh, nkv, scale, s);
    case 128: return launch<128>(q, k, v, q_offsets, kv_lens, o, B, Sq, Sk, nh, nkv, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
