// Absorbed EliteKV decode attention over the block-paged compressed cache.
//
// Replaces the TPU kernel src/repro/kernels/elite_decode.py::elite_decode_paged
// (Pallas body _paged_kernel).  For serving lane b and kv head h it computes,
// over the lane's live tokens t < lengths[b] located through block_tables[b],
//     s[g, t] = (q_e[g] . k_e[t, h] + q_lat[g] . c_k[t]) * scale
//     o[g]    = softmax_t(s[g]) . c_v[t]
// for the G query heads g of the group, and writes o into out [B, nh, d_c].
// A lane of length 0 writes exact zeros (acc / max(l, 1e-30) with acc = 0).
//
// What bounds it on the H100: bytes.  Each live token brings 2r*n_kv + d_c
// floats (J-LRD) against about 4*nh*(2r + d_c) flops: a few flops per byte,
// far below the ~20 flops per byte at which f32 FMA would become the limit.
// The floor is reading the compressed cache once at 3.35 TB/s.
//
// What the design does about it: one CTA per (lane, kv head) walks the
// lane's block table only up to ceil(length / block_size) -- the TPU grid
// visits every table entry and skips under pl.when -- so padded entries
// (block 0, a live block of another sequence) are never read.  Each block's
// k_e slice and latent rows are staged once in shared memory with coalesced
// loads, and all G query heads of the group are scored against the staged
// rows.  The online-softmax state (m, l, acc [G, d_c]) stays in f32 shared
// memory across blocks; nothing is sized statically to one model's widths.
// Known shortfall: the latent rows have no head axis but are re-read once
// per kv head, and B * n_kv CTAs (32 at 8 lanes of TinyLlama) leave most of
// the 132 SMs idle.  All heads of a lane in one CTA plus split-KV is later
// work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(kThreads) decode_kernel(
    const float* __restrict__ q_e, const float* __restrict__ q_lat,
    const float* __restrict__ k_e, const float* __restrict__ c_k,
    const float* __restrict__ c_v, const int* __restrict__ block_tables,
    const int* __restrict__ lengths, float* __restrict__ out, int nkv, int G,
    int r2, int dc, int bs, int mb, float scale, bool shared_cv) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = r2 + dc;   // one [k_e | c_k] row
  const int Wp = W + 1;    // its stride in shared memory: odd, so the rows
                           // read at one column fall in distinct banks
  const int nh = nkv * G;
  // threads per score: the largest power of two <= 32 that keeps all G * bs
  // scores of a block within one pass of the CTA
  int tpp = 1;
  while (tpp < 32 && G * bs * tpp * 2 <= kThreads) tpp *= 2;
  extern __shared__ float smem[];
  float* q = smem;                                // [G, Wp]  [q_e | q_lat]
  float* kc = q + G * Wp;                         // [bs, Wp] [k_e | c_k]
  float* cv = kc + bs * Wp;                       // [bs, dc] c_v (S-LRD)
  float* s = cv + (shared_cv ? 0 : bs * dc);      // [G, bs] scores -> probs
  float* acc = s + G * bs;                        // [G, dc]
  float* m = acc + G * dc;                        // [G]
  float* l = m + G;                               // [G]
  float* alpha = l + G;                           // [G]

  for (int i = tid; i < G * W; i += kThreads) {
    const int g = i / W, e = i - g * W;
    const long row = (long)b * nh + h * G + g;
    q[g * Wp + e] = e < r2 ? q_e[row * r2 + e] : q_lat[row * dc + (e - r2)];
  }
  for (int i = tid; i < G * dc; i += kThreads) acc[i] = 0.f;
  for (int g = tid; g < G; g += kThreads) {
    m[g] = -1e30f;
    l[g] = 0.f;
  }

  const int len = min(lengths[b], mb * bs);  // a length past the table sees it all
  const int n_blocks = (len + bs - 1) / bs;
  const float* cv_rows = shared_cv ? kc + r2 : cv;
  const int cv_stride = shared_cv ? Wp : dc;
  for (int j = 0; j < n_blocks; ++j) {
    const long base = (long)block_tables[b * mb + j] * bs;
    const int n = min(bs, len - j * bs);  // live rows of this block
    __syncthreads();                       // previous block fully consumed
    for (int i = tid; i < n * r2; i += kThreads) {
      const int t = i / r2, e = i - t * r2;
      kc[t * Wp + e] = k_e[((base + t) * nkv + h) * r2 + e];
    }
    for (int i = tid; i < n * dc; i += kThreads) {
      const int t = i / dc, d = i - t * dc;
      kc[t * Wp + r2 + d] = c_k[(base + t) * dc + d];
      if (!shared_cv) cv[i] = c_v[(base + t) * dc + d];
    }
    __syncthreads();
    // scores: tpp adjacent threads per (query head, token) pair; the loop
    // bound is uniform, so every lane reaches the shuffles
    for (int p0 = 0; p0 < G * n; p0 += kThreads / tpp) {
      const int p = p0 + tid / tpp, sub = tid % tpp;
      const int g = p / n, t = p - g * n;
      float a = 0.f;
      if (p < G * n)
        for (int e = sub; e < W; e += tpp) a += q[g * Wp + e] * kc[t * Wp + e];
      for (int o = tpp / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (p < G * n && sub == 0) s[g * bs + t] = a * scale;
    }
    __syncthreads();
    // online-softmax update: one warp per query head
    for (int g = warp; g < G; g += kWarps) {
      float mx = -1e30f;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[g * bs + t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m[g], mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float pr = expf(s[g * bs + t] - m_new);
        s[g * bs + t] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m[g] - m_new);
        alpha[g] = a;
        l[g] = l[g] * a + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * dc; i += kThreads) {
      const int g = i / dc, d = i - g * dc;
      float a = acc[i] * alpha[g];
      for (int t = 0; t < n; ++t) a += s[g * bs + t] * cv_rows[t * cv_stride + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * dc; i += kThreads) {
    const int g = i / dc, d = i - g * dc;
    out[((long)b * nh + h * G + g) * dc + d] = acc[i] / fmaxf(l[g], 1e-30f);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).  c_k and
// c_v may be the same pointer (J-LRD), in which case the latent rows are
// staged once.
extern "C" int elite_decode_paged(const float* q_e, const float* q_lat,
                                  const float* k_e, const float* c_k,
                                  const float* c_v, const int* block_tables,
                                  const int* lengths, float* out, int B,
                                  int nkv, int G, int r2, int dc, int bs,
                                  int mb, float scale, void* stream) {
  const bool shared_cv = c_k == c_v;
  const size_t Wp = (size_t)r2 + dc + 1;
  const size_t floats = G * Wp + bs * Wp + (shared_cv ? 0 : (size_t)bs * dc) +
                        (size_t)G * bs + (size_t)G * dc + 3 * (size_t)G;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  decode_kernel<<<dim3(nkv, B), kThreads, bytes, (cudaStream_t)stream>>>(
      q_e, q_lat, k_e, c_k, c_v, block_tables, lengths, out, nkv, G, r2, dc,
      bs, mb, scale, shared_cv);
  return (int)cudaGetLastError();
}
