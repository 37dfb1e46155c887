// Absorbed EliteKV decode attention over the block-paged compressed cache:
// one templated kernel body behind four entries.
//
//   entry                          replaces (src/repro/kernels/elite_decode.py)
//   elite_decode_paged             elite_decode_paged            (_paged_kernel)
//   elite_decode_paged_q8          elite_decode_paged_q8         (_paged_kernel_q8)
//   elite_decode_sparse_paged      elite_decode_sparse_paged     (_sparse_kernel)
//   elite_decode_sparse_paged_q8   elite_decode_sparse_paged_q8  (_sparse_kernel_q8)
//
// For serving lane b and kv head h it computes, over the rows the lane's walk
// visits,
//     s[g, t] = (q_e[g] . k_e[t, h] + q_lat[g] . c_k[t]) * scale
//     o[g]    = softmax_t(s[g]) . c_v[t]
// for the G query heads g of the group, and writes o into out [B, nh, d_c]
// (always f32).  The body has two template parameters:
//   * the page element: float, or int8_t with one f32 scale per slot and
//     stream; each int8 element is multiplied by its slot's scale as it is
//     staged into the shared f32 rows -- the single multiply of the plain
//     version's q.float() * scale;
//   * the walk: ChainWalk visits block_tables[b, j] for j < ceil(len / bs)
//     with n = min(bs, len - j*bs) rows; SelWalk visits sel_tables[b, j] for
//     j < W with n = sel_counts[b, j] rows and skips a block with n == 0.
// The score loop, online softmax and acc update are one piece of code, so a
// selection that is the whole chain (what select_topk_blocks returns when its
// width covers the table) visits the same blocks with the same n in the same
// order as the chain walk and gives the dense kernel's bits, f32 and int8.
// A lane that visits no row writes exact zeros (acc / max(l, 1e-30), acc = 0).
//
// What bounds it on the H100: bytes.  Each visited token brings n_kv*2r + d_c
// elements (J-LRD; 2*d_c latent under S-LRD) -- 4 B each in f32, 1 B each in
// int8 plus 4 B of scale per slot and stream -- against about
// 4*nh*(2r + d_c) flops: a few flops per byte, far below the ~20 flops per
// byte at which f32 FMA would become the limit.  The floor is reading the
// visited rows once at 3.35 TB/s; sparse decode lowers it by visiting fewer.
//
// What the design does about it: one CTA per (lane, kv head) walks only the
// blocks its walk names -- the TPU grid visits every table entry and skips
// under pl.when -- so padded entries (block 0, a live block of another
// sequence) are never read.  Each block's k_e slice and latent rows are
// staged once in shared memory, and all G query heads of the group are
// scored against the staged rows.  The online-softmax state (m, l,
// acc [G, d_c]) stays in f32 shared memory across blocks; nothing is sized
// statically to one model's widths.
// Known shortfalls: the latent rows have no head axis but are re-read once
// per kv head; B * n_kv CTAs (32 at 8 lanes of TinyLlama) leave most of the
// 132 SMs idle; int8 k_e rows are 2r = 16 bytes per kv head, loaded a byte
// per thread, which the int8 staging coalesces poorly.  All heads of a lane
// in one CTA plus split-KV (in the same reduction order for both walks) is
// later work.

#include <cstdint>
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

// A page element as f32: as is, or times its slot's scale.
__device__ __forceinline__ float load(const float* p, long i, const float*, long) {
  return p[i];
}
__device__ __forceinline__ float load(const int8_t* p, long i, const float* s, long slot) {
  return static_cast<float>(p[i]) * s[slot];
}

// The lane's chain: block_tables [B, mb], lengths [B].
struct ChainWalk {
  const int* tables;
  const int* lengths;
  int width;  // mb
  int bs;
  __device__ int steps(int b, int& len) const {
    len = min(lengths[b], width * bs);  // a length past the table sees it all
    return (len + bs - 1) / bs;
  }
  __device__ int block(int b, int j, int len, int& n) const {
    n = min(bs, len - j * bs);
    return tables[b * width + j];
  }
};

// A selection: sel_tables / sel_counts [B, W].
struct SelWalk {
  const int* tables;
  const int* counts;
  int width;  // W
  int bs;
  __device__ int steps(int, int&) const { return width; }
  __device__ int block(int b, int j, int, int& n) const {
    n = min(counts[b * width + j], bs);
    return tables[b * width + j];
  }
};

template <typename T, typename Walk>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const float* __restrict__ q_e, const float* __restrict__ q_lat,
    const T* __restrict__ k_e, const T* __restrict__ c_k,
    const T* __restrict__ c_v, const float* __restrict__ k_s,
    const float* __restrict__ ck_s, const float* __restrict__ cv_s, Walk walk,
    float* __restrict__ out, int nkv, int G, int r2, int dc, float scale,
    bool shared_cv) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bs = walk.bs;
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

  int len = 0;
  const int n_steps = walk.steps(b, len);
  const float* cv_rows = shared_cv ? kc + r2 : cv;
  const int cv_stride = shared_cv ? Wp : dc;
  for (int j = 0; j < n_steps; ++j) {
    int n;                                 // live rows of this block
    const long base = (long)walk.block(b, j, len, n) * bs;
    if (n <= 0) continue;                  // uniform across the CTA
    __syncthreads();                       // previous block fully consumed
    for (int i = tid; i < n * r2; i += kThreads) {
      const int t = i / r2, e = i - t * r2;
      kc[t * Wp + e] = load(k_e, ((base + t) * nkv + h) * r2 + e, k_s, base + t);
    }
    for (int i = tid; i < n * dc; i += kThreads) {
      const int t = i / dc, d = i - t * dc;
      kc[t * Wp + r2 + d] = load(c_k, (base + t) * dc + d, ck_s, base + t);
      if (!shared_cv) cv[i] = load(c_v, (base + t) * dc + d, cv_s, base + t);
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

// Sizes shared memory for this launch (opting in above 48 KB), launches on
// `stream` and returns cudaGetLastError() (0 on success).  c_k and c_v (and
// their scales) may be the same pointer (J-LRD), in which case the latent
// rows are staged once.
template <typename T, typename Walk>
int launch(const float* q_e, const float* q_lat, const T* k_e, const T* c_k,
           const T* c_v, const float* k_s, const float* ck_s, const float* cv_s,
           Walk walk, float* out, int B, int nkv, int G, int r2, int dc,
           float scale, void* stream) {
  const bool shared_cv = c_k == c_v && ck_s == cv_s;
  const size_t bs = walk.bs;
  const size_t Wp = (size_t)r2 + dc + 1;
  const size_t floats = G * Wp + bs * Wp + (shared_cv ? 0 : bs * dc) +
                        (size_t)G * bs + (size_t)G * dc + 3 * (size_t)G;
  const size_t bytes = floats * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, Walk>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  decode_kernel<T, Walk><<<dim3(nkv, B), kThreads, bytes, (cudaStream_t)stream>>>(
      q_e, q_lat, k_e, c_k, c_v, k_s, ck_s, cv_s, walk, out, nkv, G, r2, dc,
      scale, shared_cv);
  return (int)cudaGetLastError();
}

}  // namespace

// Pages: k_e [n_slots, nkv, r2], c_k / c_v [n_slots, dc]; q_e [B, nh, r2] and
// q_lat [B, nh, dc] f32; out [B, nh, dc] f32.  The q8 entries take int8 pages
// and f32 scales [n_slots] per stream.  The chain entries take block_tables
// [B, mb] and lengths [B]; the sparse entries sel_tables and sel_counts
// [B, W]; all int32.

extern "C" int elite_decode_paged(const float* q_e, const float* q_lat,
                                  const float* k_e, const float* c_k,
                                  const float* c_v, const int* block_tables,
                                  const int* lengths, float* out, int B,
                                  int nkv, int G, int r2, int dc, int bs,
                                  int mb, float scale, void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, nullptr, nullptr, nullptr,
                ChainWalk{block_tables, lengths, mb, bs}, out, B, nkv, G, r2,
                dc, scale, stream);
}

extern "C" int elite_decode_paged_q8(const float* q_e, const float* q_lat,
                                     const int8_t* k_e, const int8_t* c_k,
                                     const int8_t* c_v, const float* k_s,
                                     const float* ck_s, const float* cv_s,
                                     const int* block_tables, const int* lengths,
                                     float* out, int B, int nkv, int G, int r2,
                                     int dc, int bs, int mb, float scale,
                                     void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, k_s, ck_s, cv_s,
                ChainWalk{block_tables, lengths, mb, bs}, out, B, nkv, G, r2,
                dc, scale, stream);
}

extern "C" int elite_decode_sparse_paged(const float* q_e, const float* q_lat,
                                         const float* k_e, const float* c_k,
                                         const float* c_v, const int* sel_tables,
                                         const int* sel_counts, float* out,
                                         int B, int nkv, int G, int r2, int dc,
                                         int bs, int W, float scale,
                                         void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, nullptr, nullptr, nullptr,
                SelWalk{sel_tables, sel_counts, W, bs}, out, B, nkv, G, r2, dc,
                scale, stream);
}

extern "C" int elite_decode_sparse_paged_q8(
    const float* q_e, const float* q_lat, const int8_t* k_e, const int8_t* c_k,
    const int8_t* c_v, const float* k_s, const float* ck_s, const float* cv_s,
    const int* sel_tables, const int* sel_counts, float* out, int B, int nkv,
    int G, int r2, int dc, int bs, int W, float scale, void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, k_s, ck_s, cv_s,
                SelWalk{sel_tables, sel_counts, W, bs}, out, B, nkv, G, r2, dc,
                scale, stream);
}
