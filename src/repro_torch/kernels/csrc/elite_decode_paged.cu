// Absorbed EliteKV decode and speculative-verify attention over the
// block-paged compressed cache, and decode over a contiguous cache: one
// templated kernel body behind seven entries.
//
//   entry                          replaces (src/repro/kernels/elite_decode.py)
//   elite_decode                   elite_decode                  (_kernel)
//   elite_decode_paged             elite_decode_paged            (_paged_kernel)
//   elite_decode_paged_q8          elite_decode_paged_q8         (_paged_kernel_q8)
//   elite_decode_sparse_paged      elite_decode_sparse_paged     (_sparse_kernel)
//   elite_decode_sparse_paged_q8   elite_decode_sparse_paged_q8  (_sparse_kernel_q8)
//   elite_verify_paged             elite_verify_paged            (_verify_kernel)
//   elite_verify_paged_q8          elite_verify_paged_q8         (_verify_kernel_q8)
//
// For serving lane b and kv head h it computes, over the rows the lane's walk
// visits,
//     s[r, t] = (q_e[r] . k_e[t, h] + q_lat[r] . c_k[t]) * scale
//     o[r]    = softmax_t(s[r]) . c_v[t]
// for the R = nw * G query rows of the group: row r is window position
// w = r / G of query head h*G + r%G.  A decode call has nw = 1 and no
// window mask.  A verify call scores nw = k+1 window tokens per lane in the
// same walk: row r sits at global position q_offsets[b] + r/G and sees pool
// position pos = j*bs + t only if pos <= q_offsets[b] + r/G (besides
// pos < lengths[b], which the walk gives).  A masked score gets probability
// exactly 0, so a row that meets a block with nothing visible to it (not
// possible in the chain walk, where every row sees position 0) adds nothing.
// q is read as [B, nw, nh, .] and o written as [B, nw, nh, dc] (always f32),
// so no host transpose regroups the window.  The body has two template
// parameters:
//   * the page element: float, or int8_t with one f32 scale per slot and
//     stream; each int8 element is multiplied by its slot's scale as it is
//     staged into the shared f32 rows -- the single multiply of the plain
//     version's q.float() * scale;
//   * the walk, which yields the first row and the count n of each tile of
//     rows it visits: ChainWalk visits block_tables[b, j] for
//     j < ceil(len / bs) with n = min(bs, len - j*bs) rows; SelWalk visits
//     sel_tables[b, j] for j < W with n = sel_counts[b, j] rows and skips a
//     block with n == 0; ContigWalk visits lane b's rows b*S + j*bs of a
//     contiguous [B, S, ...] cache for j < ceil(len / bs), with a partial
//     last tile (S need not be a multiple of bs).  A contiguous cache has
//     the memory layout of pages [B*S, ...] whose table is the identity,
//     so ContigWalk reads it in place and builds no table; with S a
//     multiple of bs it visits the rows ChainWalk visits over the identity
//     table, in the same tiles and order, and gives its bits.
// The window (nw, q_offsets) is a run-time argument of the same body, not a
// third instantiation: a decode entry is the window nw = 1 with no mask,
// whose bits a verify call with nw = 1 and q_offsets = lengths - 1 repeats
// (its mask never fires, and the threads per score follow R * bs = G * bs).
// The score loop, online softmax and acc update are one piece of code, so a
// selection that is the whole chain (what select_topk_blocks returns when its
// width covers the table) visits the same blocks with the same n in the same
// order as the chain walk and gives the dense kernel's bits, f32 and int8.
// A lane that visits no row writes exact zeros (acc / max(l, 1e-30), acc = 0).
//
// What bounds it on the H100.  Decode: bytes.  Each visited token brings
// n_kv*2r + d_c elements (J-LRD; 2*d_c latent under S-LRD) -- 4 B each in
// f32, 1 B each in int8 plus 4 B of scale per slot and stream -- against
// about 4*nh*(2r + d_c) flops: a few flops per byte, below the ~20 flops
// per byte at which f32 FMA would become the limit.  Verify: operations.
// The same bytes feed W times the flops (TinyLlama at W = 5: 512 B against
// ~46 kflop per visited token and lane, ~90 flop/B), above the f32-FMA
// ridge (67 TFLOP/s / 3.35 TB/s ~ 20 flop/B).  Tensor cores, with a stated
// tolerance, are the redesign for verify; this body uses plain f32 FMA.
//
// What the design does about it: one CTA per (lane, kv head) walks only the
// blocks its walk names -- the TPU grid visits every table entry and skips
// under pl.when -- so padded entries (block 0, a live block of another
// sequence) are never read.  Each block's k_e slice and latent rows are
// staged once in shared memory, and all R query rows of the group (the
// whole verify window) are scored against the staged rows, so verify reads
// the cache once per window instead of once per token.  The online-softmax
// state (m, l, acc [R, d_c]) stays in f32 shared memory across blocks;
// nothing is sized statically to one model's widths.  Shared memory grows
// with R; the launch opts in above 48 KB and fails past the card's opt-in
// limit (the Python wrapper checks first and names the limit).
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
  __device__ long rows(int b, int j, int len, int& n) const {
    n = min(bs, len - j * bs);
    return (long)tables[b * width + j] * bs;
  }
};

// A selection: sel_tables / sel_counts [B, W].
struct SelWalk {
  const int* tables;
  const int* counts;
  int width;  // W
  int bs;
  __device__ int steps(int, int&) const { return width; }
  __device__ long rows(int b, int j, int, int& n) const {
    n = min(counts[b * width + j], bs);
    return (long)tables[b * width + j] * bs;
  }
};

// A contiguous cache [B, S, ...]: lane b's first lengths[b] rows, in tiles
// of bs rows.
struct ContigWalk {
  const int* lengths;
  int S;
  int bs;
  __device__ int steps(int b, int& len) const {
    len = max(0, min(lengths[b], S));    // a length past S sees the whole lane
    return (len + bs - 1) / bs;
  }
  __device__ long rows(int b, int j, int len, int& n) const {
    n = min(bs, len - j * bs);
    return (long)b * S + (long)j * bs;
  }
};

// Shared memory of one CTA, in bytes: q [R, Wp], kc [bs, Wp], cv [bs, dc]
// (S-LRD only), s [R, bs], acc [R, dc], m/l/alpha [R] floats, with
// Wp = r2 + dc + 1 and R = nw * G (int8 pages are staged as f32).
size_t smem_bytes(int R, int bs, int r2, int dc, bool shared_cv) {
  const size_t Wp = (size_t)r2 + dc + 1;
  const size_t floats = (size_t)R * Wp + (size_t)bs * Wp +
                        (shared_cv ? 0 : (size_t)bs * dc) + (size_t)R * bs +
                        (size_t)R * dc + 3 * (size_t)R;
  return floats * sizeof(float);
}

constexpr float kMasked = -1e30f;   // a score outside the window's mask

template <typename T, typename Walk>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const float* __restrict__ q_e, const float* __restrict__ q_lat,
    const T* __restrict__ k_e, const T* __restrict__ c_k,
    const T* __restrict__ c_v, const float* __restrict__ k_s,
    const float* __restrict__ ck_s, const float* __restrict__ cv_s, Walk walk,
    const int* __restrict__ q_off, float* __restrict__ out, int nw, int nkv,
    int G, int r2, int dc, float scale, bool shared_cv) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bs = walk.bs;
  const int W = r2 + dc;   // one [k_e | c_k] row
  const int Wp = W + 1;    // its stride in shared memory: odd, so the rows
                           // read at one column fall in distinct banks
  const int nh = nkv * G;
  const int R = nw * G;    // query rows: window position r / G, head r % G
  // threads per score: the largest power of two <= 32 that keeps all R * bs
  // scores of a block within one pass of the CTA
  int tpp = 1;
  while (tpp < 32 && R * bs * tpp * 2 <= kThreads) tpp *= 2;
  extern __shared__ float smem[];
  float* q = smem;                                // [R, Wp]  [q_e | q_lat]
  float* kc = q + R * Wp;                         // [bs, Wp] [k_e | c_k]
  float* cv = kc + bs * Wp;                       // [bs, dc] c_v (S-LRD)
  float* s = cv + (shared_cv ? 0 : bs * dc);      // [R, bs] scores -> probs
  float* acc = s + R * bs;                        // [R, dc]
  float* m = acc + R * dc;                        // [R]
  float* l = m + R;                               // [R]
  float* alpha = l + R;                           // [R]

  // global row of query row r: ((b * nw + r / G) * nh + h * G + r % G)
  for (int i = tid; i < R * W; i += kThreads) {
    const int r = i / W, e = i - r * W;
    const int w = r / G, g = r - w * G;
    const long row = ((long)b * nw + w) * nh + h * G + g;
    q[r * Wp + e] = e < r2 ? q_e[row * r2 + e] : q_lat[row * dc + (e - r2)];
  }
  for (int i = tid; i < R * dc; i += kThreads) acc[i] = 0.f;
  for (int r = tid; r < R; r += kThreads) {
    m[r] = -1e30f;
    l[r] = 0.f;
  }

  int len = 0;
  const int n_steps = walk.steps(b, len);
  const int qo = q_off ? q_off[b] : 0;   // the window's first position
  const float* cv_rows = shared_cv ? kc + r2 : cv;
  const int cv_stride = shared_cv ? Wp : dc;
  for (int j = 0; j < n_steps; ++j) {
    int n;                                 // live rows of this block
    const long base = walk.rows(b, j, len, n);
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
    // scores: tpp adjacent threads per (query row, token) pair; the loop
    // bound is uniform, so every lane reaches the shuffles
    for (int p0 = 0; p0 < R * n; p0 += kThreads / tpp) {
      const int p = p0 + tid / tpp, sub = tid % tpp;
      const int r = p / n, t = p - r * n;
      float a = 0.f;
      if (p < R * n)
        for (int e = sub; e < W; e += tpp) a += q[r * Wp + e] * kc[t * Wp + e];
      for (int o = tpp / 2; o > 0; o >>= 1) a += __shfl_xor_sync(0xffffffffu, a, o);
      if (p < R * n && sub == 0)
        s[r * bs + t] = q_off && j * bs + t > qo + r / G ? kMasked : a * scale;
    }
    __syncthreads();
    // online-softmax update: one warp per query row; a masked score's
    // probability is exactly 0 whatever the running max
    for (int r = warp; r < R; r += kWarps) {
      float mx = -1e30f;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, s[r * bs + t]);
      mx = warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float sv = s[r * bs + t];
        const float pr = sv == kMasked ? 0.f : expf(sv - m_new);
        s[r * bs + t] = pr;
        sum += pr;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = expf(m[r] - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < R * dc; i += kThreads) {
      const int r = i / dc, d = i - r * dc;
      float a = acc[i] * alpha[r];
      for (int t = 0; t < n; ++t) a += s[r * bs + t] * cv_rows[t * cv_stride + d];
      acc[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * dc; i += kThreads) {
    const int r = i / dc, d = i - r * dc;
    const int w = r / G, g = r - w * G;
    out[(((long)b * nw + w) * nh + h * G + g) * dc + d] = acc[i] / fmaxf(l[r], 1e-30f);
  }
}

// Sizes shared memory for this launch (opting in above 48 KB), launches on
// `stream` and returns cudaGetLastError() (0 on success).  c_k and c_v (and
// their scales) may be the same pointer (J-LRD), in which case the latent
// rows are staged once.  q_off == nullptr is decode (nw must be 1).
template <typename T, typename Walk>
int launch(const float* q_e, const float* q_lat, const T* k_e, const T* c_k,
           const T* c_v, const float* k_s, const float* ck_s, const float* cv_s,
           Walk walk, const int* q_off, float* out, int B, int nw, int nkv,
           int G, int r2, int dc, float scale, void* stream) {
  const bool shared_cv = c_k == c_v && ck_s == cv_s;
  const size_t bytes = smem_bytes(nw * G, walk.bs, r2, dc, shared_cv);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, Walk>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  decode_kernel<T, Walk><<<dim3(nkv, B), kThreads, bytes, (cudaStream_t)stream>>>(
      q_e, q_lat, k_e, c_k, c_v, k_s, ck_s, cv_s, walk, q_off, out, nw, nkv, G,
      r2, dc, scale, shared_cv);
  return (int)cudaGetLastError();
}

}  // namespace

// Pages: k_e [n_slots, nkv, r2], c_k / c_v [n_slots, dc]; q_e [B, nh, r2] and
// q_lat [B, nh, dc] f32 (verify: [B, W, nh, .]); out [B, nh, dc] f32
// (verify: [B, W, nh, dc]).  The q8 entries take int8 pages and f32 scales
// [n_slots] per stream.  The chain entries take block_tables [B, mb] and
// lengths [B]; the verify entries also q_offsets [B]; the sparse entries
// sel_tables and sel_counts [B, W]; all int32.

// Shared memory per CTA of a call with window nw (1 for decode), and the
// card's opt-in limit for one block: the wrapper refuses a call above it.
extern "C" long elite_decode_smem_bytes(int nw, int G, int bs, int r2, int dc,
                                        int shared_cv) {
  return (long)smem_bytes(nw * G, bs, r2, dc, shared_cv != 0);
}

extern "C" int elite_decode_smem_optin(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  return v;
}

// The contiguous cache: k_e [B, S, nkv, r2], c_k / c_v [B, S, dc], lengths
// [B]; rows staged in tiles of bs.
extern "C" int elite_decode(const float* q_e, const float* q_lat,
                            const float* k_e, const float* c_k,
                            const float* c_v, const int* lengths, float* out,
                            int B, int S, int nkv, int G, int r2, int dc,
                            int bs, float scale, void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, nullptr, nullptr, nullptr,
                ContigWalk{lengths, S, bs}, nullptr, out, B, 1, nkv, G, r2, dc,
                scale, stream);
}

extern "C" int elite_decode_paged(const float* q_e, const float* q_lat,
                                  const float* k_e, const float* c_k,
                                  const float* c_v, const int* block_tables,
                                  const int* lengths, float* out, int B,
                                  int nkv, int G, int r2, int dc, int bs,
                                  int mb, float scale, void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, nullptr, nullptr, nullptr,
                ChainWalk{block_tables, lengths, mb, bs}, nullptr, out, B, 1,
                nkv, G, r2, dc, scale, stream);
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
                ChainWalk{block_tables, lengths, mb, bs}, nullptr, out, B, 1,
                nkv, G, r2, dc, scale, stream);
}

extern "C" int elite_decode_sparse_paged(const float* q_e, const float* q_lat,
                                         const float* k_e, const float* c_k,
                                         const float* c_v, const int* sel_tables,
                                         const int* sel_counts, float* out,
                                         int B, int nkv, int G, int r2, int dc,
                                         int bs, int W, float scale,
                                         void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, nullptr, nullptr, nullptr,
                SelWalk{sel_tables, sel_counts, W, bs}, nullptr, out, B, 1, nkv,
                G, r2, dc, scale, stream);
}

extern "C" int elite_decode_sparse_paged_q8(
    const float* q_e, const float* q_lat, const int8_t* k_e, const int8_t* c_k,
    const int8_t* c_v, const float* k_s, const float* ck_s, const float* cv_s,
    const int* sel_tables, const int* sel_counts, float* out, int B, int nkv,
    int G, int r2, int dc, int bs, int W, float scale, void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, k_s, ck_s, cv_s,
                SelWalk{sel_tables, sel_counts, W, bs}, nullptr, out, B, 1, nkv,
                G, r2, dc, scale, stream);
}

extern "C" int elite_verify_paged(const float* q_e, const float* q_lat,
                                  const float* k_e, const float* c_k,
                                  const float* c_v, const int* block_tables,
                                  const int* q_offsets, const int* lengths,
                                  float* out, int B, int W, int nkv, int G,
                                  int r2, int dc, int bs, int mb, float scale,
                                  void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, nullptr, nullptr, nullptr,
                ChainWalk{block_tables, lengths, mb, bs}, q_offsets, out, B, W,
                nkv, G, r2, dc, scale, stream);
}

extern "C" int elite_verify_paged_q8(
    const float* q_e, const float* q_lat, const int8_t* k_e, const int8_t* c_k,
    const int8_t* c_v, const float* k_s, const float* ck_s, const float* cv_s,
    const int* block_tables, const int* q_offsets, const int* lengths,
    float* out, int B, int W, int nkv, int G, int r2, int dc, int bs, int mb,
    float scale, void* stream) {
  return launch(q_e, q_lat, k_e, c_k, c_v, k_s, ck_s, cv_s,
                ChainWalk{block_tables, lengths, mb, bs}, q_offsets, out, B, W,
                nkv, G, r2, dc, scale, stream);
}
