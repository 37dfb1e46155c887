// Absorbed EliteKV decode and speculative-verify attention over the
// block-paged compressed cache, and decode over a contiguous cache: one
// templated split-KV kernel body behind seven entries.
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
// For serving lane b it computes, over the rows the lane's walk visits,
//     s[r, t] = (q_e[r] . k_e[t, h(r)] + q_lat[r] . c_k[t]) * scale
//     o[r]    = softmax_t(s[r]) . c_v[t]
// for every query row r of the lane: nw window positions times nh heads.
// A decode call has nw = 1 and no window mask.  A verify call scores nw =
// k+1 window tokens per lane in the same walk: window position w sits at
// q_offsets[b] + w and sees pool position pos = j*bs + t only if pos <=
// q_offsets[b] + w (besides pos < lengths[b], which the walk gives).  A
// masked score gets probability exactly 0.  q is read as [B, nw, nh, .]
// and o written as [B, nw, nh, dc] (always f32).  The body has two
// template parameters:
//   * the page element: float, or int8_t with one f32 scale per slot and
//     stream; each int8 element is multiplied by its slot's scale when the
//     staged tile is widened to f32 -- the single multiply of the plain
//     version's q.float() * scale;
//   * the walk, which yields the first row and the count n of each tile of
//     rows it visits: ChainWalk visits block_tables[b, j] for
//     j < ceil(len / bs) with n = min(bs, len - j*bs) rows; SelWalk visits
//     sel_tables[b, j] for j < W with n = sel_counts[b, j] rows and skips a
//     tile with n == 0; ContigWalk visits lane b's rows b*S + j*bs of a
//     contiguous [B, S, ...] cache for j < ceil(len / bs), with a partial
//     last tile.  A contiguous cache has the memory layout of pages
//     [B*S, ...] whose table is the identity, so ContigWalk reads it in
//     place; with S a multiple of bs it visits the rows ChainWalk visits over
//     the identity table, in the same tiles and order.
//
// What bounds it on the H100.  Decode: bytes.  Each visited token brings
// n_kv*2r + d_c elements (J-LRD; 2*d_c latent under S-LRD) -- 4 B each in
// f32, 1 B each in int8 plus 4 B of scale per slot and stream -- against
// about 4*nh*(2r + d_c) flops, a few flops per byte.  Verify: operations
// (TinyLlama at W = 5: ~90 flop/B, above the f32-FMA ridge of ~20).  At
// the main paths' sizes (8 lanes, ~1,000 rows each) both bounds are a few
// microseconds, so what limits the body is latency: how many SMs hold
// work, and how long one tile's load-score-accumulate round trip takes.
//
// What the design does about it:
//   * Split-KV.  The grid is (split, head group, lane).  The host cuts the
//     walk's width (mb, W or ceil(S / bs) tiles) into `splits` ranges of
//     `tps` tiles (kernels/elite_decode.py: plan).  tps is sized for two
//     CTAs per SM on a reference load (8 lanes of 64 tiles), from the
//     model's head groups and the card only -- never from lengths, the
//     batch or the walk's width -- so the plan needs no device read, a
//     lane's ranges (and bits) do not move when other lanes grow the table,
//     and the two sides of each bitwise identity below get the same plan.
//     At most dc splits.  A CTA walks
//     its range and writes a partial (m, l, acc) per row; a range past the
//     lane's end writes the empty partial (m = -1e30, l = 0).
//   * All query heads of as many kv heads as fit.  A CTA holds R = nw*G*gh
//     query rows for gh kv heads (all of them for TinyLlama: R = 32 at
//     decode, 160 at W = 5), so a latent tile is staged once per head group
//     instead of once per kv head.  gh is the largest divisor of n_kv whose
//     shared memory fits the card's opt-in limit (the host chooses it).
//     Where one kv head's rows of the whole window do not fit (LLaMA2-13B
//     at half cache, W = 5), the host cuts the window into parts of wc
//     positions, each part its own CTAs (grid y = parts * head groups), so
//     a CTA holds R = wc*G*gh rows; the walk, the ranges and every row's
//     arithmetic are the uncut call's.
//   * Asynchronous staging.  cp.async (16 B where the rows allow, else 4 B)
//     brings the query rows with the first tile and double-buffers the next
//     tile while the current one is scored; where two stages do not fit
//     (LLaMA2-7B S-LRD) one stage is used.  int8 tiles land raw and are
//     widened by their slot's scale into one f32 tile.
//   * Scoring on f32 FMA: LPR = next_pow2(bs) adjacent threads hold one
//     row's scores of a tile (one token each), so the tile's online-softmax
//     update is a butterfly over those lanes with no extra barrier; each
//     thread scores up to 4 rows per pass against one float4 read of the
//     latent row, then acc += P c_v with a float4 of acc per thread.
//     Shared strides of 4*odd floats keep the float4 reads conflict-free.
//     (A 3xTF32 tensor-core body for the two products was built and timed
//     beside this one and was not faster at the main paths' shapes; the
//     times are in PERF.md.)
//   * In-kernel combine.  Each CTA writes its partial, fences and counts
//     itself in on a per-(lane, group) counter; the last to arrive merges
//     the partials in ascending split order and sets the counter back to
//     0: per row M = max m_i and the weights w_i = e^(m_i - M) (0 for an
//     empty partial, whose acc is never read) go to shared memory, then
//     o = sum acc_i w_i / max(sum l_i w_i, 1e-30) with the partials' loads
//     in flight together.  No second launch; repeated calls give identical
//     bits.  Counters and partials are per-device scratch of the wrapper;
//     calls are ordered by their stream (one stream at a time).
//   * An optional log-sum-exp (the contiguous entry's lse pointer; nullptr
//     in every other entry).  The same combine writes each row's natural
//     log of sum_t e^(s[r, t]), M + log(sum_i l_i w_i), or -inf for a lane
//     with no visited row: what a caller needs to merge pieces of one
//     cache attended apart (the sequence-sharded decode, kernels/ops.py),
//     as the reference's softmax reduces across shards under GSPMD.  It
//     reads what the merge already holds and changes no other output.
// A row's arithmetic -- its dot product order, its softmax butterfly, its
// accumulation -- depends on neither R, gh nor nw, and each identity's two
// sides share the plan, so a verify window of one token at
// q_offsets = lengths - 1 gives decode's bits; a full-width selection
// (tiles with n == 0 add nothing, and W = mb gives the chain's plan) gives
// the dense bits; ContigWalk gives ChainWalk's bits over identity pages.
// An empty lane writes exact zeros.  r2 and dc must be multiples of 4 and
// bs <= 32; the wrapper checks.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerPass = 4;     // query rows one thread scores per pass
constexpr float kMasked = -1e30f;   // a score outside the window's mask
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }
__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
// a row stride of 4*odd floats: float4 reads of 8 rows at one column fall
// in 8 distinct bank quads
__host__ __device__ inline int odd_quads(int x) { return 4 * ((round4(x) / 4) | 1); }

// Shared memory of one CTA, as offsets in floats (every region 16-byte
// aligned): q_e rows [R, r2], q_lat rows [R, dc], acc [R, dc], probs
// [R, bs], m / l / alpha [R], a flag; then the f32 tiles (stages of them for
// f32 pages, one for int8) of [k_e for gh heads | c_k | c_v (S-LRD)], and for
// int8 pages `stages` raw tiles plus their scales.
struct Layout {
  int KS, CS, KRB, CRB;
  int qe, ql, acc, p, m, l, alpha, flag, tile, tile_floats, raw, raw_floats, total;
};

__host__ __device__ inline Layout make_layout(int R, int gh, int bs, int r2, int dc,
                                              bool shared_cv, bool q8, int stages) {
  Layout L;
  L.KS = odd_quads(gh * r2);
  L.CS = odd_quads(dc);
  L.KRB = round16(gh * r2);
  L.CRB = round16(dc);
  const int lat = shared_cv ? 1 : 2;
  L.qe = 0;
  L.ql = L.qe + round4(R * r2);
  L.acc = L.ql + round4(R * dc);
  L.p = L.acc + round4(R * dc);
  L.m = L.p + round4(R * bs);
  L.l = L.m + round4(R);
  L.alpha = L.l + round4(R);
  L.flag = L.alpha + round4(R);
  L.tile = L.flag + 4;
  L.tile_floats = bs * (L.KS + lat * L.CS);
  L.raw = L.tile + (q8 ? 1 : stages) * L.tile_floats;
  L.raw_floats = (bs * (L.KRB + lat * L.CRB) + 3 * 4 * round4(bs)) / 4;
  L.total = L.raw + (q8 ? stages * L.raw_floats : 0);
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows x cols bytes from src (row stride sstride) to shared dst (row stride
// dstride), issued by the whole CTA; 16-byte copies where every address and
// stride allows, else 4-byte ones (the wrapper guarantees 4-byte alignment).
__device__ __forceinline__ void copy_rows(char* dst, int dstride, const char* src,
                                          long sstride, int rows, int cols) {
  const bool v16 = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst) |
                     (uintptr_t)sstride | (uintptr_t)dstride | (uintptr_t)cols) & 15) == 0;
  const int unit = v16 ? 16 : 4;
  const int per = cols / unit;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i - r * per) * unit;
    if (v16)
      cp_async16(dst + r * dstride + c, src + r * sstride + c);
    else
      cp_async4(dst + r * dstride + c, src + r * sstride + c);
  }
}

__device__ __forceinline__ float dot4(float4 q, float4 k, float a) {
  a = fmaf(q.x, k.x, a);
  a = fmaf(q.y, k.y, a);
  a = fmaf(q.z, k.z, a);
  return fmaf(q.w, k.w, a);
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

template <typename T>
struct Pages {
  const T* k_e;
  const T* c_k;
  const T* c_v;
  const float* k_s;    // int8 only: per-slot scales
  const float* ck_s;
  const float* cv_s;
};

// Issue the copies of one tile (n rows from pool row `base`) into stage
// `buf`: f32 pages straight into an f32 tile, int8 pages into a raw tile.
template <typename T>
__device__ void stage_tile(const Layout& L, float* smem, int buf, const Pages<T>& pg,
                           long base, int n, int nkv, int h0, int gh, int r2, int dc,
                           int bs, bool shared_cv) {
  constexpr int es = sizeof(T);
  char *ke, *ck, *cv;
  int kstride, cstride;
  if (es == 4) {
    float* t = smem + L.tile + buf * L.tile_floats;
    ke = reinterpret_cast<char*>(t);
    ck = reinterpret_cast<char*>(t + bs * L.KS);
    cv = reinterpret_cast<char*>(t + bs * (L.KS + L.CS));
    kstride = 4 * L.KS;
    cstride = 4 * L.CS;
  } else {
    ke = reinterpret_cast<char*>(smem + L.raw + buf * L.raw_floats);
    ck = ke + bs * L.KRB;
    cv = ck + bs * L.CRB;
    kstride = L.KRB;
    cstride = L.CRB;
  }
  copy_rows(ke, kstride, reinterpret_cast<const char*>(pg.k_e + (base * nkv + h0) * r2),
            (long)nkv * r2 * es, n, gh * r2 * es);
  copy_rows(ck, cstride, reinterpret_cast<const char*>(pg.c_k + base * dc), (long)dc * es,
            n, dc * es);
  if (!shared_cv)
    copy_rows(cv, cstride, reinterpret_cast<const char*>(pg.c_v + base * dc), (long)dc * es,
              n, dc * es);
  if (es == 1) {   // the slots' scales, after the raw rows
    float* s = reinterpret_cast<float*>(ck + (shared_cv ? 1 : 2) * bs * L.CRB);
    for (int i = threadIdx.x; i < 3 * n; i += kThreads) {
      const int k = i / n, t = i - k * n;
      const float* src = k == 0 ? pg.k_s : k == 1 ? pg.ck_s : pg.cv_s;
      cp_async4(s + k * round4(bs) + t, src + base + t);
    }
  }
}

// int8 only: widen raw stage `buf` into the f32 tile, each element times
// its slot's scale (the plain version's single multiply).
__device__ void widen_tile(const Layout& L, float* smem, int buf, int n, int gh, int r2,
                           int dc, int bs, bool shared_cv) {
  const int8_t* ke = reinterpret_cast<const int8_t*>(smem + L.raw + buf * L.raw_floats);
  const int8_t* ck = ke + bs * L.KRB;
  const int8_t* cv = ck + bs * L.CRB;
  const float* s = reinterpret_cast<const float*>(ck + (shared_cv ? 1 : 2) * bs * L.CRB);
  float* t = smem + L.tile;
  const int kw = gh * r2;
  for (int i = threadIdx.x; i < n * kw; i += kThreads) {
    const int r = i / kw, c = i - r * kw;
    t[r * L.KS + c] = static_cast<float>(ke[r * L.KRB + c]) * s[r];
  }
  float* tc = t + bs * L.KS;
  float* tv = tc + bs * L.CS;
  for (int i = threadIdx.x; i < n * dc; i += kThreads) {
    const int r = i / dc, c = i - r * dc;
    tc[r * L.CS + c] = static_cast<float>(ck[r * L.CRB + c]) * s[round4(bs) + r];
    if (!shared_cv)
      tv[r * L.CS + c] = static_cast<float>(cv[r * L.CRB + c]) * s[2 * round4(bs) + r];
  }
}

template <typename T, typename Walk>
__global__ void __launch_bounds__(kThreads) decode_kernel(
    const float* __restrict__ q_e, const float* __restrict__ q_lat, Pages<T> pg,
    Walk walk, const int* __restrict__ q_off, float* __restrict__ out,
    float* __restrict__ lse, float* __restrict__ partials, int* __restrict__ counters, int nw, int wc, int nkv,
    int G, int r2, int dc, float scale, int gh, int tps, int stages, bool shared_cv) {
  // blockIdx.y = window part * head groups + head group
  const int s_idx = blockIdx.x, b = blockIdx.z;
  const int splits = gridDim.x, n_units = gridDim.y, n_groups = nkv / gh;
  const int grp = blockIdx.y % n_groups, w0 = blockIdx.y / n_groups * wc;
  const int tid = threadIdx.x;
  const int bs = walk.bs;
  const int nh = nkv * G;
  const int RG = gh * G;      // query rows per window position
  const int RW = wc * RG;     // rows of a full window part: the layout's and the partials'
  const int R = min(wc, nw - w0) * RG;   // row r: window position w0 + r / RG,
                                         // head grp*RG + r % RG
  const int E4 = r2 / 4, DC4 = dc / 4;
  const Layout L = make_layout(RW, gh, bs, r2, dc, shared_cv, sizeof(T) == 1, stages);
  extern __shared__ __align__(16) float smem[];
  float* qe = smem + L.qe;
  float* ql = smem + L.ql;
  float4* acc4 = reinterpret_cast<float4*>(smem + L.acc);
  float* ps = smem + L.p;
  float* ms = smem + L.m;
  float* ls = smem + L.l;
  float* als = smem + L.alpha;
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  // the group's query rows of this window part: R / RG runs of RG
  // contiguous heads each, copied asynchronously with the first tile
  const long q0 = ((long)b * nw + w0) * nh + grp * RG;
  copy_rows(reinterpret_cast<char*>(qe), RG * r2 * 4,
            reinterpret_cast<const char*>(q_e + q0 * r2), (long)nh * r2 * 4, R / RG,
            RG * r2 * 4);
  copy_rows(reinterpret_cast<char*>(ql), RG * dc * 4,
            reinterpret_cast<const char*>(q_lat + q0 * dc), (long)nh * dc * 4, R / RG,
            RG * dc * 4);
  for (int i = tid; i < R * DC4; i += kThreads) acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = tid; r < R; r += kThreads) {
    ms[r] = kMasked;
    ls[r] = 0.f;
  }

  int len = 0;
  const int n_steps = walk.steps(b, len);
  const int j0 = s_idx * tps, j1 = min(j0 + tps, n_steps);
  const int qo = q_off ? q_off[b] + w0 : 0;   // the window part's first position
  const int h0 = grp * gh;
  int lpr = 1;                           // lanes per row: one per token of a tile
  while (lpr < bs) lpr *= 2;
  const int n_slots = kThreads / lpr;
  const int t = tid & (lpr - 1), slot = tid / lpr;
  const int n_pass = (R + n_slots * kRowsPerPass - 1) / (n_slots * kRowsPerPass);
  bool any = false;

  if (stages == 2 && j0 < j1) {
    int n;
    const long base = walk.rows(b, j0, len, n);
    stage_tile(L, smem, 0, pg, base, n, nkv, h0, gh, r2, dc, bs, shared_cv);
  }
  for (int j = j0; j < j1; ++j) {
    const int buf = stages == 2 ? (j - j0) & 1 : 0;
    int n;
    const long base = walk.rows(b, j, len, n);
    if (stages == 1) {
      __syncthreads();                   // the previous tile fully consumed
      stage_tile(L, smem, 0, pg, base, n, nkv, h0, gh, r2, dc, bs, shared_cv);
    }
    cp_async_wait_all();
    __syncthreads();                     // tile j landed; tile j-1 consumed
    if (stages == 2 && j + 1 < j1) {
      int n1;
      const long base1 = walk.rows(b, j + 1, len, n1);
      stage_tile(L, smem, buf ^ 1, pg, base1, n1, nkv, h0, gh, r2, dc, bs, shared_cv);
    }
    if (n <= 0) continue;                // uniform across the CTA
    any = true;
    const float* tile = smem + L.tile + (sizeof(T) == 4 ? buf * L.tile_floats : 0);
    if (sizeof(T) == 1) {
      widen_tile(L, smem, buf, n, gh, r2, dc, bs, shared_cv);
      __syncthreads();
    }
    const float4* ke4 = reinterpret_cast<const float4*>(tile);
    const float4* ck4 = reinterpret_cast<const float4*>(tile + bs * L.KS);
    const float4* cv4 = shared_cv ? ck4 : reinterpret_cast<const float4*>(tile + bs * (L.KS + L.CS));
    const int ks4 = L.KS / 4, cs4 = L.CS / 4;
    // scores and the online-softmax update; the loop bounds are uniform, so
    // every lane reaches the shuffles
    for (int pass = 0; pass < n_pass; ++pass) {
      int rr[kRowsPerPass];
      float a[kRowsPerPass];
#pragma unroll
      for (int i = 0; i < kRowsPerPass; ++i) {
        rr[i] = slot + n_slots * (pass * kRowsPerPass + i);
        a[i] = 0.f;
      }
      if (t < n) {
        const float4* kc = ck4 + t * cs4;
        for (int d4 = 0; d4 < DC4; ++d4) {
          const float4 k = kc[d4];
#pragma unroll
          for (int i = 0; i < kRowsPerPass; ++i)
            if (rr[i] < R)
              a[i] = dot4(reinterpret_cast<const float4*>(ql)[rr[i] * DC4 + d4], k, a[i]);
        }
#pragma unroll
        for (int i = 0; i < kRowsPerPass; ++i)
          if (rr[i] < R) {
            const int g = (rr[i] % RG) / G;
            const float4* kr = ke4 + t * ks4 + g * E4;
            const float4* qr = reinterpret_cast<const float4*>(qe) + rr[i] * E4;
            for (int e4 = 0; e4 < E4; ++e4) a[i] = dot4(qr[e4], kr[e4], a[i]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerPass; ++i) {
        const int r = rr[i];
        const bool live = r < R;
        float sv = kMasked;
        if (live && t < n)
          sv = q_off && j * bs + t > qo + r / RG ? kMasked : a[i] * scale;
        float mx = sv;
        for (int o = lpr / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        const float m_old = live ? ms[r] : kMasked;
        const float m_new = fmaxf(m_old, mx);
        // a masked score's probability is exactly 0 whatever the running max
        const float pr = sv == kMasked ? 0.f : expf(sv - m_new);
        float sum = pr;
        for (int o = lpr / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(kFull, sum, o);
        if (live && t < n) ps[r * bs + t] = pr;
        if (live && t == 0) {
          const float al = expf(m_old - m_new);
          als[r] = al;
          ls[r] = ls[r] * al + sum;
          ms[r] = m_new;
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < R * DC4; i += kThreads) {
      const int r = i / DC4, d4 = i - r * DC4;
      const float al = als[r];
      float4 v = acc4[i];
      v.x *= al;
      v.y *= al;
      v.z *= al;
      v.w *= al;
      const float* pr = ps + r * bs;
      for (int tt = 0; tt < n; ++tt) {
        const float pv = pr[tt];
        const float4 c = cv4[tt * cs4 + d4];
        v.x = fmaf(pv, c.x, v.x);
        v.y = fmaf(pv, c.y, v.y);
        v.z = fmaf(pv, c.z, v.z);
        v.w = fmaf(pv, c.w, v.w);
      }
      acc4[i] = v;
    }
  }

  cp_async_wait_all();                   // no copy in flight (a CTA with no tile)

  // this split's partial: acc [R, dc] (only if it visited a row), m and l
  // [R], in slots of RW rows
  const long bg = (long)b * n_units + blockIdx.y;
  const long acc_region = (long)gridDim.z * n_units * splits * RW * dc;
  float4* pacc = reinterpret_cast<float4*>(partials);
  float* pm = partials + acc_region;     // [B * units * splits][2][RW]
  if (any)
    for (int i = tid; i < R * DC4; i += kThreads)
      pacc[(bg * splits + s_idx) * RW * DC4 + i] = acc4[i];
  for (int r = tid; r < R; r += kThreads) {
    pm[((bg * splits + s_idx) * 2) * RW + r] = ms[r];
    pm[((bg * splits + s_idx) * 2 + 1) * RW + r] = ls[r];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counters + bg, 1);
    const int last = prev == splits - 1;
    if (last) counters[bg] = 0;           // ready for the next call on the stream
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __syncthreads();                        // every thread has read the flag
  __threadfence();
  // the last CTA of (lane, group) merges the partials in ascending split
  // order: per row the weights e^(m_i - M) (0 for an empty partial) into
  // shared memory [R, splits] (the host keeps splits <= dc, so they fit in
  // the q_lat and acc rows), then o = sum_i acc_i w_i / max(sum_i l_i w_i, 1e-30)
  float* wsm = smem + L.ql;               // m_i, then w_i
  float* lsm = wsm + R * splits;          // l_i
  float* den = smem + L.p;                // [R]
  for (int i = tid; i < R * splits; i += kThreads) {
    const int r = i / splits, s = i - r * splits;
    wsm[i] = __ldcg(pm + ((bg * splits + s) * 2) * RW + r);
    lsm[i] = __ldcg(pm + ((bg * splits + s) * 2 + 1) * RW + r);
  }
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) {
    float M = kMasked;
    for (int s = 0; s < splits; ++s)
      if (lsm[r * splits + s] > 0.f) M = fmaxf(M, wsm[r * splits + s]);
    float lsum = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float l = lsm[r * splits + s];
      const float w = l > 0.f ? expf(wsm[r * splits + s] - M) : 0.f;
      wsm[r * splits + s] = w;
      if (l > 0.f) lsum = fmaf(l, w, lsum);
    }
    den[r] = fmaxf(lsum, 1e-30f);
    if (lse) {                            // sum_t e^(s_t) = e^M * lsum
      const int w = r / RG, hh = r - w * RG;
      lse[((long)b * nw + w0 + w) * nh + grp * RG + hh] =
          lsum > 0.f ? M + logf(lsum) : -INFINITY;
    }
  }
  __syncthreads();
  for (int i = tid; i < R * DC4; i += kThreads) {
    const int r = i / DC4, d4 = i - r * DC4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < splits; ++s) {
      // loaded unconditionally so that loads overlap; an empty partial's
      // acc was never written, and its weight 0 keeps it out
      const float w = wsm[r * splits + s];
      const float4 v = __ldcg(pacc + (bg * splits + s) * RW * DC4 + i);
      if (w > 0.f) {
        o.x = fmaf(v.x, w, o.x);
        o.y = fmaf(v.y, w, o.y);
        o.z = fmaf(v.z, w, o.z);
        o.w = fmaf(v.w, w, o.w);
      }
    }
    const float dn = den[r];
    const int w = r / RG, hh = r - w * RG;
    float4* dst =
        reinterpret_cast<float4*>(out + (((long)b * nw + w0 + w) * nh + grp * RG + hh) * dc);
    dst[d4] = make_float4(o.x / dn, o.y / dn, o.z / dn, o.w / dn);
  }
}

// Sizes shared memory for this launch (opting in above 48 KB), launches on
// `stream` and returns cudaGetLastError() (0 on success).  c_k and c_v (and
// their scales) may be the same pointer (J-LRD), in which case the latent
// rows are staged once.  q_off == nullptr is decode (nw must be 1).  The
// plan (gh kv heads per CTA, splits of tps tiles, stages, and wc window
// positions per CTA) comes from the host: a window that one kv head per
// CTA cannot hold is cut into parts of wc positions, each its own CTAs
// (grid y = parts * head groups), which changes no row's arithmetic.
// partials holds B * units * splits * wc * G * gh * (dc + 2) floats and
// counters B * units zeros, units = ceil(nw / wc) * (nkv / gh).
template <typename T, typename Walk>
int launch(const float* q_e, const float* q_lat, Pages<T> pg, Walk walk, const int* q_off,
           float* out, float* lse, float* partials, int* counters, int B, int nw, int nkv, int G,
           int r2, int dc, float scale, int gh, int splits, int tps, int stages, int wc,
           void* stream) {
  if (gh < 1 || nkv % gh || r2 % 4 || dc % 4 || walk.bs < 1 || walk.bs > 32 ||
      splits < 1 || splits > dc || tps < 1 || (stages != 1 && stages != 2) || wc < 1 ||
      wc > nw)
    return (int)cudaErrorInvalidValue;
  auto kernel = decode_kernel<T, Walk>;
  const bool shared_cv = pg.c_k == pg.c_v && pg.ck_s == pg.cv_s;
  const Layout L = make_layout(wc * G * gh, gh, walk.bs, r2, dc, shared_cv, sizeof(T) == 1,
                               stages);
  const size_t bytes = (size_t)L.total * sizeof(float);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int parts = (nw + wc - 1) / wc;
  kernel<<<dim3(splits, parts * (nkv / gh), B), kThreads, bytes, (cudaStream_t)stream>>>(
      q_e, q_lat, pg, walk, q_off, out, lse, partials, counters, nw, wc, nkv, G, r2, dc, scale,
      gh, tps, stages, shared_cv);
  return (int)cudaGetLastError();
}

}  // namespace

// Pages: k_e [n_slots, nkv, r2], c_k / c_v [n_slots, dc]; q_e [B, nh, r2] and
// q_lat [B, nh, dc] f32 (verify: [B, W, nh, .]); out [B, nh, dc] f32
// (verify: [B, W, nh, dc]).  The q8 entries take int8 pages and f32 scales
// [n_slots] per stream.  The chain entries take block_tables [B, mb] and
// lengths [B]; the verify entries also q_offsets [B]; the sparse entries
// sel_tables and sel_counts [B, W]; all int32.  Every entry then takes the
// partials and counters scratch and the plan (gh, splits, tps, stages, wc;
// wc = 1 for decode, the window positions per CTA for verify).

// Shared memory per CTA of a call with nw window positions per CTA (1 for
// decode; wc for a cut window) and gh kv heads per CTA, and the card's
// opt-in limit for one block: the wrapper plans by them.
extern "C" long elite_decode_smem_bytes(int nw, int G, int gh, int bs, int r2, int dc,
                                        int shared_cv, int q8, int stages) {
  return (long)make_layout(nw * G * gh, gh, bs, r2, dc, shared_cv != 0, q8 != 0, stages)
             .total * (long)sizeof(float);
}

extern "C" int elite_decode_smem_optin(void) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
      cudaSuccess)
    return 0;
  return v;
}

// Loads every instantiation of the decode body on the current device now.
// CUDA loads a kernel lazily at its first launch, and loading waits for the
// whole context: a first launch behind a stream wait (a traced launch,
// kernels/build.py) would wait for itself.  Returns 0 or the CUDA error.
extern "C" int elite_decode_preload(void) {
  const void* fns[] = {(const void*)decode_kernel<float, ContigWalk>,
                       (const void*)decode_kernel<float, ChainWalk>,
                       (const void*)decode_kernel<int8_t, ChainWalk>,
                       (const void*)decode_kernel<float, SelWalk>,
                       (const void*)decode_kernel<int8_t, SelWalk>};
  cudaFuncAttributes attr;
  for (const void* fn : fns) {
    const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The contiguous cache: k_e [B, S, nkv, r2], c_k / c_v [B, S, dc], lengths
// [B]; rows staged in tiles of bs.  lse [B, nh] f32 or nullptr: where set,
// each row's natural log-sum-exp of its scaled scores over the visited rows
// (-inf for a lane with none), so that pieces of one cache attended apart
// can be merged (kernels/ref.py: merge_lse); out does not change with it.
extern "C" int elite_decode(const float* q_e, const float* q_lat, const float* k_e,
                            const float* c_k, const float* c_v, const int* lengths,
                            float* out, float* lse, float* partials, int* counters, int B,
                            int S, int nkv, int G, int r2, int dc, int bs, int gh,
                            int splits, int tps, int stages, int wc, float scale,
                            void* stream) {
  return launch(q_e, q_lat, Pages<float>{k_e, c_k, c_v, nullptr, nullptr, nullptr},
                ContigWalk{lengths, S, bs}, nullptr, out, lse, partials, counters, B, 1, nkv,
                G, r2, dc, scale, gh, splits, tps, stages, wc, stream);
}

extern "C" int elite_decode_paged(const float* q_e, const float* q_lat, const float* k_e,
                                  const float* c_k, const float* c_v,
                                  const int* block_tables, const int* lengths, float* out,
                                  float* partials, int* counters, int B, int nkv, int G,
                                  int r2, int dc, int bs, int mb, int gh, int splits,
                                  int tps, int stages, int wc, float scale, void* stream) {
  return launch(q_e, q_lat, Pages<float>{k_e, c_k, c_v, nullptr, nullptr, nullptr},
                ChainWalk{block_tables, lengths, mb, bs}, nullptr, out, nullptr, partials,
                counters, B, 1, nkv, G, r2, dc, scale, gh, splits, tps, stages, wc, stream);
}

extern "C" int elite_decode_paged_q8(const float* q_e, const float* q_lat,
                                     const int8_t* k_e, const int8_t* c_k,
                                     const int8_t* c_v, const float* k_s,
                                     const float* ck_s, const float* cv_s,
                                     const int* block_tables, const int* lengths,
                                     float* out, float* partials, int* counters, int B,
                                     int nkv, int G, int r2, int dc, int bs, int mb,
                                     int gh, int splits, int tps, int stages, int wc,
                                     float scale, void* stream) {
  return launch(q_e, q_lat, Pages<int8_t>{k_e, c_k, c_v, k_s, ck_s, cv_s},
                ChainWalk{block_tables, lengths, mb, bs}, nullptr, out, nullptr, partials,
                counters, B, 1, nkv, G, r2, dc, scale, gh, splits, tps, stages, wc, stream);
}

extern "C" int elite_decode_sparse_paged(const float* q_e, const float* q_lat,
                                         const float* k_e, const float* c_k,
                                         const float* c_v, const int* sel_tables,
                                         const int* sel_counts, float* out,
                                         float* partials, int* counters, int B, int nkv,
                                         int G, int r2, int dc, int bs, int W, int gh,
                                         int splits, int tps, int stages, int wc,
                                         float scale, void* stream) {
  return launch(q_e, q_lat, Pages<float>{k_e, c_k, c_v, nullptr, nullptr, nullptr},
                SelWalk{sel_tables, sel_counts, W, bs}, nullptr, out, nullptr, partials, counters,
                B, 1, nkv, G, r2, dc, scale, gh, splits, tps, stages, wc, stream);
}

extern "C" int elite_decode_sparse_paged_q8(
    const float* q_e, const float* q_lat, const int8_t* k_e, const int8_t* c_k,
    const int8_t* c_v, const float* k_s, const float* ck_s, const float* cv_s,
    const int* sel_tables, const int* sel_counts, float* out, float* partials,
    int* counters, int B, int nkv, int G, int r2, int dc, int bs, int W, int gh,
    int splits, int tps, int stages, int wc, float scale, void* stream) {
  return launch(q_e, q_lat, Pages<int8_t>{k_e, c_k, c_v, k_s, ck_s, cv_s},
                SelWalk{sel_tables, sel_counts, W, bs}, nullptr, out, nullptr, partials, counters,
                B, 1, nkv, G, r2, dc, scale, gh, splits, tps, stages, wc, stream);
}

extern "C" int elite_verify_paged(const float* q_e, const float* q_lat, const float* k_e,
                                  const float* c_k, const float* c_v,
                                  const int* block_tables, const int* q_offsets,
                                  const int* lengths, float* out, float* partials,
                                  int* counters, int B, int W, int nkv, int G, int r2,
                                  int dc, int bs, int mb, int gh, int splits, int tps,
                                  int stages, int wc, float scale, void* stream) {
  return launch(q_e, q_lat, Pages<float>{k_e, c_k, c_v, nullptr, nullptr, nullptr},
                ChainWalk{block_tables, lengths, mb, bs}, q_offsets, out, nullptr, partials,
                counters, B, W, nkv, G, r2, dc, scale, gh, splits, tps, stages, wc, stream);
}

extern "C" int elite_verify_paged_q8(
    const float* q_e, const float* q_lat, const int8_t* k_e, const int8_t* c_k,
    const int8_t* c_v, const float* k_s, const float* ck_s, const float* cv_s,
    const int* block_tables, const int* q_offsets, const int* lengths, float* out,
    float* partials, int* counters, int B, int W, int nkv, int G, int r2, int dc, int bs,
    int mb, int gh, int splits, int tps, int stages, int wc, float scale, void* stream) {
  return launch(q_e, q_lat, Pages<int8_t>{k_e, c_k, c_v, k_s, ck_s, cv_s},
                ChainWalk{block_tables, lengths, mb, bs}, q_offsets, out, nullptr, partials,
                counters, B, W, nkv, G, r2, dc, scale, gh, splits, tps, stages, wc, stream);
}
