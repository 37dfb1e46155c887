// Causal GQA flash attention with per-lane offsets: prefill, chunked
// prefill and the baseline model's decode.
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill.py::flash_prefill
// (pallas_call at :126, body _kernel at :49).  q [B, Sq, nh, dh], k/v
// [B, Sk, nkv, dh], q_offsets/kv_lens [B] int32 -> o [B, Sq, nh, dh].  Key j
// is visible to query i of lane b iff j <= i + q_offsets[b] and
// j < kv_lens[b]; query head h reads kv head h / G through the index (K/V
// are never repeated).  Masked scores are -1e30, and the finish is
// acc / max(l, 1e-30), so a query with no visible key (kv_len = 0) writes
// exact zeros.  Sq and Sk need not be multiples of the tiles: the ragged
// edges are masked here.  Head dims 32, 64 and 128.
//
// Two bodies; the host picks one from the shapes alone (G * Sq), never from
// q_offsets or kv_lens (kernels/flash_prefill.py: plan):
//
// * Decode body, for at most kDecRows query rows per kv head (G * Sq <= 16:
//   the baseline's decode, one token per lane).  What bounds it: bytes --
//   each visible K/V row (2 * dh floats) is read once for G * Sq query rows,
//   about one flop per byte.  Design: the grid is (key range, kv head,
//   lane); a CTA takes every query row that reads its kv head, so each K/V
//   row leaves device memory once, not G times.  The keys are cut into
//   ranges of kRangeKeys, a constant, so a lane's ranges depend on its own
//   kv_len only; Sk sets just the count of trailing ranges, which see
//   nothing and write l = 0.  Tiles of kDecTile keys come in by cp.async
//   (16 B), two in flight.  Scores on f32 FMA (a warp's lanes are a tile's
//   keys, float4 reads of conflict-free rows), the online softmax by warp
//   shuffles, then acc += P V with a float4 of acc per thread.  Each CTA
//   writes a partial (m, l, acc) per row; the last CTA of a (lane, kv head)
//   -- a fence, an atomic on a counter that it sets back to 0 -- merges the
//   partials in ascending range order, skipping l = 0 exactly, in the same
//   launch.  So a lane's bits do not depend on the other lanes' kv_len or
//   on Sk.  Partials and counters are scratch of the wrapper.
//
// * Prefill body, for everything else.  What bounds it: operations, about
//   4 * dh flops per visible (query, key) pair against 4 * dh bytes per key
//   row.  Design, FlashAttention-2 style: a CTA of 4 warps takes 64 query
//   rows of one query head, 16 rows per warp; K/V tiles of kBK = 32 keys
//   come in by cp.async (16 B), double-buffered, only up to min(last row +
//   q_offset + 1, kv_len), so tiles above the diagonal or past the live
//   keys are never loaded.  Both
//   products run on the tensor cores in 3xTF32 (mma.sync m16n8k8): each f32
//   operand is split into a TF32 high part and a TF32 low part, and each
//   8-deep step sums lo*hi + hi*lo + hi*hi from zero, then adds it to the
//   running f32 accumulator in IEEE f32 (summing into the running
//   accumulator inside the tensor core loses more).  Scores and the online
//   softmax stay in registers (row reductions by quad shuffles).  P goes
//   from the score fragments straight into the A fragments of P V: a
//   thread holds keys 2t and 2t+1 of each 8-key step, which become A's
//   columns t and t+4, with V's rows read in the same order -- so P never
//   passes through shared memory.  Query tiles run heaviest first (the
//   grid's x is reversed), which evens out the causal imbalance.  The bound
//   at the tensor cores' 3xTF32 rate is 495 / 3 TFLOP/s; at the plain f32
//   rate 67 TFLOP/s (PERF.md gives both).  Timed in turns on the card,
//   tiles of 64 keys, 8 warps per CTA, four CTAs per SM forced, lo products
//   kept in their own accumulators, and a plain-f32 body with 8 x 8
//   register tiles were all as fast or slower (PERF.md); mma.sync is not
//   Hopper's full tensor-core rate (wgmma is).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr float kMasked = -1e30f;   // a masked score
constexpr unsigned kFull = 0xffffffffu;

// decode body
constexpr int kDecThreads = 128;
constexpr int kDecRows = 16;        // most query rows (G * Sq) per kv head
constexpr int kRangeKeys = 128;     // keys per range (kernels/flash_prefill.py: RANGE_KEYS)
constexpr int kDecTile = 32;        // keys per staged tile: one per lane of a warp

// prefill body
constexpr int kPreThreads = 128;    // 4 warps x 16 query rows
constexpr int kBQ = 64;             // query rows per CTA
constexpr int kBK = 32;             // keys per K/V tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = fill ? 16 : 0;      // 0: write zeros, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = fill ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// `rows` rows of `cols` floats from src (row stride sstride floats) to
// shared dst (row stride dstride floats), issued by the whole CTA; rows at
// or past `valid` are zero-filled and their source is not read.  16-byte
// copies when v16 (every pointer 16-byte aligned), else 4-byte ones.
template <int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, int dstride, const float* src,
                                           long sstride, int rows, int valid, int cols,
                                           bool v16) {
  if (v16) {
    const int per = cols / 4;
    for (int i = threadIdx.x; i < rows * per; i += THREADS) {
      const int r = i / per, c = (i - r * per) * 4;
      const bool ok = r < valid;
      cp_async16(dst + r * dstride + c, src + (ok ? r * sstride + c : 0), ok);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
      const int r = i / cols, c = i - r * cols;
      const bool ok = r < valid;
      cp_async4(dst + r * dstride + c, src + (ok ? r * sstride + c : 0), ok);
    }
  }
}

__device__ __forceinline__ float dot4(float4 q, float4 k, float a) {
  a = fmaf(q.x, k.x, a);
  a = fmaf(q.y, k.y, a);
  a = fmaf(q.z, k.z, a);
  return fmaf(q.w, k.w, a);
}

// ---------------------------------------------------------------- decode body

// Shared memory of a decode CTA, in floats: q rows [kDecRows][DH], K and V
// tiles [2][kDecTile][DH + 4] each, probabilities [kDecRows][kDecTile],
// alpha, the merge's M and denominator [kDecRows] each, a flag.
template <int DH>
struct DecLayout {
  static constexpr int S = DH + 4;  // 4 * odd quads: float4 reads of 8 rows conflict-free
  static constexpr int q = 0;
  static constexpr int k = q + kDecRows * DH;
  static constexpr int v = k + 2 * kDecTile * S;
  static constexpr int p = v + 2 * kDecTile * S;
  static constexpr int alpha = p + kDecRows * kDecTile;
  static constexpr int mx = alpha + kDecRows;
  static constexpr int den = mx + kDecRows;
  static constexpr int flag = den + kDecRows;
  static constexpr int total = flag + 4;
};

template <int DH>
__global__ void __launch_bounds__(kDecThreads) flash_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ q_offsets, const int* __restrict__ kv_lens,
    float* __restrict__ o, float* __restrict__ partials, int* __restrict__ counters,
    int Sq, int Sk, int nh, int nkv, int G, float scale, bool v16) {
  using L = DecLayout<DH>;
  constexpr int DH4 = DH / 4, S = L::S;
  constexpr int kOut = (kDecRows * DH4 + kDecThreads - 1) / kDecThreads;  // float4s of acc
  const int ri = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int n_ranges = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int R = G * Sq;           // row r: query i = r / G of head hk * G + r % G
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm + L::q;
  float* Ks = sm + L::k;
  float* Vs = sm + L::v;
  float* Ps = sm + L::p;
  float* As = sm + L::alpha;
  int* flag = reinterpret_cast<int*>(sm + L::flag);

  const int off = q_offsets[b], kvl = kv_lens[b];
  const int kend = max(0, min(min(Sq + off, kvl), Sk));   // keys any row of the lane sees
  const int k0 = ri * kRangeKeys, k1 = min(k0 + kRangeKeys, kend);
  const int n_t = k1 > k0 ? (k1 - k0 + kDecTile - 1) / kDecTile : 0;
  const long kv_row = (long)nkv * DH;
  const float* kb = k + ((long)b * Sk * nkv + hk) * DH;
  const float* vb = v + ((long)b * Sk * nkv + hk) * DH;

  float m_r[4], l_r[4];           // rows warp + 4 j, held by every lane of the warp
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    m_r[j] = kMasked;
    l_r[j] = 0.f;
  }
  float4 acc[kOut];
#pragma unroll
  for (int u = 0; u < kOut; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (n_t > 0) {
    // the G heads of one query are contiguous: Sq runs of G * DH floats
    stage_rows<kDecThreads>(Qs, G * DH, q + ((long)b * Sq * nh + hk * G) * DH,
                            (long)nh * DH, Sq, Sq, G * DH, v16);
    const int n0 = min(kDecTile, k1 - k0);
    stage_rows<kDecThreads>(Ks, S, kb + k0 * kv_row, kv_row, kDecTile, n0, DH, v16);
    stage_rows<kDecThreads>(Vs, S, vb + k0 * kv_row, kv_row, kDecTile, n0, DH, v16);
  }
  for (int t = 0; t < n_t; ++t) {
    const int buf = t & 1, t0 = k0 + t * kDecTile;
    const int n = min(kDecTile, k1 - t0);
    cp_async_wait_all();
    __syncthreads();              // tile t landed; tile t - 1 consumed
    if (t + 1 < n_t) {
      const int t1 = t0 + kDecTile, n1 = min(kDecTile, k1 - t1);
      stage_rows<kDecThreads>(Ks + (buf ^ 1) * kDecTile * S, S, kb + t1 * kv_row, kv_row,
                              kDecTile, n1, DH, v16);
      stage_rows<kDecThreads>(Vs + (buf ^ 1) * kDecTile * S, S, vb + t1 * kv_row, kv_row,
                              kDecTile, n1, DH, v16);
    }
    const float* Kt = Ks + buf * kDecTile * S;
    const float4* Vt = reinterpret_cast<const float4*>(Vs + buf * kDecTile * S);
    // scores: lane = key of the tile, rows warp + 4 j
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    const float4* kr = reinterpret_cast<const float4*>(Kt + lane * S);
    const float4* q4 = reinterpret_cast<const float4*>(Qs);
    for (int d4 = 0; d4 < DH4; ++d4) {
      const float4 kk = kr[d4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (warp + 4 * j < R) a[j] = dot4(q4[(warp + 4 * j) * DH4 + d4], kk, a[j]);
    }
    const int kp = t0 + lane;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp + 4 * j;
      if (r >= R) break;          // uniform across the warp
      const bool vis = lane < n && kp <= r / G + off;
      const float s = vis ? a[j] * scale : kMasked;
      float mx = s;
      for (int o2 = 16; o2 > 0; o2 >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o2));
      const float m_new = fmaxf(m_r[j], mx);
      const float p = vis ? expf(s - m_new) : 0.f;
      float sum = p;
      for (int o2 = 16; o2 > 0; o2 >>= 1) sum += __shfl_xor_sync(kFull, sum, o2);
      const float al = expf(m_r[j] - m_new);
      l_r[j] = l_r[j] * al + sum;
      m_r[j] = m_new;
      Ps[r * kDecTile + lane] = p;
      if (lane == 0) As[r] = al;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int i = tid + kDecThreads * u, r = i / DH4, d4 = i - r * DH4;
      if (r >= R) continue;
      const float al = As[r];
      float4 x = acc[u];
      x.x *= al;
      x.y *= al;
      x.z *= al;
      x.w *= al;
      const float* pr = Ps + r * kDecTile;
      for (int c = 0; c < n; ++c) {
        const float pv = pr[c];
        const float4 vv = Vt[c * (S / 4) + d4];
        x.x = fmaf(pv, vv.x, x.x);
        x.y = fmaf(pv, vv.y, x.y);
        x.z = fmaf(pv, vv.z, x.z);
        x.w = fmaf(pv, vv.w, x.w);
      }
      acc[u] = x;
    }
  }
  cp_async_wait_all();

  // this range's partial: acc [R][DH] (only if it saw a key), m and l [R]
  const long bg = (long)b * nkv + hk;
  const long slot = bg * n_ranges + ri;
  float4* pacc = reinterpret_cast<float4*>(partials);
  float* pml = partials + (long)gridDim.z * nkv * n_ranges * R * DH;  // [slot][2][R]
  if (n_t > 0) {
#pragma unroll
    for (int u = 0; u < kOut; ++u) {
      const int i = tid + kDecThreads * u;
      if (i < R * DH4) pacc[slot * R * DH4 + i] = acc[u];
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = warp + 4 * j;
      if (r < R) {
        pml[slot * 2 * R + r] = m_r[j];
        pml[(slot * 2 + 1) * R + r] = l_r[j];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int prev = atomicAdd(counters + bg, 1);
    const int last = prev == n_ranges - 1;
    if (last) counters[bg] = 0;   // ready for the next call on the stream
    *flag = last;
  }
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  // the last CTA of (lane, kv head) merges in ascending range order: per row
  // M = max m_i over ranges with l_i > 0, w_i = e^(m_i - M), then
  // o = sum acc_i w_i / max(sum l_i w_i, 1e-30), ranges with l_i = 0 skipped
  float* Ms = sm + L::mx;
  float* Dn = sm + L::den;
  const float* pm0 = pml + bg * n_ranges * 2 * R;
  for (int r = tid; r < R; r += kDecThreads) {
    float M = kMasked;
    for (int s = 0; s < n_ranges; ++s)
      if (__ldcg(pm0 + (2 * s + 1) * R + r) > 0.f) M = fmaxf(M, __ldcg(pm0 + 2 * s * R + r));
    float lsum = 0.f;
    for (int s = 0; s < n_ranges; ++s) {
      const float l = __ldcg(pm0 + (2 * s + 1) * R + r);
      if (l > 0.f) lsum = fmaf(l, expf(__ldcg(pm0 + 2 * s * R + r) - M), lsum);
    }
    Ms[r] = M;
    Dn[r] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kOut; ++u) {
    const int i = tid + kDecThreads * u, r = i / DH4, d4 = i - r * DH4;
    if (r >= R) continue;
    const float M = Ms[r];
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < n_ranges; ++s) {
      const float l = __ldcg(pm0 + (2 * s + 1) * R + r);
      if (l > 0.f) {
        const float w = expf(__ldcg(pm0 + 2 * s * R + r) - M);
        const float4 y = __ldcg(pacc + (bg * n_ranges + s) * R * DH4 + i);
        x.x = fmaf(y.x, w, x.x);
        x.y = fmaf(y.y, w, x.y);
        x.z = fmaf(y.z, w, x.z);
        x.w = fmaf(y.w, w, x.w);
      }
    }
    const float dn = Dn[r];
    const int qi = r / G, g = r - qi * G;
    float4* dst = reinterpret_cast<float4*>(o + (((long)b * Sq + qi) * nh + hk * G + g) * DH);
    dst[d4] = make_float4(x.x / dn, x.y / dn, x.z / dn, x.w / dn);
  }
}

// --------------------------------------------------------------- prefill body

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo with hi, lo TF32 (lo carries the next 11 bits)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b over one m16n8k8 tile, TF32 inputs, f32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc += a b for one 8-deep step in 3xTF32: the step is summed from zero in
// the tensor core (small terms first), then added to acc in IEEE f32
__device__ __forceinline__ void mma3(float (&acc)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4], const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, bh);
  mma_tf32(t, ah, bl);
  mma_tf32(t, ah, bh);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

// Shared memory of a prefill CTA, in floats: the Q tile [kBQ][DH + 4] and
// K and V tiles [2][kBK][DH + 4] each.  With rows of DH + 4 floats a
// fragment's load (8 rows x 4 columns, or V's rows 2 t and 2 t + 1) falls
// in 32 distinct banks.
template <int DH>
struct PreLayout {
  static constexpr int S = DH + 4;
  static constexpr int q = 0;
  static constexpr int k = q + kBQ * S;
  static constexpr int v = k + 2 * kBK * S;
  static constexpr int total = v + 2 * kBK * S;
};

template <int DH>
__global__ void __launch_bounds__(kPreThreads) flash_prefill_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const int* __restrict__ q_offsets, const int* __restrict__ kv_lens,
    float* __restrict__ o, int Sq, int Sk, int nh, int nkv, int G, float scale, bool v16) {
  using L = PreLayout<DH>;
  constexpr int BK = kBK, BQ = kBQ, S = L::S, THREADS = kPreThreads;
  constexpr int NT = BK / 8;      // 8-key steps per tile
  constexpr int KD = DH / 8;      // 8-deep steps of q k, and 8-wide column tiles of o
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // fragment row group and column
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm + L::q;
  float* Ks = sm + L::k;
  float* Vs = sm + L::v;

  const int off = q_offsets[b], kvl = kv_lens[b];
  const int last_q = min(q0 + BQ, Sq) - 1;
  const int kend = max(0, min(min(last_q + off + 1, kvl), Sk));  // keys any row sees
  const int n_kt = (kend + BK - 1) / BK;
  const long q_row = (long)nh * DH, kv_row = (long)nkv * DH;
  const float* kb = k + ((long)b * Sk * nkv + hk) * DH;
  const float* vb = v + ((long)b * Sk * nkv + hk) * DH;

  stage_rows<THREADS>(Qs, S, q + (((long)b * Sq + q0) * nh + h) * DH, q_row, BQ,
                      min(BQ, Sq - q0), DH, v16);
  if (n_kt > 0) {
    stage_rows<THREADS>(Ks, S, kb, kv_row, BK, min(BK, kend), DH, v16);
    stage_rows<THREADS>(Vs, S, vb, kv_row, BK, min(BK, kend), DH, v16);
  }
  const int qp0 = q0 + warp * 16 + g, qp1 = qp0 + 8;   // this thread's two rows
  float oacc[KD][4];
#pragma unroll
  for (int nd = 0; nd < KD; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) oacc[nd][i] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1, k0 = kt * BK;
    cp_async_wait_all();
    __syncthreads();              // tile kt (and Q) landed; tile kt - 1 consumed
    if (kt + 1 < n_kt) {
      const int k1 = k0 + BK, n1 = min(BK, kend - k1);
      stage_rows<THREADS>(Ks + (buf ^ 1) * BK * S, S, kb + k1 * kv_row, kv_row, BK, n1, DH,
                          v16);
      stage_rows<THREADS>(Vs + (buf ^ 1) * BK * S, S, vb + k1 * kv_row, kv_row, BK, n1, DH,
                          v16);
    }
    const float* Kt = Ks + buf * BK * S;
    const float* Vt = Vs + buf * BK * S;

    // s = q k^T: s[nt] holds (row g, keys 8 nt + 2 t4, +1) and (row g + 8, same)
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      unsigned ah[4], al[4];
      const float* qa = Qs + (warp * 16 + g) * S + kk * 8 + t4;
      split_tf32(qa[0], ah[0], al[0]);
      split_tf32(qa[8 * S], ah[1], al[1]);
      split_tf32(qa[4], ah[2], al[2]);
      split_tf32(qa[8 * S + 4], ah[3], al[3]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* kr = Kt + (nt * 8 + g) * S + kk * 8 + t4;
        unsigned bh[2], bl[2];
        split_tf32(kr[0], bh[0], bl[0]);
        split_tf32(kr[4], bh[1], bl[1]);
        mma3(s[nt], ah, al, bh, bl);
      }
    }
    // mask, scale and the online softmax of rows qp0 and qp1
    float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + nt * 8 + 2 * t4 + e;
        const bool in = kp < kend;
        s[nt][e] = in && kp <= qp0 + off ? s[nt][e] * scale : kMasked;
        s[nt][2 + e] = in && kp <= qp1 + off ? s[nt][2 + e] * scale : kMasked;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        // a masked score's probability is exactly 0 whatever the running max
        s[nt][e] = s[nt][e] == kMasked ? 0.f : expf(s[nt][e] - mn0);
        s[nt][2 + e] = s[nt][2 + e] == kMasked ? 0.f : expf(s[nt][2 + e] - mn1);
        sum0 += s[nt][e];
        sum1 += s[nt][2 + e];
      }
    sum0 += __shfl_xor_sync(kFull, sum0, 1);
    sum0 += __shfl_xor_sync(kFull, sum0, 2);
    sum1 += __shfl_xor_sync(kFull, sum1, 1);
    sum1 += __shfl_xor_sync(kFull, sum1, 2);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd) {
      oacc[nd][0] *= a0;
      oacc[nd][1] *= a0;
      oacc[nd][2] *= a1;
      oacc[nd][3] *= a1;
    }
    // o += P V: step nt's A is the score fragment, keys 8 nt + 2 t4 and
    // + 2 t4 + 1 as A's columns t4 and t4 + 4; V's rows in that order
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      unsigned ah[4], al[4];
      split_tf32(s[nt][0], ah[0], al[0]);
      split_tf32(s[nt][2], ah[1], al[1]);
      split_tf32(s[nt][1], ah[2], al[2]);
      split_tf32(s[nt][3], ah[3], al[3]);
      const float* vr = Vt + (nt * 8 + 2 * t4) * S + g;
#pragma unroll
      for (int nd = 0; nd < KD; ++nd) {
        unsigned bh[2], bl[2];
        split_tf32(vr[nd * 8], bh[0], bl[0]);
        split_tf32(vr[S + nd * 8], bh[1], bl[1]);
        mma3(oacc[nd], ah, al, bh, bl);
      }
    }
  }
  cp_async_wait_all();
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (qp0 < Sq) {
    float* dst = o + (((long)b * Sq + qp0) * nh + h) * DH + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd)
      *reinterpret_cast<float2*>(dst + nd * 8) = make_float2(oacc[nd][0] / d0, oacc[nd][1] / d0);
  }
  if (qp1 < Sq) {
    float* dst = o + (((long)b * Sq + qp1) * nh + h) * DH + 2 * t4;
#pragma unroll
    for (int nd = 0; nd < KD; ++nd)
      *reinterpret_cast<float2*>(dst + nd * 8) = make_float2(oacc[nd][2] / d1, oacc[nd][3] / d1);
  }
}

// ---------------------------------------------------------------- launching

template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

enum Body { kPrefill = 0, kDecode = 1 };

template <int DH>
long smem_floats(int body) {
  return body == kDecode ? DecLayout<DH>::total : PreLayout<DH>::total;
}

template <int DH>
int launch(int body, const float* q, const float* k, const float* v, const int* q_offsets,
           const int* kv_lens, float* o, float* partials, int* counters, int B, int Sq,
           int Sk, int nh, int nkv, float scale, cudaStream_t stream) {
  const int G = nh / nkv;
  const bool v16 = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  switch (body) {
    case kDecode: {
      if (G * Sq > kDecRows) return (int)cudaErrorInvalidValue;
      const size_t bytes = (size_t)DecLayout<DH>::total * sizeof(float);
      const int e = set_smem(flash_decode_kernel<DH>, bytes);
      if (e) return e;
      const dim3 grid(Sk > 0 ? (Sk + kRangeKeys - 1) / kRangeKeys : 1, nkv, B);
      flash_decode_kernel<DH><<<grid, kDecThreads, bytes, stream>>>(
          q, k, v, q_offsets, kv_lens, o, partials, counters, Sq, Sk, nh, nkv, G, scale, v16);
      return (int)cudaGetLastError();
    }
    default: {
      const size_t bytes = (size_t)PreLayout<DH>::total * sizeof(float);
      const int e = set_smem(flash_prefill_kernel<DH>, bytes);
      if (e) return e;
      const dim3 grid((Sq + kBQ - 1) / kBQ, nh, B);
      flash_prefill_kernel<DH><<<grid, kPreThreads, bytes, stream>>>(
          q, k, v, q_offsets, kv_lens, o, Sq, Sk, nh, nkv, G, scale, v16);
      return (int)cudaGetLastError();
    }
  }
}

}  // namespace

// Shared memory of one CTA of `body` (0 prefill, 1 decode)
// at head dim dh, in bytes; -1 for a head dim this file does not instantiate.
extern "C" long flash_prefill_smem_bytes(int body, int dh) {
  switch (dh) {
    case 32: return smem_floats<32>(body) * 4;
    case 64: return smem_floats<64>(body) * 4;
    case 128: return smem_floats<128>(body) * 4;
    default: return -1;
  }
}

// Loads both bodies at every head dim on the current device now (CUDA loads
// a kernel lazily at its first launch, which waits for the whole context:
// a first launch behind a stream wait would wait for itself).  Returns 0 or
// the CUDA error.
extern "C" int flash_prefill_preload(void) {
  const void* fns[] = {(const void*)flash_decode_kernel<32>, (const void*)flash_decode_kernel<64>,
                       (const void*)flash_decode_kernel<128>,
                       (const void*)flash_prefill_kernel<32>,
                       (const void*)flash_prefill_kernel<64>,
                       (const void*)flash_prefill_kernel<128>};
  cudaFuncAttributes attr;
  for (const void* fn : fns) {
    const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// Launches `body` on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a head dim this file does not instantiate or a
// decode call with more than 16 query rows per kv head.  The decode body
// needs partials of B * nkv * ceil(Sk / 128) * G * Sq * (dh + 2) floats and
// B * nkv counters that are 0 (it leaves them 0); the prefill body ignores
// both.
extern "C" int flash_prefill(const float* q, const float* k, const float* v,
                             const int* q_offsets, const int* kv_lens, float* o,
                             float* partials, int* counters, int B, int Sq, int Sk, int nh,
                             int nkv, int dh, int body, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dh) {
    case 32:
      return launch<32>(body, q, k, v, q_offsets, kv_lens, o, partials, counters, B, Sq, Sk,
                        nh, nkv, scale, s);
    case 64:
      return launch<64>(body, q, k, v, q_offsets, kv_lens, o, partials, counters, B, Sq, Sk,
                        nh, nkv, scale, s);
    case 128:
      return launch<128>(body, q, k, v, q_offsets, kv_lens, o, partials, counters, B, Sq, Sk,
                         nh, nkv, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
