// Rotary embedding of q and k in one launch, the packed elite dims or the
// full head, with each angle's sin and cos computed once and shared by
// every head that reads its frequency row.
//
// Replaces src/repro/kernels/rope_elite.py::rope_elite (_kernel).  For
// token (b, s), query head h of q [B, S, Hq, 2r] and key head h of
// k [B, S, Hk, 2r], and pair c < r:
//     ang          = (float) pos[b, s] * freqs[row, c]
//     out[.., 2c]   = x[.., 2c] * cos(ang) - x[.., 2c+1] * sin(ang)
//     out[.., 2c+1] = x[.., 2c] * sin(ang) + x[.., 2c+1] * cos(ang)
// which is core/rope.py's interleaved rotation, with row = h / q_per_row for
// a query head and h / k_per_row for a key head (freqs [R, r], Hq = R *
// q_per_row, Hk = R * k_per_row).  The backward is the same body with
// transpose = 1, which negates sin after the sincosf: the rotation by -ang
// is the rotation's transpose, so on the output's gradient (g_e, g_o) it
// gives the input's, g_e * cos + g_o * sin and -g_e * sin + g_o * cos.  The
// negation is exact and does not rely on sincosf being odd.  EliteKV: R =
// n_kv, q_per_row = q_group, k_per_row = 1.  The full RoPE: R = 1, freqs =
// chunk_freqs, q_per_row = n_heads, k_per_row = n_kv.  The TPU contract
// (one tensor, freqs [H, r]) is the same body with k_per_row = 0.  Beyond it, for the port's callers:
// positions are [S] (lane stride 0) or per lane [B, S] (lane stride S),
// int32 or int64; q and k are read through their own (b, s, h) strides
// with a unit last stride, so the q_e slice q[..., :2r] of the query
// projection is rotated in place of a copy; the outputs are new contiguous
// tensors.
//
// Arithmetic, for the plain version's bits: the angle is one f32 multiply
// of the position converted to f32 (as positions.float() * freqs); sin and
// cos come from sincosf, the full-accuracy routine, not __sinf/__cosf,
// whose error grows with the angle (chunk 0's frequency is 1, so angles
// reach the sequence length in radians); each product and the sum or
// difference are rounded on their own (__fmul_rn, __fsub_rn, __fadd_rn), so
// nvcc cannot contract them into an FMA the plain version does not do.  An
// angle shared by several heads has the bits it would have per head.
//
// What bounds it on the H100: bytes.  Each pair reads 8 B and writes 8 B
// against ~7 flops, and the sincos is shared, far below the ~20 flops per
// byte at which f32 would become the limit.  There is no reuse of data, so
// nothing is staged in shared memory and no tensor core is used.  The
// design keeps many bytes in flight with little integer work:
// - a 3-D block: x = a vector of VEC pairs within a row (VEC = 2: 16-byte
//   loads and stores; VEC = 1: 8-byte, for inputs whose rows or strides are
//   not 16-byte aligned), y = (frequency row, head subset), z = tokens of one
//   lane; grid (token blocks, lanes, row blocks).  All index math is
//   32-bit, and the only division splits y into row and subset.  A token
//   whose rows need more threads than a CTA holds (40 rows of 32 pairs for
//   LLaMA2-13B at half cache, or the RoPElite search's per-head masked
//   frequencies) has its rows cut into row blocks of rpc rows each, one
//   block per grid z; every element's arithmetic is the same;
// - a thread computes the VEC sincos of its (token, row, vector) once and
//   applies them to up to kMaxVectors heads of the row (its q heads, then
//   its k heads).  A row read by more heads (the full RoPE's 32 + 4) is
//   split into subsets across threads, each recomputing the sincos;
// - a thread issues all its loads first, then computes its angles while
//   they are in flight, then stores: up to kMaxVectors independent 16-byte
//   loads (144 B) in flight, and one memory latency on the critical path
//   less than loading after the sincos.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;   // per CTA; the wrapper plans within it
constexpr int kMaxVectors = 9;     // heads per thread

struct Args {
  const float* q;
  const float* k;
  const void* pos;
  const float* freqs;
  float* q_out;
  float* k_out;
  int S, r, rows, rpc, subsets, per_sub, q_per_row, k_per_row, Hq, Hk;
  int q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, pos_sb, f_sr;
  int transpose;   // 1: rotate by -ang (the backward), by negating sin
};

__device__ __forceinline__ void rotate(float e, float o, float c, float s, float& re,
                                       float& ro) {
  re = __fsub_rn(__fmul_rn(e, c), __fmul_rn(o, s));
  ro = __fadd_rn(__fmul_rn(e, s), __fmul_rn(o, c));
}

__device__ __forceinline__ float2 load(const float* p, float2*) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float4 load(const float* p, float4*) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float2 rotated(float2 x, const float* c, const float* s) {
  float2 y;
  rotate(x.x, x.y, c[0], s[0], y.x, y.y);
  return y;
}
__device__ __forceinline__ float4 rotated(float4 x, const float* c, const float* s) {
  float4 y;
  rotate(x.x, x.y, c[0], s[0], y.x, y.y);
  rotate(x.z, x.w, c[1], s[1], y.z, y.w);
  return y;
}

template <int VEC> struct VecOf;
template <> struct VecOf<1> { using T = float2; };
template <> struct VecOf<2> { using T = float4; };

template <int VEC, typename P>
__global__ void __launch_bounds__(kMaxThreads) rope_qk_kernel(const Args a) {
  using V = typename VecOf<VEC>::T;
  const int s = blockIdx.x * blockDim.z + threadIdx.z;
  const int ly = threadIdx.y / a.subsets;
  const int row = blockIdx.z * a.rpc + ly;
  if (s >= a.S || row >= a.rows) return;
  const int b = blockIdx.y;
  const int pair = threadIdx.x * VEC;
  const int sub = threadIdx.y - ly * a.subsets;

  // heads [i0, i1) of the row's list: its q heads, then its k heads
  const int n = a.q_per_row + a.k_per_row;
  const int i0 = sub * a.per_sub;
  const int i1 = min(n, i0 + a.per_sub);
  const float* q_in = a.q + b * a.q_sb + s * a.q_ss + row * a.q_per_row * a.q_sh + 2 * pair;
  const float* k_in = a.k + b * a.k_sb + s * a.k_ss + row * a.k_per_row * a.k_sh + 2 * pair;
  V buf[kMaxVectors];
#pragma unroll
  for (int j = 0; j < kMaxVectors; ++j) {
    const int i = i0 + j;
    if (i < i1)
      buf[j] = load(i < a.q_per_row ? q_in + i * a.q_sh : k_in + (i - a.q_per_row) * a.k_sh,
                    static_cast<V*>(nullptr));
  }

  // the angles, while the loads are in flight
  const float p = static_cast<float>(static_cast<const P*>(a.pos)[b * a.pos_sb + s]);
  float cs[VEC], sn[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float ang = __fmul_rn(p, __ldg(a.freqs + row * a.f_sr + pair + j));
    sincosf(ang, &sn[j], &cs[j]);
    if (a.transpose) sn[j] = -sn[j];
  }

  const int token = b * a.S + s;
  float* q_o = a.q_out + (token * a.Hq + row * a.q_per_row) * 2 * a.r + 2 * pair;
  float* k_o = a.k_out + (token * a.Hk + row * a.k_per_row) * 2 * a.r + 2 * pair;
#pragma unroll
  for (int j = 0; j < kMaxVectors; ++j) {
    const int i = i0 + j;
    if (i < i1) {
      float* dst = i < a.q_per_row ? q_o + i * 2 * a.r : k_o + (i - a.q_per_row) * 2 * a.r;
      *reinterpret_cast<V*>(dst) = rotated(buf[j], cs, sn);
    }
  }
}

template <int VEC>
void launch(const Args& a, bool pos64, dim3 grid, dim3 block, cudaStream_t stream) {
  if (pos64)
    rope_qk_kernel<VEC, int64_t><<<grid, block, 0, stream>>>(a);
  else
    rope_qk_kernel<VEC, int32_t><<<grid, block, 0, stream>>>(a);
}

}  // namespace

// Loads every instantiation of the rotation on the current device now (CUDA
// loads a kernel lazily at its first launch, which waits for the whole
// context: a first launch behind a stream wait would wait for itself).
// Returns 0 or the CUDA error.
extern "C" int rope_elite_preload(void) {
  const void* fns[] = {(const void*)rope_qk_kernel<1, int32_t>,
                       (const void*)rope_qk_kernel<1, int64_t>,
                       (const void*)rope_qk_kernel<2, int32_t>,
                       (const void*)rope_qk_kernel<2, int64_t>};
  cudaFuncAttributes attr;
  for (const void* fn : fns) {
    const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// q: f32, element (b, s, h, e) at b*q_sb + s*q_ss + h*q_sh + e, Hq = rows *
// q_per_row heads; k likewise with Hk = rows * k_per_row (k_per_row = 0: no
// k, and k, k_out may be null); pos: int32 (pos64 == 0) or int64, element
// (b, s) at b*pos_sb + s; freqs: f32, element (row, c) at row*f_sr + c;
// q_out, k_out: contiguous f32 [B, S, H, 2r].  vec: pairs per access (2:
// every q and k row start 16-byte aligned and r even; 1: 8-byte aligned).
// A thread handles per_sub heads of one of a row's `subsets` head subsets;
// tz tokens and rpc rows per CTA.  Every offset must fit in 32 bits.  Needs
// B, S, r >= 1.
// transpose: 1 rotates by -ang (the backward of the rotation), else 0.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a plan the kernel cannot run.
extern "C" int rope_elite_qk(const float* q, const float* k, const void* pos, int pos64,
                             const float* freqs, float* q_out, float* k_out, int vec,
                             int B, int S, int r, int rows, int q_per_row, int k_per_row,
                             int subsets, int per_sub, int tz, int rpc, int q_sb, int q_ss,
                             int q_sh, int k_sb, int k_ss, int k_sh, int pos_sb, int f_sr,
                             int transpose, void* stream) {
  if ((vec != 1 && vec != 2) || r % vec || per_sub < 1 || per_sub > kMaxVectors ||
      subsets * per_sub < q_per_row + k_per_row || tz < 1 || rpc < 1 || rpc > rows ||
      (r / vec) * rpc * subsets * tz > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, pos, freqs, q_out, k_out, S, r, rows, rpc, subsets, per_sub,
               q_per_row, k_per_row, rows * q_per_row, rows * k_per_row, q_sb, q_ss, q_sh,
               k_sb, k_ss, k_sh, pos_sb, f_sr, transpose != 0};
  const dim3 grid((S + tz - 1) / tz, B, (rows + rpc - 1) / rpc),
      block(r / vec, rpc * subsets, tz);
  if (vec == 2)
    launch<2>(a, pos64 != 0, grid, block, (cudaStream_t)stream);
  else
    launch<1>(a, pos64 != 0, grid, block, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
