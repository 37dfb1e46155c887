// Per-head rotary embedding of the packed elite dims, cos/sin computed
// in-kernel.
//
// Replaces src/repro/kernels/rope_elite.py::rope_elite (_kernel).  For row
// (b, s, h) of x [B, S, H, 2r] and pair c < r:
//     ang          = (float) pos[b, s] * freqs[h, c]
//     out[.., 2c]   = x[.., 2c] * cos(ang) - x[.., 2c+1] * sin(ang)
//     out[.., 2c+1] = x[.., 2c] * sin(ang) + x[.., 2c+1] * cos(ang)
// which is core/rope.py's interleaved rotation.  With freqs = chunk_freqs(dh)
// broadcast over the heads (a head stride of 0) it is the baseline's full
// RoPE.  Two generalisations of the TPU contract, both for the port's
// callers: positions are [S] (batch stride 0) or per lane [B, S] (batch
// stride S), int32 or int64; and x is read through its own (b, s, h)
// strides with a unit last stride, so the q_e slice q[..., :2r] of the
// query projection is rotated in place of a copy.  The output is a new
// contiguous [B, S, H, 2r] tensor.
//
// Arithmetic, for the plain version's bits: the angle is one f32 multiply
// of the position converted to f32 (as positions.float() * freqs); sin and
// cos come from sincosf, the full-accuracy routine, not __sinf/__cosf,
// whose error grows with the angle (chunk 0's frequency is 1, so angles
// reach the sequence length in radians); each product and the sum or
// difference are rounded on their own (__fmul_rn, __fsub_rn, __fadd_rn), so
// nvcc cannot contract them into an FMA the plain version does not do.
//
// What bounds it on the H100: bytes.  Each pair reads 8 B and writes 8 B
// against ~7 flops and one sincos, far below the ~20 flops per byte at which
// f32 would become the limit.  Design: one thread per (row, pair), so
// neighbouring threads read neighbouring pairs of a row and neighbouring
// rows; the position and frequency loads hit the cache.  Nothing is staged
// in shared memory: there is no reuse to stage.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename P>
__global__ void __launch_bounds__(kThreads) rope_kernel(
    const float* __restrict__ x, const P* __restrict__ pos,
    const float* __restrict__ freqs, float* __restrict__ out, long n_pairs,
    int S, int H, int r, long sb, long ss, long sh, long pos_sb, long f_sh) {
  const long i = (long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pairs) return;
  const int c = (int)(i % r);
  const long row = i / r;              // (b * S + s) * H + h
  const int h = (int)(row % H);
  const long bsi = row / H;            // b * S + s
  const int s = (int)(bsi % S);
  const long b = bsi / S;
  const float p = static_cast<float>(pos[b * pos_sb + s]);
  const float ang = __fmul_rn(p, freqs[h * f_sh + c]);
  float sn, cs;
  sincosf(ang, &sn, &cs);
  const float* xr = x + b * sb + s * ss + h * sh + 2 * c;
  const float e = xr[0], o = xr[1];
  float* orow = out + row * 2 * r + 2 * c;
  orow[0] = __fsub_rn(__fmul_rn(e, cs), __fmul_rn(o, sn));
  orow[1] = __fadd_rn(__fmul_rn(e, sn), __fmul_rn(o, cs));
}

template <typename P>
int launch(const float* x, const P* pos, const float* freqs, float* out, int B,
           int S, int H, int r, long sb, long ss, long sh, long pos_sb,
           long f_sh, void* stream) {
  const long n_pairs = (long)B * S * H * r;
  const long blocks = (n_pairs + kThreads - 1) / kThreads;
  rope_kernel<P><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      x, pos, freqs, out, n_pairs, S, H, r, sb, ss, sh, pos_sb, f_sh);
  return (int)cudaGetLastError();
}

}  // namespace

// x: f32, element (b, s, h, e) at b*sb + s*ss + h*sh + e; pos: int32
// (pos64 == 0) or int64, element (b, s) at b*pos_sb + s; freqs: f32, element
// (h, c) at h*f_sh + c; out: contiguous f32 [B, S, H, 2r].  Needs
// B*S*H*r >= 1.  Returns cudaGetLastError() after the launch.
extern "C" int rope_elite(const float* x, const void* pos, int pos64,
                          const float* freqs, float* out, int B, int S, int H,
                          int r, long sb, long ss, long sh, long pos_sb,
                          long f_sh, void* stream) {
  if (pos64)
    return launch(x, static_cast<const int64_t*>(pos), freqs, out, B, S, H, r,
                  sb, ss, sh, pos_sb, f_sh, stream);
  return launch(x, static_cast<const int32_t*>(pos), freqs, out, B, S, H, r, sb,
                ss, sh, pos_sb, f_sh, stream);
}
