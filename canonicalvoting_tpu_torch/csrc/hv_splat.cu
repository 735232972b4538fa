// The vote splat of canonical Hough voting, for sm_90a.
//
// Replaces the Pallas TPU kernel hv_splat_pallas of
// canonicalvoting_tpu/ops/pallas/hv_splat.py (_kernel), with channels = 1 and
// channels = 6: for each point and each of num_rots yaw angles, rotate the
// scaled LCC offset, drop votes that fall outside [0, dims - 1) on any axis,
// and splat trilinearly onto the 8 surrounding cells of a channel-last
// (gx, gy, gz, CH) float32 grid. With w the corner weight times obj * valid,
// channel 1 adds w (the objectness grid), channel 6 adds
// [w, w cos, w sin, w sx, w sy, w sz] (the rotation and scale votes that
// hough_voting normalizes by the objectness sum).
//
// Design. One thread per (rotation, point) vote, points fastest so a warp
// reads neighbouring point rows. The math is the JAX XLA path's, in f32
// (the TPU kernel rounds its tent products to bf16; this one does not).
// Sums are deterministic: each corner weight is converted to a 64-bit fixed
// point number with 32 fractional bits and added with an integer atomicAdd.
// Integer addition is associative, so the grid is bitwise the same whatever
// order the votes land in, and a weight of 2^-8 or more converts exactly.
// A second pass turns the fixed point grid into float32. The cos and sin
// channels are signed: two's-complement sums through the unsigned atomicAdd
// are exact, and the conversion reads them back as signed. The sums stay
// exact while a cell's |sum| is below 2^31 (2^63 at 2^32 per unit): a hot
// cell of ~2e3 votes of scale ~5 m is far inside.
//
// Bound. Each vote is a few dozen f32 operations and 8 * CH atomics, and the
// grid is written once, so at ScanNet scale the splat is bound by the
// atomics' traffic to L2 rather than by device memory or arithmetic; six
// channels carry six times the atomics of one. The 64-bit scratch is
// 8 * CH bytes a cell (302 MB for the six channels of a 256 x 96 x 256 grid).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFixedScale = 4294967296.0f;  // 2^32

template <int CH>
__global__ void vote_kernel(const float* __restrict__ points,
                            const float* __restrict__ xyz,
                            const float* __restrict__ scale,
                            const float* __restrict__ obj,
                            const float* __restrict__ valid, int n,
                            const float* __restrict__ cosv,
                            const float* __restrict__ sinv, int num_rots,
                            const float* __restrict__ corner,
                            const int* __restrict__ dims, float res, int gy,
                            int gz, unsigned long long* __restrict__ acc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)n * num_rots) return;
  const int r = (int)(i / n), p = (int)(i - (long long)r * n);
  float ob = obj[p];
  if (valid != nullptr) {
    if (!(valid[p] > 0.f)) return;
    ob = __fmul_rn(ob, valid[p]);
  }
  // every product and sum rounded on its own (no fused multiply-add), in
  // the plain version's order, so both place each vote identically
  const float cx = __fmul_rn(xyz[3 * p], scale[3 * p]);
  const float cy = __fmul_rn(xyz[3 * p + 1], scale[3 * p + 1]);
  const float cz = __fmul_rn(xyz[3 * p + 2], scale[3 * p + 2]);
  const float c = cosv[r], s = sinv[r];
  // offset = -Rot_y(theta) @ corr
  const float offx = __fadd_rn(__fmul_rn(-c, cx), __fmul_rn(s, cz));
  const float offy = -cy;
  const float offz = __fsub_rn(__fmul_rn(-s, cx), __fmul_rn(c, cz));
  const float u[3] = {
      __fdiv_rn(__fsub_rn(__fadd_rn(points[3 * p], offx), corner[0]), res),
      __fdiv_rn(__fsub_rn(__fadd_rn(points[3 * p + 1], offy), corner[1]), res),
      __fdiv_rn(__fsub_rn(__fadd_rn(points[3 * p + 2], offz), corner[2]), res)};
  int f[3];
  float w1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!(u[a] >= 0.f && u[a] < (float)dims[a] - 1.f)) return;
    const float fl = floorf(u[a]);
    f[a] = (int)fl;
    w1[a] = __fsub_rn(u[a], fl);
  }
#pragma unroll
  for (int bx = 0; bx < 2; ++bx)
#pragma unroll
    for (int by = 0; by < 2; ++by)
#pragma unroll
      for (int bz = 0; bz < 2; ++bz) {
        const float wx = bx ? w1[0] : __fsub_rn(1.f, w1[0]);
        const float wy = by ? w1[1] : __fsub_rn(1.f, w1[1]);
        const float wz = bz ? w1[2] : __fsub_rn(1.f, w1[2]);
        const float w = __fmul_rn(__fmul_rn(__fmul_rn(wx, wy), wz), ob);
        const long long cell = ((long long)(f[0] + bx) * gy + (f[1] + by)) * gz + (f[2] + bz);
        if (CH == 1) {
          atomicAdd(acc + cell, (unsigned long long)__float2ll_rn(w * kFixedScale));
        } else {
          const float ch[6] = {w, __fmul_rn(w, c), __fmul_rn(w, s),
                               __fmul_rn(w, scale[3 * p]), __fmul_rn(w, scale[3 * p + 1]),
                               __fmul_rn(w, scale[3 * p + 2])};
#pragma unroll
          for (int j = 0; j < 6; ++j)
            atomicAdd(acc + cell * 6 + j, (unsigned long long)__float2ll_rn(ch[j] * kFixedScale));
        }
      }
}

__global__ void fixed_to_float_kernel(const unsigned long long* __restrict__ acc,
                                      long long total, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) out[i] = (float)((double)(long long)acc[i] * (1.0 / 4294967296.0));
}

}  // namespace

// channels 1 or 6; acc: (gx*gy*gz*channels) uint64 scratch, zeroed here;
// out: (gx, gy, gz, channels) float32. corner (3,) float32 and dims (3,)
// int32 live on the device.
extern "C" int hv_splat_launch(const float* points, const float* xyz,
                               const float* scale, const float* obj,
                               const float* valid, int n, const float* cosv,
                               const float* sinv, int num_rots, const float* corner,
                               const int* dims, float res, int gx, int gy, int gz,
                               int channels, void* acc, float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (channels != 1 && channels != 6) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = (long long)gx * gy * gz * channels;
  cudaError_t e = cudaMemsetAsync(acc, 0, total * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long votes = (long long)n * num_rots;
  const int nt = 256;
  const unsigned blocks = (unsigned)((votes + nt - 1) / nt);
  unsigned long long* a = static_cast<unsigned long long*>(acc);
  if (votes > 0 && channels == 1) {
    vote_kernel<1><<<blocks, nt, 0, s>>>(points, xyz, scale, obj, valid, n, cosv, sinv,
                                         num_rots, corner, dims, res, gy, gz, a);
  } else if (votes > 0) {
    vote_kernel<6><<<blocks, nt, 0, s>>>(points, xyz, scale, obj, valid, n, cosv, sinv,
                                         num_rots, corner, dims, res, gy, gz, a);
  }
  fixed_to_float_kernel<<<(unsigned)((total + nt - 1) / nt), nt, 0, s>>>(
      static_cast<const unsigned long long*>(acc), total, out);
  return static_cast<int>(cudaGetLastError());
}
