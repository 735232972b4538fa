// The vote splat of canonical Hough voting, for sm_90a.
//
// Replaces the Pallas TPU kernels hv_splat_pallas of
// canonicalvoting_tpu/ops/pallas/hv_splat.py (_kernel), with channels = 1 and
// channels = 6, and hv_splat_windowed (_kernel_windowed), the channels = 1
// function through per-x-bucket windows (below): for each point and each of
// num_rots yaw angles, rotate the scaled LCC offset, drop votes that fall
// outside [0, dims - 1) on any axis, and splat trilinearly onto the 8
// surrounding cells of a channel-last (gx, gy, gz, CH) float32 grid. With w
// the corner weight times obj * valid, channel 1 adds w (the objectness
// grid), channel 6 adds [w, w cos, w sin, w sx, w sy, w sz] (the rotation
// and scale votes that hough_voting normalizes by the objectness sum).
//
// Sums are deterministic: each corner weight is converted to a 64-bit fixed
// point number with 32 fractional bits and added with an integer atomicAdd.
// Integer addition is associative, so the grid is bitwise the same whatever
// order or grouping the votes land in, and a weight of 2^-8 or more converts
// exactly. A second pass turns the fixed point grid into float32. The cos
// and sin channels are signed: two's-complement sums through the unsigned
// atomicAdd are exact, and the conversion reads them back as signed. The
// sums stay exact while a cell's |sum| is below 2^31 (2^63 at 2^32 per
// unit): a hot cell of ~2e3 votes of scale ~5 m is far inside. The math is
// the JAX XLA path's, in f32 (the TPU kernel rounds its tent products to
// bf16; these do not).
//
// The plane splats (obj_vote_kernel, channels = 1; vote6_kernel, channels =
// 6, the non-lazy tails). One thread per (category, rotation, point) vote,
// the categories on the grid's y axis so the separate evaluator's nine
// splat in one launch into one (C, cells, channels) scratch. What bounds
// them is the atomics, not bytes or arithmetic: up to
// 7.4 M votes x 8 corners a ScanNet-scale scene, and Hough voting makes
// them collide by design (a box's points at its true rotation, and points
// whose predicted offset is small at every rotation, hit the same cells),
// so same-address atomics serialize in L2. The kernel therefore adds each
// warp's votes that share a floor cell in registers first: __match_any_sync
// groups the lanes by floor cell, the group's 8 corner weights are summed
// in registers (64-bit integer adds: the same bits in any grouping), and
// the sums go out in 8 atomics, skipping sums of zero. A warp that is one
// group (32 votes in one cell) sums by recursive halving and issues its 8
// atomics from 8 lanes at once; other groups sum over a tree in lane order
// and their lowest lane issues them. (redux.sync over 22-bit pieces in
// place of the tree measured slower on the H100; PERF.md.)
// Threads run rotations fastest, so a warp holds 32 consecutive rotations of
// one point (or the tail and head of two): its votes lie 3 degrees apart on
// one arc of the point's offset radius, so neighbours share cells for any
// radius of a few cells, and all 32 fall in one cell where the offset is
// under a cell. The whole-warp path serves that last case only, which is a
// property of the head rows: the planted rows that chip_smoke.py decodes
// give their background points an offset of exactly 0 (65% of the joint
// scene's warps, 79% of the separate path's are one group), while the
// random-weight backbones' own head rows make almost no warp one group
// (1e-5); there it costs one warp vote a warp, and rotations fastest
// still issues 2.6-6.9x fewer atomics than points fastest (PERF.md).
//
// vote6_kernel is the same design over six channels, where a vote without
// grouping issues 8 x 6 atomics (343 M a ScanNet-scale joint scene;
// PERF.md). The eight corner weights are computed once a vote; the sums
// then run one channel at a time, each channel's eight 64-bit values
// recomputed from them (w, w cos, w sin, w sx, w sy, w sz, each product
// rounded alone), so a lane holds 8 and not 48 64-bit sums and nothing
// spills. The channels share the group, so the whole-warp test is made once
// a warp. The whole-warp path depends on warps that are one group (65% and
// 79% of them on the planted rows, 1e-5 and 6e-7 on the backbones' rows):
// without it the vote kernel measured 14% and 55% slower on the planted
// rows (joint, nine categories), 14% slower on the backbones' joint rows,
// where it almost never fires, and no faster on their nine categories
// (PERF.md, alternated runs), so it stays. One template for both kernels measured 5-12% slower on
// obj_vote_kernel's mixed groups (PERF.md), so the two stay apart. The
// 64-bit scratch is 8 bytes a cell, channel and category (302 MB for six
// channels of a 256 x 96 x 256 grid, 2.7 GB for nine categories); its fill
// and the conversion are outside the vote kernels.
//
// windowed_vote_kernel (hv_splat_windowed) is obj_vote_kernel with the JAX
// windowed kernel's rule as a mask: a corner outside its point's x window
// (x_window: the point's x bucket padded by x_pad cells, or the whole width
// for the tail of large radii) weighs 0. The TPU kernel sorts the points
// into (y plane, x bucket) segments so that each segment's votes fit a
// VMEM canvas; the card needs no canvas, so nothing is sorted: each vote is
// placed once, one thread a vote, grouped by floor cell as above, and the
// window is worked out in registers from the point's own rows (no key
// array, no host work beyond obj_vote_kernel's). With the keys right no
// corner leaves its window, so the grid equals hv_splat's bitwise; a wrong
// bucket or radius rule drops corners, and the bitwise check shows it.
// The sort's locality does not pay here: the rows in window order
// (tools/splat_probe.py --windowed) made this kernel 31% slower on the
// planted rows, whose neighbouring warps then hit the same cells, and no
// faster on the backbones' (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kFixedScale = 4294967296.0f;  // 2^32

// Places the vote of point p at the rotation (c, s): false when p is invalid
// or the vote lands outside [0, dims - 1) on an axis; else its floor cell f,
// its fractional parts w1 and its weight ob = obj * valid. Every product and
// sum is rounded on its own (no fused multiply-add), in the plain version's
// order, so both place each vote identically.
__device__ __forceinline__ bool place_vote(const float* __restrict__ points,
                                           const float* __restrict__ xyz,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ obj,
                                           const float* __restrict__ valid, int p, float c,
                                           float s, const float* __restrict__ corner,
                                           const int* __restrict__ dims, float res,
                                           int (&f)[3], float (&w1)[3], float& ob) {
  ob = obj[p];
  if (valid != nullptr) {
    if (!(valid[p] > 0.f)) return false;
    ob = __fmul_rn(ob, valid[p]);
  }
  const float cx = __fmul_rn(xyz[3 * p], scale[3 * p]);
  const float cy = __fmul_rn(xyz[3 * p + 1], scale[3 * p + 1]);
  const float cz = __fmul_rn(xyz[3 * p + 2], scale[3 * p + 2]);
  // offset = -Rot_y(theta) @ corr
  const float offx = __fadd_rn(__fmul_rn(-c, cx), __fmul_rn(s, cz));
  const float offy = -cy;
  const float offz = __fsub_rn(__fmul_rn(-s, cx), __fmul_rn(c, cz));
  const float u[3] = {
      __fdiv_rn(__fsub_rn(__fadd_rn(points[3 * p], offx), corner[0]), res),
      __fdiv_rn(__fsub_rn(__fadd_rn(points[3 * p + 1], offy), corner[1]), res),
      __fdiv_rn(__fsub_rn(__fadd_rn(points[3 * p + 2], offz), corner[2]), res)};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (!(u[a] >= 0.f && u[a] < (float)dims[a] - 1.f)) return false;
    const float fl = floorf(u[a]);
    f[a] = (int)fl;
    w1[a] = __fsub_rn(u[a], fl);
  }
  return true;
}

// the trilinear weight of corner (bx, by, bz) of a placed vote
__device__ __forceinline__ float corner_weight(const float (&w1)[3], int bx, int by, int bz,
                                               float ob) {
  const float wx = bx ? w1[0] : __fsub_rn(1.f, w1[0]);
  const float wy = by ? w1[1] : __fsub_rn(1.f, w1[1]);
  const float wz = bz ? w1[2] : __fsub_rn(1.f, w1[2]);
  return __fmul_rn(__fmul_rn(__fmul_rn(wx, wy), wz), ob);
}

__device__ __forceinline__ unsigned long long to_fixed(float w) {
  return (unsigned long long)__float2ll_rn(w * kFixedScale);
}

// Sums each lane's v over its group of lanes (peers: the lanes of the
// warp with the same key, from __match_any_sync): the group's lowest lane
// ends with the group's sums, the other lanes with partial sums. A tree in
// lane order: each round, every lane still in the tree adds the partial sum
// of the next group member still in it, and every other member drops out.
// Every lane of the warp runs it.
template <int N>
__device__ __forceinline__ void sum_peers(unsigned peers, unsigned long long (&v)[N]) {
  const int lane = threadIdx.x & 31;
  unsigned rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(0xffffffffu, above != 0u)) {
    const int next = __ffs(above) - 1;  // -1: none left above this lane
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const unsigned long long t = __shfl_sync(0xffffffffu, v[j], next < 0 ? lane : next);
      if (next >= 0) v[j] += t;
    }
    above &= ~__ballot_sync(0xffffffffu, rank & 1u);
    rank >>= 1;
  }
}

// The 8 sums over the whole warp, when all 32 lanes share one group: each
// round a lane trades half of its values with the lane `off` away and keeps
// the sums of the other half (18 shuffles of 32 bits, against the tree's up
// to 80). Lane l ends with the total of value (l >> 2) & 7.
__device__ __forceinline__ unsigned long long warp_sums8(const unsigned long long (&v)[8]) {
  const int lane = threadIdx.x & 31;
  const bool hi4 = lane & 16, hi3 = lane & 8, hi2 = lane & 4;
  unsigned long long h4[4], h2[2];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h4[k] = (hi4 ? v[k + 4] : v[k]) + __shfl_xor_sync(0xffffffffu, hi4 ? v[k] : v[k + 4], 16);
#pragma unroll
  for (int k = 0; k < 2; ++k)
    h2[k] = (hi3 ? h4[k + 2] : h4[k]) + __shfl_xor_sync(0xffffffffu, hi3 ? h4[k] : h4[k + 2], 8);
  unsigned long long s = (hi2 ? h2[1] : h2[0]) + __shfl_xor_sync(0xffffffffu, hi2 ? h2[0] : h2[1], 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s;
}

// The x window of point p's corners in hv_splat_windowed, [lo, hi): the
// JAX kernel's keys (hv_splat.py:440-456, window_keys in ops/hv_splat.py)
// put a point whose rotation radius is at most pad - 2 cells in x bucket bx
// = clamp(floor(px / xb), 0, nb - 1) of its x cell px, whose window is
// [bx * xb - pad, bx * xb + xb + pad); the larger radii go to the tail,
// which keeps every corner. Points off the y range or not valid belong to
// no window; place_vote drops their votes by the same test. Each product,
// sum, root and quotient is rounded on its own, in window_keys' order.
struct XWindow {
  int xb, pad, nb, gx;  // bucket width, pad, buckets, grid x
};

__device__ __forceinline__ void x_window(const float* __restrict__ points,
                                         const float* __restrict__ xyz,
                                         const float* __restrict__ scale, int p,
                                         const float* __restrict__ corner, float res,
                                         const XWindow& w, int& lo, int& hi) {
  const float cx = __fmul_rn(xyz[3 * p], scale[3 * p]);
  const float cz = __fmul_rn(xyz[3 * p + 2], scale[3 * p + 2]);
  const float r = __fdiv_rn(__fsqrt_rn(__fadd_rn(__fmul_rn(cx, cx), __fmul_rn(cz, cz))), res);
  if (!(r <= (float)(w.pad - 2))) {  // the tail
    lo = -w.pad;
    hi = w.gx + w.pad;
    return;
  }
  const float px = __fdiv_rn(__fsub_rn(points[3 * p], corner[0]), res);
  const int bx = min(max((int)floorf(__fdiv_rn(px, (float)w.xb)), 0), w.nb - 1);
  lo = bx * w.xb - w.pad;
  hi = lo + w.xb + 2 * w.pad;
}

// One category's objectness votes, one thread a (point, rotation) vote,
// rotations fastest (obj_vote_kernel; with kWindow, windowed_vote_kernel:
// a corner outside the point's x window weighs 0).
template <bool kWindow>
__device__ __forceinline__ void obj_votes(
    const float* __restrict__ points, const float* __restrict__ xyz,
    const float* __restrict__ scale, const float* __restrict__ obj,
    const float* __restrict__ valid, int n, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int num_rots, const float* __restrict__ corner,
    const int* __restrict__ dims, float res, int gy, int gz, long long cells,
    const XWindow& win, unsigned long long* __restrict__ acc) {
  const int cat = blockIdx.y;  // category c: rows c of xyz, scale, obj; grid c
  xyz += 3LL * n * cat;
  scale += 3LL * n * cat;
  obj += (long long)n * cat;
  acc += cells * cat;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int f[3] = {0, 0, 0};
  float w1[3] = {0.f, 0.f, 0.f}, ob = 0.f;
  bool in = false;
  int lo = 0, hi = 0;
  if (i < (long long)n * num_rots) {  // rotations fastest: a warp walks one point's arc
    const int p = (int)(i / num_rots), r = (int)(i - (long long)p * num_rots);
    in = place_vote(points, xyz, scale, obj, valid, p, cosv[r], sinv[r], corner, dims, res, f,
                    w1, ob);
    if (kWindow && in) x_window(points, xyz, scale, p, corner, res, win, lo, hi);
  }
  const int base = (f[0] * gy + f[1]) * gz + f[2];
  // lanes out of range key apart (-1 - lane) and join no group
  const unsigned peers = __match_any_sync(0xffffffffu, in ? base : -1 - lane);
  unsigned long long v[8];
#pragma unroll
  for (int b = 0; b < 8; ++b) {
    const bool keep = in && (!kWindow || (f[0] + (b >> 2) >= lo && f[0] + (b >> 2) < hi));
    v[b] = keep ? to_fixed(corner_weight(w1, b >> 2, (b >> 1) & 1, b & 1, ob)) : 0ull;
  }
  if (__all_sync(0xffffffffu, peers == 0xffffffffu)) {  // one cell for the whole warp
    const unsigned long long sum = warp_sums8(v);
    const int b = (lane >> 2) & 7;
    if ((lane & 3) == 0 && sum != 0ull)
      atomicAdd(acc + base + ((b >> 2) * gy + ((b >> 1) & 1)) * gz + (b & 1), sum);
    return;
  }
  sum_peers(peers, v);
  if (!in || (peers & ((1u << lane) - 1u)) != 0u) return;
#pragma unroll
  for (int b = 0; b < 8; ++b)
    if (v[b] != 0ull)
      atomicAdd(acc + base + ((b >> 2) * gy + ((b >> 1) & 1)) * gz + (b & 1), v[b]);
}

__global__ void __launch_bounds__(256) obj_vote_kernel(
    const float* __restrict__ points, const float* __restrict__ xyz,
    const float* __restrict__ scale, const float* __restrict__ obj,
    const float* __restrict__ valid, int n, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int num_rots, const float* __restrict__ corner,
    const int* __restrict__ dims, float res, int gy, int gz, long long cells,
    unsigned long long* __restrict__ acc) {
  obj_votes<false>(points, xyz, scale, obj, valid, n, cosv, sinv, num_rots, corner, dims, res,
                   gy, gz, cells, XWindow{0, 0, 1, 0}, acc);
}

__global__ void __launch_bounds__(256) windowed_vote_kernel(
    const float* __restrict__ points, const float* __restrict__ xyz,
    const float* __restrict__ scale, const float* __restrict__ obj,
    const float* __restrict__ valid, int n, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int num_rots, const float* __restrict__ corner,
    const int* __restrict__ dims, float res, int gy, int gz, long long cells, XWindow win,
    unsigned long long* __restrict__ acc) {
  obj_votes<true>(points, xyz, scale, obj, valid, n, cosv, sinv, num_rots, corner, dims, res,
                  gy, gz, cells, win, acc);
}

__global__ void __launch_bounds__(256) vote6_kernel(
    const float* __restrict__ points, const float* __restrict__ xyz,
    const float* __restrict__ scale, const float* __restrict__ obj,
    const float* __restrict__ valid, int n, const float* __restrict__ cosv,
    const float* __restrict__ sinv, int num_rots, const float* __restrict__ corner,
    const int* __restrict__ dims, float res, int gy, int gz, long long cells,
    unsigned long long* __restrict__ acc) {
  const int cat = blockIdx.y;  // category c: rows c of xyz, scale, obj; grid c
  xyz += 3LL * n * cat;
  scale += 3LL * n * cat;
  obj += (long long)n * cat;
  acc += 6 * cells * cat;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int f[3] = {0, 0, 0};
  float w1[3] = {0.f, 0.f, 0.f}, ob = 0.f;
  float c = 0.f, s = 0.f, sx = 0.f, sy = 0.f, sz = 0.f;  // channels 1-5's factors of w
  bool in = false;
  if (i < (long long)n * num_rots) {  // rotations fastest: a warp walks one point's arc
    const int p = (int)(i / num_rots), r = (int)(i - (long long)p * num_rots);
    c = cosv[r];
    s = sinv[r];
    in = place_vote(points, xyz, scale, obj, valid, p, c, s, corner, dims, res, f, w1, ob);
    if (in) {
      sx = scale[3 * p];
      sy = scale[3 * p + 1];
      sz = scale[3 * p + 2];
    }
  }
  const int base = (f[0] * gy + f[1]) * gz + f[2];
  // lanes out of range key apart (-1 - lane) and join no group
  const unsigned peers = __match_any_sync(0xffffffffu, in ? base : -1 - lane);
  const bool whole = __all_sync(0xffffffffu, peers == 0xffffffffu);  // one cell for the warp
  const bool leader = in && (peers & ((1u << lane) - 1u)) == 0u;
  float wc[8];
#pragma unroll
  for (int b = 0; b < 8; ++b)
    wc[b] = in ? corner_weight(w1, b >> 2, (b >> 1) & 1, b & 1, ob) : 0.f;
#pragma unroll 1
  for (int j = 0; j < 6; ++j) {
    const float fj = j == 1 ? c : j == 2 ? s : j == 3 ? sx : j == 4 ? sy : sz;
    unsigned long long v[8];
#pragma unroll
    for (int b = 0; b < 8; ++b)
      v[b] = in ? to_fixed(j == 0 ? wc[b] : __fmul_rn(wc[b], fj)) : 0ull;
    if (whole) {
      const unsigned long long sum = warp_sums8(v);
      const int b = (lane >> 2) & 7;
      if ((lane & 3) == 0 && sum != 0ull)
        atomicAdd(acc + 6LL * (base + ((b >> 2) * gy + ((b >> 1) & 1)) * gz + (b & 1)) + j, sum);
      continue;
    }
    sum_peers(peers, v);
    if (!leader) continue;
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if (v[b] != 0ull)
        atomicAdd(acc + 6LL * (base + ((b >> 2) * gy + ((b >> 1) & 1)) * gz + (b & 1)) + j,
                  v[b]);
  }
}

__global__ void fixed_to_float_kernel(const unsigned long long* __restrict__ acc,
                                      long long total, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) out[i] = (float)((double)(long long)acc[i] * (1.0 / 4294967296.0));
}

}  // namespace

// channels 1 or 6, n_cat categories over the same points: xyz (n_cat, n,
// 3), scale (n_cat, n, 3), obj (n_cat, n); acc: (n_cat, gx, gy, gz,
// channels) uint64 fixed point, zeroed by the caller. corner (3,) float32
// and dims (3,) int32, clipped to (gx, gy, gz), live on the device. x_bucket
// > 0 (channels 1 only) runs hv_splat_windowed's votes: each corner kept
// only inside its point's x window (x_window), gx a multiple of x_bucket.
extern "C" int hv_votes_launch(const float* points, const float* xyz, const float* scale,
                               const float* obj, const float* valid, int n, int n_cat,
                               const float* cosv, const float* sinv, int num_rots,
                               const float* corner, const int* dims, float res, int gx,
                               int gy, int gz, int channels, int x_bucket, int x_pad,
                               void* acc, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((channels != 1 && channels != 6) || n_cat < 1 || n_cat > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((long long)gx * gy * gz >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  if (x_bucket != 0 && (channels != 1 || x_bucket < 0 || x_pad < 0 || gx % x_bucket != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long votes = (long long)n * num_rots;
  if (votes <= 0) return 0;
  const int nt = 256;
  const dim3 grid((unsigned)((votes + nt - 1) / nt), n_cat);
  const long long cells = (long long)gx * gy * gz;
  auto* a = static_cast<unsigned long long*>(acc);
  if (x_bucket > 0) {
    windowed_vote_kernel<<<grid, nt, 0, s>>>(points, xyz, scale, obj, valid, n, cosv, sinv,
                                             num_rots, corner, dims, res, gy, gz, cells,
                                             XWindow{x_bucket, x_pad, gx / x_bucket, gx}, a);
  } else {
    auto* kernel = channels == 6 ? vote6_kernel : obj_vote_kernel;
    kernel<<<grid, nt, 0, s>>>(points, xyz, scale, obj, valid, n, cosv, sinv, num_rots, corner,
                               dims, res, gy, gz, cells, a);
  }
  return static_cast<int>(cudaGetLastError());
}

// acc: total int64 fixed point sums -> out: total float32
extern "C" int hv_fixed_to_float_launch(const void* acc, long long total, float* out,
                                        void* stream) {
  const int nt = 256;
  if (total > 0)
    fixed_to_float_kernel<<<(unsigned)((total + nt - 1) / nt), nt, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned long long*>(acc), total, out);
  return static_cast<int>(cudaGetLastError());
}
