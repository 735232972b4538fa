// Occupied-tile convolutions of the dense MinkUNet backbone, for sm_90a.
//
// Replaces the Pallas TPU kernels of canonicalvoting_tpu/ops/pallas/
// tiled_conv.py: tiled_conv3d (_kernel), tiled_down2 (_down2_kernel) and
// tiled_up2 (_up2_kernel). Each computes the same function over the same
// margined channel-last grids (X + 2MX, Y + 2MY, Z + 2MZ, C) and the same
// tile lists; cells outside the listed tiles are left as the caller's zeros.
//
// Design. Every kernel is an implicit GEMM whose rows are the cells of the
// listed tiles, flattened (row = tile * cells + local cell, z fastest), so a
// block's rows may span several small tiles and no tile shape wastes a
// block. Columns are output channels; the reduction index walks taps x input
// channels (kg = tap * cin + c, the (k^3, Cin, Cout) weight rows, taps
// x-fastest). A tap's input cell is the row's base cell plus a constant
// offset, because the grids' zero margins absorb every halo read. The
// epilogue is the TPU kernel's, in its order: BN affine, occupancy mask,
// residual (plain, or a second GEMM through the fused 1x1 downsample with its
// own affine and mask), ReLU. Duplicate tiles (lists are padded by repeating
// the last tile) recompute and store the same values; nothing accumulates
// into the output.
//
// The grids are bfloat16, the model's compute dtype, and the three kernels
// are one template, tc_kernel, on the tensor cores (WMMA bf16 tiles, f32
// accumulation, see below). float32 grids on the card are refused by the
// wrappers; the plain versions serve them on the CPU.
//
// Bound. The function needs the MACs of occupied (output, tap) pairs only,
// since empty cells hold zeros, and must move the listed cells' inputs and
// outputs once; at the backbone's sparse levels the bytes bound it. These
// kernels sit well above that bound: they run the MACs of every listed
// cell, empty ones too (at the finest level about 8% of listed cells are
// occupied), and stage each operand slice through shared memory with no
// overlap of loads and math. Skipping empty rows, and a cp.async / TMA
// pipeline feeding wgmma, are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int MX = 2, MY = 2, MZ = 16;

struct Grid {
  int xm, ym, zm;  // margined dims
};

struct Tiles {
  const int* t;  // (T, 3) tile coordinates over the interior
  int n_rows;    // T * cells
  int tx, ty, tz;
};

// interior coordinates of row r, or false past the last row
__device__ __forceinline__ bool row_cell(const Tiles& tl, int r, int& ix, int& iy,
                                         int& iz) {
  if (r >= tl.n_rows) return false;
  const int cells = tl.tx * tl.ty * tl.tz;
  const int t = r / cells, l = r - t * cells;
  const int lz = l % tl.tz, ly = (l / tl.tz) % tl.ty, lx = l / (tl.tz * tl.ty);
  ix = tl.t[3 * t] * tl.tx + lx;
  iy = tl.t[3 * t + 1] * tl.ty + ly;
  iz = tl.t[3 * t + 2] * tl.tz + lz;
  return true;
}

__device__ __forceinline__ long long flat(const Grid& g, int x, int y, int z) {
  return ((long long)x * g.ym + y) * g.zm + z;
}

// ---------------------------------------------------------------------------
// The implicit GEMMs on the tensor cores (WMMA, 16x16x16 bf16 tiles, f32
// accumulation). A block owns TM = 64 rows x TN = 64
// columns; each of its 4 warps keeps 16 rows x 64 columns in 4 accumulator
// fragments. Operands are staged through shared memory in TK = 32 slices with
// 16-byte loads where channel counts are multiples of 8 (every width of the
// backbone but the 3-channel stem input). The transposed conv is laid out as
// one GEMM too: its rows are the coarse parent cells of the listed fine
// tiles and its 8 * Cout columns the 8 child parities, so every parent
// writes its 8 children.

constexpr int TM = 64, TN = 64, TK = 32, TT = 128;
constexpr int LDA = TK + 8, LDB = TN + 8, LDC = TN + 4;
enum { CONV = 0, DOWN = 1, UP = 2 };

template <int MODE>
__global__ void __launch_bounds__(TT) tc_kernel(
    const __nv_bfloat16* __restrict__ x, int cin, Grid gin,
    const __nv_bfloat16* __restrict__ w, int k, int cout, Tiles tl, int n_rows,
    Grid gout, const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ occ, const __nv_bfloat16* __restrict__ res, int cres,
    const __nv_bfloat16* __restrict__ rw, const float* __restrict__ rscale,
    const float* __restrict__ rbias, const __nv_bfloat16* __restrict__ skip,
    int skip_ctot, int skip_c, int relu, int vec_a, int vec_b,
    __nv_bfloat16* __restrict__ out) {
  namespace wm = nvcuda::wmma;
  __shared__ __align__(128) __nv_bfloat16 As[TM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[TK * LDB];
  __shared__ __align__(128) float Cs[TM * LDC];
  __shared__ __align__(128) float Rs[TM * LDC];
  __shared__ long long a_base[TM];  // element offset of the row's tap-0 input
  __shared__ long long o_cell[TM];  // output cell (CONV/DOWN), valid flag (UP)
  __shared__ int pc[TM][3];         // UP: parent interior coordinates
  const int tid = threadIdx.x, warp = tid / 32;
  const int n0 = blockIdx.y * TN;
  const int K = MODE == UP ? cin : k * k * k * cin;
  const int N = MODE == UP ? 8 * cout : cout;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  if (tid < TM) {
    const int r = blockIdx.x * TM + tid;
    long long base = -1, oc = -1;
    if (MODE == UP) {
      const int hx = tl.tx / 2, hy = tl.ty / 2, hz = tl.tz / 2;
      const int pcells = hx * hy * hz;
      if (r < n_rows) {
        const int t = r / pcells, l = r - t * pcells;
        const int px = tl.t[3 * t] * hx + l / (hz * hy);
        const int py = tl.t[3 * t + 1] * hy + (l / hz) % hy;
        const int pz = tl.t[3 * t + 2] * hz + l % hz;
        pc[tid][0] = px;
        pc[tid][1] = py;
        pc[tid][2] = pz;
        base = flat(gin, px + MX, py + MY, pz + MZ) * cin;
        oc = 0;
      }
    } else {
      int ix, iy, iz;
      if (row_cell(tl, r, ix, iy, iz)) {
        const int h = MODE == DOWN ? 0 : k / 2;
        const int st = MODE == DOWN ? 2 : 1;
        oc = flat(gout, ix + MX, iy + MY, iz + MZ);
        base = flat(gin, st * ix + MX - h, st * iy + MY - h, st * iz + MZ - h) * cin;
      }
    }
    a_base[tid] = base;
    o_cell[tid] = oc;
  }
  __syncthreads();

  wm::fragment<wm::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wm::fill_fragment(acc[j], 0.f);

  for (int k0 = 0; k0 < K; k0 += TK) {
    // A: the rows' inputs for reduction indices k0 .. k0 + TK
    if (vec_a) {
      for (int v = tid; v < TM * TK / 8; v += TT) {
        const int m = v / (TK / 8), kq = (v % (TK / 8)) * 8, kg = k0 + kq;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (a_base[m] >= 0 && kg < K) {
          long long off = kg;
          if (MODE != UP) {
            const int tap = kg / cin, c = kg - tap * cin;
            const int dx = tap % k, dy = (tap / k) % k, dz = tap / (k * k);
            off = ((long long)dx * gin.ym + dy) * gin.zm * cin + (long long)dz * cin + c;
          }
          val = *reinterpret_cast<const uint4*>(x + a_base[m] + off);
        }
        *reinterpret_cast<uint4*>(As + m * LDA + kq) = val;
      }
    } else {
      for (int e = tid; e < TM * TK; e += TT) {
        const int m = e / TK, kq = e % TK, kg = k0 + kq;
        __nv_bfloat16 val = zero;
        if (a_base[m] >= 0 && kg < K) {
          long long off = kg;
          if (MODE != UP) {
            const int tap = kg / cin, c = kg - tap * cin;
            const int dx = tap % k, dy = (tap / k) % k, dz = tap / (k * k);
            off = ((long long)dx * gin.ym + dy) * gin.zm * cin + (long long)dz * cin + c;
          }
          val = x[a_base[m] + off];
        }
        As[m * LDA + kq] = val;
      }
    }
    // B: weight rows k0 .. k0 + TK, columns n0 .. n0 + TN
    if (vec_b) {
      for (int v = tid; v < TK * TN / 8; v += TT) {
        const int kk = v / (TN / 8), nq = (v % (TN / 8)) * 8;
        const int kg = k0 + kk, n = n0 + nq;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (kg < K && n < N) {
          const long long src = MODE == UP
              ? ((long long)(n / cout) * cin + kg) * cout + n % cout
              : (long long)kg * cout + n;
          val = *reinterpret_cast<const uint4*>(w + src);
        }
        *reinterpret_cast<uint4*>(Bs + kk * LDB + nq) = val;
      }
    } else {
      for (int e = tid; e < TK * TN; e += TT) {
        const int kk = e / TN, nq = e % TN, kg = k0 + kk, n = n0 + nq;
        __nv_bfloat16 val = zero;
        if (kg < K && n < N) {
          val = MODE == UP ? w[((long long)(n / cout) * cin + kg) * cout + n % cout]
                           : w[(long long)kg * cout + n];
        }
        Bs[kk * LDB + nq] = val;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major> a;
      wm::load_matrix_sync(a, As + warp * 16 * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major> b;
        wm::load_matrix_sync(b, Bs + kk * LDB + j * 16, LDB);
        wm::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wm::store_matrix_sync(Cs + warp * 16 * LDC + j * 16, acc[j], LDC, wm::mem_row_major);

  // fused 1x1 downsample branch: a second GEMM over the residual's channels
  if (MODE == CONV && rw != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wm::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < cres; k0 += TK) {
      for (int e = tid; e < TM * TK; e += TT) {
        const int m = e / TK, c = k0 + e % TK;
        const long long oc = o_cell[m];
        As[m * LDA + e % TK] = (oc >= 0 && c < cres) ? res[oc * cres + c] : zero;
      }
      for (int e = tid; e < TK * TN; e += TT) {
        const int kk = e / TN, c = k0 + kk, n = n0 + e % TN;
        Bs[kk * LDB + e % TN] = (c < cres && n < cout) ? rw[(long long)c * cout + n] : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        wm::fragment<wm::matrix_a, 16, 16, 16, __nv_bfloat16, wm::row_major> a;
        wm::load_matrix_sync(a, As + warp * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wm::fragment<wm::matrix_b, 16, 16, 16, __nv_bfloat16, wm::row_major> b;
          wm::load_matrix_sync(b, Bs + kk * LDB + j * 16, LDB);
          wm::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wm::store_matrix_sync(Rs + warp * 16 * LDC + j * 16, acc[j], LDC, wm::mem_row_major);
  }
  __syncthreads();

  const int ctot = MODE == UP ? cout + skip_c : cout;
  for (int e = tid; e < TM * TN; e += TT) {
    const int m = e / TN, nn = e % TN, n = n0 + nn;
    if (o_cell[m] < 0 || n >= N) continue;
    int co = n;
    long long oc = o_cell[m];
    if (MODE == UP) {
      const int d = n / cout;
      co = n - d * cout;
      oc = flat(gout, 2 * pc[m][0] + (d & 1) + MX, 2 * pc[m][1] + ((d >> 1) & 1) + MY,
                2 * pc[m][2] + (d >> 2) + MZ);
    }
    float v = Cs[m * LDC + nn];
    const float o = occ != nullptr ? occ[oc] : 1.f;
    if (scale != nullptr) v = v * scale[co] + bias[co];
    if (occ != nullptr) v = v * o;
    if (MODE == CONV && res != nullptr) {
      float rv;
      if (rw != nullptr) {
        rv = Rs[m * LDC + nn] * rscale[co] + rbias[co];
        if (occ != nullptr) rv = rv * o;
      } else {
        rv = __bfloat162float(res[oc * cout + co]);
      }
      v = v + rv;
    }
    if (relu) v = fmaxf(v, 0.f);
    out[oc * ctot + co] = __float2bfloat16(v);
  }
  // fused U-Net concat: each parent copies its 8 children's skip channels
  if (MODE == UP && blockIdx.y == 0 && skip != nullptr) {
    for (int e = tid; e < TM * 8 * skip_c; e += TT) {
      const int m = e / (8 * skip_c), rem = e % (8 * skip_c);
      const int d = rem / skip_c, c = rem % skip_c;
      if (o_cell[m] < 0) continue;
      const long long oc = flat(gout, 2 * pc[m][0] + (d & 1) + MX,
                                2 * pc[m][1] + ((d >> 1) & 1) + MY,
                                2 * pc[m][2] + (d >> 2) + MZ);
      out[oc * ctot + cout + c] = skip[oc * skip_ctot + c];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int MODE>
void launch_tc(const void* x, int cin, Grid gin, const void* w, int k, int cout,
               Tiles tl, int n_rows, Grid gout, const float* scale, const float* bias,
               const float* occ, const void* res, int cres, const void* rw,
               const float* rscale, const float* rbias, const void* skip,
               int skip_ctot, int skip_c, int relu, void* out, cudaStream_t s) {
  const int n = MODE == UP ? 8 * cout : cout;
  const dim3 grid((n_rows + TM - 1) / TM, (n + TN - 1) / TN);
  const int vec_a = cin % 8 == 0 && aligned16(x);
  const int vec_b = cout % 8 == 0 && aligned16(w);
  tc_kernel<MODE><<<grid, TT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), cin, gin,
      static_cast<const __nv_bfloat16*>(w), k, cout, tl, n_rows, gout, scale, bias, occ,
      static_cast<const __nv_bfloat16*>(res), cres,
      static_cast<const __nv_bfloat16*>(rw), rscale, rbias,
      static_cast<const __nv_bfloat16*>(skip), skip_ctot, skip_c, relu, vec_a, vec_b,
      static_cast<__nv_bfloat16*>(out));
}

}  // namespace

// bfloat16 grids, weights, residual and skip; affines and occupancy are
// float32. Null pointers switch the matching epilogue step off.
extern "C" int tiled_conv3d_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* w, int k, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, const float* scale,
    const float* bias, const float* occ, const void* res, int cres, const void* rw,
    const float* rscale, const float* rbias, int relu, void* out, void* stream) {
  const Grid g{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  if (n_rows > 0)
    launch_tc<CONV>(x, cin, g, w, k, cout, tl, n_rows, g, scale, bias, occ, res, cres, rw,
                    rscale, rbias, nullptr, 0, 0, relu, out,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// x: fine grid (xm, ym, zm); out: coarse grid (cxm, cym, czm); w (8, cin, cout)
extern "C" int tiled_down2_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* w, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int cxm, int cym, int czm,
    const float* scale, const float* bias, const float* occ, int relu, void* out,
    void* stream) {
  const Grid gi{xm, ym, zm}, go{cxm, cym, czm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  if (n_rows > 0)
    launch_tc<DOWN>(x, cin, gi, w, 2, cout, tl, n_rows, go, scale, bias, occ, nullptr, 0,
                    nullptr, nullptr, nullptr, nullptr, 0, 0, relu, out,
                    static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// x: coarse grid (cxm, cym, czm); out and skip: fine grid (xm, ym, zm);
// n_rows counts the fine cells of the listed tiles (even tile dims)
extern "C" int tiled_up2_launch(
    const void* x, int cin, int cxm, int cym, int czm, const void* w, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int xm, int ym, int zm,
    const float* scale, const float* bias, const float* occ, const void* skip,
    int skip_ctot, int skip_c, int relu, void* out, void* stream) {
  const Grid gi{cxm, cym, czm}, go{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  // one GEMM row per coarse parent: 8 fine children each
  if (n_rows > 0)
    launch_tc<UP>(x, cin, gi, w, 2, cout, tl, n_rows / 8, go, scale, bias, occ, nullptr,
                  0, nullptr, nullptr, nullptr, skip, skip_ctot, skip_c, relu, out,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}
