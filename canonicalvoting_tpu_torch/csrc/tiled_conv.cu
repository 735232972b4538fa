// Occupied-tile convolutions of the dense MinkUNet backbone, for sm_90a.
//
// Replaces the Pallas TPU kernels of canonicalvoting_tpu/ops/pallas/
// tiled_conv.py: tiled_conv3d (_kernel:85), its prefolded=True stem mode,
// tiled_down2 (_down2_kernel), tiled_up2 (_up2_kernel:1392), tiled_up2_into
// (_up2v2_kernel) and tiled_block3d (_block_kernel). Each computes the same
// function over the same margined channel-last grids (X + 2MX, Y + 2MY,
// Z + 2MZ, C) and the same tile lists; cells outside the listed tiles are
// left as the caller's zeros (tiled_up2_into: as the caller's dest holds
// them). The epilogue is the TPU kernel's, in its order: BN affine,
// occupancy mask, residual (plain, or the fused 1x1 downsample with its own
// affine and mask), ReLU. Duplicate tiles (lists are padded by repeating the
// last tile) recompute and store the same values; nothing accumulates into
// the output. The grids are bfloat16, the model's compute dtype; float32
// grids on the card are refused by the wrappers, the plain versions serve
// them on the CPU.
//
// tiled_conv3d and tiled_up2: occupied-row GEMMs (conv_rows_kernel,
// up_rows_kernel). Their function needs the MACs of occupied rows only:
// an unoccupied output cell is masked to zero (plus the plain residual, if
// any), and an unoccupied coarse parent has no occupied child. The listed
// tiles hold 5-26% occupied cells at the backbone's levels and every listed
// tile holds at least one, so skipping empty 64-row blocks saves nothing;
// the rows are compacted instead:
// - compact_kernel lists the live rows of each call on the card (a warp
//   ballot scan per block and one atomicAdd per block into a row buffer and
//   a device-side count; no host sync). The GEMM grid is sized from the
//   listed rows, an upper bound, and loops over the live count. Rows whose
//   output is the plain residual alone are listed from the buffer's end and
//   written by dead_rows_kernel, an epilogue-only pass. Row order varies
//   from run to run; each row is computed alone, so outputs are bitwise
//   reproducible.
// - One warpgroup (128 threads) owns 64 live rows and up to 256 output
//   columns, so the gathered rows are read once per row block. The K loop
//   runs by tap, then by 32-channel chunk: a row's operand is one contiguous
//   run at x + (cell + tap_offset) * cin + c0, the row's cell kept in shared
//   memory and the tap offset computed once per step (64-bit element
//   offsets). A and B slices arrive by 16-byte cp.async (zero-filled past
//   the row list and past cin) into a 4-stage ring in dynamic shared memory,
//   so the loads of the next three steps overlap the math of this one; the
//   math is wgmma m64nNk16 (bf16 in, f32 accumulate) reading both operands
//   from shared memory in the unswizzled core-matrix layout (8 rows x 16
//   bytes), weights pre-transposed K-major by the wrapper. The 3-channel
//   stem's A side takes element loads into the same ring.
// - The fused 1x1 downsample is a first K phase (a k = 1 conv over the
//   residual grid) whose masked, affine result is kept in shared memory in
//   float32 for the epilogue. The epilogue stages the accumulators through
//   shared memory and writes 16-byte vectors.
// - When the live rows are too few to fill the card (L3, L4: 16-67 row
//   blocks), the conv splits K over blocks: k_splits works the count out on
//   the card from the live count, each split writes its raw float32 sums
//   (and split 0 the fused 1x1's result) to the wrapper's scratch, and
//   split_reduce_kernel adds them in split order and runs the epilogue, so
//   the output stays bitwise reproducible.
// - The up is one GEMM a parity: the live parents' input rows (64 x cin)
//   are loaded once into shared memory, the 8 parities' weight slices
//   stream through the ring, and each parity's epilogue writes its child's
//   cout channels with 16-byte stores at occupied children only (the rest
//   are the wrapper's zeros). skip_copy_kernel copies the U-Net skip into
//   every listed fine cell with 16-byte vectors.
// What bounds them: at the sparse levels the listed cells' bytes (inputs
// gathered per tap mostly hit L2); the weights are re-read from L2 by every
// row block, which dominates at L3 and L4, where the calls are also short
// enough for the host's launches to matter. The wrapper's zero fill of the
// whole output grid is outside these kernels.
//
// DOWN, PREF and UPI, the modes of tc_kernel, are implicit GEMMs over the
// flattened cells of all listed tiles (row = tile * cells + local cell, z
// fastest) on WMMA bf16 tiles with f32 accumulation. Columns are output
// channels; the reduction walks taps x input channels (kg = tap * cin + c,
// taps x-fastest). A tap's input cell is the row's base cell plus a
// constant offset, because the grids' zero margins absorb every halo read.
// They run the MACs of every listed cell and stage each operand slice
// through shared memory with no overlap of loads and math.
//
// The prefolded stem (PREF) is that GEMM over fold_dydz's grid: the (dy, dz)
// taps of the k = 5 stem already sit in its channels (lane c*k*k + dz*k +
// dy, padded to a multiple of 8 so the 16-byte operand loads stay aligned),
// so only the k x-offsets remain as taps (offset (dx - h) * Ym * Zm cells)
// and the reduction is k * Cf, with the weights in _fold_w's prefolded row
// order (dx; c, dz, dy).
//
// tiled_up2_into (UPI) is the transposed conv's GEMM over the coarse parents
// of the listed fine tiles (8 * Cout columns, one per child parity), writing
// its conv channels into a caller's grid at a channel offset and pitch:
// dest holds the skip in channels [0, skip_c) and receives the conv at
// [skip_c, skip_c + cout), the layout [skip | conv] of the JAX kernel;
// nothing else of dest is touched. The TPU kernel's lane pack of the
// occupancy (pack_occ_updma) is a TPU layout; this mode reads the margined
// occupancy grid as the others do.
//
// tiled_block3d (block_kernel, below) runs a whole BasicBlock per tile:
// conv1 over the tile grown by one cell, kept in a per-block global scratch
// (the grown tile's mid does not fit shared memory: 461 KB at L2), then conv2
// over the tile from that scratch, with the residual. Its bound counts the
// input window, output and both weights once and no mid; it runs the MACs
// of every listed and grown cell, and conv1's grown cells are 1.3x-5x the
// tile's at the backbone's tile shapes.

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

// interior coordinates of coarse parent r of the listed fine tiles (even
// tile dims: each tile holds (tx/2)(ty/2)(tz/2) parents, z fastest)
__device__ __forceinline__ void parent_cell(const Tiles& tl, int r, int& px, int& py,
                                            int& pz) {
  const int hx = tl.tx / 2, hy = tl.ty / 2, hz = tl.tz / 2;
  const int pcells = hx * hy * hz;
  const int t = r / pcells, l = r - t * pcells;
  px = tl.t[3 * t] * hx + l / (hz * hy);
  py = tl.t[3 * t + 1] * hy + (l / hz) % hy;
  pz = tl.t[3 * t + 2] * hz + l % hz;
}

__device__ __forceinline__ long long flat(const Grid& g, int x, int y, int z) {
  return ((long long)x * g.ym + y) * g.zm + z;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// ---------------------------------------------------------------------------
// tc_kernel: the WMMA implicit GEMMs of tiled_down2 (DOWN), the prefolded
// stem (PREF) and tiled_up2_into (UPI). A block owns TM = 64 rows x TN = 64
// columns; each of its 4 warps keeps 16 rows x 64 columns in 4 accumulator
// fragments. Operands are staged through shared memory in TK = 32 slices
// with 16-byte loads where channel counts are multiples of 8.

constexpr int TM = 64, TN = 64, TK = 32, TT = 128;
constexpr int LDA = TK + 8, LDB = TN + 8, LDC = TN + 4;
enum { DOWN = 1, PREF = 3, UPI = 4 };

template <int MODE>
__global__ void __launch_bounds__(TT) tc_kernel(
    const __nv_bfloat16* __restrict__ x, int cin, Grid gin,
    const __nv_bfloat16* __restrict__ w, int k, int cout, Tiles tl, int n_rows,
    Grid gout, const float* __restrict__ scale, const float* __restrict__ bias,
    const float* __restrict__ occ, int ctot, int c_off, int relu, int vec_a, int vec_b,
    __nv_bfloat16* __restrict__ out) {
  namespace wm = nvcuda::wmma;
  __shared__ __align__(128) __nv_bfloat16 As[TM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[TK * LDB];
  __shared__ __align__(128) float Cs[TM * LDC];
  __shared__ long long a_base[TM];  // element offset of the row's tap-0 input
  __shared__ long long o_cell[TM];  // output cell (DOWN/PREF), valid flag (UPI)
  __shared__ int pc[TM][3];         // UPI: parent interior coordinates
  constexpr bool kUp = MODE == UPI;
  const int tid = threadIdx.x, warp = tid / 32;
  const int n0 = blockIdx.y * TN;
  const int K = kUp ? cin : MODE == PREF ? k * cin : k * k * k * cin;
  const int N = kUp ? 8 * cout : cout;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  if (tid < TM) {
    const int r = blockIdx.x * TM + tid;
    long long base = -1, oc = -1;
    if (kUp) {
      if (r < n_rows) {
        int px, py, pz;
        parent_cell(tl, r, px, py, pz);
        pc[tid][0] = px;
        pc[tid][1] = py;
        pc[tid][2] = pz;
        base = flat(gin, px + MX, py + MY, pz + MZ) * cin;
        oc = 0;
      }
    } else {
      int ix, iy, iz;
      if (row_cell(tl, r, ix, iy, iz)) {
        const int h = MODE == DOWN ? 0 : k / 2;  // prefolded: x taps only
        const int st = MODE == DOWN ? 2 : 1;
        oc = flat(gout, ix + MX, iy + MY, iz + MZ);
        base = flat(gin, st * ix + MX - h, st * iy + MY, st * iz + MZ) * cin;
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
          if (!kUp) {
            const int tap = kg / cin, c = kg - tap * cin;
            const int dx = MODE == PREF ? tap : tap % k;
            const int dy = MODE == PREF ? 0 : (tap / k) % k;
            const int dz = MODE == PREF ? 0 : tap / (k * k);
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
          if (!kUp) {
            const int tap = kg / cin, c = kg - tap * cin;
            const int dx = MODE == PREF ? tap : tap % k;
            const int dy = MODE == PREF ? 0 : (tap / k) % k;
            const int dz = MODE == PREF ? 0 : tap / (k * k);
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
          const long long src = kUp
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
          val = kUp ? w[((long long)(n / cout) * cin + kg) * cout + n % cout]
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
  __syncthreads();

  // UPI writes into a (ctot)-channel grid at channels [c_off, c_off + cout)
  for (int e = tid; e < TM * TN; e += TT) {
    const int m = e / TN, nn = e % TN, n = n0 + nn;
    if (o_cell[m] < 0 || n >= N) continue;
    int co = n;
    long long oc = o_cell[m];
    if (kUp) {
      const int d = n / cout;
      co = n - d * cout;
      oc = flat(gout, 2 * pc[m][0] + (d & 1) + MX, 2 * pc[m][1] + ((d >> 1) & 1) + MY,
                2 * pc[m][2] + (d >> 2) + MZ);
    }
    float v = Cs[m * LDC + nn];
    if (scale != nullptr) v = v * scale[co] + bias[co];
    if (occ != nullptr) v = v * occ[oc];
    if (relu) v = fmaxf(v, 0.f);
    out[oc * ctot + c_off + co] = __float2bfloat16(v);
  }
}

template <int MODE>
void launch_tc(const void* x, int cin, Grid gin, const void* w, int k, int cout,
               Tiles tl, int n_rows, Grid gout, const float* scale, const float* bias,
               const float* occ, int ctot, int c_off, int relu, void* out, cudaStream_t s) {
  const int n = MODE == UPI ? 8 * cout : cout;
  const dim3 grid((n_rows + TM - 1) / TM, (n + TN - 1) / TN);
  const int vec_a = cin % 8 == 0 && aligned16(x);
  const int vec_b = cout % 8 == 0 && aligned16(w);
  tc_kernel<MODE><<<grid, TT, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), cin, gin,
      static_cast<const __nv_bfloat16*>(w), k, cout, tl, n_rows, gout, scale, bias, occ,
      ctot, c_off, relu, vec_a, vec_b, static_cast<__nv_bfloat16*>(out));
}

// ---------------------------------------------------------------------------
// The occupied-row GEMMs of tiled_conv3d and tiled_up2 (see the header).

constexpr int GM = 64;            // rows a block: one wgmma m64 tile
constexpr int GK = 32;            // channels a K step: two k16 wgmmas
constexpr int GT = 128;           // one warpgroup
constexpr int STAGES = 4;         // cp.async ring depth
constexpr int A_STAGE = GM * GK * 2;
constexpr int CORE = 128;         // bytes of a core matrix (8 rows x 16 bytes)
constexpr int MAX_GRID = 1024;    // row blocks looping over the live count
constexpr int MAX_SMEM = 230400;  // 227 KB a block, less its static arrays

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !full (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory matrix descriptor, no swizzle, K-major: lbo is the
// byte distance between core matrices adjacent in K, sbo between 8-row
// groups. Every operand tile here is laid out [8-row group][16-byte K
// chunk][8 rows][8 values]: lbo = 128 and sbo = 128 * (K chunks a row).
__device__ __forceinline__ uint64_t sdesc(const void* p, uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(CORE >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}
// byte offset of (row, 16-byte chunk) in that layout, kc chunks a row
__device__ __forceinline__ int core_off(int row, int chunk, int kc) {
  return (row >> 3) * kc * CORE + chunk * CORE + (row & 7) * 16;
}

// D (64 x N, f32 in registers) += A (64 x 16) * B (16 x N), both K-major
// in shared memory; accumulator fragment of thread t: rows 16 (t / 32) +
// (t % 32) / 4 + {0, 8}, columns 8 q + 2 (t % 4) + {0, 1}, register
// 4 q + 2 (row half) + column.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[48], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}


// N output columns of a block as NH wgmmas of NW columns each
template <int BN>
struct Cols {
  static constexpr int NW = BN > 128 ? 128 : BN;
  static constexpr int NH = BN / NW;
};

// the live rows of one call. Conv (up = 0): listed row r is live when occ
// is null or occ at its cell is non-zero; with want_dead, the other listed
// rows are listed from the buffer's end (count[1] of them). Up (up = 1):
// row r is the r-th coarse parent, live when any of its 8 children is
// occupied. rows[0, count[0]) receives the live rows, in no fixed order.
__global__ void __launch_bounds__(256) compact_kernel(Tiles tl, Grid g, const float* occ,
                                                      int up, int n_list, int* rows,
                                                      int* count, int want_dead) {
  __shared__ int wl[8], wd[8], base_l, base_d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x * 256 + tid;
  bool live = false;
  const bool listed = r < n_list;
  if (listed) {
    if (occ == nullptr) {
      live = true;
    } else if (up) {
      int px, py, pz;
      parent_cell(tl, r, px, py, pz);
#pragma unroll
      for (int d = 0; d < 8; ++d)
        live |= occ[flat(g, 2 * px + (d & 1) + MX, 2 * py + ((d >> 1) & 1) + MY,
                         2 * pz + (d >> 2) + MZ)] != 0.f;
    } else {
      int ix, iy, iz;
      row_cell(tl, r, ix, iy, iz);
      live = occ[flat(g, ix + MX, iy + MY, iz + MZ)] != 0.f;
    }
  }
  const bool dead = listed && !live && want_dead;
  const unsigned bl = __ballot_sync(0xffffffffu, live);
  const unsigned bd = __ballot_sync(0xffffffffu, dead);
  if (lane == 0) {
    wl[warp] = __popc(bl);
    wd[warp] = __popc(bd);
  }
  __syncthreads();
  if (tid == 0) {
    int sl = 0, sd = 0;
    for (int w = 0; w < 8; ++w) {
      const int a = wl[w], b = wd[w];
      wl[w] = sl;
      wd[w] = sd;
      sl += a;
      sd += b;
    }
    base_l = sl ? atomicAdd(count, sl) : 0;
    base_d = sd ? atomicAdd(count + 1, sd) : 0;
  }
  __syncthreads();
  const unsigned lt = (1u << lane) - 1;
  if (live) rows[base_l + wl[warp] + __popc(bl & lt)] = r;
  if (dead) rows[n_list - 1 - (base_d + wd[warp] + __popc(bd & lt))] = r;
}

// One K phase of a conv block: x's taps (k^3 of them, x-fastest, offsets
// from the row's cell) by 32-channel chunks against wt (cout, k^3, cpad).
// The fused 1x1 downsample is the same loader with k = 1 over the residual.
struct TapLoader {
  const __nv_bfloat16* x;
  int cin, k, vec;
  Grid g;
  const __nv_bfloat16* wt;
  int cpad, cout, n0;
  const int* cell;  // shared: the rows' cells, -1 past the live rows

  __device__ __forceinline__ int steps() const { return k * k * k * (cpad / GK); }

  template <int BN>
  __device__ __forceinline__ void load(int s, uint8_t* st) const {
    const int nkc = cpad / GK, taps = k * k * k, h = k / 2;
    const int tap = s / nkc, c0 = (s - tap * nkc) * GK;
    const int dx = tap % k, dy = (tap / k) % k, dz = tap / (k * k);
    const int off = ((dx - h) * g.ym + (dy - h)) * g.zm + (dz - h);
    if (vec) {
      for (int v = threadIdx.x; v < GM * (GK / 8); v += GT) {
        const int m = v >> 2, q = v & 3, c = c0 + q * 8, cl = cell[m];
        const bool ok = cl >= 0 && c < cin;
        cp_async16(st + core_off(m, q, GK / 8),
                   ok ? x + (long long)(cl + off) * cin + c : x, ok);
      }
    } else {  // element loads (cin not a multiple of 8)
      for (int e = threadIdx.x; e < GM * GK; e += GT) {
        const int m = e / GK, kk = e % GK, c = c0 + kk, cl = cell[m];
        __nv_bfloat16 val = __float2bfloat16(0.f);
        if (cl >= 0 && c < cin) val = x[(long long)(cl + off) * cin + c];
        *reinterpret_cast<__nv_bfloat16*>(st + core_off(m, kk >> 3, GK / 8) +
                                          (kk & 7) * 2) = val;
      }
    }
    uint8_t* sb = st + A_STAGE;
    for (int v = threadIdx.x; v < BN * (GK / 8); v += GT) {
      const int n = v >> 2, q = v & 3, gn = n0 + n;
      const bool ok = gn < cout;
      cp_async16(sb + core_off(n, q, GK / 8),
                 ok ? wt + ((long long)gn * taps + tap) * cpad + c0 + q * 8 : wt, ok);
    }
  }
};

// acc = the rows' GEMM over ld's K steps [first, first + steps) through
// the STAGES-deep ring. Each step: wait for its slice, fence it for the
// async proxy, barrier (so the slot read by the previous step is free for
// every warp), issue the copies STAGES - 1 steps ahead, then the wgmmas on
// this slice.
template <int BN>
__device__ __forceinline__ void ring_gemm(const TapLoader& ld, int first, int steps,
                                          uint8_t* ring,
                                          float (&acc)[Cols<BN>::NH][Cols<BN>::NW / 2]) {
  constexpr int NW = Cols<BN>::NW, NH = Cols<BN>::NH;
  constexpr int STAGE = A_STAGE + BN * GK * 2;
#pragma unroll
  for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) acc[hh][i] = 0.f;
    fence_regs(acc[hh]);
  }
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) ld.template load<BN>(first + s, ring + s * STAGE);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const int nx = s + STAGES - 1;
    if (nx < steps) ld.template load<BN>(first + nx, ring + (nx % STAGES) * STAGE);
    cp_async_commit();
    const uint8_t* a = ring + (s % STAGES) * STAGE;
    const uint8_t* b = a + A_STAGE;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint64_t da = sdesc(a + 2 * j * CORE, (GK / 8) * CORE);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
        wgmma_bf16(acc[hh], da,
                   sdesc(b + hh * (NW / 8) * (GK / 8) * CORE + 2 * j * CORE,
                         (GK / 8) * CORE));
    }
    wgmma_commit();
    wgmma_wait0();
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
  }
  cp_async_wait<0>();
  __syncthreads();
}

struct ConvRows {
  const __nv_bfloat16* x;
  int cin, cpad, k;
  Grid g;
  const __nv_bfloat16* wt;  // (cout, k^3, cpad)
  int cout;
  Tiles tl;
  const int* rows;
  const int* count;
  const float* scale;
  const float* bias;
  const float* occ;
  const __nv_bfloat16* res;  // plain residual (cout channels) or the 1x1's input
  int cres, crpad;
  const __nv_bfloat16* rwt;  // (cout, crpad): the fused 1x1, or null
  const float* rscale;
  const float* rbias;
  int relu, vec_a, vec_r, vec_o;
  __nv_bfloat16* out;
  float* part;    // (s_max [+ 1 for the fused 1x1], n_list, cout) split-K sums
  int s_max;      // most K splits part holds (1: none)
  int n_list;     // listed rows, part's row count
  int target;     // work items that fill the card: 2 x the SM count
};

// K splits of one call, worked out on the card from the live rows alone:
// enough (rows block x column block x split) items to fill the card, at
// most s_max. Every pass of the call computes the same number.
__device__ __forceinline__ int k_splits(const ConvRows& p, int n_live, int col_blocks) {
  const int items = (n_live + GM - 1) / GM * col_blocks;
  if (items == 0 || p.s_max <= 1) return 1;
  const int s = (p.target + items - 1) / items;
  return s < p.s_max ? s : p.s_max;
}

template <int BN>
__host__ __device__ constexpr int conv_ring_bytes() {
  return STAGES * (A_STAGE + BN * GK * 2);
}
template <int BN>
__host__ __device__ constexpr int conv_stage_bytes() {  // the fused 1x1's result, float32
  return GM * (BN + 4) * 4;
}

template <int BN>
__global__ void __launch_bounds__(GT, 1) conv_rows_kernel(const __grid_constant__ ConvRows p) {
  constexpr int NW = Cols<BN>::NW, NH = Cols<BN>::NH, LD = BN + 4;
  static_assert(conv_ring_bytes<BN>() >= GM * LD * 4, "the staging tile aliases the ring");
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem;
  float* cs = reinterpret_cast<float*>(smem);  // epilogue staging, once the ring drains
  float* rs = reinterpret_cast<float*>(smem + conv_ring_bytes<BN>());
  __shared__ int cell[GM];
  __shared__ float orow[GM];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * BN;
  const int n_live = p.count[0];
  const TapLoader main_ld{p.x, p.cin, p.k, p.vec_a, p.g, p.wt, p.cpad, p.cout, n0, cell};
  const TapLoader res_ld{p.res, p.cres, 1, p.vec_r, p.g, p.rwt, p.crpad, p.cout, n0, cell};
  float acc[NH][NW / 2];
  const int n_split = k_splits(p, n_live, gridDim.y);
  const int steps = main_ld.steps();

  // work item = (row block rb, K split sp); with one split the block also
  // runs the epilogue, with more split_reduce_kernel sums the splits
  for (int it = blockIdx.x; it < (n_live + GM - 1) / GM * n_split; it += gridDim.x) {
    const int rb = it / n_split, sp = it - rb * n_split;
    if (tid < GM) {
      const int i = rb * GM + tid;
      int c = -1;
      float o = 1.f;
      if (i < n_live) {
        int ix, iy, iz;
        row_cell(p.tl, p.rows[i], ix, iy, iz);
        c = static_cast<int>(flat(p.g, ix + MX, iy + MY, iz + MZ));
        if (p.occ != nullptr) o = p.occ[c];
      }
      cell[tid] = c;
      orow[tid] = o;
    }
    __syncthreads();
    if (p.rwt != nullptr && sp == 0) {  // the fused 1x1: occ * (res @ rw * rscale + rbias)
      ring_gemm<BN>(res_ld, 0, res_ld.steps(), ring, acc);
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int q = 0; q < NW / 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = warp * 16 + (lane >> 2) + 8 * (e >> 1);
            const int n = hh * NW + q * 8 + (lane & 3) * 2 + (e & 1), gn = n0 + n;
            float v = acc[hh][4 * q + e];
            if (gn < p.cout) v = v * p.rscale[gn] + p.rbias[gn];
            if (p.occ != nullptr) v = v * orow[m];
            if (n_split == 1) {
              rs[m * LD + n] = v;
            } else if (cell[m] >= 0 && gn < p.cout) {  // the slice after the splits
              p.part[((long long)n_split * p.n_list + rb * GM + m) * p.cout + gn] = v;
            }
          }
    }
    const int k0 = (int)((long long)steps * sp / n_split);
    const int k1 = (int)((long long)steps * (sp + 1) / n_split);
    ring_gemm<BN>(main_ld, k0, k1 - k0, ring, acc);
    if (n_split > 1) {  // this split's raw sums
#pragma unroll
      for (int hh = 0; hh < NH; ++hh)
#pragma unroll
        for (int q = 0; q < NW / 8; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = warp * 16 + (lane >> 2) + 8 * (e >> 1);
            const int n = hh * NW + q * 8 + (lane & 3) * 2 + (e & 1), gn = n0 + n;
            if (cell[m] >= 0 && gn < p.cout)
              p.part[((long long)sp * p.n_list + rb * GM + m) * p.cout + gn] = acc[hh][4 * q + e];
          }
      __syncthreads();  // cell is rewritten by the next item
      continue;
    }
    // BN affine, then the mask, into the staging tile
#pragma unroll
    for (int hh = 0; hh < NH; ++hh)
#pragma unroll
      for (int q = 0; q < NW / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = warp * 16 + (lane >> 2) + 8 * (e >> 1);
          const int n = hh * NW + q * 8 + (lane & 3) * 2 + (e & 1), gn = n0 + n;
          float v = acc[hh][4 * q + e];
          if (p.scale != nullptr && gn < p.cout) v = v * p.scale[gn] + p.bias[gn];
          if (p.occ != nullptr) v = v * orow[m];
          cs[m * LD + n] = v;
        }
    __syncthreads();
    // then the residual and ReLU, 8 channels a thread
    for (int e = tid; e < GM * (BN / 8); e += GT) {
      const int m = e / (BN / 8), n = (e % (BN / 8)) * 8, gn = n0 + n, cl = cell[m];
      if (cl < 0 || gn >= p.cout) continue;
      const long long o = (long long)cl * p.cout + gn;
      float v[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) v[t] = cs[m * LD + n + t];
      if (p.vec_o) {
        if (p.rwt != nullptr) {
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += rs[m * LD + n + t];
        } else if (p.res != nullptr) {
          const uint4 r = *reinterpret_cast<const uint4*>(p.res + o);
          const __nv_bfloat16* rb16 = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
          for (int t = 0; t < 8; ++t) v[t] += __bfloat162float(rb16[t]);
        }
        uint4 packed;
        __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
        for (int t = 0; t < 8; ++t) pb[t] = __float2bfloat16(p.relu ? fmaxf(v[t], 0.f) : v[t]);
        *reinterpret_cast<uint4*>(p.out + o) = packed;
      } else {
        for (int t = 0; t < 8 && gn + t < p.cout; ++t) {
          float u = v[t];
          if (p.rwt != nullptr) u += rs[m * LD + n + t];
          else if (p.res != nullptr) u += __bfloat162float(p.res[o + t]);
          p.out[o + t] = __float2bfloat16(p.relu ? fmaxf(u, 0.f) : u);
        }
      }
    }
    __syncthreads();  // cell, cs and rs are rewritten by the next row block
  }
}

// the split sums of each live row in split order, then the epilogue:
// affine, mask, residual (plain, or the fused 1x1's slice), ReLU
__global__ void __launch_bounds__(256) split_reduce_kernel(const __grid_constant__ ConvRows p,
                                                           int col_blocks) {
  const int n_live = p.count[0];
  const int n_split = k_splits(p, n_live, col_blocks);
  if (n_split == 1) return;
  const int nv = p.vec_o ? p.cout / 8 : p.cout, w = p.vec_o ? 8 : 1;
  const long long n = (long long)n_live * nv;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int i = static_cast<int>(e / nv), c0 = static_cast<int>(e % nv) * w;
    int ix, iy, iz;
    row_cell(p.tl, p.rows[i], ix, iy, iz);
    const long long cl = flat(p.g, ix + MX, iy + MY, iz + MZ);
    const float o = p.occ != nullptr ? p.occ[cl] : 1.f;
    float v[8];
    uint4 rv = make_uint4(0, 0, 0, 0);  // the plain residual's channels
    __nv_bfloat16* r = reinterpret_cast<__nv_bfloat16*>(&rv);
    if (p.rwt == nullptr && p.res != nullptr) {
      if (w == 8) rv = *reinterpret_cast<const uint4*>(p.res + cl * p.cout + c0);
      else r[0] = p.res[cl * p.cout + c0];
    }
    for (int t = 0; t < w; ++t) {
      const int c = c0 + t;
      float a = 0.f;
      for (int sp = 0; sp < n_split; ++sp) a += p.part[((long long)sp * p.n_list + i) * p.cout + c];
      if (p.scale != nullptr) a = a * p.scale[c] + p.bias[c];
      if (p.occ != nullptr) a = a * o;
      if (p.rwt != nullptr) a += p.part[((long long)n_split * p.n_list + i) * p.cout + c];
      else if (p.res != nullptr) a += __bfloat162float(r[t]);
      v[t] = p.relu ? fmaxf(a, 0.f) : a;
    }
    if (w == 8) {
      uint4 packed;
      __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(&packed);
#pragma unroll
      for (int t = 0; t < 8; ++t) pb[t] = __float2bfloat16(v[t]);
      *reinterpret_cast<uint4*>(p.out + cl * p.cout + c0) = packed;
    } else {
      p.out[cl * p.cout + c0] = __float2bfloat16(v[0]);
    }
  }
}

// listed rows whose occupancy is 0 under a plain residual: out = relu?(res)
__global__ void __launch_bounds__(256) dead_rows_kernel(Tiles tl, Grid g, const int* rows,
                                                        const int* count, int n_list,
                                                        const __nv_bfloat16* res, int cout,
                                                        int relu, int vec,
                                                        __nv_bfloat16* out) {
  const int nv = vec ? cout / 8 : cout;
  const long long n = (long long)count[1] * nv;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = static_cast<int>(e / nv), v = static_cast<int>(e % nv);
    int ix, iy, iz;
    row_cell(tl, rows[n_list - 1 - j], ix, iy, iz);
    const long long cl = flat(g, ix + MX, iy + MY, iz + MZ) * cout;
    if (vec) {
      uint4 r = *reinterpret_cast<const uint4*>(res + cl + v * 8);
      __nv_bfloat16* rb16 = reinterpret_cast<__nv_bfloat16*>(&r);
      if (relu) {
#pragma unroll
        for (int t = 0; t < 8; ++t)
          rb16[t] = __float2bfloat16(fmaxf(__bfloat162float(rb16[t]), 0.f));
      }
      *reinterpret_cast<uint4*>(out + cl + v * 8) = r;
    } else {
      const float u = __bfloat162float(res[cl + v]);
      out[cl + v] = __float2bfloat16(relu ? fmaxf(u, 0.f) : u);
    }
  }
}

struct UpRows {
  const __nv_bfloat16* x;
  int cin, cpad;
  Grid gin;
  const __nv_bfloat16* wt;  // (8, cout, cpad)
  int cout;
  Tiles tl;  // the fine tiles
  Grid gout;
  const int* rows;
  const int* count;
  const float* scale;
  const float* bias;
  const float* occ;
  int ctot, relu, vec_a, vec_o;
  __nv_bfloat16* out;
};

template <int BN>
__host__ __device__ constexpr int up_ring_bytes() {
  return STAGES * BN * GK * 2;
}
template <int BN>
__host__ __device__ constexpr int up_stage_bytes() {  // the bfloat16 staging tile, 128-byte rounded
  return (GM * (BN + 8) * 2 + 127) / 128 * 128;
}

// rows: live coarse parents; columns: one parity's cout at a time
template <int BN>
__global__ void __launch_bounds__(GT, 1) up_rows_kernel(const __grid_constant__ UpRows p) {
  constexpr int NW = Cols<BN>::NW, NH = Cols<BN>::NH, LD = BN + 8;
  constexpr int B_STAGE = BN * GK * 2;
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem + up_ring_bytes<BN>());
  uint8_t* as = smem + up_ring_bytes<BN>() + up_stage_bytes<BN>();  // GM x cpad
  __shared__ int pc[GM][3];   // parent interior coordinates
  __shared__ int icell[GM];   // parent's coarse cell, -1 past the live rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * BN;
  const int n_live = p.count[0];
  const int akc = p.cpad / 8;        // 16-byte chunks of a resident A row
  const int nkc = p.cpad / GK, steps = 8 * nkc;
  float acc[NH][NW / 2];

  for (int rb = blockIdx.x; rb * GM < n_live; rb += gridDim.x) {
    if (tid < GM) {
      const int i = rb * GM + tid;
      int c = -1;
      if (i < n_live) {
        int px, py, pz;
        parent_cell(p.tl, p.rows[i], px, py, pz);
        pc[tid][0] = px;
        pc[tid][1] = py;
        pc[tid][2] = pz;
        c = static_cast<int>(flat(p.gin, px + MX, py + MY, pz + MZ));
      }
      icell[tid] = c;
    }
    __syncthreads();
    // A: the parents' input rows, once for all 8 parities
    if (p.vec_a) {
      for (int v = tid; v < GM * akc; v += GT) {
        const int m = v / akc, q = v - m * akc, c = q * 8, cl = icell[m];
        const bool ok = cl >= 0 && c < p.cin;
        cp_async16(as + core_off(m, q, akc), ok ? p.x + (long long)cl * p.cin + c : p.x, ok);
      }
    } else {
      for (int e = tid; e < GM * p.cpad; e += GT) {
        const int m = e / p.cpad, c = e - m * p.cpad, cl = icell[m];
        __nv_bfloat16 val = __float2bfloat16(0.f);
        if (cl >= 0 && c < p.cin) val = p.x[(long long)cl * p.cin + c];
        *reinterpret_cast<__nv_bfloat16*>(as + core_off(m, c >> 3, akc) + (c & 7) * 2) = val;
      }
    }
    cp_async_commit();
    // B: step s = parity d, chunk c of W[d] rows n0 .. n0 + BN
    auto load_b = [&](int s, uint8_t* sb) {
      const int d = s / nkc, c0 = (s - d * nkc) * GK;
      for (int v = tid; v < BN * (GK / 8); v += GT) {
        const int n = v >> 2, q = v & 3, gn = n0 + n;
        const bool ok = gn < p.cout;
        cp_async16(sb + core_off(n, q, GK / 8),
                   ok ? p.wt + ((long long)d * p.cout + gn) * p.cpad + c0 + q * 8 : p.wt, ok);
      }
    };
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[hh][i] = 0.f;
      fence_regs(acc[hh]);
    }
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < steps) load_b(s, ring + s * B_STAGE);
      cp_async_commit();
    }
    for (int s = 0; s < steps; ++s) {
      cp_async_wait<STAGES - 2>();
      fence_proxy_async();
      __syncthreads();
      const int nx = s + STAGES - 1;
      if (nx < steps) load_b(nx, ring + (nx % STAGES) * B_STAGE);
      cp_async_commit();
      const int d = s / nkc, c = s - d * nkc;
      const uint8_t* b = ring + (s % STAGES) * B_STAGE;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint64_t da = sdesc(as + (c * (GK / 8) + 2 * j) * CORE, akc * CORE);
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
          wgmma_bf16(acc[hh], da,
                     sdesc(b + hh * (NW / 8) * (GK / 8) * CORE + 2 * j * CORE,
                           (GK / 8) * CORE));
      }
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) fence_regs(acc[hh]);
      if (c != nkc - 1) continue;
      // parity d done: relu?(occ * (acc * scale + bias)) at child 2p + d
      const int dx = d & 1, dy = (d >> 1) & 1, dz = d >> 2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = warp * 16 + (lane >> 2) + 8 * hf;
        float o = 1.f;
        if (p.occ != nullptr && icell[m] >= 0)
          o = p.occ[flat(p.gout, 2 * pc[m][0] + dx + MX, 2 * pc[m][1] + dy + MY,
                         2 * pc[m][2] + dz + MZ)];
#pragma unroll
        for (int hh = 0; hh < NH; ++hh)
#pragma unroll
          for (int q = 0; q < NW / 8; ++q)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int n = hh * NW + q * 8 + (lane & 3) * 2 + e, gn = n0 + n;
              float v = acc[hh][4 * q + 2 * hf + e];
              if (p.scale != nullptr && gn < p.cout) v = v * p.scale[gn] + p.bias[gn];
              if (p.occ != nullptr) v = v * o;
              if (p.relu) v = fmaxf(v, 0.f);
              cs[m * LD + n] = __float2bfloat16(v);
            }
      }
#pragma unroll
      for (int hh = 0; hh < NH; ++hh) {
#pragma unroll
        for (int i = 0; i < NW / 2; ++i) acc[hh][i] = 0.f;
        fence_regs(acc[hh]);
      }
      __syncthreads();
      for (int e = tid; e < GM * (BN / 8); e += GT) {
        const int m = e / (BN / 8), n = (e % (BN / 8)) * 8, gn = n0 + n;
        if (icell[m] < 0 || gn >= p.cout) continue;
        const long long ch = flat(p.gout, 2 * pc[m][0] + dx + MX, 2 * pc[m][1] + dy + MY,
                                  2 * pc[m][2] + dz + MZ);
        if (p.occ != nullptr && p.occ[ch] == 0.f) continue;  // the wrapper's zeros
        const long long o = ch * p.ctot + gn;
        if (p.vec_o) {
          *reinterpret_cast<uint4*>(p.out + o) = *reinterpret_cast<const uint4*>(cs + m * LD + n);
        } else {
          for (int t = 0; t < 8 && gn + t < p.cout; ++t) p.out[o + t] = cs[m * LD + n + t];
        }
      }
      // the next parity's staging writes follow the next step's barrier
    }
    cp_async_wait<0>();
    __syncthreads();  // pc, icell, as and cs are rewritten by the next row block
  }
}

// the U-Net skip into channels [cout, cout + skip_c) of every listed fine
// cell, 8 channels a thread where the widths allow
__global__ void __launch_bounds__(256) skip_copy_kernel(Tiles tl, Grid g,
                                                        const __nv_bfloat16* skip,
                                                        int skip_ctot, int skip_c, int cout,
                                                        int ctot, int vec,
                                                        __nv_bfloat16* out) {
  const int nv = vec ? skip_c / 8 : skip_c;
  const long long n = (long long)tl.n_rows * nv;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int r = static_cast<int>(e / nv), v = static_cast<int>(e % nv);
    int ix, iy, iz;
    row_cell(tl, r, ix, iy, iz);
    const long long cl = flat(g, ix + MX, iy + MY, iz + MZ);
    if (vec)
      *reinterpret_cast<uint4*>(out + cl * ctot + cout + v * 8) =
          *reinterpret_cast<const uint4*>(skip + cl * skip_ctot + v * 8);
    else
      out[cl * ctot + cout + v] = skip[cl * skip_ctot + v];
  }
}

int blocks_for(long long work, int per_block) {
  const long long b = (work + per_block - 1) / per_block;
  return static_cast<int>(b < MAX_GRID ? (b > 0 ? b : 1) : MAX_GRID);
}

template <int BN>
cudaError_t launch_conv_rows(const ConvRows& p, int n_list, cudaStream_t s) {
  const int smem = conv_ring_bytes<BN>() + (p.rwt != nullptr ? conv_stage_bytes<BN>() : 0);
  cudaError_t e = cudaFuncSetAttribute(conv_rows_kernel<BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks_for((long long)n_list * p.s_max, GM), (p.cout + BN - 1) / BN);
  conv_rows_kernel<BN><<<grid, GT, smem, s>>>(p);
  if (p.s_max > 1)
    split_reduce_kernel<<<blocks_for((long long)n_list * p.cout / 8, 256), 256, 0, s>>>(
        p, static_cast<int>(grid.y));
  return cudaGetLastError();
}

template <int BN>
cudaError_t launch_up_rows(const UpRows& p, int n_list, cudaStream_t s) {
  const int smem = up_ring_bytes<BN>() + up_stage_bytes<BN>() + GM * p.cpad * 2;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(up_rows_kernel<BN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks_for(n_list, GM), (p.cout + BN - 1) / BN);
  up_rows_kernel<BN><<<grid, GT, smem, s>>>(p);
  return cudaGetLastError();
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 1;
}

// output columns a block: the narrowest wgmma tile that holds cout, 256 at most
int block_cols(int cout) {
  return cout <= 32 ? 32 : cout <= 64 ? 64 : cout <= 96 ? 96 : cout <= 128 ? 128 : 256;
}

// ---------------------------------------------------------------------------
// The fused BasicBlock (block_kernel). One block owns one listed tile at a
// time, looping over the list with a stride of the grid. conv1 runs over the
// tile grown by one cell on each side (its BN, mask and ReLU applied) into
// the block's own slice of a global scratch, in bfloat16 as the two-conv path
// rounds it; conv2 then reads its taps from that slice, adds the residual (the
// input's own channels, or the fused 1x1 downsample GEMM) and writes the
// tile. Both are the same WMMA GEMM as tc_kernel (conv_gemm), row blocks of
// 64 cells. The scratch is written and read inside one kernel, so it is read
// through plain loads (no __restrict__, which could route them through the
// non-coherent read-only cache); __syncthreads orders the writes of one
// phase before the reads of the next.

using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

// element offset of reduction index kg = tap * cin + c from a row's tap-0 input
__device__ __forceinline__ long long tap_offset(int kg, int cin, int k, Grid g) {
  const int tap = kg / cin, c = kg - tap * cin;
  const int dx = tap % k, dy = (tap / k) % k, dz = tap / (k * k);
  return ((long long)dx * g.ym + dy) * g.zm * cin + (long long)dz * cin + c;
}

// acc += A x W[:, n0 : n0 + TN] over K = k^3 * cin, where row m of A reads
// src[a_base[m] + tap_offset(kg)] (zeros where a_base[m] < 0); a_base lives in
// shared memory and is complete before the call
__device__ __forceinline__ void conv_gemm(const __nv_bfloat16* src, int cin, Grid g, int k,
                                          const long long* a_base, const __nv_bfloat16* w,
                                          int cout, int n0, int vec_a, int vec_b,
                                          __nv_bfloat16* As, __nv_bfloat16* Bs,
                                          Frag (&acc)[4]) {
  namespace wm = nvcuda::wmma;
  const int tid = threadIdx.x, warp = tid / 32;
  const int K = k * k * k * cin;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int k0 = 0; k0 < K; k0 += TK) {
    if (vec_a) {
      for (int v = tid; v < TM * TK / 8; v += TT) {
        const int m = v / (TK / 8), kq = (v % (TK / 8)) * 8, kg = k0 + kq;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (a_base[m] >= 0 && kg < K)
          val = *reinterpret_cast<const uint4*>(src + a_base[m] + tap_offset(kg, cin, k, g));
        *reinterpret_cast<uint4*>(As + m * LDA + kq) = val;
      }
    } else {
      for (int e = tid; e < TM * TK; e += TT) {
        const int m = e / TK, kq = e % TK, kg = k0 + kq;
        As[m * LDA + kq] = (a_base[m] >= 0 && kg < K)
                               ? src[a_base[m] + tap_offset(kg, cin, k, g)] : zero;
      }
    }
    if (vec_b) {
      for (int v = tid; v < TK * TN / 8; v += TT) {
        const int kk = v / (TN / 8), nq = (v % (TN / 8)) * 8;
        const int kg = k0 + kk, n = n0 + nq;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (kg < K && n < cout)
          val = *reinterpret_cast<const uint4*>(w + (long long)kg * cout + n);
        *reinterpret_cast<uint4*>(Bs + kk * LDB + nq) = val;
      }
    } else {
      for (int e = tid; e < TK * TN; e += TT) {
        const int kk = e / TN, nq = e % TN, kg = k0 + kk, n = n0 + nq;
        Bs[kk * LDB + nq] = (kg < K && n < cout) ? w[(long long)kg * cout + n] : zero;
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
}

__device__ __forceinline__ void gemm_to(float* C, int vec_a, int vec_b,
                                        const __nv_bfloat16* src, int cin, Grid g, int k,
                                        const long long* a_base, const __nv_bfloat16* w,
                                        int cout, int n0, __nv_bfloat16* As,
                                        __nv_bfloat16* Bs) {
  namespace wm = nvcuda::wmma;
  Frag acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wm::fill_fragment(acc[j], 0.f);
  conv_gemm(src, cin, g, k, a_base, w, cout, n0, vec_a, vec_b, As, Bs, acc);
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wm::store_matrix_sync(C + warp * 16 * LDC + j * 16, acc[j], LDC, wm::mem_row_major);
}

__global__ void __launch_bounds__(TT) block_kernel(
    const __nv_bfloat16* __restrict__ x, int cin, Grid g, const __nv_bfloat16* __restrict__ w1,
    const __nv_bfloat16* __restrict__ w2, int cmid, int cout, const int* __restrict__ tiles,
    int n_tiles, int tx, int ty, int tz, const float* __restrict__ scale1,
    const float* __restrict__ bias1, const float* __restrict__ scale2,
    const float* __restrict__ bias2, const float* __restrict__ occ,
    const __nv_bfloat16* __restrict__ rw, const float* __restrict__ rscale,
    const float* __restrict__ rbias, int vec_x, int vec_m, int vec_w1, int vec_w2,
    __nv_bfloat16* mid, __nv_bfloat16* __restrict__ out) {
  __shared__ __align__(128) __nv_bfloat16 As[TM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[TK * LDB];
  __shared__ __align__(128) float Cs[TM * LDC];
  __shared__ __align__(128) float Rs[TM * LDC];
  __shared__ long long a_base[TM];  // tap-0 input of the row (x or the scratch)
  __shared__ long long r_base[TM];  // the row's own input cell (1x1 downsample)
  __shared__ long long o_cell[TM];  // the row's cell in the margined grid
  const int tid = threadIdx.x;
  const int ex = tx + 2, ey = ty + 2, ez = tz + 2;
  const int ne = ex * ey * ez, nc = tx * ty * tz;
  const Grid ge{ex, ey, ez};
  __nv_bfloat16* ms = mid + (long long)blockIdx.x * ne * cmid;

  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int ox = tiles[3 * t] * tx, oy = tiles[3 * t + 1] * ty, oz = tiles[3 * t + 2] * tz;
    // conv1 -> BN -> mask -> ReLU over the grown tile: expanded cell (lx, ly,
    // lz) is interior cell (ox + lx - 1, ...); the margins absorb the reads
    for (int r0 = 0; r0 < ne; r0 += TM) {
      if (tid < TM) {
        const int r = r0 + tid;
        long long base = -1, oc = -1;
        if (r < ne) {
          const int lx = r / (ey * ez), ly = (r / ez) % ey, lz = r % ez;
          oc = flat(g, ox + lx - 1 + MX, oy + ly - 1 + MY, oz + lz - 1 + MZ);
          base = flat(g, ox + lx - 2 + MX, oy + ly - 2 + MY, oz + lz - 2 + MZ) * cin;
        }
        a_base[tid] = base;
        o_cell[tid] = oc;
      }
      __syncthreads();
      for (int n0 = 0; n0 < cmid; n0 += TN) {
        gemm_to(Cs, vec_x, vec_w1, x, cin, g, 3, a_base, w1, cmid, n0, As, Bs);
        __syncthreads();
        for (int e = tid; e < TM * TN; e += TT) {
          const int m = e / TN, n = n0 + e % TN;
          if (r0 + m >= ne || n >= cmid) continue;
          float v = Cs[m * LDC + e % TN] * scale1[n] + bias1[n];
          v = fmaxf(v * occ[o_cell[m]], 0.f);
          ms[(long long)(r0 + m) * cmid + n] = __float2bfloat16(v);
        }
        __syncthreads();
      }
    }
    // conv2 -> BN -> mask -> + residual -> ReLU over the tile: core cell (lx,
    // ly, lz) reads its taps from expanded cells (lx + dx, ly + dy, lz + dz)
    for (int r0 = 0; r0 < nc; r0 += TM) {
      if (tid < TM) {
        const int r = r0 + tid;
        long long base = -1, rbase = -1, oc = -1;
        if (r < nc) {
          const int lx = r / (ty * tz), ly = (r / tz) % ty, lz = r % tz;
          base = flat(ge, lx, ly, lz) * cmid;
          oc = flat(g, ox + lx + MX, oy + ly + MY, oz + lz + MZ);
          rbase = oc * cin;
        }
        a_base[tid] = base;
        r_base[tid] = rbase;
        o_cell[tid] = oc;
      }
      __syncthreads();
      for (int n0 = 0; n0 < cout; n0 += TN) {
        gemm_to(Cs, vec_m, vec_w2, ms, cmid, ge, 3, a_base, w2, cout, n0, As, Bs);
        if (rw != nullptr)
          gemm_to(Rs, vec_x, vec_w2, x, cin, g, 1, r_base, rw, cout, n0, As, Bs);
        __syncthreads();
        for (int e = tid; e < TM * TN; e += TT) {
          const int m = e / TN, n = n0 + e % TN;
          if (o_cell[m] < 0 || n >= cout) continue;
          const long long oc = o_cell[m];
          const float o = occ[oc];
          float v = (Cs[m * LDC + e % TN] * scale2[n] + bias2[n]) * o;
          const float rv = rw != nullptr ? (Rs[m * LDC + e % TN] * rscale[n] + rbias[n]) * o
                                         : __bfloat162float(x[oc * cin + n]);
          out[oc * cout + n] = __float2bfloat16(fmaxf(v + rv, 0.f));
        }
        __syncthreads();
      }
    }
  }
}

}  // namespace

// bfloat16 grids, weights, residual and skip; affines and occupancy are
// float32. Null pointers switch the matching epilogue step off. rows is an
// int32 scratch of n_rows + 2 (the row list, then the live and dead counts).

// wt: (cout, k^3, cpad) K-major, cpad = cin rounded up to 32 with zero rows;
// rwt: (cout, crpad) for the fused 1x1 over res (cres channels), or null;
// part: float32 scratch of (s_max + (rwt ? 1 : 0)) * n_rows * cout for up to
// s_max K splits, chosen on the card from the live rows (s_max 1: none)
extern "C" int tiled_conv3d_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* wt, int cpad, int k,
    int cout, const int* tiles, int n_rows, int tx, int ty, int tz, const float* scale,
    const float* bias, const float* occ, const void* res, int cres, const void* rwt,
    int crpad, const float* rscale, const float* rbias, int relu, int* rows, void* out,
    float* part, int s_max, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  int* count = rows + n_rows;
  const int want_dead = occ != nullptr && res != nullptr && rwt == nullptr;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  compact_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(tl, g, occ, 0, n_rows, rows, count,
                                                      want_dead);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* rb = static_cast<const __nv_bfloat16*>(res);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const ConvRows p{xb, cin, cpad, k, g, static_cast<const __nv_bfloat16*>(wt), cout, tl,
                   rows, count, scale, bias, occ, rb, cres, crpad,
                   static_cast<const __nv_bfloat16*>(rwt), rscale, rbias, relu,
                   cin % 8 == 0 && aligned16(x),
                   rwt != nullptr && cres % 8 == 0 && aligned16(res),
                   cout % 8 == 0 && aligned16(out) &&
                       (res == nullptr || rwt != nullptr || aligned16(res)),
                   ob, part, s_max, n_rows, 2 * sm_count()};
  cudaError_t e;
  switch (block_cols(cout)) {
    case 32: e = launch_conv_rows<32>(p, n_rows, s); break;
    case 64: e = launch_conv_rows<64>(p, n_rows, s); break;
    case 96: e = launch_conv_rows<96>(p, n_rows, s); break;
    case 128: e = launch_conv_rows<128>(p, n_rows, s); break;
    default: e = launch_conv_rows<256>(p, n_rows, s); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (want_dead) {
    const int vec = cout % 8 == 0 && aligned16(res) && aligned16(out);
    dead_rows_kernel<<<blocks_for((long long)n_rows * (vec ? cout / 8 : cout), 256), 256, 0,
                       s>>>(tl, g, rows, count, n_rows, rb, cout, relu, vec, ob);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: fold_dydz's grid (xm, ym, zm, cf), cf % 8 == 0 for the vector loads;
// w: (k, cf, cout) prefolded rows; out: (xm, ym, zm, cout)
extern "C" int tiled_conv3d_prefolded_launch(
    const void* x, int cf, int xm, int ym, int zm, const void* w, int k, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, const float* scale,
    const float* bias, const float* occ, int relu, void* out, void* stream) {
  const Grid g{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  if (n_rows > 0)
    launch_tc<PREF>(x, cf, g, w, k, cout, tl, n_rows, g, scale, bias, occ, cout, 0, relu,
                    out, static_cast<cudaStream_t>(stream));
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
    launch_tc<DOWN>(x, cin, gi, w, 2, cout, tl, n_rows, go, scale, bias, occ, cout, 0, relu,
                    out, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// x: coarse grid (cxm, cym, czm); out and skip: fine grid (xm, ym, zm);
// n_rows counts the fine cells of the listed tiles (even tile dims); wt:
// (8, cout, cpad) K-major, cpad = cin rounded up to 32; rows: int32 scratch
// of n_rows / 8 + 2
extern "C" int tiled_up2_launch(
    const void* x, int cin, int cxm, int cym, int czm, const void* wt, int cpad, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int xm, int ym, int zm,
    const float* scale, const float* bias, const float* occ, const void* skip,
    int skip_ctot, int skip_c, int relu, int* rows, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid gi{cxm, cym, czm}, go{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  const int n_par = n_rows / 8, ctot = cout + skip_c;
  int* count = rows + n_par;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  compact_kernel<<<(n_par + 255) / 256, 256, 0, s>>>(tl, go, occ, 1, n_par, rows, count, 0);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const UpRows p{static_cast<const __nv_bfloat16*>(x), cin, cpad, gi,
                 static_cast<const __nv_bfloat16*>(wt), cout, tl, go, rows, count, scale,
                 bias, occ, ctot, relu, cin % 8 == 0 && aligned16(x),
                 cout % 8 == 0 && ctot % 8 == 0 && aligned16(out), ob};
  cudaError_t e;
  switch (block_cols(cout)) {
    case 32: e = launch_up_rows<32>(p, n_par, s); break;
    case 64: e = launch_up_rows<64>(p, n_par, s); break;
    case 96: e = launch_up_rows<96>(p, n_par, s); break;
    case 128: e = launch_up_rows<128>(p, n_par, s); break;
    default: e = launch_up_rows<256>(p, n_par, s); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  if (skip != nullptr) {
    const int vec = skip_c % 8 == 0 && skip_ctot % 8 == 0 && ctot % 8 == 0 &&
                    cout % 8 == 0 && aligned16(skip) && aligned16(out);
    skip_copy_kernel<<<blocks_for((long long)n_rows * (vec ? skip_c / 8 : skip_c), 256), 256,
                       0, s>>>(tl, go, static_cast<const __nv_bfloat16*>(skip), skip_ctot,
                               skip_c, cout, ctot, vec, ob);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: coarse grid (cxm, cym, czm); dest: fine grid (xm, ym, zm, ctot), written
// at channels [skip_c, skip_c + cout) of the listed tiles' cells only
extern "C" int tiled_up2_into_launch(
    const void* x, int cin, int cxm, int cym, int czm, const void* w, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int xm, int ym, int zm,
    const float* scale, const float* bias, const float* occ, int skip_c, int ctot,
    int relu, void* dest, void* stream) {
  const Grid gi{cxm, cym, czm}, go{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  if (n_rows > 0)
    launch_tc<UPI>(x, cin, gi, w, 2, cout, tl, n_rows / 8, go, scale, bias, occ, ctot,
                   skip_c, relu, dest, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}


// x: (xm, ym, zm, cin); w1 (27, cin, cmid), w2 (27, cmid, cout), rw (cin,
// cout) or null for the identity residual (cin == cout); mid: n_ctas * (tx +
// 2)(ty + 2)(tz + 2) * cmid bfloat16 scratch; out: (xm, ym, zm, cout), zeros
// outside the listed tiles
extern "C" int tiled_block3d_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* w1, const void* w2,
    int cmid, int cout, const int* tiles, int n_tiles, int tx, int ty, int tz,
    const float* scale1, const float* bias1, const float* scale2, const float* bias2,
    const float* occ, const void* rw, const float* rscale, const float* rbias,
    void* mid, int n_ctas, void* out, void* stream) {
  const Grid g{xm, ym, zm};
  const int vec_x = cin % 8 == 0 && aligned16(x);
  const int vec_m = cmid % 8 == 0 && aligned16(mid);
  const int vec_w1 = cmid % 8 == 0 && aligned16(w1);
  const int vec_w2 = cout % 8 == 0 && aligned16(w2) && (rw == nullptr || aligned16(rw));
  if (n_tiles > 0 && n_ctas > 0)
    block_kernel<<<n_ctas, TT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), cin, g,
        static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(w2), cmid,
        cout, tiles, n_tiles, tx, ty, tz, scale1, bias1, scale2, bias2, occ,
        static_cast<const __nv_bfloat16*>(rw), rscale, rbias, vec_x, vec_m, vec_w1, vec_w2,
        static_cast<__nv_bfloat16*>(mid), static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
