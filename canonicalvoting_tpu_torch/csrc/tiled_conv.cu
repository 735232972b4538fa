// Occupied-tile convolutions of the dense MinkUNet backbone, for sm_90a.
//
// Replaces the Pallas TPU kernels of canonicalvoting_tpu/ops/pallas/
// tiled_conv.py: tiled_conv3d (_kernel:85), its prefolded=True stem mode,
// tiled_down2 (_down2_kernel), tiled_up2 (_up2_kernel:1392), tiled_up2_into
// (_up2v2_kernel) and tiled_block3d (_block_kernel:750). Each computes the same
// function over the same margined channel-last grids (X + 2MX, Y + 2MY,
// Z + 2MZ, C) and the same tile lists; cells outside the listed tiles are
// left as the caller's zeros (tiled_up2_into: as the caller's dest holds
// them). The epilogue is the TPU kernel's, in its order: BN affine,
// occupancy mask, residual (plain, or the fused 1x1 downsample with its own
// affine and mask), ReLU. Duplicate tiles (lists are padded by repeating the
// last tile) recompute and store the same values; nothing accumulates into
// the output. The grids are bfloat16 (the tensor-core kernels below) or
// float32 (the FFMA kernels at the end of the file), the model's compute
// dtype.
//
// tiled_conv3d, its prefolded stem, tiled_down2, tiled_up2, tiled_up2_into
// and tiled_block3d: occupied-row GEMMs (conv_rows_kernel, up_rows_kernel).
// Their function needs the MACs of occupied rows only: an unoccupied output
// cell is masked to zero (plus the plain residual, if any), and an
// unoccupied coarse parent has no occupied child. The listed tiles hold
// 5-26% occupied cells at the backbone's levels and every listed tile holds
// at least one, so skipping empty 64-row blocks saves nothing; the rows are
// compacted instead:
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
//   are the wrapper's zeros; tiled_up2_into, below, writes them). The
//   weights arrive K-major, (8, cout, cpad). skip_copy_kernel copies the
//   U-Net skip into every listed fine cell with 16-byte vectors.
// What bounds them: at the sparse levels the listed cells' bytes (inputs
// gathered per tap mostly hit L2); the weights are re-read from L2 by every
// row block, which dominates at L3 and L4 (there the host issues a call
// faster than the card runs it). The wrapper's zero fill of the whole
// output grid is outside these kernels.
//
// The prefolded stem (tiled_conv3d_prefolded) is the same occupied-row GEMM
// over fold_dydz's grid: the (dy, dz) taps of the k = 5 stem already sit in
// its channels (lane c*k*k + dz*k + dy, cf = 80 for 3 input channels, a
// multiple of 8 so the 16-byte loads stay aligned), so the loader walks the
// k x-offsets only (offset (dx - h) * Ym * Zm cells) over cpad = cf rounded
// up to 32 channels (the loads past cf are zero-filled): 5 taps x 3 chunks =
// 15 K steps, against 125 x 1 for the tiled k=5 stem. The weights arrive
// folded and K-major, (cout, k, cpad) in the fold's row order (dx; c, dz,
// dy), built once per category by the separate evaluator
// (prefold_stem_weights). The stem lists 5.6% of
// its cells as occupied, so compaction cuts its MACs 17x; its epilogue is
// BN affine, mask, ReLU, with no residual and no K split (937 row blocks).
//
// tiled_down2 (the stride-2 k = 2 conv out[o] = sum_d W[d] in[2o + d]) is
// the same conv_rows_kernel with down = 1: its rows are the live COARSE
// cells (compact_kernel over the listed coarse tiles against the coarse
// occupancy; with no occupancy every listed cell), each row keeps two cells
// (its tap base, the fine cell 2o in the fine grid, and its own cell in the
// coarse grid, where occ is read and out written), and the K loop walks the
// 8 taps {0, 1}^3 x-fastest at offsets (dx * Ym + dy) * Zm + dz of the fine
// grid by 32-channel chunks against (cout, 8, cpad) K-major weights. Its
// epilogue is BN affine, mask, ReLU, with no residual; an unoccupied listed
// cell keeps the wrapper's zero. At L3 and L4 (10-70 live row blocks) K
// splits over blocks as for the convs. The listed coarse cells are 12-55%
// occupied at the backbone's levels, so the compaction cuts the MACs 2-8x.
//
// tiled_up2_into is the same up_rows_kernel writing into a caller's grid:
// dest holds the skip in channels [0, skip_c) and receives the conv at
// [skip_c, skip_c + cout) (c_off), the layout [skip | conv] of the JAX
// kernel, with no skip copy and no fill; nothing else of dest is touched.
// Its contract writes exact zeros at every listed cell whose occupancy is
// 0, whatever dest held there, where the concat route leaves its fresh
// zeros: the epilogue (into = 1) stores zeros at the unoccupied children of
// live parents, and compact_kernel lists the dead parents (no occupied
// child) from the row buffer's end for up_dead_kernel, which zeroes their 8
// children's conv channels. The conv channels are tiled_up2's bit for bit:
// the same GEMM and epilogue, and +0 where tiled_up2 leaves its zeros. The
// dead parents' zeros are most of the bytes at L0 (the listed fine cells
// outnumber the occupied ones 54x there): one warp a dead parent writes
// them at ~2.2 TB/s on the H100. Writing them from the GEMM kernel's spare
// blocks, beside its row blocks, measured no faster (PERF.md): those
// blocks hold the GEMM's shared memory, so too few warps store. The TPU
// kernel's lane pack of the occupancy (pack_occ_updma) is a TPU layout; the
// kernels read the margined occupancy grid.
//
// tiled_block3d, a whole BasicBlock (relu(occ * bn2(conv2 relu(occ *
// bn1(conv1 x)))) + res)), is the same occupied-row GEMM twice over one
// compaction. The TPU kernel keeps a grown tile's mid in VMEM and recomputes
// the halo; here the whole block's mid at the live rows fits the 50 MB L2
// (0.5-12 MB at the backbone's levels), so nothing is recomputed. conv2
// needs conv1's output at the live rows (occupied listed cells) and zeros
// everywhere else, as the two-conv route's dense mid grid holds it:
// - compact_kernel lists the live rows once (the dead rows too, for the
//   identity residual) and writes each live cell's position in the list
//   into a row map over the margined grid, which one memset sets to -1 at
//   every call (another level or scene sees other cells).
// - conv1 (by_row) writes live row i's mid at mid + i * cmid: a compact,
//   uninitialised buffer sized by the listed rows, of which only the live
//   part is written and read. No dense mid grid is filled or written.
// - conv2 (conv_rows_kernel<BN, true>) loads its 64 rows' 27 neighbour
//   positions from the map into shared memory at the start of a row block;
//   each K step then copies mid + pos * cmid + c0 by cp.async, zero-filled
//   where pos < 0. Its epilogue (the residual read from the dense x at the
//   row's own cell, or the fused 1x1), its K split and dead_rows_kernel are
//   row 1's.
// Both GEMMs take the K splits the model's two tiled_conv3d calls take, in
// the same tap and chunk order with the same bfloat16 rounding of the mid,
// so the block's output equals the two-conv route's bit for bit. One host
// call issues the memsets, the compaction and both GEMMs; against the two
// convs it saves one compaction, one host call and the dense mid grid's
// fill and writes. Its bound counts the listed cells' input and output and
// the weights once, no mid; its MACs are the occupied (output, tap) pairs
// of both convs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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
// With a row map (the fused block: conv, occ given), map at a live row's
// cell in g receives the row's position in rows.
__global__ void __launch_bounds__(256) compact_kernel(Tiles tl, Grid g, const float* occ,
                                                      int up, int n_list, int* rows,
                                                      int* count, int want_dead, int* map) {
  __shared__ int wl[8], wd[8], base_l, base_d;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x * 256 + tid;
  bool live = false;
  long long cl = 0;
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
      cl = flat(g, ix + MX, iy + MY, iz + MZ);
      live = occ[cl] != 0.f;
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
  if (live) {
    const int pos = base_l + wl[warp] + __popc(bl & lt);
    rows[pos] = r;
    if (map != nullptr) map[cl] = pos;
  }
  if (dead) rows[n_list - 1 - (base_d + wd[warp] + __popc(bd & lt))] = r;
}

// B of K step (tap, c0): weight rows n0 .. n0 + BN of wt (cout, taps,
// cpad), 32 channels from c0, zero-filled past cout
template <int BN>
__device__ __forceinline__ void load_weights(const __nv_bfloat16* wt, int cout, int taps,
                                             int cpad, int n0, int tap, int c0, uint8_t* sb) {
  for (int v = threadIdx.x; v < BN * (GK / 8); v += GT) {
    const int n = v >> 2, q = v & 3, gn = n0 + n;
    const bool ok = gn < cout;
    cp_async16(sb + core_off(n, q, GK / 8),
               ok ? wt + ((long long)gn * taps + tap) * cpad + c0 + q * 8 : wt, ok);
  }
}

// One K phase of a conv block: x's taps (k^3 of them, x-fastest, offsets
// from the row's cell; with xonly the k x offsets alone, over the prefolded
// stem's fold; with down the 8 taps {0, 1}^3 of the stride-2 down, from
// the fine cell 2o) by 32-channel chunks against wt (cout, taps, cpad). The
// fused 1x1 downsample is the same loader with k = 1 over the residual.
struct TapLoader {
  const __nv_bfloat16* x;
  int cin, k, xonly, down, vec;
  Grid g;  // x's grid
  const __nv_bfloat16* wt;
  int cpad, cout, n0;
  const int* cell;  // shared: the rows' tap-base cells in g, -1 past the live rows

  __device__ __forceinline__ int taps() const { return xonly ? k : k * k * k; }
  __device__ __forceinline__ int steps() const { return taps() * (cpad / GK); }

  template <int BN>
  __device__ __forceinline__ void load(int s, uint8_t* st) const {
    const int nkc = cpad / GK, h = down ? 0 : k / 2;
    const int tap = s / nkc, c0 = (s - tap * nkc) * GK;
    const int dx = xonly ? tap : tap % k;
    const int dy = xonly ? h : (tap / k) % k, dz = xonly ? h : tap / (k * k);
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
    load_weights<BN>(wt, cout, taps(), cpad, n0, tap, c0, st + A_STAGE);
  }
};

// conv2 of the fused block: the 27 taps (k = 3, x-fastest) of each row
// through the row map, by 32-channel chunks of the compact mid (live row j
// at mid + j * cmid) against wt (cout, 27, cpad)
constexpr int MAP_TAPS = 27;
struct MapLoader {
  const __nv_bfloat16* mid;
  int cmid, vec;
  const __nv_bfloat16* wt;
  int cpad, cout, n0;
  const int* nbr;  // shared (MAP_TAPS, GM): the rows' neighbours' positions, -1 for none

  __device__ __forceinline__ int steps() const { return MAP_TAPS * (cpad / GK); }

  template <int BN>
  __device__ __forceinline__ void load(int s, uint8_t* st) const {
    const int nkc = cpad / GK;
    const int tap = s / nkc, c0 = (s - tap * nkc) * GK;
    const int* pos = nbr + tap * GM;
    if (vec) {
      for (int v = threadIdx.x; v < GM * (GK / 8); v += GT) {
        const int m = v >> 2, q = v & 3, c = c0 + q * 8, j = pos[m];
        const bool ok = j >= 0 && c < cmid;
        cp_async16(st + core_off(m, q, GK / 8), ok ? mid + (long long)j * cmid + c : mid, ok);
      }
    } else {  // element loads (cmid not a multiple of 8)
      for (int e = threadIdx.x; e < GM * GK; e += GT) {
        const int m = e / GK, kk = e % GK, c = c0 + kk, j = pos[m];
        __nv_bfloat16 val = __float2bfloat16(0.f);
        if (j >= 0 && c < cmid) val = mid[(long long)j * cmid + c];
        *reinterpret_cast<__nv_bfloat16*>(st + core_off(m, kk >> 3, GK / 8) +
                                          (kk & 7) * 2) = val;
      }
    }
    load_weights<BN>(wt, cout, MAP_TAPS, cpad, n0, tap, c0, st + A_STAGE);
  }
};

// acc = the rows' GEMM over ld's K steps [first, first + steps) through
// the STAGES-deep ring. Each step: wait for its slice, fence it for the
// async proxy, barrier (so the slot read by the previous step is free for
// every warp), issue the copies STAGES - 1 steps ahead, then the wgmmas on
// this slice.
template <int BN, class Loader>
__device__ __forceinline__ void ring_gemm(const Loader& ld, int first, int steps,
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
  int cin, cpad, k, xonly;  // xonly: the prefolded stem's k x taps
  int down;                 // the stride-2 down (k = 2): x is the fine grid
  Grid gin;                 // x's grid
  Grid g;                   // the rows' grid: occ, res, out
  const __nv_bfloat16* wt;  // (cout, k^3 or k, cpad)
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
  int by_row;       // the fused block's conv1: live row i's output at out + i * cout
  const int* map;   // the fused block's conv2 (MAP): the row map over g; x is the mid
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

// MAP: conv2 of the fused block, its taps through the row map (MapLoader)
template <int BN, bool MAP>
__global__ void __launch_bounds__(GT, 1) conv_rows_kernel(const __grid_constant__ ConvRows p) {
  constexpr int NW = Cols<BN>::NW, NH = Cols<BN>::NH, LD = BN + 4;
  static_assert(conv_ring_bytes<BN>() >= GM * LD * 4, "the staging tile aliases the ring");
  extern __shared__ __align__(1024) uint8_t smem[];
  uint8_t* ring = smem;
  float* cs = reinterpret_cast<float*>(smem);  // epilogue staging, once the ring drains
  float* rs = reinterpret_cast<float*>(smem + conv_ring_bytes<BN>());
  __shared__ int cell[GM];   // the row's tap base in gin (the down: fine cell 2o)
  __shared__ int ocell[GM];  // the row's cell in g (by_row: its place), -1 past the live rows
  __shared__ float orow[GM];
  __shared__ int nbr[MAP ? MAP_TAPS * GM : 1];  // MAP: (tap, row) positions in the mid
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.y * BN;
  const int n_live = p.count[0];
  const TapLoader main_ld{p.x, p.cin, p.k, p.xonly, p.down, p.vec_a, p.gin, p.wt, p.cpad,
                          p.cout, n0, cell};
  const MapLoader map_ld{p.x, p.cin, p.vec_a, p.wt, p.cpad, p.cout, n0, nbr};
  const TapLoader res_ld{p.res, p.cres, 1, 0, 0, p.vec_r, p.g, p.rwt, p.crpad, p.cout, n0,
                         ocell};
  float acc[NH][NW / 2];
  const int n_split = k_splits(p, n_live, gridDim.y);
  const int steps = MAP ? map_ld.steps() : main_ld.steps();

  // work item = (row block rb, K split sp); with one split the block also
  // runs the epilogue, with more split_reduce_kernel sums the splits
  for (int it = blockIdx.x; it < (n_live + GM - 1) / GM * n_split; it += gridDim.x) {
    const int rb = it / n_split, sp = it - rb * n_split;
    if (tid < GM) {
      const int i = rb * GM + tid;
      int c = -1, oc = -1;
      float o = 1.f;
      if (i < n_live) {
        int ix, iy, iz;
        row_cell(p.tl, p.rows[i], ix, iy, iz);
        oc = static_cast<int>(flat(p.g, ix + MX, iy + MY, iz + MZ));
        c = p.down ? static_cast<int>(flat(p.gin, 2 * ix + MX, 2 * iy + MY, 2 * iz + MZ)) : oc;
        if (p.occ != nullptr) o = p.occ[oc];
      }
      cell[tid] = c;
      ocell[tid] = p.by_row && oc >= 0 ? i : oc;
      orow[tid] = o;
      if constexpr (MAP) {  // tap t = dx + 3 dy + 9 dz at offset (d - 1) from the cell
#pragma unroll
        for (int t = 0; t < MAP_TAPS; ++t) {
          const int off = ((t % 3 - 1) * p.g.ym + (t / 3 % 3 - 1)) * p.g.zm + t / 9 - 1;
          nbr[t * GM + tid] = oc < 0 ? -1 : p.map[oc + off];
        }
      }
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
            } else if (ocell[m] >= 0 && gn < p.cout) {  // the slice after the splits
              p.part[((long long)n_split * p.n_list + rb * GM + m) * p.cout + gn] = v;
            }
          }
    }
    const int k0 = (int)((long long)steps * sp / n_split);
    const int k1 = (int)((long long)steps * (sp + 1) / n_split);
    if constexpr (MAP)
      ring_gemm<BN>(map_ld, k0, k1 - k0, ring, acc);
    else
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
            if (ocell[m] >= 0 && gn < p.cout)
              p.part[((long long)sp * p.n_list + rb * GM + m) * p.cout + gn] = acc[hh][4 * q + e];
          }
      __syncthreads();  // cell and ocell are rewritten by the next item
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
      const int m = e / (BN / 8), n = (e % (BN / 8)) * 8, gn = n0 + n, cl = ocell[m];
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
    __syncthreads();  // cell, ocell, cs and rs are rewritten by the next row block
  }
}

// the split sums of each live row in split order, then the epilogue:
// affine, mask, residual (plain, or the fused 1x1's slice), ReLU; stored at
// the row's cell (by_row: at its place in the row list)
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
    const long long ol = (p.by_row ? i : cl) * p.cout + c0;
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
      *reinterpret_cast<uint4*>(p.out + ol) = packed;
    } else {
      p.out[ol] = __float2bfloat16(v[0]);
    }
  }
}

// element conversions of the grid dtypes (bfloat16 rows 1-9; float32 rows
// 1-3, 6 and 7), and the elements of a 16-byte vector
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <typename T>
constexpr int VEC = 16 / static_cast<int>(sizeof(T));

// listed rows whose occupancy is 0 under a plain residual: out = relu?(res)
template <typename T>
__global__ void __launch_bounds__(256) dead_rows_kernel(Tiles tl, Grid g, const int* rows,
                                                        const int* count, int n_list,
                                                        const T* res, int cout, int relu,
                                                        int vec, T* out) {
  constexpr int V = VEC<T>;
  const int nv = vec ? cout / V : cout;
  const long long n = (long long)count[1] * nv;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int j = static_cast<int>(e / nv), v = static_cast<int>(e % nv);
    int ix, iy, iz;
    row_cell(tl, rows[n_list - 1 - j], ix, iy, iz);
    const long long cl = flat(g, ix + MX, iy + MY, iz + MZ) * cout;
    if (vec) {
      uint4 r = *reinterpret_cast<const uint4*>(res + cl + v * V);
      T* rv = reinterpret_cast<T*>(&r);
      if (relu) {
#pragma unroll
        for (int t = 0; t < V; ++t) rv[t] = from_f<T>(fmaxf(to_f(rv[t]), 0.f));
      }
      *reinterpret_cast<uint4*>(out + cl + v * V) = r;
    } else {
      const float u = to_f(res[cl + v]);
      out[cl + v] = from_f<T>(relu ? fmaxf(u, 0.f) : u);
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
  int ctot, c_off;  // out's channels; the conv's first channel in them
  int into;         // tiled_up2_into: exact zeros at unoccupied children
  int relu, vec_a, vec_o;
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
        const long long o = ch * p.ctot + p.c_off + gn;
        // an unoccupied child: tiled_up2 leaves the wrapper's zeros, the
        // into-conv writes them
        const bool zero = p.occ != nullptr && p.occ[ch] == 0.f;
        if (zero && !p.into) continue;
        if (p.vec_o) {
          *reinterpret_cast<uint4*>(p.out + o) =
              zero ? make_uint4(0, 0, 0, 0) : *reinterpret_cast<const uint4*>(cs + m * LD + n);
        } else {
          for (int t = 0; t < 8 && gn + t < p.cout; ++t)
            p.out[o + t] = zero ? __float2bfloat16(0.f) : cs[m * LD + n + t];
        }
      }
      // the next parity's staging writes follow the next step's barrier
    }
    cp_async_wait<0>();
    __syncthreads();  // pc, icell, as and cs are rewritten by the next row block
  }
}

// the U-Net skip into channels [cout, cout + skip_c) of every listed fine
// cell, 16 bytes a thread where the widths allow
template <typename T>
__global__ void __launch_bounds__(256) skip_copy_kernel(Tiles tl, Grid g, const T* skip,
                                                        int skip_ctot, int skip_c, int cout,
                                                        int ctot, int vec, T* out) {
  constexpr int V = VEC<T>;
  const int nv = vec ? skip_c / V : skip_c;
  const long long n = (long long)tl.n_rows * nv;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int r = static_cast<int>(e / nv), v = static_cast<int>(e % nv);
    int ix, iy, iz;
    row_cell(tl, r, ix, iy, iz);
    const long long cl = flat(g, ix + MX, iy + MY, iz + MZ);
    if (vec)
      *reinterpret_cast<uint4*>(out + cl * ctot + cout + v * V) =
          *reinterpret_cast<const uint4*>(skip + cl * skip_ctot + v * V);
    else
      out[cl * ctot + cout + v] = skip[cl * skip_ctot + v];
  }
}

// tiled_up2_into's dead parents (no occupied child; listed from the row
// buffer's end by compact_kernel, count[1] of them): exact zeros in
// channels [c_off, c_off + cout) of their 8 children. One warp a dead
// parent, its lanes over the children's channel runs (16-byte stores where
// the widths allow), so a warp's stores land on a few contiguous runs and
// the parent's coordinates are worked out once.
template <typename T>
__global__ void __launch_bounds__(256) up_dead_kernel(Tiles tl, Grid g, const int* rows,
                                                      const int* count, int n_par, int cout,
                                                      int ctot, int c_off, int vec, T* out) {
  constexpr int V = VEC<T>;
  const int lane = threadIdx.x & 31, wpb = blockDim.x >> 5;
  const int per = vec ? cout / V : cout;  // stores a child
  for (int j = blockIdx.x * wpb + (threadIdx.x >> 5); j < count[1]; j += gridDim.x * wpb) {
    int px, py, pz;
    parent_cell(tl, rows[n_par - 1 - j], px, py, pz);
    for (int e = lane; e < 8 * per; e += 32) {
      const int d = e / per, v = e - d * per;
      T* o = out + c_off +
             flat(g, 2 * px + (d & 1) + MX, 2 * py + ((d >> 1) & 1) + MY,
                  2 * pz + (d >> 2) + MZ) * ctot;
      if (vec)
        reinterpret_cast<uint4*>(o)[v] = make_uint4(0, 0, 0, 0);
      else
        o[v] = from_f<T>(0.f);
    }
  }
}

int blocks_for(long long work, int per_block) {
  const long long b = (work + per_block - 1) / per_block;
  return static_cast<int>(b < MAX_GRID ? (b > 0 ? b : 1) : MAX_GRID);
}

template <int BN, bool MAP>
cudaError_t launch_conv_rows(const ConvRows& p, int n_list, cudaStream_t s) {
  const int smem = conv_ring_bytes<BN>() + (p.rwt != nullptr ? conv_stage_bytes<BN>() : 0);
  cudaError_t e = cudaFuncSetAttribute(conv_rows_kernel<BN, MAP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(blocks_for((long long)n_list * p.s_max, GM), (p.cout + BN - 1) / BN);
  conv_rows_kernel<BN, MAP><<<grid, GT, smem, s>>>(p);
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

// conv_rows_kernel (and its K-split reduction) at the narrowest block width
// that holds cout
template <bool MAP = false>
cudaError_t launch_conv_cols(const ConvRows& p, int n_list, cudaStream_t s) {
  switch (block_cols(p.cout)) {
    case 32: return launch_conv_rows<32, MAP>(p, n_list, s);
    case 64: return launch_conv_rows<64, MAP>(p, n_list, s);
    case 96: return launch_conv_rows<96, MAP>(p, n_list, s);
    case 128: return launch_conv_rows<128, MAP>(p, n_list, s);
    default: return launch_conv_rows<256, MAP>(p, n_list, s);
  }
}

// up_rows_kernel at the narrowest block width that holds cout, after
// compact_kernel has listed the live parents (and, with want_dead, the dead
// ones from the buffer's end) into rows, n_par + 2 int32
cudaError_t launch_up(UpRows p, int n_par, int* rows, int want_dead, cudaStream_t s) {
  int* count = rows + n_par;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  compact_kernel<<<(n_par + 255) / 256, 256, 0, s>>>(p.tl, p.gout, p.occ, 1, n_par, rows,
                                                     count, want_dead, nullptr);
  p.rows = rows;
  p.count = count;
  switch (block_cols(p.cout)) {
    case 32: return launch_up_rows<32>(p, n_par, s);
    case 64: return launch_up_rows<64>(p, n_par, s);
    case 96: return launch_up_rows<96>(p, n_par, s);
    case 128: return launch_up_rows<128>(p, n_par, s);
    default: return launch_up_rows<256>(p, n_par, s);
  }
}

// ---------------------------------------------------------------------------
// float32 grids (tiled_conv3d, its prefolded stem, tiled_down2, tiled_up2,
// tiled_up2_into and tiled_block3d at conv_dtype=float32): the JAX
// kernels of the header at float32, over the same compacted live rows
// (compact_kernel), with exact float32 products and float32 sums on the
// FFMA units. TF32 (the tensor cores' float32 input) would round each
// product's operands to 10 mantissa bits, a different result.
//
// What bounds them on the H100: the convs at L0-L4 the MACs, which the
// FFMA units run at 67 TF/s (the 27 taps of every live row: a tap whose
// neighbour is empty multiplies the zeros it gathers); the prefolded stem
// and the down the listed cells' bytes. conv_rows_f32_kernel is a SIMT
// GEMM laid out for that:
// - A block owns 128 live rows by 128 output columns (64 or 96 where
//   cout fits), 8 x 8 accumulators a thread (8 x 6 at 96 columns) at rows
//   tm + 16 i, columns tn + 16 j (tn + 8 j at 64 columns); a warp's lanes
//   cover 4 tm by 8 tn. Both operands are staged row-major (a live row's
//   or a weight row's 16 channels of a K step) at a pitch of 20 floats: a
//   thread reads its 8 rows and its 8 columns as float4s over 4 channels,
//   256 FMAs for sixteen 16-byte shared loads (the 64 x 64 tile before it:
//   16 FMAs for eight 4-byte loads), and a warp's 4 row and 8 column reads
//   each fall in distinct banks. Each product is a float32 fmaf; a thread
//   sums its outputs in tap, then channel order. On the H100 the loop runs
//   at roughly 40% of the FFMA rate, loads or not (PERF.md).
// - A K step is 16 channels of one tap (taps x ceil(cin / 16) steps; the
//   K-major weights' zero rows past cin are never read). The gathered
//   operand (each live row's 16-byte channel chunk at cell + tap offset,
//   4-byte copies where cin is not a multiple of 4) and the weight slice
//   arrive by cp.async into a 4-stage ring in dynamic shared memory, one
//   __syncthreads a stage; rows past the live count and channels past cin
//   are zero-filled by the copy's source size 0.
// - Work items (row block, column block, K split) run one a block over a
//   1-D grid, so the busy blocks spread over the SMs. When the live row
//   blocks times the column blocks fill less than one round of the card's
//   resident blocks (L2-L4), K splits over taps into a float32 scratch
//   (f32_k_splits, from the live count on the card, at most the wrapper's
//   s_max), and split_reduce_f32_kernel adds the splits in split order and
//   runs the epilogue, so a repeat is bitwise equal.
// - The epilogue is row 1's, in its order: affine, mask, residual (plain,
//   or the fused 1x1's masked affine result), ReLU. The fused 1x1 runs
//   first, a k = 1 phase over the residual grid, and parks its result in
//   the scratch (its slice after the splits) at the row's place in the
//   list, which the epilogue or the reduction reads back.
// The fused block (tiled_block3d_f32_launch) runs it twice over one
// compaction as the bfloat16 block does: conv1 into a compact mid, conv2
// gathering through the row map, both with the splits the model's two
// convs take, so its output equals theirs bit for bit. The ups (rows 3f,
// 7f) run the same ring core as a k = 1 product (up_rows_f32_kernel below).

constexpr int FBM = 128;        // live rows a block
constexpr int FBK = 16;         // channels a K step
constexpr int FLD = FBK + 4;    // pitch of a staged row, floats
constexpr int FSTAGES = 4;      // cp.async ring depth

template <int BN>
struct F32Tile {
  static constexpr int TJ = BN == 96 ? 6 : 8;     // columns a thread
  static constexpr int TNC = BN / TJ;             // thread columns: tn + TNC * j
  static constexpr int THREADS = 16 * TNC;        // 16 thread rows: tm + 16 * i
  static constexpr int WN = TNC / 8;              // warps across the columns
  static constexpr int MIN_BLOCKS = BN > 64 ? 2 : 3;
  static constexpr int STAGE = (FBM + BN) * FLD;  // floats of a ring stage
  static constexpr int SMEM = FSTAGES * STAGE * 4;
};

// 4 bytes global -> shared, zero-filled when !full (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

struct ConvF32 {
  const float* x;
  int cin, cpad, k, xonly, down;
  Grid gin, g;
  const float* wt;  // (cout, taps, cpad)
  int cout;
  Tiles tl;
  const int* rows;
  const int* count;
  const float* scale;
  const float* bias;
  const float* occ;
  const float* res;  // plain residual (cout channels) or the 1x1's input
  int cres, crpad;
  const float* rwt;  // (cout, crpad): the fused 1x1, or null
  const float* rscale;
  const float* rbias;
  int relu, vec_a, vec_r, vec_o;
  float* out;
  float* part;     // (s_max [+ 1 for the fused 1x1], n_list, cout) split-K sums;
                   // with one split, (n_list, cout): the fused 1x1's result
  int s_max;       // most K splits part holds (1: none)
  int n_list;      // listed rows, part's row count
  int target;      // work items of one round of the card's resident blocks
  int by_row;      // the fused block's conv1: live row i's output at out + i * cout
  const int* map;  // the fused block's conv2 (MAP): the row map over g; x is the mid
};

// the K step a ring loads next: its tap (x-fastest offsets dx, dy, dz),
// first channel and the tap's cell offset
struct F32Step {
  int tap, c0, dx, dy, dz, off;
};

// K steps of one phase into ring stages: A, the rows' 16 channels from c0
// of the step's tap at their gathered source (x's taps from the row's cell
// as TapLoader walks them, or with nbr the mid's row through the row map);
// B, weight rows n0 .. n0 + BN of wt (cout, taps, cpad) at (tap, c0). The
// steps load in order, so an F32Step advances one a load, without the
// divisions of step_at.
struct F32Taps {
  const float* x;
  int cin, k, xonly, down, vec;
  Grid g;  // x's grid
  const float* wt;
  int cpad, cout, n0;
  const int* cell;  // shared: the rows' tap-base cells in g, -1 past the live rows
  const int* nbr;   // shared (MAP_TAPS, FBM): positions in the mid, -1 for none; or null

  __device__ __forceinline__ int taps() const {
    return nbr != nullptr ? MAP_TAPS : xonly ? k : k * k * k;
  }
  __device__ __forceinline__ int chunks() const { return (cin + FBK - 1) / FBK; }
  __device__ __forceinline__ int steps() const { return taps() * chunks(); }

  __device__ __forceinline__ void set_off(F32Step& c) const {
    const int h = down ? 0 : k / 2;
    c.off = nbr != nullptr ? 0 : ((c.dx - h) * g.ym + (c.dy - h)) * g.zm + (c.dz - h);
  }
  __device__ __forceinline__ F32Step step_at(int s) const {
    const int nkc = chunks(), h = down ? 0 : k / 2;
    F32Step c;
    c.tap = s / nkc;
    c.c0 = (s - c.tap * nkc) * FBK;
    c.dx = xonly ? c.tap : c.tap % k;
    c.dy = xonly ? h : (c.tap / k) % k;
    c.dz = xonly ? h : c.tap / (k * k);
    set_off(c);
    return c;
  }
  __device__ __forceinline__ void next(F32Step& c) const {
    c.c0 += FBK;
    if (c.c0 < cin) return;  // the tap's last chunk starts below cin
    c.c0 = 0;
    ++c.tap;
    if (xonly) {
      ++c.dx;
    } else if (++c.dx == k) {
      c.dx = 0;
      if (++c.dy == k) {
        c.dy = 0;
        ++c.dz;
      }
    }
    set_off(c);
  }

  template <int BN>
  __device__ __forceinline__ void load(const F32Step& cur, float* st) const {
    constexpr int T = F32Tile<BN>::THREADS;
    const int tap = cur.tap, c0 = cur.c0, off = cur.off, nt = taps();
    const int* src = nbr != nullptr ? nbr + tap * FBM : cell;
    constexpr int Q = FBK / 4;  // 16-byte chunks a staged row
    if (vec) {
      for (int v = threadIdx.x; v < FBM * Q; v += T) {
        const int m = v / Q, q = (v % Q) * 4, c = c0 + q, b = src[m];
        const bool ok = b >= 0 && c < cin;
        cp_async16(st + m * FLD + q, ok ? x + (long long)(b + off) * cin + c : x, ok);
      }
    } else {  // element copies (cin not a multiple of 4)
      for (int e = threadIdx.x; e < FBM * FBK; e += T) {
        const int m = e / FBK, kk = e % FBK, c = c0 + kk, b = src[m];
        const bool ok = b >= 0 && c < cin;
        cp_async4(st + m * FLD + kk, ok ? x + (long long)(b + off) * cin + c : x, ok);
      }
    }
    float* sb = st + FBM * FLD;
    for (int v = threadIdx.x; v < BN * Q; v += T) {
      const int n = v / Q, q = (v % Q) * 4, gn = n0 + n;
      const bool ok = gn < cout;
      cp_async16(sb + n * FLD + q, ok ? wt + ((long long)gn * nt + tap) * cpad + c0 + q : wt, ok);
    }
  }
};

// acc = the rows' products over ld's K steps [first, first + steps)
// through the FSTAGES-deep ring: each step waits for its slice, passes the
// barrier (so the slot the previous step read is free for every warp),
// issues the copies FSTAGES - 1 steps ahead, then runs its 16 channels.
template <int BN>
__device__ __forceinline__ void f32_ring_gemm(const F32Taps& ld, int first, int steps,
                                              float* ring,
                                              float (&acc)[8][F32Tile<BN>::TJ]) {
  using T = F32Tile<BN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tm = (warp / T::WN) * 4 + (lane >> 3), tn = (warp % T::WN) * 8 + (lane & 7);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < T::TJ; ++j) acc[i][j] = 0.f;
  F32Step cur = ld.step_at(first);
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < steps) {
      ld.load<BN>(cur, ring + s * T::STAGE);
      ld.next(cur);
    }
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<FSTAGES - 2>();
    __syncthreads();
    const int nx = s + FSTAGES - 1;
    if (nx < steps) {
      ld.load<BN>(cur, ring + (nx % FSTAGES) * T::STAGE);
      ld.next(cur);
    }
    cp_async_commit();
    const float* a = ring + (s % FSTAGES) * T::STAGE + tm * FLD;
    const float* b = ring + (s % FSTAGES) * T::STAGE + (FBM + tn) * FLD;
    // a kq step's 4 channels: this thread's 8 rows as float4s (held), each
    // column's float4 in turn
#pragma unroll 1
    for (int kq = 0; kq < FBK; kq += 4) {
      float4 av[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = *reinterpret_cast<const float4*>(a + 16 * i * FLD + kq);
#pragma unroll
      for (int j = 0; j < T::TJ; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(b + T::TNC * j * FLD + kq);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          float t = fmaf(av[i].x, bv.x, acc[i][j]);
          t = fmaf(av[i].y, bv.y, t);
          t = fmaf(av[i].z, bv.z, t);
          acc[i][j] = fmaf(av[i].w, bv.w, t);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// K splits of one float32 call, worked out on the card from the live rows
// alone: the most that keep the (row block x column block x split) items
// within one round of the card's resident blocks (p.target), at most s_max
__device__ __forceinline__ int f32_k_splits(const ConvF32& p, int n_live, int col_blocks) {
  const int items = (n_live + FBM - 1) / FBM * col_blocks;
  if (items == 0 || p.s_max <= 1) return 1;
  const int s = p.target / items;
  return s < 1 ? 1 : s < p.s_max ? s : p.s_max;
}

// MAP: conv2 of the fused block, its taps through the row map
template <int BN, bool MAP>
__global__ void __launch_bounds__(F32Tile<BN>::THREADS, F32Tile<BN>::MIN_BLOCKS)
    conv_rows_f32_kernel(const __grid_constant__ ConvF32 p) {
  using T = F32Tile<BN>;
  extern __shared__ __align__(16) float fring[];
  __shared__ int cell[FBM];   // the row's tap base in gin (the down: fine cell 2o)
  __shared__ int ocell[FBM];  // the row's cell in g (by_row: its place), -1 past the live rows
  __shared__ float orow[FBM];
  __shared__ int nbr[MAP ? MAP_TAPS * FBM : 1];  // MAP: (tap, row) positions in the mid
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = (warp / T::WN) * 4 + (lane >> 3), tn = (warp % T::WN) * 8 + (lane & 7);
  const int n_live = p.count[0];
  const int col_blocks = (p.cout + BN - 1) / BN;
  float acc[8][T::TJ];
  const int n_split = f32_k_splits(p, n_live, col_blocks);
  const int per_rb = col_blocks * n_split;

  // work item = (row block rb, column block, K split sp), one a block in
  // turn over a 1-D grid, so the busy blocks spread over the SMs; with one
  // split the block also runs the epilogue, with more
  // split_reduce_f32_kernel sums the splits
  for (int it = blockIdx.x; it < (n_live + FBM - 1) / FBM * per_rb; it += gridDim.x) {
    const int rb = it / per_rb, cs = it - rb * per_rb;
    const int n0 = cs / n_split * BN, sp = cs % n_split;
    const F32Taps main_ld{p.x, p.cin, p.k, p.xonly, p.down, p.vec_a, p.gin, p.wt, p.cpad,
                          p.cout, n0, cell, MAP ? nbr : nullptr};
    const F32Taps res_ld{p.res, p.cres, 1, 0, 0, p.vec_r, p.g, p.rwt, p.crpad, p.cout, n0,
                         ocell, nullptr};
    const int steps = main_ld.steps();
    for (int r = tid; r < FBM; r += T::THREADS) {
      const int i = rb * FBM + r;
      int c = -1, oc = -1;
      float o = 1.f;
      if (i < n_live) {
        int ix, iy, iz;
        row_cell(p.tl, p.rows[i], ix, iy, iz);
        oc = static_cast<int>(flat(p.g, ix + MX, iy + MY, iz + MZ));
        c = p.down ? static_cast<int>(flat(p.gin, 2 * ix + MX, 2 * iy + MY, 2 * iz + MZ)) : oc;
        if (p.occ != nullptr) o = p.occ[oc];
      }
      cell[r] = c;
      ocell[r] = p.by_row && oc >= 0 ? i : oc;
      orow[r] = o;
      if constexpr (MAP) {  // tap t = dx + 3 dy + 9 dz at offset (d - 1) from the cell
#pragma unroll
        for (int t = 0; t < MAP_TAPS; ++t) {
          const int off = ((t % 3 - 1) * p.g.ym + (t / 3 % 3 - 1)) * p.g.zm + t / 9 - 1;
          nbr[t * FBM + r] = oc < 0 ? -1 : p.map[oc + off];
        }
      }
    }
    __syncthreads();
    // the fused 1x1, occ * (res @ rw * rscale + rbias), parked in part's
    // slice after the splits (its first with one split) at the row's place
    // in the list: a duplicate tile's rows share their cell, never a place
    const int rslice = n_split > 1 ? n_split : 0;
    if (p.rwt != nullptr && sp == 0) {
      f32_ring_gemm<BN>(res_ld, 0, res_ld.steps(), fring, acc);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = tm + 16 * i;
        if (ocell[m] < 0) continue;
#pragma unroll
        for (int j = 0; j < T::TJ; ++j) {
          const int gn = n0 + tn + T::TNC * j;
          if (gn >= p.cout) continue;
          float v = fmaf(acc[i][j], p.rscale[gn], p.rbias[gn]);
          if (p.occ != nullptr) v = v * orow[m];
          p.part[((long long)rslice * p.n_list + rb * FBM + m) * p.cout + gn] = v;
        }
      }
    }
    const int k0 = (int)((long long)steps * sp / n_split);
    const int k1 = (int)((long long)steps * (sp + 1) / n_split);
    f32_ring_gemm<BN>(main_ld, k0, k1 - k0, fring, acc);
    if (n_split > 1) {  // this split's raw sums
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = tm + 16 * i;
        if (ocell[m] < 0) continue;
#pragma unroll
        for (int j = 0; j < T::TJ; ++j) {
          const int gn = n0 + tn + T::TNC * j;
          if (gn < p.cout)
            p.part[((long long)sp * p.n_list + rb * FBM + m) * p.cout + gn] = acc[i][j];
        }
      }
      __syncthreads();  // cell, ocell, orow and nbr are rewritten by the next item
      continue;
    }
    // affine, mask, residual (plain, or the parked 1x1), ReLU
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = tm + 16 * i, cl = ocell[m];
      if (cl < 0) continue;
#pragma unroll
      for (int j = 0; j < T::TJ; ++j) {
        const int gn = n0 + tn + T::TNC * j;
        if (gn >= p.cout) continue;
        const long long o = (long long)cl * p.cout + gn;
        float v = acc[i][j];
        if (p.scale != nullptr) v = fmaf(v, p.scale[gn], p.bias[gn]);
        if (p.occ != nullptr) v = v * orow[m];
        if (p.rwt != nullptr) v += p.part[((long long)rb * FBM + m) * p.cout + gn];
        else if (p.res != nullptr) v += p.res[o];
        p.out[o] = p.relu ? fmaxf(v, 0.f) : v;
      }
    }
    __syncthreads();  // cell, ocell, orow and nbr are rewritten by the next row block
  }
}

// the split sums of each live row in split order, then the epilogue:
// affine, mask, residual (plain, or the fused 1x1's slice), ReLU; stored at
// the row's cell (by_row: at its place in the row list), 4 channels a
// thread where the widths allow
__global__ void __launch_bounds__(256) split_reduce_f32_kernel(const __grid_constant__ ConvF32 p,
                                                               int col_blocks) {
  const int n_live = p.count[0];
  const int n_split = f32_k_splits(p, n_live, col_blocks);
  if (n_split == 1) return;
  const int w = p.vec_o ? 4 : 1, nv = p.cout / w;
  const long long n = (long long)n_live * nv;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int i = static_cast<int>(e / nv), c0 = static_cast<int>(e % nv) * w;
    int ix, iy, iz;
    row_cell(p.tl, p.rows[i], ix, iy, iz);
    const long long cl = flat(p.g, ix + MX, iy + MY, iz + MZ);
    const long long ol = (p.by_row ? i : cl) * p.cout + c0;
    const float o = p.occ != nullptr ? p.occ[cl] : 1.f;
    float v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t >= w) break;
      const int c = c0 + t;
      float a = 0.f;
      for (int sp = 0; sp < n_split; ++sp) a += p.part[((long long)sp * p.n_list + i) * p.cout + c];
      if (p.scale != nullptr) a = fmaf(a, p.scale[c], p.bias[c]);
      if (p.occ != nullptr) a = a * o;
      if (p.rwt != nullptr) a += p.part[((long long)n_split * p.n_list + i) * p.cout + c];
      else if (p.res != nullptr) a += p.res[cl * p.cout + c];
      v[t] = p.relu ? fmaxf(a, 0.f) : a;
    }
    if (w == 4)
      *reinterpret_cast<float4*>(p.out + ol) = make_float4(v[0], v[1], v[2], v[3]);
    else
      p.out[ol] = v[0];
  }
}

// a kernel's dynamic shared-memory limit raised to bytes, once a device:
// raised (the caller's, one a kernel instance) keeps a bit a device done
template <typename K>
cudaError_t smem_raised(K* kernel, int bytes, unsigned& raised) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && (raised >> dev & 1u)) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 32) raised |= 1u << dev;
  return e;
}

template <int BN, bool MAP>
cudaError_t f32_smem_raised() {
  static unsigned raised = 0;
  return smem_raised(conv_rows_f32_kernel<BN, MAP>, F32Tile<BN>::SMEM, raised);
}

// conv_rows_f32_kernel (and its K-split reduction) at the narrowest block
// width of 64, 96 and 128 columns that holds cout (128 past it). The split
// target is the card's resident blocks of the dense-tap instance (the
// row-map one takes the same, so the fused block splits as the convs do).
template <int BN, bool MAP>
cudaError_t launch_conv_f32_rows(const ConvF32& p, cudaStream_t s) {
  using T = F32Tile<BN>;
  cudaError_t e = f32_smem_raised<BN, false>();
  if (e == cudaSuccess && MAP) e = f32_smem_raised<BN, MAP>();
  if (e != cudaSuccess) return e;
  static int per_sm = 0;  // resident blocks an SM
  if (per_sm == 0) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_rows_f32_kernel<BN, false>,
                                                      T::THREADS, T::SMEM);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) per_sm = 1;
  }
  ConvF32 q = p;
  q.target = per_sm * sm_count();
  const int col_blocks = (p.cout + BN - 1) / BN;
  conv_rows_f32_kernel<BN, MAP>
      <<<blocks_for((long long)p.n_list * col_blocks * p.s_max, FBM), T::THREADS, T::SMEM, s>>>(q);
  if (p.s_max > 1)
    split_reduce_f32_kernel<<<blocks_for((long long)p.n_list * p.cout / 4, 256), 256, 0, s>>>(
        q, col_blocks);
  return cudaGetLastError();
}

template <bool MAP = false>
cudaError_t launch_conv_f32_cols(const ConvF32& p, cudaStream_t s) {
  return p.cout <= 64   ? launch_conv_f32_rows<64, MAP>(p, s)
         : p.cout <= 96 ? launch_conv_f32_rows<96, MAP>(p, s)
                        : launch_conv_f32_rows<128, MAP>(p, s);
}

// the float32 conv after compaction: conv_rows_f32_kernel over the listed
// rows' live part, then (identity residual) dead_rows_kernel
int launch_conv_f32(ConvF32 p, int n_rows, int* rows, int want_dead, cudaStream_t s) {
  int* count = rows + n_rows;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  compact_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(p.tl, p.g, p.occ, 0, n_rows, rows, count,
                                                      want_dead, nullptr);
  p.rows = rows;
  p.count = count;
  p.n_list = n_rows;
  const cudaError_t e = launch_conv_f32_cols(p, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (want_dead) {
    const int vec = p.cout % 4 == 0 && aligned16(p.res) && aligned16(p.out);
    dead_rows_kernel<float><<<blocks_for((long long)n_rows * (vec ? p.cout / 4 : p.cout), 256),
                              256, 0, s>>>(p.tl, p.g, rows, count, n_rows, p.res, p.cout,
                                           p.relu, vec, p.out);
  }
  return static_cast<int>(cudaGetLastError());
}

// the up at float32 (rows 3f, 7f): TPU kernels tiled_up2 (_up2_kernel,
// ops/pallas/tiled_conv.py:1392) and tiled_up2_into (_up2v2_kernel,
// :1803), out[2p + d] = relu?(occ * (W[d] @ in[p] * scale + bias)) over the
// listed fine tiles. It is the ring core above as a k = 1 product: rows
// the live coarse parents (compact_kernel, up mode), 128 a block; columns
// the 8 parities' outputs, column j parity j / cout and channel j % cout,
// so the weights (8, cout, cpad) load as (8 cout, 1, cpad); K the parent's
// cin channels, 16 a step, with no split (cin <= 256 at the backbone's
// ups: at most 16 steps). Each output is one fmaf chain over the channels
// in ascending order, then fmaf(v, scale, bias), the mask and ReLU, so a
// repeat is bitwise and the outputs are the 64 x 64 tile's before it.
// What bounds it: bytes (the listed fine cells' outputs, the live
// parents' inputs, the weights; 8 cout MACs a parent channel). So:
// - BN is the widest of 128, 96 and 64 that divides cout (256, 128: 128;
//   96: 96): a column block is one parity's channel slice and each of its
//   rows one child, whose cell and occupancy the block works out once
//   into shared memory. The epilogue stages the tile through the free
//   ring and stores each child's BN channels with 16-byte stores,
//   consecutive threads on consecutive channels (vec_o; 4-byte stores
//   where the widths or the output's alignment do not allow).
// - A cout that none divides takes BN 64 with a block's columns across
//   parities: each output works out its child and reads its occupancy, and
//   stores 4 bytes. Correct, not fast.
// - Work items (row block, column block), columns fastest so a row
//   block's inputs stay in L2, run one a block over a 1-D grid bounded by
//   the live count.
// An unoccupied child keeps tiled_up2's wrapper zeros; the into-conv (into
// = 1) writes exact zeros there, and up_dead_kernel at its dead parents'
// children. On the H100 the GEMM runs at ~43% of the FFMA rate, as the
// convs' core does, over all 8 children of a live parent (~1.4 of them
// occupied at L0), so its FFMA loop, not the bytes, sets its time
// (PERF.md).
struct UpF32 {
  const float* x;
  int cin, cpad;
  Grid gin;
  const float* wt;
  int cout;
  Tiles tl;
  Grid gout;
  const int* rows;
  const int* count;
  const float* scale;
  const float* bias;
  const float* occ;
  int ctot, c_off, into, relu, vec_a, vec_o;
  float* out;
};

// cell offset of parity d's child (x-fastest: d = dx + 2 dy + 4 dz) from 2p
__device__ __forceinline__ int child_off(const Grid& g, int d) {
  return ((d & 1) * g.ym + ((d >> 1) & 1)) * g.zm + (d >> 2);
}

// relu?(occ * fmaf(v, scale, bias)) of output channel n
__device__ __forceinline__ float up_epilogue(const UpF32& p, float v, int n, float o) {
  if (p.scale != nullptr) v = fmaf(v, p.scale[n], p.bias[n]);
  if (p.occ != nullptr) v = v * o;
  return p.relu ? fmaxf(v, 0.f) : v;
}

template <int BN>
__global__ void __launch_bounds__(F32Tile<BN>::THREADS, F32Tile<BN>::MIN_BLOCKS)
    up_rows_f32_kernel(const __grid_constant__ UpF32 p) {
  using T = F32Tile<BN>;
  constexpr int TP = BN + 8;  // staged tile pitch: a warp's 4 rows 8 banks apart
  static_assert(FBM * TP <= FSTAGES * T::STAGE, "the staged tile fits the ring");
  extern __shared__ __align__(16) float fring[];
  __shared__ int cell[FBM];   // the parent's cell in gin, -1 past the live rows
  __shared__ int ocell[FBM];  // one parity a block: the child's cell in gout; else 2p's
  __shared__ float orow[FBM];  // one parity a block: occ at the child
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = (warp / T::WN) * 4 + (lane >> 3), tn = (warp % T::WN) * 8 + (lane & 7);
  const int ncol = 8 * p.cout, col_blocks = (ncol + BN - 1) / BN;
  const bool one = p.cout % BN == 0;  // a column block is one parity's slice
  const int n_live = p.count[0];
  float acc[8][T::TJ];
  for (int it = blockIdx.x; it < (n_live + FBM - 1) / FBM * col_blocks; it += gridDim.x) {
    const int rb = it / col_blocks, n0 = (it - rb * col_blocks) * BN;
    const int d0 = n0 / p.cout, c0 = n0 - d0 * p.cout;  // the first column's parity, channel
    const F32Taps ld{p.x, p.cin, 1, 0, 0, p.vec_a, p.gin, p.wt, p.cpad, ncol, n0, cell,
                     nullptr};
    for (int r = tid; r < FBM; r += T::THREADS) {
      const int i = rb * FBM + r;
      int c = -1, oc = -1;
      float o = 1.f;
      if (i < n_live) {
        int px, py, pz;
        parent_cell(p.tl, p.rows[i], px, py, pz);
        c = static_cast<int>(flat(p.gin, px + MX, py + MY, pz + MZ));
        oc = static_cast<int>(flat(p.gout, 2 * px + MX, 2 * py + MY, 2 * pz + MZ));
        if (one) {
          oc += child_off(p.gout, d0);
          if (p.occ != nullptr) o = p.occ[oc];
        }
      }
      cell[r] = c;
      ocell[r] = oc;
      orow[r] = o;
    }
    __syncthreads();
    f32_ring_gemm<BN>(ld, 0, ld.steps(), fring, acc);
    if (one && p.vec_o) {  // the tile through the free ring, 16-byte stores
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < T::TJ; ++j) fring[(tm + 16 * i) * TP + tn + T::TNC * j] = acc[i][j];
      __syncthreads();
      constexpr int Q = BN / 4;
      for (int e = tid; e < FBM * Q; e += T::THREADS) {
        const int m = e / Q, q = (e - m * Q) * 4, cl = ocell[m];
        if (cl < 0) continue;
        const float o = orow[m];
        const bool zero = p.occ != nullptr && o == 0.f;
        if (zero && !p.into) continue;
        const float4 a = *reinterpret_cast<const float4*>(fring + m * TP + q);
        const int n = c0 + q;
        *reinterpret_cast<float4*>(p.out + (long long)cl * p.ctot + p.c_off + n) =
            zero ? make_float4(0.f, 0.f, 0.f, 0.f)
                 : make_float4(up_epilogue(p, a.x, n, o), up_epilogue(p, a.y, n + 1, o),
                               up_epilogue(p, a.z, n + 2, o), up_epilogue(p, a.w, n + 3, o));
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = tm + 16 * i, base = ocell[m];
        if (base < 0) continue;
#pragma unroll
        for (int j = 0; j < T::TJ; ++j) {
          const int col = n0 + tn + T::TNC * j;
          if (col >= ncol) continue;
          const int d = col / p.cout, n = col - d * p.cout;
          const int ch = one ? base : base + child_off(p.gout, d);
          const float o = one ? orow[m] : p.occ != nullptr ? p.occ[ch] : 1.f;
          const bool zero = p.occ != nullptr && o == 0.f;
          if (zero && !p.into) continue;
          p.out[(long long)ch * p.ctot + p.c_off + n] =
              zero ? 0.f : up_epilogue(p, acc[i][j], n, o);
        }
      }
    }
    __syncthreads();  // cell, ocell, orow and the ring are rewritten by the next item
  }
}

template <int BN>
cudaError_t launch_up_f32_rows(const UpF32& p, int n_par, cudaStream_t s) {
  using T = F32Tile<BN>;
  static unsigned raised = 0;
  const cudaError_t e = smem_raised(up_rows_f32_kernel<BN>, T::SMEM, raised);
  if (e != cudaSuccess) return e;
  const int col_blocks = (8 * p.cout + BN - 1) / BN;
  up_rows_f32_kernel<BN>
      <<<blocks_for((long long)n_par * col_blocks, FBM), T::THREADS, T::SMEM, s>>>(p);
  return cudaGetLastError();
}

int launch_up_f32(UpF32 p, int n_par, int* rows, int want_dead, cudaStream_t s) {
  int* count = rows + n_par;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  compact_kernel<<<(n_par + 255) / 256, 256, 0, s>>>(p.tl, p.gout, p.occ, 1, n_par, rows,
                                                     count, want_dead, nullptr);
  p.rows = rows;
  p.count = count;
  const cudaError_t e = p.cout % 128 == 0  ? launch_up_f32_rows<128>(p, n_par, s)
                        : p.cout % 96 == 0 ? launch_up_f32_rows<96>(p, n_par, s)
                                           : launch_up_f32_rows<64>(p, n_par, s);
  return static_cast<int>(e);
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
                                                      want_dead, nullptr);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* rb = static_cast<const __nv_bfloat16*>(res);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const ConvRows p{xb, cin, cpad, k, 0, 0, g, g, static_cast<const __nv_bfloat16*>(wt), cout,
                   tl, rows, count, scale, bias, occ, rb, cres, crpad,
                   static_cast<const __nv_bfloat16*>(rwt), rscale, rbias, relu,
                   cin % 8 == 0 && aligned16(x),
                   rwt != nullptr && cres % 8 == 0 && aligned16(res),
                   cout % 8 == 0 && aligned16(out) &&
                       (res == nullptr || rwt != nullptr || aligned16(res)),
                   ob, part, s_max, n_rows, 2 * sm_count()};
  const cudaError_t e = launch_conv_cols(p, n_rows, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (want_dead) {
    const int vec = cout % 8 == 0 && aligned16(res) && aligned16(out);
    dead_rows_kernel<__nv_bfloat16><<<blocks_for((long long)n_rows * (vec ? cout / 8 : cout), 256), 256, 0,
                       s>>>(tl, g, rows, count, n_rows, rb, cout, relu, vec, ob);
  }
  return static_cast<int>(cudaGetLastError());
}

// x: fold_dydz's grid (xm, ym, zm, cf); wt: (cout, k, cpad) K-major folded
// weights, cpad = cf rounded up to 32 with zero rows; rows: int32 scratch
// of n_rows + 2; out: (xm, ym, zm, cout), the caller's zeros outside the
// occupied listed cells
extern "C" int tiled_conv3d_prefolded_launch(
    const void* x, int cf, int xm, int ym, int zm, const void* wt, int cpad, int k,
    int cout, const int* tiles, int n_rows, int tx, int ty, int tz, const float* scale,
    const float* bias, const float* occ, int relu, int* rows, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  int* count = rows + n_rows;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  compact_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(tl, g, occ, 0, n_rows, rows, count, 0,
                                                      nullptr);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const ConvRows p{static_cast<const __nv_bfloat16*>(x), cf, cpad, k, 1, 0, g, g,
                   static_cast<const __nv_bfloat16*>(wt), cout, tl, rows, count, scale, bias,
                   occ, nullptr, 0, 0, nullptr, nullptr, nullptr, relu,
                   cf % 8 == 0 && aligned16(x), 0, cout % 8 == 0 && aligned16(out), ob,
                   nullptr, 1, n_rows, 2 * sm_count()};
  const cudaError_t e = launch_conv_cols(p, n_rows, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// x: fine grid (xm, ym, zm); out: coarse grid (cxm, cym, czm), the caller's
// zeros outside the occupied listed cells; tiles list COARSE tiles, n_rows
// their cells; wt: (cout, 8, cpad) K-major, taps d = dx + 2 dy + 4 dz, cpad
// = cin rounded up to 32 with zero rows; occ: the coarse occupancy or null
// (every listed cell live); rows: int32 scratch of n_rows + 2; part:
// float32 scratch of s_max * n_rows * cout for up to s_max K splits
extern "C" int tiled_down2_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* wt, int cpad, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int cxm, int cym, int czm,
    const float* scale, const float* bias, const float* occ, int relu, int* rows, void* out,
    float* part, int s_max, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid gi{xm, ym, zm}, go{cxm, cym, czm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  int* count = rows + n_rows;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  compact_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(tl, go, occ, 0, n_rows, rows, count, 0,
                                                      nullptr);
  const ConvRows p{static_cast<const __nv_bfloat16*>(x), cin, cpad, 2, 0, 1, gi, go,
                   static_cast<const __nv_bfloat16*>(wt), cout, tl, rows, count, scale, bias,
                   occ, nullptr, 0, 0, nullptr, nullptr, nullptr, relu,
                   cin % 8 == 0 && aligned16(x), 0, cout % 8 == 0 && aligned16(out),
                   static_cast<__nv_bfloat16*>(out), part, s_max, n_rows, 2 * sm_count()};
  const cudaError_t e = launch_conv_cols(p, n_rows, s);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
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
  const int ctot = cout + skip_c;
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const UpRows p{static_cast<const __nv_bfloat16*>(x), cin, cpad, gi,
                 static_cast<const __nv_bfloat16*>(wt), cout, tl, go, nullptr, nullptr, scale,
                 bias, occ, ctot, 0, 0, relu, cin % 8 == 0 && aligned16(x),
                 cout % 8 == 0 && ctot % 8 == 0 && aligned16(out), ob};
  const cudaError_t e = launch_up(p, n_rows / 8, rows, 0, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (skip != nullptr) {
    const int vec = skip_c % 8 == 0 && skip_ctot % 8 == 0 && ctot % 8 == 0 &&
                    cout % 8 == 0 && aligned16(skip) && aligned16(out);
    skip_copy_kernel<__nv_bfloat16><<<blocks_for((long long)n_rows * (vec ? skip_c / 8 : skip_c), 256), 256,
                       0, s>>>(tl, go, static_cast<const __nv_bfloat16*>(skip), skip_ctot,
                               skip_c, cout, ctot, vec, ob);
  }
  return static_cast<int>(cudaGetLastError());
}

// tiled_up2's conv into dest, a fine grid (xm, ym, zm, ctot) that holds the
// skip in [0, skip_c): channels [skip_c, skip_c + cout) of every listed fine
// cell receive the conv, exact zeros at the unoccupied ones (children of
// live parents in up_rows_kernel's epilogue, every child of a dead parent in
// up_dead_kernel); nothing else of dest is touched. x, wt, cpad, tiles,
// n_rows and rows as tiled_up2_launch.
extern "C" int tiled_up2_into_launch(
    const void* x, int cin, int cxm, int cym, int czm, const void* wt, int cpad, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int xm, int ym, int zm,
    const float* scale, const float* bias, const float* occ, int skip_c, int ctot, int relu,
    int* rows, void* dest, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid gi{cxm, cym, czm}, go{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  const int n_par = n_rows / 8;
  auto* ob = static_cast<__nv_bfloat16*>(dest);
  const int vec = cout % 8 == 0 && ctot % 8 == 0 && skip_c % 8 == 0 && aligned16(dest);
  const UpRows p{static_cast<const __nv_bfloat16*>(x), cin, cpad, gi,
                 static_cast<const __nv_bfloat16*>(wt), cout, tl, go, nullptr, nullptr, scale,
                 bias, occ, ctot, skip_c, 1, relu, cin % 8 == 0 && aligned16(x), vec, ob};
  const int want_dead = occ != nullptr;
  const cudaError_t e = launch_up(p, n_par, rows, want_dead, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (want_dead)
    up_dead_kernel<__nv_bfloat16><<<blocks_for((long long)n_par * 32, 256), 256, 0, s>>>(
        tl, go, rows, rows + n_par, n_par, cout, ctot, skip_c, vec, ob);
  return static_cast<int>(cudaGetLastError());
}

// x: (xm, ym, zm, cin); w1t (cmid, 27, cpad1) and w2t (cout, 27, cpad2)
// K-major, cpad = cin or cmid rounded up to 32; rwt (cout, crpad) for the
// fused 1x1, or null for the identity residual (cin == cout); occ: the
// margined occupancy; rows: int32 scratch of n_rows + 2; map: int32 scratch
// of xm * ym * zm (the row map, rewritten here); mid: bfloat16 scratch of
// n_rows * cmid; part: float32 scratch for the K splits of both GEMMs, up to
// s_max1 (conv1) and s_max2 (conv2, plus the fused 1x1's slice), as
// tiled_conv3d_launch takes them; out: (xm, ym, zm, cout), the caller's
// zeros outside the occupied listed cells (and the identity residual's
// unoccupied ones)
extern "C" int tiled_block3d_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* w1t, int cpad1,
    const void* w2t, int cpad2, int cmid, int cout, const int* tiles, int n_rows, int tx,
    int ty, int tz, const float* scale1, const float* bias1, const float* scale2,
    const float* bias2, const float* occ, const void* rwt, int crpad, const float* rscale,
    const float* rbias, int* rows, int* map, void* mid, void* out, float* part, int s_max1,
    int s_max2, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  int* count = rows + n_rows;
  const int want_dead = rwt == nullptr;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  cudaMemsetAsync(map, 0xff, (size_t)xm * ym * zm * sizeof(int), s);
  compact_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(tl, g, occ, 0, n_rows, rows, count,
                                                      want_dead, map);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  auto* mb = static_cast<__nv_bfloat16*>(mid);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  const int target = 2 * sm_count();
  ConvRows p1{xb, cin, cpad1, 3, 0, 0, g, g, static_cast<const __nv_bfloat16*>(w1t), cmid,
              tl, rows, count, scale1, bias1, occ, nullptr, 0, 0, nullptr, nullptr, nullptr,
              1, cin % 8 == 0 && aligned16(x), 0, cmid % 8 == 0 && aligned16(mid), mb, part,
              s_max1, n_rows, target};
  p1.by_row = 1;
  cudaError_t e = launch_conv_cols(p1, n_rows, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ConvRows p2{mb, cmid, cpad2, 3, 0, 0, g, g, static_cast<const __nv_bfloat16*>(w2t), cout,
              tl, rows, count, scale2, bias2, occ, xb, cin, crpad,
              static_cast<const __nv_bfloat16*>(rwt), rscale, rbias, 1,
              cmid % 8 == 0 && aligned16(mid),
              rwt != nullptr && cin % 8 == 0 && aligned16(x),
              cout % 8 == 0 && aligned16(out) && (rwt != nullptr || aligned16(x)), ob, part,
              s_max2, n_rows, target};
  p2.map = map;
  e = launch_conv_cols<true>(p2, n_rows, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (want_dead) {
    const int vec = cout % 8 == 0 && aligned16(x) && aligned16(out);
    dead_rows_kernel<__nv_bfloat16><<<blocks_for((long long)n_rows * (vec ? cout / 8 : cout), 256), 256, 0,
                       s>>>(tl, g, rows, count, n_rows, xb, cout, 1, vec, ob);
  }
  return static_cast<int>(cudaGetLastError());
}

// float32 grids, weights, residual and skip, with the bfloat16 launchers'
// arguments: rows, part and s_max as those take them (the float32 convs
// split K the same way, from the live rows on the card at 128 a work item).

extern "C" int tiled_conv3d_f32_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* wt, int cpad, int k,
    int cout, const int* tiles, int n_rows, int tx, int ty, int tz, const float* scale,
    const float* bias, const float* occ, const void* res, int cres, const void* rwt,
    int crpad, const float* rscale, const float* rbias, int relu, int* rows, void* out,
    float* part, int s_max, void* stream) {
  if (n_rows <= 0) return 0;
  const Grid g{xm, ym, zm};
  const ConvF32 p{static_cast<const float*>(x), cin, cpad, k, 0, 0, g, g,
                  static_cast<const float*>(wt), cout, Tiles{tiles, n_rows, tx, ty, tz},
                  nullptr, nullptr, scale, bias, occ, static_cast<const float*>(res), cres,
                  crpad, static_cast<const float*>(rwt), rscale, rbias, relu,
                  cin % 4 == 0 && aligned16(x), rwt != nullptr && cres % 4 == 0 && aligned16(res),
                  cout % 4 == 0 && aligned16(out), static_cast<float*>(out), part, s_max};
  return launch_conv_f32(p, n_rows, rows, occ != nullptr && res != nullptr && rwt == nullptr,
                         static_cast<cudaStream_t>(stream));
}

extern "C" int tiled_conv3d_prefolded_f32_launch(
    const void* x, int cf, int xm, int ym, int zm, const void* wt, int cpad, int k,
    int cout, const int* tiles, int n_rows, int tx, int ty, int tz, const float* scale,
    const float* bias, const float* occ, int relu, int* rows, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const Grid g{xm, ym, zm};
  const ConvF32 p{static_cast<const float*>(x), cf, cpad, k, 1, 0, g, g,
                  static_cast<const float*>(wt), cout, Tiles{tiles, n_rows, tx, ty, tz},
                  nullptr, nullptr, scale, bias, occ, nullptr, 0, 0, nullptr, nullptr, nullptr,
                  relu, cf % 4 == 0 && aligned16(x), 0, cout % 4 == 0 && aligned16(out),
                  static_cast<float*>(out), nullptr, 1};
  return launch_conv_f32(p, n_rows, rows, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int tiled_down2_f32_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* wt, int cpad, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int cxm, int cym, int czm,
    const float* scale, const float* bias, const float* occ, int relu, int* rows, void* out,
    float* part, int s_max, void* stream) {
  if (n_rows <= 0) return 0;
  const ConvF32 p{static_cast<const float*>(x), cin, cpad, 2, 0, 1, Grid{xm, ym, zm},
                  Grid{cxm, cym, czm}, static_cast<const float*>(wt), cout,
                  Tiles{tiles, n_rows, tx, ty, tz}, nullptr, nullptr, scale, bias, occ, nullptr,
                  0, 0, nullptr, nullptr, nullptr, relu, cin % 4 == 0 && aligned16(x), 0,
                  cout % 4 == 0 && aligned16(out), static_cast<float*>(out), part, s_max};
  return launch_conv_f32(p, n_rows, rows, 0, static_cast<cudaStream_t>(stream));
}

extern "C" int tiled_up2_f32_launch(
    const void* x, int cin, int cxm, int cym, int czm, const void* wt, int cpad, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int xm, int ym, int zm,
    const float* scale, const float* bias, const float* occ, const void* skip,
    int skip_ctot, int skip_c, int relu, int* rows, void* out, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  const Grid go{xm, ym, zm};
  const int ctot = cout + skip_c;
  auto* of = static_cast<float*>(out);
  const UpF32 p{static_cast<const float*>(x), cin, cpad, Grid{cxm, cym, czm},
                static_cast<const float*>(wt), cout, tl, go, nullptr, nullptr, scale, bias,
                occ, ctot, 0, 0, relu, cin % 4 == 0 && aligned16(x),
                cout % 4 == 0 && ctot % 4 == 0 && aligned16(out), of};
  const int e = launch_up_f32(p, n_rows / 8, rows, 0, s);
  if (e != 0) return e;
  if (skip != nullptr) {
    const int vec = skip_c % 4 == 0 && skip_ctot % 4 == 0 && ctot % 4 == 0 &&
                    cout % 4 == 0 && aligned16(skip) && aligned16(out);
    skip_copy_kernel<float><<<blocks_for((long long)n_rows * (vec ? skip_c / 4 : skip_c), 256),
                              256, 0, s>>>(tl, go, static_cast<const float*>(skip), skip_ctot,
                                           skip_c, cout, ctot, vec, of);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tiled_up2_into_f32_launch(
    const void* x, int cin, int cxm, int cym, int czm, const void* wt, int cpad, int cout,
    const int* tiles, int n_rows, int tx, int ty, int tz, int xm, int ym, int zm,
    const float* scale, const float* bias, const float* occ, int skip_c, int ctot, int relu,
    int* rows, void* dest, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  const Grid go{xm, ym, zm};
  const int n_par = n_rows / 8;
  auto* of = static_cast<float*>(dest);
  const UpF32 p{static_cast<const float*>(x), cin, cpad, Grid{cxm, cym, czm},
                static_cast<const float*>(wt), cout, tl, go, nullptr, nullptr, scale, bias,
                occ, ctot, skip_c, 1, relu, cin % 4 == 0 && aligned16(x),
                cout % 4 == 0 && ctot % 4 == 0 && skip_c % 4 == 0 && aligned16(dest), of};
  const int want_dead = occ != nullptr;
  const int e = launch_up_f32(p, n_par, rows, want_dead, s);
  if (e != 0) return e;
  if (want_dead) {
    const int vec = cout % 4 == 0 && ctot % 4 == 0 && skip_c % 4 == 0 && aligned16(dest);
    up_dead_kernel<float><<<blocks_for((long long)n_par * 32, 256), 256, 0, s>>>(
        tl, go, rows, rows + n_par, n_par, cout, ctot, skip_c, vec, of);
  }
  return static_cast<int>(cudaGetLastError());
}

// tiled_block3d_launch's function and arguments on float32 grids, weights
// and mid: conv_rows_f32_kernel twice over one compaction (conv1 into the
// compact mid, conv2 through the row map), with the splits the two float32
// tiled_conv3d calls take
extern "C" int tiled_block3d_f32_launch(
    const void* x, int cin, int xm, int ym, int zm, const void* w1t, int cpad1,
    const void* w2t, int cpad2, int cmid, int cout, const int* tiles, int n_rows, int tx,
    int ty, int tz, const float* scale1, const float* bias1, const float* scale2,
    const float* bias2, const float* occ, const void* rwt, int crpad, const float* rscale,
    const float* rbias, int* rows, int* map, void* mid, void* out, float* part, int s_max1,
    int s_max2, void* stream) {
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Grid g{xm, ym, zm};
  const Tiles tl{tiles, n_rows, tx, ty, tz};
  int* count = rows + n_rows;
  const int want_dead = rwt == nullptr;
  cudaMemsetAsync(count, 0, 2 * sizeof(int), s);
  cudaMemsetAsync(map, 0xff, (size_t)xm * ym * zm * sizeof(int), s);
  compact_kernel<<<(n_rows + 255) / 256, 256, 0, s>>>(tl, g, occ, 0, n_rows, rows, count,
                                                      want_dead, map);
  const auto* xf = static_cast<const float*>(x);
  auto* mf = static_cast<float*>(mid);
  auto* of = static_cast<float*>(out);
  ConvF32 p1{xf, cin, cpad1, 3, 0, 0, g, g, static_cast<const float*>(w1t), cmid, tl, rows,
             count, scale1, bias1, occ, nullptr, 0, 0, nullptr, nullptr, nullptr, 1,
             cin % 4 == 0 && aligned16(x), 0, cmid % 4 == 0 && aligned16(mid), mf, part,
             s_max1, n_rows};
  p1.by_row = 1;
  cudaError_t e = launch_conv_f32_cols(p1, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  ConvF32 p2{mf, cmid, cpad2, 3, 0, 0, g, g, static_cast<const float*>(w2t), cout, tl, rows,
             count, scale2, bias2, occ, xf, cin, crpad, static_cast<const float*>(rwt), rscale,
             rbias, 1, cmid % 4 == 0 && aligned16(mid),
             rwt != nullptr && cin % 4 == 0 && aligned16(x), cout % 4 == 0 && aligned16(out),
             of, part, s_max2, n_rows};
  p2.map = map;
  e = launch_conv_f32_cols<true>(p2, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (want_dead) {
    const int vec = cout % 4 == 0 && aligned16(x) && aligned16(out);
    dead_rows_kernel<float><<<blocks_for((long long)n_rows * (vec ? cout / 4 : cout), 256), 256,
                              0, s>>>(tl, g, rows, count, n_rows, xf, cout, 1, vec, of);
  }
  return static_cast<int>(cudaGetLastError());
}
