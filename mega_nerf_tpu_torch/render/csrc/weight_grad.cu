// Weight and bias gradients of the fused NeRF training MLP for Hopper
// (sm_90a), written by hand.
//
// Replaces the dW/db half of `mega_nerf_tpu/render/pallas_train.py::
// _train_bwd_kernel` (its f32 weight and bias accumulators, zeroed at
// program_id 0 and summed over the sequential grid). Inputs are the saved
// activation rows of the training forward (`fused_train.py::act_layout`) and
// the pre-activation gradient rows of the backward-data kernel
// (`grad_layout`); the output is the flat f32 gradient buffer in
// `packed_shapes` order. For each job (d_col, n, x_col, k, out_off,
// out_stride, bias_off) of `fused_train.py::weight_grad_jobs`:
//   dW[n][k] = sum_m grad[m][d_col + n] * act[m][x_col + k]
//   db[n]    = sum_m grad[m][d_col + n]          (when bias_off >= 0)
// with bf16 operands and f32 sums.
//
// What bounds it on an H100: the products are ~0.64 ms of dense bf16 at
// 989 TFLOP/s for the fg-fine launch of one 1024-ray step (524,288 points),
// but they read every column of both rows: 5,184 + 4,880 B per point, 5.28
// GB, 1.575 ms at 3.35 TB/s. So one pass over the rows at the memory rate
// is this design's floor, and the tensor cores have to stay off the
// critical path.
//
// Design:
// - TMA loads every operand tile. Two 2-D tensor maps per launch view the
//   rows as [M, stride] bf16 with a 128-byte swizzle; a box is 64 points x
//   64 columns at any column that is a multiple of 8 (a box at an odd
//   column faulted with an illegal instruction), so one map serves every
//   job. Rows past M read as zeros. Columns past a job's n or k read a
//   neighbouring field, and the epilogue masks them. No L2 promotion: each
//   box row is one 128 B piece of a 5 KB point row, and promoting it to 128
//   or 256 B fetches neighbours that other CTAs read at other times (it
//   measured slower in bring-up).
// - A CTA computes one 128 (n) x 256 (k) output tile over one split of the
//   points: two consumer warpgroups of 64 n-rows, each with 64 x 256 f32
//   accumulators, and one producer warp that keeps a ring of 4 stages of 64
//   points in flight (16 KB of d_pre and 32 KB of X per stage) behind full
//   and empty mbarriers. Tiles of narrow jobs load only the boxes they use;
//   a warpgroup with no live rows issues no products.
// - wgmma reads both operands from shared memory, MN-major: the reduction
//   runs over points, and both tiles arrive as [point][column] with the
//   output dimension contiguous, so A = d_pre^T and B = X are both
//   "transposed" operands, and a k-step advances 16 rows (2 KB) of the tile.
//   No thread touches the operands.
// - Bias gradients come from the same tiles: one more m64n8k16 per k-step
//   multiplies d_pre^T by a block of bf16 ones in shared memory, which sums
//   the same bf16 values in f32 (issued for every tile, 3% of the products,
//   so no branch sits between products; tiles with k0 == 0 of a job with a
//   bias write it).
// - Each row byte from device memory about once: CTAs run in clusters of
//   two. The two n-tiles of a job need the same X boxes, the two k-tiles of
//   the branch job the same d_pre boxes; each CTA loads every other box of
//   the shared operand and multicasts it into both CTAs' rings, and a stage
//   is refilled only after the consumers of both CTAs released it. At the
//   paper width TMA then requests 11,776 B per point against 10,064 B of
//   rows (16,640 B without clusters, where the second read of X came from
//   L2 only as far as the two CTAs stayed in step; that version measured
//   slower in bring-up).
// - Split-K over points, reduced in a fixed order: each CTA writes its f32
//   partial tile to scratch; the last CTA of a tile (an atomic counter only
//   elects it) sums the splits in split order, so two launches give the same
//   bits. No f32 atomics touch the gradients.
// - The wrapper (`fused_train.py::weight_grad_plan`) computes the tile
//   pairs and the splits (two waves of the clusters the card holds); this
//   file only follows it.
// - One CTA per SM (199 KB of shared memory); no setmaxnreg: at 288 threads
//   a thread may hold 224 registers, enough for 132 accumulators (ptxas:
//   158 registers, no spills).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int TN = 128;        // output tile rows (n): two warpgroups of 64
constexpr int TK = 256;        // output tile columns (k): one m64n256k16
constexpr int BOX = 64;        // TMA box: 64 points x 64 columns (128 B rows)
constexpr int SP = 64;         // points per stage
constexpr int STAGES = 4;
constexpr int BOX_BYTES = SP * BOX * 2;
constexpr int A_BOXES = TN / BOX;
constexpr int B_BOXES = TK / BOX;
constexpr int STAGE_BYTES = (A_BOXES + B_BOXES) * BOX_BYTES;
constexpr int ONES_BYTES = 16 * 128;  // 16 points x one 128 B row
constexpr int CONSUMER_WARPS = 8;
constexpr int NTHREADS = CONSUMER_WARPS * 32 + 32;
constexpr int TILE_ELEMS = TN * TK + TN;  // partial tile + bias row
constexpr int MAX_JOBS = 24;
constexpr int MAX_TILES = 128;
// What the two CTAs of a cluster share (one TMA load multicast to both).
constexpr int SHARE_NONE = 0;
constexpr int SHARE_X = 1;  // two n-tiles of a job: the same X boxes
constexpr int SHARE_A = 2;  // two k-tiles of a job: the same d_pre boxes
constexpr int SMEM_BYTES =
    1024 + STAGES * STAGE_BYTES + ONES_BYTES + 2 * STAGES * 8 + 16;

struct Job {
  int d_col, n, x_col, k, out_off, out_stride, bias_off;
};

struct Params {
  float* out;
  float* scratch;  // (splits, ntiles, TILE_ELEMS)
  int* counters;   // (ntiles,), zero at launch
  int M, ntiles, splits, split_len;
  Job jobs[MAX_JOBS];
  int tiles[MAX_TILES][3];  // (job, n0, k0); job -1: an idle CTA
  int share[MAX_TILES / 2];  // per cluster: tiles 2c and 2c + 1
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes) : "memory");
}

// One box of `map` at (column c, row r) into shared memory at dst.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c,
                                         int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

// The same box into both CTAs of the cluster, at the same shared-memory
// offsets, completing on each CTA's barrier at the same offset.
__device__ __forceinline__ void tma_load_both(void* dst, const CUtensorMap* map,
                                              int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"((uint16_t)3),
      "r"(c), "r"(r)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled MN-major operand:
// a swizzle atom is 64 MN elements (128 B) x 8 K rows; `lbo` is the byte
// stride between atoms along MN, `sbo` between atoms along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 256, f32) = A (64 x 16) * B (16 x 256) (+ d if accumulate), both
// MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                                 uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
      "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
      "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, "
      "%76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, "
      "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),
        "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),
        "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]),
        "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]),
        "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]),
        "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]),
        "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]),
        "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]),
        "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 8, f32) = A (64 x 16) * B (16 x 8) (+ d): the bias sums.
__device__ __forceinline__ void wgmma_m64n8k16(float* d, uint64_t da,
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(NTHREADS, 1)
weight_grad_kernel(const __grid_constant__ CUtensorMap map_act,
                   const __grid_constant__ CUtensorMap map_grad,
                   const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 B: tiles start on that boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ones = smem + STAGES * STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + ONES_BYTES);
  uint64_t* empty = full + STAGES;
  int* s_last = reinterpret_cast<int*>(empty + STAGES);

  // Clusters walk the tile pairs fastest and the splits slowest.
  const uint32_t rank = cluster_rank();
  const int npairs = p.ntiles / 2;
  const int pair = (blockIdx.x / 2) % npairs;
  const int split = (blockIdx.x / 2) / npairs;
  const int tile = 2 * pair + rank;
  const int share = p.share[pair];
  const bool idle = p.tiles[tile][0] < 0;
  const Job jb = idle ? Job{0, 0, 0, 0, 0, 0, -1} : p.jobs[p.tiles[tile][0]];
  const int n0 = p.tiles[tile][1];
  const int k0 = p.tiles[tile][2];
  const int rows = min(TN, jb.n - n0);  // live output rows and columns
  const int cols = min(TK, jb.k - k0);
  // d_pre boxes start on 16 B: a job at an odd column (the rgb head's, one
  // past the sigma head's) sits `shift` rows into its accumulators.
  const int a_col = jb.d_col + n0;
  const int shift = a_col & 7;
  const int a_boxes = (shift + rows + BOX - 1) / BOX;
  const int b_boxes = (cols + BOX - 1) / BOX;
  const bool do_bias = jb.bias_off >= 0 && k0 == 0;
  const int mb = split * p.split_len;
  const int nst = idle ? 0 : (min(p.M, mb + p.split_len) - mb + SP - 1) / SP;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      // A shared stage is refilled in both CTAs: both must have used it.
      mbar_init(empty + s, share ? 2 * CONSUMER_WARPS : CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < ONES_BYTES / 4; i += NTHREADS)
    reinterpret_cast<uint32_t*>(ones)[i] = 0x3F803F80u;  // bf16 1.0 pairs
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  cluster_sync();  // both CTAs' barriers exist before either is used

  if (warp == CONSUMER_WARPS) {
    // Producer: one thread keeps the ring full. Of a shared operand each CTA
    // loads every other box for both; every box lands in both CTAs.
    if (lane == 0) {
      const int bytes = (a_boxes + b_boxes) * BOX_BYTES;
      for (int it = 0; it < nst; ++it) {
        const int s = it % STAGES;
        const int use = it / STAGES;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        mbar_expect_tx(full + s, bytes);
        uint8_t* st = smem + s * STAGE_BYTES;
        const int row = mb + it * SP;
        for (int b = 0; b < a_boxes; ++b) {
          uint8_t* dst = st + b * BOX_BYTES;
          const int c = a_col - shift + b * BOX;
          if (share != SHARE_A)
            tma_load(dst, &map_grad, c, row, full + s);
          else if (b % 2 == (int)rank)
            tma_load_both(dst, &map_grad, c, row, full + s);
        }
        for (int b = 0; b < b_boxes; ++b) {
          uint8_t* dst = st + (A_BOXES + b) * BOX_BYTES;
          const int c = jb.x_col + k0 + b * BOX;
          if (share != SHARE_X)
            tma_load(dst, &map_act, c, row, full + s);
          else if (b % 2 == (int)rank)
            tma_load_both(dst, &map_act, c, row, full + s);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns output rows wg*64 .. wg*64+63.
    const int wg = warp >> 2;
    const bool active = wg * 64 < shift + rows;
    float acc[128];  // set by the first product (accumulate = 0)
    float bacc[4];
    const uint64_t d_ones = sw128_desc(smem_u32(ones), BOX_BYTES, 1024);
    for (int it = 0; it < nst; ++it) {
      const int s = it % STAGES;
      mbar_wait(full + s, (it / STAGES) & 1);
      if (active) {
        const uint32_t st = smem_u32(smem + s * STAGE_BYTES);
        const uint64_t da = sw128_desc(st + wg * BOX_BYTES, BOX_BYTES, 1024);
        const uint64_t db = sw128_desc(st + A_BOXES * BOX_BYTES, BOX_BYTES, 1024);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < SP / 16; ++ks) {
          // 16 points = 2 KB further into each tile (descriptor units of 16 B).
          // The bias product runs for every tile (3% of the work) so that no
          // branch sits between the products; only bias tiles write it.
          const int accumulate = it > 0 || ks > 0;
          wgmma_m64n256k16(acc, da + ks * 128, db + ks * 128, accumulate);
          wgmma_m64n8k16(bacc, da + ks * 128, d_ones, accumulate);
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      __syncwarp();
      if (lane == 0) {
        if (share) {
          mbar_arrive_cluster(empty + s, 0);
          mbar_arrive_cluster(empty + s, 1);
        } else {
          mbar_arrive(empty + s);
        }
      }
    }
    fence_operands<128>(acc);
    fence_operands<4>(bacc);

    // This split's partial tile: accumulator i of a thread sits at row
    // 16 * warp + lane / 4 (+ 8 for i % 4 >= 2), column 8 * (i / 4) +
    // 2 * (lane % 4) + i % 2 of the warpgroup's 64 x 256 block.
    if (active) {
      float* part = p.scratch + ((size_t)split * p.ntiles + tile) * TILE_ELEMS;
      const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < TK / 8; ++j) {
        if (8 * j < cols) {
          const int c = 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(part + r * TK + c) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(part + (r + 8) * TK + c) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      if (do_bias && (lane & 3) == 0) {
        part[TN * TK + r] = bacc[0];
        part[TN * TK + r + 8] = bacc[2];
      }
    }
  }

  // No CTA leaves while its peer may still arrive on its barriers.
  cluster_sync();
  if (idle) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();

  // The last CTA of this tile sums every split's partial in split order.
  const size_t split_stride = (size_t)p.ntiles * TILE_ELEMS;
  const float* part = p.scratch + (size_t)tile * TILE_ELEMS;
  for (int e = threadIdx.x; e < rows * cols; e += NTHREADS) {
    const int r = e / cols, c = e % cols;
    float s = 0.f;
    for (int sp = 0; sp < p.splits; ++sp)
      s += __ldcg(part + sp * split_stride + (shift + r) * TK + c);
    p.out[jb.out_off + (size_t)(n0 + r) * jb.out_stride + k0 + c] = s;
  }
  if (do_bias) {
    for (int r = threadIdx.x; r < rows; r += NTHREADS) {
      float s = 0.f;
      for (int sp = 0; sp < p.splits; ++sp)
        s += __ldcg(part + sp * split_stride + TN * TK + shift + r);
      p.out[jb.bias_off + n0 + r] = s;
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// rows x cols bf16 row-major at ptr, boxes of 64 rows x 64 columns, 128-byte
// swizzle, out-of-range elements read as zero.
CUresult make_map(CUtensorMap* map, const void* ptr, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {BOX, SP};
  const cuuint32_t estr[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ERR_NO_ENCODE = -1000;  // below: -CUresult of a failed encode

}  // namespace

extern "C" {

// ptrs: act, grad, out, scratch, counters.
// dims: M, njobs, ntiles, splits, split_len, act_stride, grad_stride.
// jobs: njobs x 7 ints (Job fields in order); tiles: ntiles x (job, n0, k0);
// share: ntiles / 2 ints, one per cluster.
// Returns 0, a cudaError_t, or a negative code (weight_grad_error_string).
int weight_grad_launch(const long long* ptrs, const int* dims, const int* jobs,
                       const int* tiles, const int* share, void* stream) {
  Params p;
  p.out = reinterpret_cast<float*>(ptrs[2]);
  p.scratch = reinterpret_cast<float*>(ptrs[3]);
  p.counters = reinterpret_cast<int*>(ptrs[4]);
  p.M = dims[0];
  const int njobs = dims[1];
  p.ntiles = dims[2];
  p.splits = dims[3];
  p.split_len = dims[4];
  if (njobs > MAX_JOBS || p.ntiles > MAX_TILES || p.ntiles % 2 || p.split_len % SP ||
      (dims[5] * 2) % 16 || (dims[6] * 2) % 16 || (ptrs[0] | ptrs[1]) % 16)
    return (int)cudaErrorInvalidValue;
  if (p.M <= 0 || p.ntiles <= 0) return 0;
  for (int j = 0; j < njobs; ++j) {
    const int* f = jobs + 7 * j;
    p.jobs[j] = {f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
  }
  for (int t = 0; t < p.ntiles; ++t)
    for (int f = 0; f < 3; ++f) p.tiles[t][f] = tiles[3 * t + f];
  for (int c = 0; c < p.ntiles / 2; ++c) p.share[c] = share[c];
  if (!encode_tiled()) return ERR_NO_ENCODE;
  CUtensorMap map_act, map_grad;
  CUresult r = make_map(&map_act, reinterpret_cast<const void*>(ptrs[0]), p.M, dims[5]);
  if (r == CUDA_SUCCESS)
    r = make_map(&map_grad, reinterpret_cast<const void*>(ptrs[1]), p.M, dims[6]);
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaError_t err = cudaFuncSetAttribute(
      weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  weight_grad_kernel<<<p.ntiles * p.splits, NTHREADS, SMEM_BYTES,
                       reinterpret_cast<cudaStream_t>(stream)>>>(map_act, map_grad, p);
  return (int)cudaGetLastError();
}

// How many CTAs of the kernel the card holds at once (clusters of two, one
// CTA per SM; a GPC with an odd number of free SMs leaves one unused).
int weight_grad_resident_ctas(int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      weight_grad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * 132);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, weight_grad_kernel, &cfg);
  *ctas = 2 * clusters;
  return (int)err;
}

const char* weight_grad_error_string(int code) {
  static char buf[96];
  if (code == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the driver";
  if (code < 0) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)", -code);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
