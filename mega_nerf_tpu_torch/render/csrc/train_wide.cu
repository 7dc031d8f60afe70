// The wide NeRF training MLP's heads, backward-data and weight-gradient
// kernels for Hopper (sm_90a), written by hand: layer_dim 513-1024, bf16
// compute.
//
// Replaces the TPU kernels `mega_nerf_tpu/render/pallas_train.py::
// _train_fwd_kernel` (its sigma noise and heads) and `::_train_bwd_kernel`
// (its head derivatives, data gradients and f32 weight and bias gradients)
// at the widths the JAX training gate admits past the port's fused chain
// (train_fwd.cu, train_bwd.cu and weight_grad.cu, <= 512). The forward's
// trunk, trunk_final and dir_a layers are eval_wide.cu's layer GEMM, whose
// bf16 outputs fused_train_wide.py keeps for the backward; these four
// kernels do the rest of one training step's MLP work:
// - train_wide_heads_fwd_kernel: sigma_pre = h . w_sigma + b + noise and
//   rgb_pre = branch . W_rgb + b (h without the branch), a warp per point
//   (eval_wide.cu's head code); writes [sigmoid rgb, activated sigma] and
//   the pre-activations [rgb_pre, sigma_pre + noise], both (M, 4) f32.
// - train_wide_heads_bwd_kernel: a warp per point. The cotangent rounded
//   to bf16, g_rgb = g s(1 - s) and g_sigma = g sigmoid(x - 1) (shifted
//   softplus) or g (x > 0), each rounded to bf16 into a 16-column row
//   (g_sigma at column 0, g_rgb at 8: TMA boxes start on 16 B); then
//   d_branch_pre = (g_rgb W_rgb) (branch > 0), or without the branch the
//   last trunk layer's d_pre = (g_sigma w_sigma + g_rgb W_rgb) (h > 0),
//   bf16.
// - train_wide_dx_kernel: one layer's backward-data GEMM,
//   Y[:, c] = sum_n G[:, n] W[n][c0 + c], on the transposed packed matrix
//   (rows c0 .. c0 + N of it), with eval_wide.cu's persistent layer GEMM
//   without its clusters: 128 x 256 output tiles walked by one CTA per SM
//   (tile t at point tile t / ntn, N tile t % ntn), a producer thread
//   keeping a 3-stage TMA ring of G boxes (128 points x 64) and weight
//   boxes (256 x 64, L2 evict_last) full across tile boundaries, two
//   consumer warpgroups on wgmma m64n256k16 with both operands K-major.
//   (Two-CTA clusters sharing the weight boxes, as eval_wide.cu's, made
//   the masked dX 5% slower: they tie each CTA's pace to its peer's, and
//   the mask loads make that pace uneven.) The epilogue adds
//   g_sigma[p] w_sigma[c] in f32 at the last trunk layer (as
//   _train_bwd_kernel sums both terms before masking; both brought into
//   shared memory by cp.async at the tile's start), applies the ReLU mask
//   of the saved layer output (> 0) and rounds to bf16, or leaves unmasked
//   bf16 (d_final), into a shared half-tile buffer per warpgroup (four
//   64 x 64 boxes, 128-byte swizzle) that a second producer thread stores
//   by TMA under the next tile's products. The mask tile comes in by TMA
//   into that same buffer as soon as the previous tile's stores have read
//   it, so it lands under the products; each thread reads its own mask
//   pairs there and overwrites them with its results. d_app (f32, N = the
//   appearance width, any) goes through the same buffer 64 columns at a
//   time and out by coalesced stores predicated on the tile's edge. One
//   instance of the kernel per mode keeps each within ptxas's 168
//   registers with the products pipelined.
//   Per tile at 1024 x 1024 the design it replaces (one tile per CTA, mask
//   words read from device memory in the epilogue a quarter tile at a
//   time) spent 1.2 µs before its first product, 9.7 µs in products and
//   10.1 µs in its epilogue (a %globaltimer copy of that kernel).
// - train_wide_dw_kernel: dW = d_pre^T X and db = sum d_pre of one packed
//   matrix (its X segments are separate tensors, each its own tensor map)
//   or of the two heads, over 128 (n) x 256 (k) output tiles, persistent
//   and split over the points: one CTA per SM, in clusters of two, walks a
//   balanced split of the launch's (tile pair, 64-point stage) space
//   (DwWalk: every cluster gets the same number of stages within one; the
//   mains of all tile pairs run over the same points at once, so the rows
//   they share come from L2; the floaters walk what the mains leave,
//   stream-K). The two CTAs of a cluster take neighbouring n-tiles of one
//   k-tile (or k-tiles of one n-tile) over the same points and each loads
//   half of every box of the shared operand into both. A producer warp
//   keeps a 4-stage ring of 64-point boxes full across unit boundaries; two
//   consumer warpgroups run wgmma m64n256k16 with both operands MN-major,
//   one stage's products in flight while the next stage's start, at most
//   DW_CHAIN stages into one accumulator before it is added into the unit's
//   partial (wgmma's f32 sums lose accuracy with the length of the chain);
//   two bias warps add the d_pre columns of the bias tiles in f32 as the
//   stages pass. Each unit's f32 partial goes to its own slot and its stages to
//   its tile's count; past the walk, the CTA whose unit completed a tile's
//   stages (the atomic count elects it) sums the tile's partials in point
//   order with four-float loads, so two launches at one grid give the same
//   bits.
//   The design it replaces (one CTA per tile and split, 256 CTAs in two
//   waves at a 1024 x 1024 layer, products drained every stage, the last
//   CTA of a tile summing eight partials one float at a time) spent per CTA
//   at 524,288 points 0.5 µs in its prologue, 1.4 µs to its first full
//   stage, 856 µs in its loop (11% of it waiting on a full stage), 3.9 µs
//   storing its partial, and the 32 summing CTAs 94 µs more (a %globaltimer
//   copy of that kernel, NVIDIA H100 80GB HBM3 at 700 W).
//
// What bounds it on an H100: the tensor cores. A 1024 x 1024 layer does 2
// FLOP per weight per point in each of the forward, dX and dW GEMMs: on the
// 524,288 points of one fg-fine pass that is 1.126 TFLOP, 1.138 ms at 989
// TFLOP/s, against 0.64-0.96 ms to move its operands at 3.35 TB/s. The
// heads kernels move bytes only (~5 KB per point read).
//
// Nothing that reads the accumulators or sits between products branches
// on a value ptxas cannot prove warp-uniform (the warp index comes from a
// shuffle where products follow; the ring releases and the epilogue stores
// are predicated instructions). The device helpers are eval_wide.cu's and
// weight_grad.cu's, copied (each .cu stands alone).
// Left for later work: ping-pong consumer warpgroups in dX, fusing dW into
// the dX sweep.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- constants

// train_wide_dx_kernel (eval_wide.cu's layer GEMM tile, ring, output
// buffer and plan: fused_wide.py WIDE_*).
constexpr int TILE_M = 128;
constexpr int TILE_N = 256;
constexpr int TILE_K = 64;
constexpr int STAGES = 3;
constexpr int A_BYTES = TILE_M * TILE_K * 2;
constexpr int B_BYTES = TILE_N * TILE_K * 2;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
// The output tile in shared memory: per consumer warpgroup its 64 rows as
// four 64 x 64 boxes (128-byte rows, 128-byte swizzle), stored by TMA; the
// mask tile loads into the same place first.
constexpr int HALF_M = TILE_M / 2;
constexpr int OUT_BOX = HALF_M * 64 * 2;
constexpr int OUT_HALF_BYTES = HALF_M * TILE_N * 2;
constexpr int OUT_BYTES = 2 * OUT_HALF_BYTES;
// Per consumer warpgroup, two copies (tile parity) of the tile's epilogue
// operands: w_sigma of its 256 columns (bf16 pairs, 512 B) and g_sigma of
// the warpgroup's 64 rows (a 4-byte word each, at SIGMA_ROWS).
constexpr int PARAM_BYTES = 1024;
constexpr int SIGMA_ROWS = 512;
constexpr int PARAMS_BYTES = 2 * 2 * PARAM_BYTES;
// full and empty per stage; per warpgroup: ready, freed, mask landed.
constexpr int BARRIERS = 2 * STAGES + 6;
constexpr int DX_SMEM_BYTES =
    RING_BYTES + OUT_BYTES + PARAMS_BYTES + 8 * BARRIERS + 1024;
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int DX_THREADS = CONSUMER_WARPS * 32 + 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// The dX epilogues (fused_train_wide.py DX_*).
constexpr int MODE_F32 = 0;
constexpr int MODE_NONE = 1;
constexpr int MODE_MASK = 2;
constexpr int MODE_MASK_SIGMA = 3;

// train_wide_dw_kernel (weight_grad.cu's tile and ring; fused_train_wide.py
// DW_*).
constexpr int DW_TN = 128;  // output tile rows (n): two warpgroups of 64
constexpr int DW_TK = 256;  // output tile columns (k): one m64n256k16
constexpr int BOX = 64;     // TMA box: 64 points x 64 columns (128 B rows)
constexpr int SP = 64;      // points per stage
constexpr int DW_STAGES = 4;
constexpr int BOX_BYTES = SP * BOX * 2;
constexpr int A_BOXES = DW_TN / BOX;
constexpr int B_BOXES = DW_TK / BOX;
constexpr int DW_STAGE_BYTES = (A_BOXES + B_BOXES) * BOX_BYTES;
// Two consumer warpgroups, the producer warp, two bias warps.
constexpr int DW_BIAS_WARPS = 2;
constexpr int DW_THREADS = CONSUMER_WARPS * 32 + 32 + 32 * DW_BIAS_WARPS;
constexpr int DW_SUM_THREADS = DW_THREADS - 32;  // all but the producer warp
constexpr int DW_TILE_ELEMS = DW_TN * DW_TK + DW_TN;  // partial tile + bias row
constexpr int DW_MAX_JOBS = 4;
constexpr int DW_MAX_MAPS = 4;
constexpr int DW_MAX_TILES = 64;
constexpr int DW_MAX_WORKERS = 256;  // clusters of a launch
constexpr int DW_MAX_UNITS = DW_MAX_TILES + 1;  // of one worker
// The CTAs of a cluster, launched with the cluster attribute.
constexpr int DW_CLUSTER = 2;
// Stages of one chain of products into the accumulators before they are
// added into the unit's partial. wgmma's f32 sums drift from f64 in
// proportion to the chain: on an NVIDIA H100 80GB HBM3, a 1024 x 1024 trunk
// job's dW/db is 4.3e-6 relative at 128 stages, 9.5e-6 at 256, 2.2e-5 at
// 512, 4.9e-5 at 993, 1.1e-4 at 1,986 (the unbounded walk at 524,288
// points). 512 costs ~1.5% of the walk at 524,288 points, 256 ~5%.
constexpr int DW_CHAIN = 512;
// What the two CTAs of a cluster share (one TMA load multicast to both):
// nothing, the X boxes (neighbouring n-tiles of one k-tile of a job) or
// the d_pre boxes (neighbouring k-tiles of one n-tile).
constexpr int SHARE_NONE = 0;
constexpr int SHARE_X = 1;
constexpr int SHARE_A = 2;
// The ring, full and empty per stage, then a few words, the worker's units
// and whether each completed its tile, and the fixup's list of partial
// slots.
constexpr int DW_TABLE_BYTES = 16 + 20 * DW_MAX_UNITS + 4 * DW_MAX_WORKERS;
constexpr int DW_SMEM_BYTES =
    1024 + DW_STAGES * DW_STAGE_BYTES + 2 * DW_STAGES * 8 + DW_TABLE_BYTES;

constexpr int HEADS_THREADS = 256;
constexpr int HEADS_ROW = 16;     // bf16 columns of a heads-gradient row
constexpr int HEADS_RGB_COL = 8;  // g_rgb's first column in it

// ---------------------------------------------------------------- helpers

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

// Arrive where p holds (a predicate, not a branch: wgmma may be in flight).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %1, 0;\n"
      "@q mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)p) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes) : "memory");
}

// One box of `map` at (column c, row r) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c,
                                         int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

// The same, kept in L2 (evict_last): every CTA reads every weight box.
__device__ __forceinline__ void tma_load_keep(uint32_t dst, const CUtensorMap* map,
                                              int c, int r, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_last.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], pol;\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

// The same box into both CTAs of the cluster, at the same shared-memory
// offset, completing on each CTA's barrier at the same offset.
__device__ __forceinline__ void tma_load_both(uint32_t dst, const CUtensorMap* map, int c,
                                              int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"((uint16_t)3), "r"(c),
      "r"(r)
      : "memory");
}

// Arrive on the barrier at the same offset in CTA `cta` of the cluster
// where p holds (a predicate, not a branch).
__device__ __forceinline__ void mbar_arrive_cluster_if(uint64_t* bar, uint32_t cta,
                                                       bool p) {
  asm volatile(
      "{\n.reg .pred q;\n.reg .b32 remote;\nsetp.ne.s32 q, %2, 0;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@q mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(cta), "r"((int)p)
      : "memory");
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

// A 4-byte global store where p holds (a predicated instruction).
__device__ __forceinline__ void st_global_if(void* addr, uint32_t v, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %2, 0;\n@q st.global.b32 [%0], %1;\n}\n" ::"l"(
          addr),
      "r"(v), "r"((int)p) : "memory");
}

// One box from shared memory at src into `map` at (column c, row r); TMA
// clips rows and columns past the tensor. No L2 hint: with evict_first the
// GEMMs gained 1-3% and train_wide_dw, timed after them, lost 7-8%.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c,
                                          int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(r)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The committed stores have read shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 4 bytes from global memory at src into shared memory at dst, without a
// register on the way (cp.async); zeros where p does not hold.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool p) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(p ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 B, 8-row groups 1024 B apart (SBO); LBO is unused by this layout.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The 128 accumulator operands of an m64n256 product, in order.
#define ACC128                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),       \
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),       \
      "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),       \
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),       \
      "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),       \
      "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),       \
      "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),       \
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),      \
      "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),  \
      "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),  \
      "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),  \
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),  \
      "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),  \
      "+f"(d[126]), "+f"(d[127])

#define REGS128                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "    \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "    \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "    \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "    \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "    \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "    \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "        \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "        \
  "%122, %123, %124, %125, %126, %127}, "

// d (64 x 256, f32) = A (64 x 16) * B (16 x 256) (+ d if accumulate), both
// K-major in shared memory.
__device__ __forceinline__ void wgmma_n256(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : ACC128
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same with both operands MN-major (transposed).
__device__ __forceinline__ void wgmma_n256_t(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " REGS128
      "%128, %129, p, 1, 1, 1, 1;\n}\n"
      : ACC128
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void fence_operands(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 pair_at(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float sigmoidf(float x) { return 1.f / (1.f + expf(-x)); }

// ---------------------------------------------------------------- dX

struct DxMaps {
  CUtensorMap g;     // (M, K) gradient rows, 64 x 128 boxes
  CUtensorMap w;     // (N, K) rows c0 .. c0 + N of the transposed matrix, 64 x 256
  CUtensorMap out;   // (M, N) bf16 output, 64 x 64 boxes (not MODE_F32)
  CUtensorMap mask;  // (M, N) bf16 saved layer output, 64 x 64 boxes (mask modes)
};

struct DxParams {
  float* out_f32;       // (M, N) f32 (MODE_F32)
  const bf16* gheads;   // (M, HEADS_ROW) heads-gradient rows (MODE_MASK_SIGMA)
  const bf16* w_sigma;  // (N,) (MODE_MASK_SIGMA)
  int M, N, nchunk;
  int ntn, ntiles;      // N tiles, all tiles (point tiles x N tiles)
};

// Byte offset, in a warpgroup's half of the output buffer, of the bf16 pair
// at row r (0-63) and column 8 g + 2 q (q < 4) of the tile: box g / 8,
// 16-byte chunk g % 8 of the row, placed at chunk (g % 8) ^ (r % 8) (the
// 128-byte swizzle of the TMA boxes). The eight rows a warp touches at
// once differ in r % 8, so their chunks fall in different banks.
__device__ __forceinline__ uint32_t out_offset(int r, int g, int q) {
  return (g >> 3) * OUT_BOX + r * 128 + ((((g & 7) ^ (r & 7))) << 4) + 4 * q;
}

// One instance per epilogue mode (MODE_*): each holds only its own
// epilogue, which keeps the consumers within ptxas's 168 registers with the
// products pipelined (with all four in one body, ptxas serialised them,
// C7511).
template <int MODE>
__global__ void __launch_bounds__(DX_THREADS, 1)
train_wide_dx_kernel(const __grid_constant__ DxMaps maps,
                     const __grid_constant__ DxParams p) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 B: boxes start on that boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  uint8_t* outbuf = smem + RING_BYTES;
  uint8_t* params = outbuf + OUT_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(params + PARAMS_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* ready = empty + STAGES;  // per warpgroup: its half tile is written
  uint64_t* freed = ready + 2;       // per warpgroup: the store has read it
  uint64_t* mask_in = freed + 2;     // per warpgroup: its mask half has landed
  constexpr bool direct = MODE == MODE_F32;
  constexpr bool masked = MODE == MODE_MASK || MODE == MODE_MASK_SIGMA;
  constexpr bool sigma = MODE == MODE_MASK_SIGMA;
  // Read from lane 0, so the compiler knows the warp (and warpgroup) index
  // is uniform: wgmma under a branch it cannot prove uniform is serialised.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    for (int h = 0; h < 2; ++h) {
      mbar_init(ready + h, 128);
      mbar_init(freed + h, 1);
      mbar_init(mask_in + h, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // Producer warpgroup: it gives its registers to the consumers. One
    // thread keeps the ring full across tile boundaries; another loads each
    // tile's mask into the output buffer (as soon as the previous tile's
    // stores have read it) and stores each finished half tile by TMA.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int st = 0, use = 0;
      for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x) {
        const int m0 = (t / p.ntn) * TILE_M, n0 = (t % p.ntn) * TILE_N;
        for (int c = 0; c < p.nchunk; ++c) {
          if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
          mbar_expect_tx(full + st, STAGE_BYTES);
          const uint32_t dst = ring + st * STAGE_BYTES;
          tma_load(dst, &maps.g, c * TILE_K, m0, full + st);
          tma_load_keep(dst + A_BYTES, &maps.w, c * TILE_K, n0, full + st);
          if (++st == STAGES) st = 0, ++use;
        }
      }
    } else if (warp == CONSUMER_WARPS + 1 && lane == 0 && !direct) {
      int it = 0;
      for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x, ++it) {
        const int m0 = (t / p.ntn) * TILE_M, n0 = (t % p.ntn) * TILE_N;
        for (int h = 0; masked && h < 2; ++h) {
          mbar_expect_tx(mask_in + h, OUT_HALF_BYTES);
          for (int b = 0; b < TILE_N / 64; ++b)
            tma_load(smem_u32(outbuf + h * OUT_HALF_BYTES + b * OUT_BOX), &maps.mask,
                     n0 + 64 * b, m0 + HALF_M * h, mask_in + h);
        }
        for (int h = 0; h < 2; ++h) {
          mbar_wait(ready + h, it & 1);
          for (int b = 0; b < TILE_N / 64; ++b)
            tma_store(&maps.out, smem_u32(outbuf + h * OUT_HALF_BYTES + b * OUT_BOX),
                      n0 + 64 * b, m0 + HALF_M * h);
          bulk_commit();
        }
        bulk_wait_read();
        mbar_arrive(freed);
        mbar_arrive(freed + 1);
      }
      bulk_wait_all();
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2;
  const int tid = threadIdx.x & 127;
  uint8_t* half = outbuf + wg * OUT_HALF_BYTES;
  // Row of accumulators 0-1 of each group of four in the warpgroup's 64 (+ 8
  // for 2-3); its r % 8 is lane / 4.
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int q = lane & 3;
  float acc[128];
  int st = 0, phase = 0;
  int it = 0;
  for (int t = blockIdx.x; t < p.ntiles; t += gridDim.x, ++it) {
    const int m0 = (t / p.ntn) * TILE_M, n0 = (t % p.ntn) * TILE_N;
    // MODE_MASK_SIGMA: the tile's w_sigma pairs and the warpgroup's g_sigma
    // words into its copy for the tile's parity, loading under the
    // products (zeros past N and M). Every thread of the warpgroup passed
    // the barrier of the last epilogue, so none still reads the copy of two
    // tiles back.
    uint8_t* prm = params + (2 * wg + (it & 1)) * PARAM_BYTES;
    if (sigma) {
      const int col = n0 + 2 * tid;
      cp_async4(smem_u32(prm + 4 * tid), p.w_sigma + (col < p.N ? col : 0), col < p.N);
      const int row = m0 + HALF_M * wg + tid;
      const bool live = tid < HALF_M && row < p.M;
      cp_async4(smem_u32(prm + SIGMA_ROWS + 4 * tid),
                p.gheads + (size_t)(live ? row : 0) * HEADS_ROW, live);
      cp_async_commit();
    }

    // Products of a stage stay in flight while the next stage's issue; its
    // stage is released once wgmma.wait_group 1 says they are done.
    int held = -1;
    for (int c = 0; c < p.nchunk; ++c) {
      mbar_wait(full + st, phase);
      const uint32_t base = ring + st * STAGE_BYTES;
      const uint64_t da = kmajor_desc(base + wg * 64 * 128);
      const uint64_t db = kmajor_desc(base + A_BYTES);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TILE_K / 16; ++kk)
        wgmma_n256(acc, da + 2 * kk, db + 2 * kk, c > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_one();
      mbar_arrive_if(empty + held, lane == 0 && held >= 0);
      held = st;
      st = st + 1 == STAGES ? 0 : st + 1;
      phase ^= st == 0;
    }
    wgmma_wait_all();
    mbar_arrive_if(empty + held, lane == 0);
    // The epilogue reads the accumulators only after the wait above.
    fence_operands<128>(acc);

    // Accumulator i of a thread: row r0 (+ 8 for i % 4 >= 2) of the
    // warpgroup's 64, column 8 * (i / 4) + 2 * q + i % 2 of the tile's 256.
    if (direct) {
      // d_app (f32, N = the appearance width) through this warpgroup's half
      // of the output buffer, 64 columns at a time: the accumulators go to
      // shared memory (32-bit addresses, as in the other epilogues), then
      // the warpgroup copies the 64 x 64 slab out row by row, each warp
      // storing 32 consecutive floats, predicated on the edge. Stored
      // straight from the accumulators, each store's 64-bit address held
      // registers the products' pipeline needs (ptxas serialised it, C7511).
      float* slab = reinterpret_cast<float*>(half);
#pragma unroll
      for (int sl = 0; sl < TILE_N / 64; ++sl) {
        if (n0 + 64 * sl < p.N) {  // uniform: kernel parameters and the tile
          named_bar(1 + wg, 128);  // the last slab has been copied out
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
              *reinterpret_cast<float2*>(slab + (r0 + 8 * rr) * 64 + 8 * j + 2 * q) =
                  make_float2(acc[4 * (8 * sl + j) + 2 * rr],
                              acc[4 * (8 * sl + j) + 2 * rr + 1]);
          named_bar(1 + wg, 128);
          const int col = n0 + 64 * sl + (tid & 63);
          for (int r = tid >> 6; r < HALF_M; r += 2) {
            const int row = m0 + HALF_M * wg + r;
            const bool ok = row < p.M && col < p.N;
            st_global_if(p.out_f32 + (ok ? (size_t)row * p.N + col : 0),
                         __float_as_uint(slab[r * 64 + (tid & 63)]), ok);
          }
        }
      }
    } else {
      // The copies of the whole warpgroup have landed, and the half buffer
      // holds the tile's mask (mask modes) or the store has read the
      // previous tile out of it (parity 1 passes at the first tile).
      cp_async_wait_all();
      named_bar(1 + wg, 128);
      mbar_wait(masked ? mask_in + wg : freed + wg, masked ? it & 1 : (it & 1) ^ 1);
      float gs[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        gs[rr] = sigma ? __bfloat162float(*reinterpret_cast<const bf16*>(
                             prm + SIGMA_ROWS + 4 * (r0 + 8 * rr)))
                       : 0.f;
      // Four 8-column groups at a time: their mask pairs are all read
      // before any result overwrites them in place (each thread reads and
      // writes only its own pairs).
#pragma unroll
      for (int part = 0; part < TILE_N / 32; ++part) {
        uint32_t mk[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr)
            mk[j][rr] = masked ? *reinterpret_cast<const uint32_t*>(
                                     half + out_offset(r0 + 8 * rr, 4 * part + j, q))
                               : 0x3F803F80u;  // bf16 1.0 pairs: nothing masked
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int g = 4 * part + j;
          const float2 ws =
              sigma ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                          prm + 4 * (4 * g + q)))
                    : make_float2(0.f, 0.f);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            float v0 = acc[4 * g + 2 * rr];
            float v1 = acc[4 * g + 2 * rr + 1];
            v0 = sigma ? __fadd_rn(v0, __fmul_rn(gs[rr], ws.x)) : v0;
            v1 = sigma ? __fadd_rn(v1, __fmul_rn(gs[rr], ws.y)) : v1;
            const float2 m2 = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&mk[j][rr]));
            v0 = m2.x > 0.f ? v0 : 0.f;
            v1 = m2.y > 0.f ? v1 : 0.f;
            *reinterpret_cast<uint32_t*>(half + out_offset(r0 + 8 * rr, g, q)) =
                bf16_pair(v0, v1);
          }
        }
      }
      fence_async_smem();
      mbar_arrive(ready + wg);
    }
  }
}

// ---------------------------------------------------------------- dW

struct DwJob {
  int d_map, d_col, n, x_map, k, out_off, out_stride, bias_off;
};

struct DwMaps {
  CUtensorMap m[DW_MAX_MAPS];  // (M, width) bf16 tensors, 64 x 64 boxes
};

struct DwParams {
  float* out;
  float* scratch;  // (slots, DW_CLUSTER, DW_TILE_ELEMS): one partial per unit
  int* counters;   // (ntiles,), zero at launch: stages summed so far
  int M, T, ntiles, nitems;
  DwJob jobs[DW_MAX_JOBS];
  int tiles[DW_MAX_TILES][3];  // (job, n0, k0)
  int items[DW_MAX_TILES][3];  // (tile of CTA rank 0, of rank 1 or -1, share)
};

// The balanced walk (fused_train_wide.py::dw_walk mirrors it): G workers
// (clusters) share P items (tile pairs, or a lone tile) of T 64-point
// stages each. Worker c does W + (c < e) stages, so every
// worker's share is within one stage of the mean. The first q P workers
// are mains: main c = m P + p takes stages [m W + (+1s before it), ...) of
// item p, so the q mains of every item run over the same points at the
// same time (the items' shared rows come from L2). The other r = G - q P
// workers are floaters: they walk what the mains leave, each item's last
// stages [F(p), T), items in order, as one line cut into equal shares
// (stream-K). A unit is a worker's stretch of one item; its partial goes to
// slot c (a main) or q P + f + p (floater f in item p: a floater's items
// rise with f, so f + p is unique).
struct DwWalk {
  int P, T, G, q, W, e;
  __device__ DwWalk(int P_, int T_, int G_) : P(P_), T(T_), G(G_), q(G_ / P_) {
    const long long total = (long long)P_ * T_;
    W = (int)(total / G_);
    e = (int)(total - (long long)G_ * W);
  }
  __device__ int share(int c) const { return W + (c < e ? 1 : 0); }
  // The first stage of main m of item p (m <= q: F(p) at m = q).
  __device__ int main_start(int m, int p) const {
    return m * W + (e > p ? min(m, (e - p - 1) / P + 1) : 0);
  }
  // Floater f's first position on the floaters' line.
  __device__ int floater_start(int f) const {
    return f * W + min(f, max(0, e - q * P));
  }
};

// The units of worker c in order: next() gives (item, first stage, end
// stage, slot) until it returns false. Every value is the same in every
// thread (kernel parameters, blockIdx and loop counts).
struct DwUnits {
  const DwWalk& w;
  int c, p, pre, x0, x1;
  __device__ DwUnits(const DwWalk& w_, int c_) : w(w_), c(c_), p(0), pre(0) {
    x0 = c >= w.q * w.P ? w.floater_start(c - w.q * w.P) : 0;
    x1 = x0 + w.share(c);
  }
  __device__ bool next(int& item, int& s0, int& s1, int& slot) {
    if (c < w.q * w.P) {  // a main: one unit
      if (p) return false;
      p = 1;
      item = c % w.P;
      s0 = w.main_start(c / w.P, item);
      s1 = s0 + w.share(c);
      slot = c;
      return s1 > s0;
    }
    while (p < w.P && pre < x1) {
      const int f0 = w.main_start(w.q, p), len = w.T - f0;
      const int lo = max(x0, pre), hi = min(x1, pre + len);
      item = p;
      s0 = f0 + lo - pre;
      s1 = f0 + hi - pre;
      slot = c + p;  // q P + f + p
      pre += len;
      ++p;
      if (lo < hi) return true;
    }
    return false;
  }
};

// Where p holds (predicated instructions, no branch): add n to the tile's
// stage count and write to the shared word at flag whether that completed
// its T stages (-1) or not (0).
__device__ __forceinline__ void count_stages_if(int* counter, int n, int T, int* flag,
                                                bool p) {
  asm volatile(
      "{\n.reg .pred q;\n.reg .s32 old;\n.reg .s32 f;\nsetp.ne.s32 q, %3, 0;\n"
      "@q atom.global.add.s32 old, [%0], %1;\n"
      "@q add.s32 old, old, %1;\n"
      "@q set.eq.s32.s32 f, old, %2;\n"
      "@q st.shared.s32 [%4], f;\n}\n" ::"l"(counter),
      "r"(n), "r"(T), "r"((int)p), "r"(smem_u32(flag))
      : "memory");
}

// One launch computes dW = d_pre^T X and db = sum d_pre of one packed
// matrix (its X segments are separate tensors, each its own tensor map) or
// of the two heads. Persistent: G workers walk DwWalk's units; a worker is a
// cluster of two CTAs on the two tiles of an item (each loads half of the
// shared operand's boxes into both; a lone tile's peer loads its own boxes
// and stores nothing). Thread 0 writes the
// worker's units into shared memory once; a producer warp keeps a 4-stage
// ring of 64-point boxes full across unit boundaries; two consumer
// warpgroups run wgmma m64n256k16 with both operands MN-major (the
// reduction runs over points), one stage's products in flight while the
// next stage's start, DW_CHAIN stages at a time into the accumulators,
// which are then added into the unit's partial. A warpgroup with no live rows (the heads' tiles)
// runs the same products on whatever its box holds and stores nothing, so
// every branch around the products is the same for both. Two bias warps
// add the d_pre columns of the bias tiles (k0 == 0 of a job with a bias)
// in f32 as each stage passes, each lane two columns, point by point (a
// bias product beside the main one, as in weight_grad.cu, takes registers
// a consumer lacks under ptxas's 168: its wgmma were serialised, C7511).
// Each unit's f32 partial goes to its own slot, and its stages are added
// to its tile's count at once; the unit that completes a tile's T stages
// (the atomic count only elects it) has its CTA sum the tile's partials in
// point order past the walk, so two launches at one grid give the same
// bits. A floater's units mostly end before the mains of their tiles, so
// the sums fall to the mains, one unit each.
__global__ void __launch_bounds__(DW_THREADS, 1)
train_wide_dw_kernel(const __grid_constant__ DwMaps maps,
                     const __grid_constant__ DwParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + DW_STAGES * DW_STAGE_BYTES);
  uint64_t* empty = full + DW_STAGES;
  int* s_count = reinterpret_cast<int*>(empty + DW_STAGES);  // units, slots to sum
  int* s_units = s_count + 4;  // per unit: item, first stage, end stage, slot
  int* s_elected = s_units + 4 * DW_MAX_UNITS;  // per unit: it completed its tile
  int* s_order = s_elected + DW_MAX_UNITS;      // the fixup's slots, in point order

  // Read from lane 0, so the compiler knows these are uniform: wgmma under
  // a branch it cannot prove uniform is serialised.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;
  const int rank = __shfl_sync(0xffffffffu, (int)cluster_rank(), 0);
  const DwWalk w(p.nitems, p.T, gridDim.x / DW_CLUSTER);

  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(full + s, 1);
      // A stage is refilled once the consumer and bias warps of both CTAs
      // have used it (either may hold boxes the other loaded).
      mbar_init(empty + s, (CONSUMER_WARPS + DW_BIAS_WARPS) * DW_CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    int count = 0, item, s0, s1, slot;
    for (DwUnits u(w, blockIdx.x / DW_CLUSTER); u.next(item, s0, s1, slot); ++count) {
      s_units[4 * count] = item;
      s_units[4 * count + 1] = s0;
      s_units[4 * count + 2] = s1;
      s_units[4 * count + 3] = slot;
      s_elected[count] = 0;
    }
    s_count[0] = count;
  }
  cluster_sync();  // both CTAs' barriers exist before either is used
  const int nunits = __shfl_sync(0xffffffffu, s_count[0], 0);

  if (warp == CONSUMER_WARPS) {
    // Producer: one thread keeps the ring full across units. Of a shared
    // operand each CTA loads every other box for both; every box lands in
    // both CTAs.
    if (lane == 0) {
      int st = 0, use = 0;
      for (int u = 0; u < nunits; ++u) {
        const int item = s_units[4 * u], s0 = s_units[4 * u + 1], s1 = s_units[4 * u + 2];
        const int tile = p.items[item][rank];
        const int share = p.items[item][2];
        int a_boxes = 0, b_boxes = 0, a_col = 0, k0 = 0, d_map = 0, x_map = 0;
        if (tile >= 0) {
          const DwJob& jb = p.jobs[p.tiles[tile][0]];
          const int n0 = p.tiles[tile][1];
          k0 = p.tiles[tile][2];
          // d_pre boxes start on 16 B: the host refuses a d_col that is not
          // a multiple of 8, and n0 is a multiple of DW_TN.
          a_col = jb.d_col + n0;
          a_boxes = (min(DW_TN, jb.n - n0) + BOX - 1) / BOX;
          b_boxes = (min(DW_TK, jb.k - k0) + BOX - 1) / BOX;
          d_map = jb.d_map;
          x_map = jb.x_map;
        }
        const int bytes = (a_boxes + b_boxes) * BOX_BYTES;
        for (int it = s0; it < s1; ++it) {
          if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
          mbar_expect_tx(full + st, bytes);
          const uint32_t dst = ring + st * DW_STAGE_BYTES;
          const int row = it * SP;
          for (int b = 0; b < a_boxes; ++b) {
            if (share != SHARE_A)
              tma_load(dst + b * BOX_BYTES, &maps.m[d_map], a_col + b * BOX, row, full + st);
            else if (b % 2 == rank)
              tma_load_both(dst + b * BOX_BYTES, &maps.m[d_map], a_col + b * BOX, row,
                            full + st);
          }
          for (int b = 0; b < b_boxes; ++b) {
            const uint32_t xd = dst + (A_BOXES + b) * BOX_BYTES;
            if (share != SHARE_X)
              tma_load(xd, &maps.m[x_map], k0 + b * BOX, row, full + st);
            else if (b % 2 == rank)
              tma_load_both(xd, &maps.m[x_map], k0 + b * BOX, row, full + st);
          }
          if (++st == DW_STAGES) st = 0, ++use;
        }
      }
    }
    // The producer warp takes no part in the sums below.
    cluster_sync();
    return;
  }

  // Consumers (warps 0-7) and bias warps: every unit's partial, its stage
  // count, then the sums of the tiles this CTA completed.
  const int tid = warp < CONSUMER_WARPS ? threadIdx.x : threadIdx.x - 32;  // 0-319
  int st = 0, phase = 0;
  if (warp < CONSUMER_WARPS) {
    // Consumers: warpgroup wg owns output rows wg*64 .. wg*64+63.
    const int wg = warp >> 2;
    float acc[128];  // set by each chain's first product (accumulate = 0)
    for (int u = 0; u < nunits; ++u) {
      const int n = __shfl_sync(0xffffffffu, s_units[4 * u + 2] - s_units[4 * u + 1], 0);
      const int item = __shfl_sync(0xffffffffu, s_units[4 * u], 0);
      const int slot = __shfl_sync(0xffffffffu, s_units[4 * u + 3], 0);
      const int tile = p.items[item][rank];
      const DwJob& jb = p.jobs[tile >= 0 ? p.tiles[tile][0] : 0];
      const int n0 = tile >= 0 ? p.tiles[tile][1] : 0;
      const int k0 = tile >= 0 ? p.tiles[tile][2] : 0;
      const int rows = tile >= 0 ? min(DW_TN, jb.n - n0) : 0;  // live output rows
      const int cols = min(DW_TK, jb.k - k0);                   // and columns
      // Accumulator i of a thread sits at row 16 * warp + lane / 4 (+ 8 for
      // i % 4 >= 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the
      // warpgroup's 64 x 256 block.
      float* part = p.scratch + ((size_t)slot * DW_CLUSTER + rank) * DW_TILE_ELEMS +
                    (wg * 64 + (warp & 3) * 16 + (lane >> 2)) * DW_TK + 2 * (lane & 3);
      for (int c0 = 0; c0 < n; c0 += DW_CHAIN) {
        // Products of a stage stay in flight while the next stage's start;
        // its stage is released (in both CTAs) once wgmma.wait_group 1 says
        // they are done.
        const int len = min(DW_CHAIN, n - c0);
        int held = -1;
        for (int c = 0; c < len; ++c) {
          mbar_wait(full + st, phase);
          const uint32_t base = ring + st * DW_STAGE_BYTES;
          const uint64_t da = sw128_desc(base + wg * BOX_BYTES, BOX_BYTES, 1024);
          const uint64_t db = sw128_desc(base + A_BOXES * BOX_BYTES, BOX_BYTES, 1024);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < SP / 16; ++ks)  // 16 points = 2 KB (descriptor units of 16 B)
            wgmma_n256_t(acc, da + ks * 128, db + ks * 128, c > 0 || ks > 0);
          wgmma_commit();
          wgmma_wait_one();
          mbar_arrive_cluster_if(empty + held, 0, lane == 0 && held >= 0);
          mbar_arrive_cluster_if(empty + held, 1, lane == 0 && held >= 0);
          held = st;
          st = st + 1 == DW_STAGES ? 0 : st + 1;
          phase ^= st == 0;
        }
        wgmma_wait_all();
        mbar_arrive_cluster_if(empty + held, 0, lane == 0);
        mbar_arrive_cluster_if(empty + held, 1, lane == 0);
        // The partial reads the accumulators only after the waits above.
        fence_operands<128>(acc);

        // The chain into the unit's partial tile: stored by the first,
        // added to what the earlier chains left by the others, four column
        // pairs at a time (a compiler barrier after each, so the loads do
        // not all start at once and take registers the accumulators hold).
        if (wg * 64 < rows) {
#pragma unroll
          for (int j0 = 0; j0 < DW_TK / 8; j0 += 4) {
            float2 was[8];
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j) {
              const bool load = c0 > 0 && 8 * j < cols;
              was[2 * (j - j0)] = load ? *reinterpret_cast<const float2*>(part + 8 * j)
                                       : make_float2(0.f, 0.f);
              was[2 * (j - j0) + 1] =
                  load ? *reinterpret_cast<const float2*>(part + 8 * DW_TK + 8 * j)
                       : make_float2(0.f, 0.f);
            }
#pragma unroll
            for (int j = j0; j < j0 + 4; ++j) {
              if (8 * j < cols) {
                const float2 a = was[2 * (j - j0)], b = was[2 * (j - j0) + 1];
                *reinterpret_cast<float2*>(part + 8 * j) =
                    make_float2(acc[4 * j] + a.x, acc[4 * j + 1] + a.y);
                *reinterpret_cast<float2*>(part + 8 * DW_TK + 8 * j) =
                    make_float2(acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
              }
            }
            asm volatile("" ::: "memory");
          }
        }
      }
      // The partials of this unit (the bias warps' too) are stored: count
      // its stages.
      __threadfence();
      named_bar(1, DW_SUM_THREADS);
      count_stages_if(p.counters + (tile >= 0 ? tile : 0), n, p.T, s_elected + u,
                      tid == 0 && tile >= 0);
    }
  } else {
    // Bias warp b: lane l adds d_pre columns 64 b + 2 l and + 1 of the tile
    // (box b, 16-byte chunk l / 4 of each 128-byte row, placed at chunk ^
    // (row % 8) by the swizzle) over every point of a bias unit, even and
    // odd points apart, then the two together; on the other units it only
    // passes the stages on.
    const int bw = warp - CONSUMER_WARPS - 1;
    const int at = bw * BOX_BYTES + 4 * (lane & 3);
    for (int u = 0; u < nunits; ++u) {
      const int item = s_units[4 * u];
      const int n = s_units[4 * u + 2] - s_units[4 * u + 1];
      const int tile = p.items[item][rank];
      const bool bias = tile >= 0 && p.jobs[p.tiles[tile][0]].bias_off >= 0 &&
                        p.tiles[tile][2] == 0;
      float e0 = 0.f, e1 = 0.f, o0 = 0.f, o1 = 0.f;
      for (int c = 0; c < n; ++c) {
        mbar_wait(full + st, phase);
        if (bias) {
          const uint8_t* box = smem + st * DW_STAGE_BYTES + at;
#pragma unroll 16
          for (int r = 0; r < SP; r += 2) {
            const uint32_t v = *reinterpret_cast<const uint32_t*>(
                box + r * 128 + (((lane >> 2) ^ (r & 7)) << 4));
            const uint32_t x = *reinterpret_cast<const uint32_t*>(
                box + (r + 1) * 128 + (((lane >> 2) ^ ((r + 1) & 7)) << 4));
            e0 += __uint_as_float(v << 16);
            e1 += __uint_as_float(v & 0xFFFF0000u);
            o0 += __uint_as_float(x << 16);
            o1 += __uint_as_float(x & 0xFFFF0000u);
          }
        }
        __syncwarp();
        mbar_arrive_cluster_if(empty + st, 0, lane == 0);
        mbar_arrive_cluster_if(empty + st, 1, lane == 0);
        st = st + 1 == DW_STAGES ? 0 : st + 1;
        phase ^= st == 0;
      }
      if (bias) {
        float* part = p.scratch +
                      ((size_t)s_units[4 * u + 3] * DW_CLUSTER + rank) * DW_TILE_ELEMS;
        *reinterpret_cast<float2*>(part + DW_TN * DW_TK + 64 * bw + 2 * lane) =
            make_float2(e0 + o0, e1 + o1);
      }
      __threadfence();
      named_bar(1, DW_SUM_THREADS);
    }
  }

  // The tiles whose last unit this CTA ran: their partials in point order
  // (the mains, then the floaters that walked the last stages), the weights
  // summed by the consumers with four-float loads, the bias by the bias
  // warps.
  for (int u = 0; u < nunits; ++u) {
    named_bar(1, DW_SUM_THREADS);  // the flags are written; the last sums are read
    if (!s_elected[u]) continue;
    const int item = s_units[4 * u];
    const int tile = p.items[item][rank];
    if (tid == 0) {
      int count = 0;
      for (int m = 0; m < w.q; ++m)
        if (w.share(m * w.P + item) > 0) s_order[count++] = m * w.P + item;
      int pre = 0;
      for (int i = 0; i < item; ++i) pre += w.T - w.main_start(w.q, i);
      const int end = pre + w.T - w.main_start(w.q, item);
      for (int f = 0; f < w.G - w.q * w.P; ++f) {
        const int c = w.q * w.P + f;
        const int lo = w.floater_start(f);
        if (max(lo, pre) < min(lo + w.share(c), end)) s_order[count++] = c + item;
      }
      s_count[1] = count;
    }
    named_bar(1, DW_SUM_THREADS);
    __threadfence();
    const int count = s_count[1];
    const DwJob& jb = p.jobs[p.tiles[tile][0]];
    const int n0 = p.tiles[tile][1], k0 = p.tiles[tile][2];
    const int rows = min(DW_TN, jb.n - n0), cols = min(DW_TK, jb.k - k0);
    const size_t stride = (size_t)DW_CLUSTER * DW_TILE_ELEMS;
    const float* base = p.scratch + (size_t)rank * DW_TILE_ELEMS;
    float* out = p.out + jb.out_off + (size_t)n0 * jb.out_stride + k0;
    const bool vec =
        (reinterpret_cast<uintptr_t>(out) & 15) == 0 && (jb.out_stride & 3) == 0;
    // Consumer thread tid sums columns 4 (tid % 64) .. + 3 of rows tid / 64,
    // + 4, ...: the partials' loads of two rows in flight at once, eight
    // partials at a time, then added in point order.
    const int c4 = 4 * (tid & 63);
#pragma unroll 2
    for (int r = tid >> 6; warp < CONSUMER_WARPS && c4 < cols && r < rows; r += 4) {
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int i0 = 0; i0 < count; i0 += 8) {
        float4 v[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (i0 + i < count)
            v[i] = __ldcg(reinterpret_cast<const float4*>(
                base + s_order[i0 + i] * stride + r * DW_TK + c4));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i0 + i < count) {
            sum.x += v[i].x;
            sum.y += v[i].y;
            sum.z += v[i].z;
            sum.w += v[i].w;
          }
        }
      }
      float* o = out + (size_t)r * jb.out_stride + c4;
      if (vec) {
        *reinterpret_cast<float4*>(o) = sum;
      } else {
        o[0] = sum.x;
        o[1] = sum.y;
        o[2] = sum.z;
        o[3] = sum.w;
      }
    }
    if (warp > CONSUMER_WARPS && jb.bias_off >= 0 && k0 == 0) {
      for (int r = tid - CONSUMER_WARPS * 32; r < rows; r += 32 * DW_BIAS_WARPS) {
        float sum = 0.f;
        for (int i = 0; i < count; ++i)
          sum += __ldcg(base + s_order[i] * stride + DW_TN * DW_TK + r);
        p.out[jb.bias_off + n0 + r] = sum;
      }
    }
  }
  // No CTA leaves while its peer may still multicast into it or arrive on
  // its barriers.
  cluster_sync();
}

// ---------------------------------------------------------------- heads

struct HeadsFwdParams {
  const bf16* h;       // (M, D): the last trunk output
  const bf16* branch;  // (M, D / 2), or null
  const float* noise;  // (M,), or null
  const bf16* w_sigma;
  const float* b_sigma;
  const bf16* w_rgb;   // (3, rgb_in)
  const float* b_rgb;
  float* out;          // (M, 4) [rgb, sigma]
  float* pre;          // (M, 4) [rgb_pre, sigma_pre + noise]
  int M, D, rgb_in, has_branch, shifted_softplus;
};

__global__ void __launch_bounds__(HEADS_THREADS)
train_wide_heads_fwd_kernel(const HeadsFwdParams p) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long m = blockIdx.x * (long long)(blockDim.x >> 5) + (threadIdx.x >> 5);
       m < p.M; m += warps) {
    const bf16* hr = p.h + m * p.D;
    float s = 0.f;
    for (int c = 2 * lane; c < p.D; c += 64) {
      const float2 hv = pair_at(hr + c);
      const float2 wv = pair_at(p.w_sigma + c);
      s += hv.x * wv.x + hv.y * wv.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    s += p.b_sigma[0];
    if (p.noise) s += p.noise[m];
    const float sp = s;
    if (p.shifted_softplus) {
      const float x = s - 1.f;
      s = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
    } else {
      s = fmaxf(s, 0.f);
    }

    const bf16* xr = p.has_branch ? p.branch + m * p.rgb_in : hr;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int c = 2 * lane; c < p.rgb_in; c += 64) {
      const float2 hv = pair_at(xr + c);
      const float2 w0 = pair_at(p.w_rgb + c);
      const float2 w1 = pair_at(p.w_rgb + p.rgb_in + c);
      const float2 w2 = pair_at(p.w_rgb + 2 * p.rgb_in + c);
      a0 += hv.x * w0.x + hv.y * w0.y;
      a1 += hv.x * w1.x + hv.y * w1.y;
      a2 += hv.x * w2.x + hv.y * w2.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, o);
      a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    if (lane == 0) {
      a0 += p.b_rgb[0];
      a1 += p.b_rgb[1];
      a2 += p.b_rgb[2];
      reinterpret_cast<float4*>(p.out)[m] =
          make_float4(sigmoidf(a0), sigmoidf(a1), sigmoidf(a2), s);
      reinterpret_cast<float4*>(p.pre)[m] = make_float4(a0, a1, a2, sp);
    }
  }
}

struct HeadsBwdParams {
  const float* g;       // (M, 4) output cotangent
  const float* pre;     // (M, 4) [rgb_pre, sigma_pre + noise]
  const bf16* h;        // (M, D): the last trunk output
  const bf16* branch;   // (M, D / 2), or null
  const bf16* w_sigma;  // (D,)
  const bf16* w_rgb;    // (3, width)
  bf16* rows;           // (M, HEADS_ROW) [g_sigma, 0 x 7, g_rgb, 0 x 5]
  bf16* dpre;           // (M, width): d_branch_pre, or the last layer's d_pre
  int M, D, width, has_branch, shifted_softplus;
};

__global__ void __launch_bounds__(HEADS_THREADS)
train_wide_heads_bwd_kernel(const HeadsBwdParams p) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long m = blockIdx.x * (long long)(blockDim.x >> 5) + (threadIdx.x >> 5);
       m < p.M; m += warps) {
    const float4 gv = reinterpret_cast<const float4*>(p.g)[m];
    const float4 pv = reinterpret_cast<const float4*>(p.pre)[m];
    // The cotangent rounded to bf16 (the JAX kernel receives it in the
    // compute dtype), the derivatives in f32, each rounded once.
    const float s0 = sigmoidf(pv.x), s1 = sigmoidf(pv.y), s2 = sigmoidf(pv.z);
    const float g0 = round_bf16(round_bf16(gv.x) * s0 * (1.f - s0));
    const float g1 = round_bf16(round_bf16(gv.y) * s1 * (1.f - s1));
    const float g2 = round_bf16(round_bf16(gv.z) * s2 * (1.f - s2));
    const float gw = round_bf16(gv.w);
    const float gs = round_bf16(p.shifted_softplus ? gw * sigmoidf(pv.w - 1.f)
                                                   : gw * (pv.w > 0.f ? 1.f : 0.f));
    if (lane < 2) {
      const uint4 v = lane == 0 ? make_uint4(bf16_pair(gs, 0.f), 0u, 0u, 0u)
                                : make_uint4(bf16_pair(g0, g1), bf16_pair(g2, 0.f), 0u, 0u);
      reinterpret_cast<uint4*>(p.rows + m * HEADS_ROW)[lane] = v;
    }
    const bf16* xr = p.has_branch ? p.branch + m * p.width : p.h + m * p.D;
    bf16* out = p.dpre + m * p.width;
    for (int c = 2 * lane; c < p.width; c += 64) {
      const float2 w0 = pair_at(p.w_rgb + c);
      const float2 w1 = pair_at(p.w_rgb + p.width + c);
      const float2 w2 = pair_at(p.w_rgb + 2 * p.width + c);
      float d0 = g0 * w0.x + g1 * w1.x + g2 * w2.x;
      float d1 = g0 * w0.y + g1 * w1.y + g2 * w2.y;
      if (!p.has_branch) {
        const float2 ws = pair_at(p.w_sigma + c);
        d0 = gs * ws.x + d0;
        d1 = gs * ws.y + d1;
      }
      const float2 xv = pair_at(xr + c);
      *reinterpret_cast<uint32_t*>(out + c) =
          bf16_pair(xv.x > 0.f ? d0 : 0.f, xv.y > 0.f ? d1 : 0.f);
    }
  }
}

// ---------------------------------------------------------------- host

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

// rows x cols bf16 at ptr, ld elements from one row to the next, boxes of
// box_rows x 64 columns, 128-byte swizzle, out-of-range elements read as
// zero.
CUresult make_map(CUtensorMap* map, const void* ptr, int rows, int cols, long long ld,
                  int box_rows, CUtensorMapL2promotion promo) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        promo, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ERR_NO_ENCODE = -1000;  // below: -CUresult of a failed encode

// Blocks of a grid-stride launch over `work` items: enough to fill the card.
int stride_blocks(long long work, int threads) {
  const long long need = (work + threads - 1) / threads;
  return (int)(need < 132 * 16 ? (need > 0 ? need : 1) : 132 * 16);
}

bool misaligned(long long ptr) { return ptr % 16 != 0; }

}  // namespace

extern "C" {

// ptrs: h, branch (or 0), noise (or 0), w_sigma, b_sigma, w_rgb, b_rgb, out,
// pre; dims: M, D, rgb_in, has_branch, shifted_softplus
// (fused_train_wide.py::train_wide_heads_fwd).
int train_wide_heads_fwd_launch(const long long* ptrs, const int* dims, void* stream) {
  HeadsFwdParams p;
  p.h = reinterpret_cast<const bf16*>(ptrs[0]);
  p.branch = reinterpret_cast<const bf16*>(ptrs[1]);
  p.noise = reinterpret_cast<const float*>(ptrs[2]);
  p.w_sigma = reinterpret_cast<const bf16*>(ptrs[3]);
  p.b_sigma = reinterpret_cast<const float*>(ptrs[4]);
  p.w_rgb = reinterpret_cast<const bf16*>(ptrs[5]);
  p.b_rgb = reinterpret_cast<const float*>(ptrs[6]);
  p.out = reinterpret_cast<float*>(ptrs[7]);
  p.pre = reinterpret_cast<float*>(ptrs[8]);
  p.M = dims[0];
  p.D = dims[1];
  p.rgb_in = dims[2];
  p.has_branch = dims[3];
  p.shifted_softplus = dims[4];
  if (p.D % 2 || p.rgb_in % 2 || (p.has_branch && !p.branch) || misaligned(ptrs[7]) ||
      misaligned(ptrs[8]))
    return (int)cudaErrorInvalidValue;
  if (p.M <= 0) return 0;
  train_wide_heads_fwd_kernel<<<stride_blocks((long long)p.M * 32, HEADS_THREADS),
                                HEADS_THREADS, 0,
                                reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ptrs: g, pre, h, branch (or 0), w_sigma, w_rgb, rows, dpre; dims: M, D,
// width, has_branch, shifted_softplus, heads row width, g_rgb column
// (fused_train_wide.py::train_wide_heads_bwd).
int train_wide_heads_bwd_launch(const long long* ptrs, const int* dims, void* stream) {
  HeadsBwdParams p;
  p.g = reinterpret_cast<const float*>(ptrs[0]);
  p.pre = reinterpret_cast<const float*>(ptrs[1]);
  p.h = reinterpret_cast<const bf16*>(ptrs[2]);
  p.branch = reinterpret_cast<const bf16*>(ptrs[3]);
  p.w_sigma = reinterpret_cast<const bf16*>(ptrs[4]);
  p.w_rgb = reinterpret_cast<const bf16*>(ptrs[5]);
  p.rows = reinterpret_cast<bf16*>(ptrs[6]);
  p.dpre = reinterpret_cast<bf16*>(ptrs[7]);
  p.M = dims[0];
  p.D = dims[1];
  p.width = dims[2];
  p.has_branch = dims[3];
  p.shifted_softplus = dims[4];
  if (dims[5] != HEADS_ROW || dims[6] != HEADS_RGB_COL || p.D % 2 || p.width % 2 ||
      (p.has_branch ? (!p.branch || p.width != p.D / 2) : p.width != p.D) ||
      misaligned(ptrs[0]) || misaligned(ptrs[1]) || misaligned(ptrs[6]))
    return (int)cudaErrorInvalidValue;
  if (p.M <= 0) return 0;
  train_wide_heads_bwd_kernel<<<stride_blocks((long long)p.M * 32, HEADS_THREADS),
                                HEADS_THREADS, 0,
                                reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ptrs: g, the transposed matrix's first row used, out, mask (or 0), heads
// rows (or 0), w_sigma (or 0); dims: M, N (output columns), K (the
// reduction: g's and the matrix's columns), mode, g's row stride (elements),
// heads row width; plan: tile_m, tile_n, tile_k, stages, output buffer
// bytes, smem bytes (fused_wide.py's plan, checked against this file's
// constants); grid: the CTAs, each walking tiles blockIdx.x, + gridDim.x,
// ... (fused_train_wide.py::train_wide_dx).
int train_wide_dx_launch(const long long* ptrs, const int* dims, const int* plan,
                         int grid, void* stream) {
  if (plan[0] != TILE_M || plan[1] != TILE_N || plan[2] != TILE_K ||
      plan[3] != STAGES || plan[4] != OUT_BYTES || plan[5] != DX_SMEM_BYTES)
    return (int)cudaErrorInvalidValue;
  DxParams p;
  p.out_f32 = reinterpret_cast<float*>(ptrs[2]);
  p.gheads = reinterpret_cast<const bf16*>(ptrs[4]);
  p.w_sigma = reinterpret_cast<const bf16*>(ptrs[5]);
  p.M = dims[0];
  p.N = dims[1];
  const int K = dims[2];
  const int mode = dims[3];
  const int ld_g = dims[4];
  p.nchunk = (K + TILE_K - 1) / TILE_K;
  p.ntn = (p.N + TILE_N - 1) / TILE_N;
  const long long tiles = (long long)((p.M + TILE_M - 1) / TILE_M) * p.ntn;
  const bool masked = mode == MODE_MASK || mode == MODE_MASK_SIGMA;
  const bool known = mode == MODE_F32 || mode == MODE_NONE || masked;
  // bf16 outputs and masks are TMA boxes: 16-byte aligned base and rows.
  const bool boxes = mode != MODE_F32;
  if (!known || dims[5] != HEADS_ROW || p.N < 1 || K < 1 || tiles > (1LL << 30) ||
      grid < 1 || (boxes && (p.N % 8 || misaligned(ptrs[2]))) ||
      (masked && (!ptrs[3] || misaligned(ptrs[3]))) ||
      (mode == MODE_MASK_SIGMA && (!p.gheads || !p.w_sigma || ptrs[4] % 4 ||
                                     ptrs[5] % 4)) ||
      misaligned(ptrs[0]) || misaligned(ptrs[1]) || (ld_g * 2) % 16 || (K * 2) % 16)
    return (int)cudaErrorInvalidValue;
  if (p.M <= 0) return 0;
  p.ntiles = (int)tiles;
  if (!encode_tiled()) return ERR_NO_ENCODE;
  DxMaps maps;
  memset(&maps, 0, sizeof maps);
  CUresult r = make_map(&maps.g, reinterpret_cast<const void*>(ptrs[0]), p.M, K, ld_g,
                        TILE_M, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (r == CUDA_SUCCESS)
    r = make_map(&maps.w, reinterpret_cast<const void*>(ptrs[1]), p.N, K, K, TILE_N,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (r == CUDA_SUCCESS && boxes)
    r = make_map(&maps.out, reinterpret_cast<const void*>(ptrs[2]), p.M, p.N, p.N,
                 HALF_M, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (r == CUDA_SUCCESS && masked)
    r = make_map(&maps.mask, reinterpret_cast<const void*>(ptrs[3]), p.M, p.N, p.N,
                 HALF_M, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  if (r != CUDA_SUCCESS) return -(int)r;
  void (*kernel)(const DxMaps, const DxParams) =
      mode == MODE_F32    ? train_wide_dx_kernel<MODE_F32>
      : mode == MODE_NONE ? train_wide_dx_kernel<MODE_NONE>
      : mode == MODE_MASK ? train_wide_dx_kernel<MODE_MASK>
                            : train_wide_dx_kernel<MODE_MASK_SIGMA>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DX_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, DX_THREADS, DX_SMEM_BYTES, reinterpret_cast<cudaStream_t>(stream)>>>(maps,
                                                                                     p);
  return (int)cudaGetLastError();
}

// CTAs of train_wide_dx_kernel with smem bytes of shared memory that the
// current device holds at once: per SM (the occupancy calculator, on the
// masked instance: all four take the same threads and shared memory) x SMs.
int train_wide_resident_ctas(int smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(train_wide_dx_kernel<MODE_MASK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, train_wide_dx_kernel<MODE_MASK>, DX_THREADS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *ctas = per_sm * sms;
  return (int)err;
}

// ptrs: out, scratch, counters, then one pointer per tensor map; dims: M,
// nmaps, njobs, ntiles, nitems, then per map its width and row stride
// (elements); jobs: njobs x 8 ints (DwJob fields in order); tiles: ntiles x
// (job, n0, k0); items: nitems x (tile of CTA rank 0, tile of rank 1 or -1,
// share); grid: the CTAs, whole clusters of DW_CLUSTER, each cluster
// walking DwWalk's units (fused_train_wide.py::train_wide_dw).
int train_wide_dw_launch(const long long* ptrs, const int* dims, const int* jobs,
                         const int* tiles, const int* items, int grid, void* stream) {
  DwParams p;
  p.out = reinterpret_cast<float*>(ptrs[0]);
  p.scratch = reinterpret_cast<float*>(ptrs[1]);
  p.counters = reinterpret_cast<int*>(ptrs[2]);
  p.M = dims[0];
  const int nmaps = dims[1];
  const int njobs = dims[2];
  p.ntiles = dims[3];
  p.nitems = dims[4];
  p.T = (p.M + SP - 1) / SP;
  if (nmaps < 1 || nmaps > DW_MAX_MAPS || njobs < 1 || njobs > DW_MAX_JOBS ||
      p.ntiles < 1 || p.ntiles > DW_MAX_TILES || p.nitems < 1 || p.nitems > p.ntiles ||
      grid < DW_CLUSTER || grid % DW_CLUSTER || grid / DW_CLUSTER > DW_MAX_WORKERS)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < njobs; ++j) {
    const int* f = jobs + 8 * j;
    p.jobs[j] = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7]};
    // d_col a multiple of 8 (TMA boxes start on 16 B), k of 4 (the sums
    // write four columns at a time).
    if (f[0] < 0 || f[0] >= nmaps || f[3] < 0 || f[3] >= nmaps || f[1] % 8 ||
        f[2] < 1 || f[4] < 1 || f[4] % 4)
      return (int)cudaErrorInvalidValue;
  }
  for (int t = 0; t < p.ntiles; ++t) {
    for (int f = 0; f < 3; ++f) p.tiles[t][f] = tiles[3 * t + f];
    if (p.tiles[t][0] < 0 || p.tiles[t][0] >= njobs || p.tiles[t][1] % DW_TN ||
        p.tiles[t][2] % DW_TK)
      return (int)cudaErrorInvalidValue;
  }
  // Every tile in exactly one item; the two tiles of a shared item read the
  // same boxes of what they share.
  int seen[DW_MAX_TILES] = {0};
  for (int i = 0; i < p.nitems; ++i) {
    const int a = items[3 * i], b = items[3 * i + 1], share = items[3 * i + 2];
    for (int f = 0; f < 3; ++f) p.items[i][f] = items[3 * i + f];
    if (a < 0 || a >= p.ntiles || b < -1 || b >= p.ntiles || share < SHARE_NONE ||
        share > SHARE_A || (share != SHARE_NONE && b < 0))
      return (int)cudaErrorInvalidValue;
    ++seen[a];
    if (b >= 0) {
      ++seen[b];
      const int* ta = p.tiles[a];
      const int* tb = p.tiles[b];
      if ((share == SHARE_X && (ta[0] != tb[0] || ta[2] != tb[2])) ||
          (share == SHARE_A && (ta[0] != tb[0] || ta[1] != tb[1])))
        return (int)cudaErrorInvalidValue;
    }
  }
  for (int t = 0; t < p.ntiles; ++t)
    if (seen[t] != 1) return (int)cudaErrorInvalidValue;
  if (p.M <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODE;
  DwMaps maps;
  memset(&maps, 0, sizeof maps);
  for (int i = 0; i < nmaps; ++i) {
    const int width = dims[5 + 2 * i], ld = dims[6 + 2 * i];
    if (misaligned(ptrs[3 + i]) || (ld * 2) % 16 || width < 1)
      return (int)cudaErrorInvalidValue;
    const CUresult r = make_map(&maps.m[i], reinterpret_cast<const void*>(ptrs[3 + i]),
                                p.M, width, ld, SP, CU_TENSOR_MAP_L2_PROMOTION_NONE);
    if (r != CUDA_SUCCESS) return -(int)r;
  }
  cudaError_t err = cudaFuncSetAttribute(
      train_wide_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.dynamicSmemBytes = DW_SMEM_BYTES;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DW_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, train_wide_dw_kernel, maps, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// CTAs of train_wide_dw_kernel that the current device holds at once in
// clusters of DW_CLUSTER: one CTA per SM (a GPC with an odd number of free
// SMs leaves one unused).
int train_wide_dw_resident_ctas(int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      train_wide_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, clusters = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(DW_CLUSTER * sms);
  cfg.blockDim = dim3(DW_THREADS);
  cfg.dynamicSmemBytes = DW_SMEM_BYTES;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = DW_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, train_wide_dw_kernel, &cfg);
  *ctas = DW_CLUSTER * clusters;
  return (int)err;
}

const char* train_wide_error_string(int code) {
  static char buf[96];
  if (code == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the driver";
  if (code < 0) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)", -code);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
