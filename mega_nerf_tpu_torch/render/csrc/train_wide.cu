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
//   or of the two heads, weight_grad.cu's design without clusters: a CTA
//   computes one 128 (n) x 256 (k) tile over one split of the points, a
//   producer warp keeps a 4-stage ring of 64-point boxes, wgmma reads both
//   operands MN-major (the reduction runs over points), the bias sums come
//   from one m64n8k16 against bf16 ones per k-step; each CTA writes its f32
//   partial to scratch and the last CTA of a tile (an atomic counter only
//   elects it) sums the splits in split order, so two launches give the
//   same bits.
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
// Left for later work: two-CTA clusters multicasting the shared operand in
// dW, ping-pong consumer warpgroups in dX, fusing dW into the dX sweep.

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
constexpr int ONES_BYTES = 16 * 128;  // 16 points x one 128 B row
constexpr int DW_THREADS = CONSUMER_WARPS * 32 + 32;
constexpr int DW_TILE_ELEMS = DW_TN * DW_TK + DW_TN;  // partial tile + bias row
constexpr int DW_MAX_JOBS = 4;
constexpr int DW_MAX_MAPS = 4;
constexpr int DW_MAX_TILES = 64;
constexpr int DW_SMEM_BYTES =
    1024 + DW_STAGES * DW_STAGE_BYTES + ONES_BYTES + 2 * DW_STAGES * 8 + 16;

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

// d (64 x 8, f32) = A (64 x 16) * B (16 x 8) (+ d), both MN-major: the bias
// sums.
__device__ __forceinline__ void wgmma_n8_t(float* d, uint64_t da, uint64_t db,
                                           int accumulate) {
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
  float* scratch;  // (splits, ntiles, DW_TILE_ELEMS)
  int* counters;   // (ntiles,), zero at launch
  int M, ntiles, splits, split_len;
  DwJob jobs[DW_MAX_JOBS];
  int tiles[DW_MAX_TILES][3];  // (job, n0, k0)
};

__global__ void __launch_bounds__(DW_THREADS, 1)
train_wide_dw_kernel(const __grid_constant__ DwMaps maps,
                     const __grid_constant__ DwParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ones = smem + DW_STAGES * DW_STAGE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ones + ONES_BYTES);
  uint64_t* empty = full + DW_STAGES;
  int* s_last = reinterpret_cast<int*>(empty + DW_STAGES);

  // CTAs walk the tiles fastest and the splits slowest, so the tiles of one
  // split read the same point rows at about the same time (from L2).
  const int tile = blockIdx.x % p.ntiles;
  const int split = blockIdx.x / p.ntiles;
  const DwJob jb = p.jobs[p.tiles[tile][0]];
  const int n0 = p.tiles[tile][1];
  const int k0 = p.tiles[tile][2];
  const int rows = min(DW_TN, jb.n - n0);  // live output rows and columns
  const int cols = min(DW_TK, jb.k - k0);
  // d_pre boxes start on 16 B: the host refuses a d_col that is not a
  // multiple of 8, and n0 is a multiple of DW_TN.
  const int a_col = jb.d_col + n0;
  const int a_boxes = (rows + BOX - 1) / BOX;
  const int b_boxes = (cols + BOX - 1) / BOX;
  const bool do_bias = jb.bias_off >= 0 && k0 == 0;
  const int mb = split * p.split_len;
  const int nst = (min(p.M, mb + p.split_len) - mb + SP - 1) / SP;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < ONES_BYTES / 4; i += DW_THREADS)
    reinterpret_cast<uint32_t*>(ones)[i] = 0x3F803F80u;  // bf16 1.0 pairs
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // Producer: one thread keeps the ring full.
    if (lane == 0) {
      const int bytes = (a_boxes + b_boxes) * BOX_BYTES;
      for (int it = 0; it < nst; ++it) {
        const int s = it % DW_STAGES;
        const int use = it / DW_STAGES;
        if (use > 0) mbar_wait(empty + s, (use - 1) & 1);
        mbar_expect_tx(full + s, bytes);
        const uint32_t st = smem_u32(smem + s * DW_STAGE_BYTES);
        const int row = mb + it * SP;
        for (int b = 0; b < a_boxes; ++b)
          tma_load(st + b * BOX_BYTES, &maps.m[jb.d_map], a_col + b * BOX, row,
                   full + s);
        for (int b = 0; b < b_boxes; ++b)
          tma_load(st + (A_BOXES + b) * BOX_BYTES, &maps.m[jb.x_map], k0 + b * BOX, row,
                   full + s);
      }
    }
  } else {
    // Consumers: warpgroup wg owns output rows wg*64 .. wg*64+63.
    const int wg = warp >> 2;
    const bool active = wg * 64 < rows;
    float acc[128];  // set by the first product (accumulate = 0)
    float bacc[4];
    const uint64_t d_ones = sw128_desc(smem_u32(ones), BOX_BYTES, 1024);
    for (int it = 0; it < nst; ++it) {
      const int s = it % DW_STAGES;
      mbar_wait(full + s, (it / DW_STAGES) & 1);
      if (active) {
        const uint32_t st = smem_u32(smem + s * DW_STAGE_BYTES);
        const uint64_t da = sw128_desc(st + wg * BOX_BYTES, BOX_BYTES, 1024);
        const uint64_t db = sw128_desc(st + A_BOXES * BOX_BYTES, BOX_BYTES, 1024);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < SP / 16; ++ks) {
          // 16 points = 2 KB further into each tile (descriptor units of 16 B).
          // The bias product runs for every tile so that no branch sits
          // between the products; only bias tiles write it.
          const int accumulate = it > 0 || ks > 0;
          wgmma_n256_t(acc, da + ks * 128, db + ks * 128, accumulate);
          wgmma_n8_t(bacc, da + ks * 128, d_ones, accumulate);
        }
        wgmma_commit();
        wgmma_wait_all();
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + s);
    }
    fence_operands<128>(acc);
    fence_operands<4>(bacc);

    // This split's partial tile: accumulator i of a thread sits at row
    // 16 * warp + lane / 4 (+ 8 for i % 4 >= 2), column 8 * (i / 4) +
    // 2 * (lane % 4) + i % 2 of the warpgroup's 64 x 256 block.
    if (active && nst > 0) {
      float* part = p.scratch + ((size_t)split * p.ntiles + tile) * DW_TILE_ELEMS;
      const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < DW_TK / 8; ++j) {
        if (8 * j < cols) {
          const int c = 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(part + r * DW_TK + c) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<float2*>(part + (r + 8) * DW_TK + c) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
      if (do_bias && (lane & 3) == 0) {
        part[DW_TN * DW_TK + r] = bacc[0];
        part[DW_TN * DW_TK + r + 8] = bacc[2];
      }
    }
  }

  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    *s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();

  // The last CTA of this tile sums every split's partial in split order.
  const size_t split_stride = (size_t)p.ntiles * DW_TILE_ELEMS;
  const float* part = p.scratch + (size_t)tile * DW_TILE_ELEMS;
  for (int e = threadIdx.x; e < rows * cols; e += DW_THREADS) {
    const int r = e / cols, c = e % cols;
    float s = 0.f;
    for (int sp = 0; sp < p.splits; ++sp)
      s += __ldcg(part + sp * split_stride + r * DW_TK + c);
    p.out[jb.out_off + (size_t)(n0 + r) * jb.out_stride + k0 + c] = s;
  }
  if (do_bias) {
    for (int r = threadIdx.x; r < rows; r += DW_THREADS) {
      float s = 0.f;
      for (int sp = 0; sp < p.splits; ++sp)
        s += __ldcg(part + sp * split_stride + DW_TN * DW_TK + r);
      p.out[jb.bias_off + n0 + r] = s;
    }
  }
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
// nmaps, njobs, ntiles, splits, split_len, then per map its width and row
// stride (elements); jobs: njobs x 8 ints (DwJob fields in order); tiles:
// ntiles x (job, n0, k0) (fused_train_wide.py::train_wide_dw).
int train_wide_dw_launch(const long long* ptrs, const int* dims, const int* jobs,
                         const int* tiles, void* stream) {
  DwParams p;
  p.out = reinterpret_cast<float*>(ptrs[0]);
  p.scratch = reinterpret_cast<float*>(ptrs[1]);
  p.counters = reinterpret_cast<int*>(ptrs[2]);
  p.M = dims[0];
  const int nmaps = dims[1];
  const int njobs = dims[2];
  p.ntiles = dims[3];
  p.splits = dims[4];
  p.split_len = dims[5];
  if (nmaps < 1 || nmaps > DW_MAX_MAPS || njobs < 1 || njobs > DW_MAX_JOBS ||
      p.ntiles < 1 || p.ntiles > DW_MAX_TILES || p.splits < 1 || p.split_len % SP ||
      (long long)p.splits * p.split_len < p.M)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < njobs; ++j) {
    const int* f = jobs + 8 * j;
    p.jobs[j] = {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7]};
    if (f[0] < 0 || f[0] >= nmaps || f[3] < 0 || f[3] >= nmaps || f[1] % 8 ||
        f[2] < 1 || f[4] < 1)
      return (int)cudaErrorInvalidValue;
  }
  for (int t = 0; t < p.ntiles; ++t) {
    for (int f = 0; f < 3; ++f) p.tiles[t][f] = tiles[3 * t + f];
    if (p.tiles[t][0] < 0 || p.tiles[t][0] >= njobs || p.tiles[t][1] % DW_TN ||
        p.tiles[t][2] % DW_TK)
      return (int)cudaErrorInvalidValue;
  }
  if (p.M <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODE;
  DwMaps maps;
  memset(&maps, 0, sizeof maps);
  for (int i = 0; i < nmaps; ++i) {
    const int width = dims[6 + 2 * i], ld = dims[7 + 2 * i];
    if (misaligned(ptrs[3 + i]) || (ld * 2) % 16 || width < 1)
      return (int)cudaErrorInvalidValue;
    const CUresult r = make_map(&maps.m[i], reinterpret_cast<const void*>(ptrs[3 + i]),
                                p.M, width, ld, SP, CU_TENSOR_MAP_L2_PROMOTION_NONE);
    if (r != CUDA_SUCCESS) return -(int)r;
  }
  cudaError_t err = cudaFuncSetAttribute(
      train_wide_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  train_wide_dw_kernel<<<p.ntiles * p.splits, DW_THREADS, DW_SMEM_BYTES,
                         reinterpret_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
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
