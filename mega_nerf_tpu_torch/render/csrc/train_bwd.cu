// Fused NeRF training backward-data kernel for Hopper (sm_90a), written by
// hand. The training forward is in train_fwd.cu, the weight-gradient kernel
// in weight_grad.cu.
//
// Replaces the dX/d_app half of the TPU kernel `mega_nerf_tpu/render/
// pallas_train.py::_train_bwd_kernel` (the custom-VJP backward: sigmoid,
// softplus(x-1) and ReLU derivatives, d_app per point). Per point, from the
// saved activation row the forward wrote (`fused_train.py::act_layout`) and
// the (M, 4) f32 output cotangent:
// 1. heads: sigma_pre and rgb_pre recomputed from the row; g_sigma
//    (shifted-softplus or ReLU derivative) and g_rgb (sigmoid derivative),
//    each rounded to bf16, written to the row's 8-column heads segment;
// 2. with the dir/appearance branch: d_a = bf16((g_rgb @ w_rgb) * (branch >
//    0)), d_final = bf16(d_a @ W_dir_a[:, :D]), d_app = d_a @ W_dir_a[:, app
//    columns] in f32, d_pre_{L-1} = bf16((d_final @ W_final + g_sigma
//    w_sigma) * (h_{L-1} > 0)); without it d_pre_{L-1} = bf16((g_sigma
//    w_sigma + g_rgb @ w_rgb) * (h_{L-1} > 0));
// 3. trunk, i = L-1 .. 1: d_pre_{i-1} = bf16((d_pre_i @ W_i[:, h part]) *
//    (h_{i-1} > 0)); nothing flows into the encodings.
// Every d_pre, d_final and d_a lands in the point's gradient row
// (`fused_train.py::grad_layout`, 4,880 B at the fg paper width), which
// the weight-gradient kernel reads. Rounding is `_train_bwd_kernel`'s (and
// `fused_train.py::train_bwd_data_plain`'s): bf16 products with f32
// accumulation, output derivatives in f32, ReLU masks from the bf16
// activations.
//
// What bounds it on an H100: the data-gradient products of a point are a
// little less than its ~1.21 MFLOP forward, so the fg-fine launch of one
// 1024-ray step (524,288 points) is ~0.60 ms of dense bf16 at 989 TFLOP/s;
// its boundary bytes are far less. The design's own traffic, which the
// bound does not count: the h columns of the saved rows it reads for the
// masks and the heads (4,864 B a point at the fg paper width, h_{L-1}
// twice) and the gradient rows it writes (4,880 B), 5.1 GB at fg fine,
// 1.53 ms at 3.35 TB/s; both can overlap the products.
//
// Design: the training forward's layer chain (train_fwd.cu) run against the
// transposed weights (fused_train.py::transposed_weights). The plan
// (fused_train.py::train_bwd_plan) fixes the tile, the shared memory
// layout, the list of products and the mask loads; this file follows it.
// - A CTA owns TM points: 128 when D <= 256 (each of two consumer
//   warpgroups owns 64 points and every output column), else 64 (both
//   warpgroups on the same 64 points, splitting the output columns). A
//   producer warpgroup gives its registers to the consumers with setmaxnreg;
//   one of its threads feeds the weight ring, another the mask tile.
// - The gradient tile G (TM x D bf16) stays in shared memory in the layout
//   wgmma reads as A: K-major, 128-byte swizzle, blocks of 64 columns. Past
//   the first segment it is zeroed once (after the heads), so columns past a
//   segment's width add nothing to a 64-column box. Each product's epilogue writes its output in place over
//   its input, after the warpgroups that read it have waited for their
//   products.
// - The mask tile H (TM x D bf16, the same layout) holds the saved
//   activations of the layer whose ReLU a product's epilogue applies,
//   loaded by TMA from the rows (64-column boxes of TM points; rows past M
//   arrive as zeros, so their mask is 0). It has a full and an empty
//   mbarrier. At the start of a product each consumer thread reads the
//   mask of its accumulators into registers (one bit each, 128 at most)
//   and releases H, so the next layer's activations load under this
//   product's wgmma and epilogue (read in the epilogue, H would leave only
//   one product's wgmma to cover each load).
// - wgmma m64nNk16: A = G, B = a ring stage holding a box of the transposed
//   matrix (64 k-columns x up to 256 rows: row = output column of the
//   backward, contiguous along the reduction), both K-major with the
//   128-byte swizzle. The ring protocol, the descriptors and the k-loop are
//   train_fwd.cu's; the box of dir_a's d_app rows zero-fills past the
//   matrix's last row.
// - Epilogues: d_app goes from the accumulators to global memory as f32
//   (predicated stores); d_final and every d_pre go to G as bf16 (after the
//   sigma term and the mask select), then to the gradient row: whole
//   64-column blocks by TMA store, tails by 16-byte stores. The store that
//   still reads G is waited for before the next epilogue overwrites it.
// - Nothing that reads the accumulators or sits between products branches
//   on a value ptxas cannot prove warp-uniform: the warp index comes from a
//   shuffle, the column masks, the d_app stores and the barrier arrives are
//   predicated instructions (a divergent path there makes ptxas serialise
//   every wgmma, warnings C7520/C7518).
// - The heads stay one warp per point with a shuffle tree, over the saved
//   activations in shared memory: h_{L-1} comes into G by TMA at the CTA's
//   start (with the branch; else it is the first mask tile), the rgb
//   head's input is the first mask tile. Each lane keeps its head weights in
//   registers, lane i fetches row i's cotangent and noise up front, and
//   lanes 0-3 take one output derivative each. (Read from global memory,
//   one dependent round trip per point, the rows made the heads the
//   largest phase of a CTA.)
// Each .cu stands alone (a shared header cost the eval kernel 1.1%), so the
// device helpers below are train_fwd.cu's, copied.
// Left for later work: the heads as one thread per point; two point tiles
// per CTA in ping-pong, so one tile's mask reads and epilogue run under the
// other's wgmma; clusters multicasting the weight boxes; the weight
// gradient fused into this sweep.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int MAX_MATS = 16;       // trunk layers + trunk_final + dir_a
constexpr int MAX_PRODUCTS = 16;   // the plan's products
constexpr int MAX_MASKS = 16;      // the plan's mask loads
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int NTHREADS = CONSUMER_WARPS * 32 + 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: what the producer keeps
constexpr int CONSUMER_REGS = 232;  // and what each consumer thread gets
constexpr int CHUNK = 64;          // k columns of a weight box (one 128 B row)
constexpr int SLICE = 64;          // output columns of a slice
constexpr int MAX_SLICES = 4;
constexpr int BOX_ROWS = 256;      // weight rows of a box at most
constexpr int STORE_ROWS = 64;     // points of a row-store box
// What a product's epilogue does (fused_train.py BWD_*).
constexpr int KIND_APP = 0;         // d_app, f32 to global memory
constexpr int KIND_FINAL = 1;       // d_final, bf16 into G
constexpr int KIND_MASK = 2;        // d_pre, masked, bf16 into G
constexpr int KIND_MASK_SIGMA = 3;  // the same after adding g_sigma w_sigma

typedef __nv_bfloat16 bf16;

// One product (fused_train.py::TrainBwdPlan.products): A = G's first K
// columns, B = rows [row0, row0 + N) of transposed matrix `mat`; the output
// goes to gradient-row column `col` (for KIND_APP, d_app column `col`).
struct Prod {
  int mat, row0, N, K, kind, col;
};

struct Params {
  const bf16* act;     // saved rows (M, act_stride)
  bf16* grad;          // gradient rows (M, grad_stride)
  const float* g;      // (M, 4) output cotangent
  const float* noise;  // (M,), or null
  float* d_app;        // (M, app_dim), or null
  const bf16* w_sigma;
  const float* b_sigma;
  const bf16* w_rgb;   // (3, rgb_in)
  const float* b_rgb;
  int M, D, has_branch, shifted_softplus, app_dim, act_stride, grad_stride;
  // Saved-row columns of h_{L-1} and of the rgb head's input (the branch
  // or h_{L-1}), its width; the gradient-row segment the elementwise start
  // writes (d_a or d_pre_{L-1}).
  int h_last, rgb_col, rgb_in, first_col, first_width;
  // The plan: byte offsets from the 1024-aligned base of shared memory.
  int tm, stages, stage_bytes, grad_off, mask_off, ring_off, bar_off, heads_off;
  int nprod, nmask;
  Prod prod[MAX_PRODUCTS];
  int mask_col[MAX_MASKS], mask_width[MAX_MASKS];
};

struct Maps {
  CUtensorMap w[MAX_PRODUCTS];  // per product: its matrix, 64 x min(N, 256) boxes
  CUtensorMap act;              // saved rows, 64 x TM boxes
  CUtensorMap grad;             // gradient rows, 64 x 64 boxes
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row r, column c) in a swizzled tile of tm rows.
__device__ __forceinline__ uint32_t swz(int tm, int r, int c) {
  return (uint32_t)((c >> 6) * tm * 128 + r * 128 +
                    ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2);
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

__device__ __forceinline__ void st_shared_if(uint32_t addr, uint32_t v, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %2, 0;\n@q st.shared.b32 [%0], %1;\n}\n" ::"r"(
          addr),
      "r"(v), "r"((int)p) : "memory");
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

// One box of `map` at (column c, row r) into shared memory at dst, kept in
// L2 (evict_last): every CTA reads every weight box.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c,
                                         int r, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_last.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], pol;\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

// One box from shared memory at src into `map` at (column c, row r), first
// to leave L2 (evict_first): the rows stream past, the weights stay.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c,
                                          int r) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%2, %3}], [%1], pol;\n}\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c), "r"(r)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// The thread that committed the stores waits until they have read shared
// memory (a predicate, not a branch, as st_shared_if).
__device__ __forceinline__ void bulk_wait_read_if(bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %0, 0;\n@q cp.async.bulk.wait_group.read 0;\n}\n" ::"r"(
          (int)p) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy writes to shared memory become visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 B, 8-row groups 1024 B apart (SBO); LBO is unused by this layout.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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

// d (64 x 64 NSL, f32) = A (64 x 16) * B (16 x 64 NSL) (+ d if accumulate),
// both K-major in shared memory: one m64nNk16 for all of a warpgroup's
// output columns (N = 64, 128, 192 or 256), so A is read once per k-step.
template <int NSL>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t da, uint64_t db,
                                           int accumulate);

template <>
__device__ __forceinline__ void wgmma_bf16<1>(float* d, uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<2>(float* d, uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<3>(float* d, uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_bf16<4>(float* d, uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "
      "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "
      "%122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// One box of `map` at (column c, row r) into shared memory at dst, first to
// leave L2 (evict_first): the saved rows stream past, the weights stay.
__device__ __forceinline__ void tma_load_first(uint32_t dst, const CUtensorMap* map,
                                               int c, int r, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], pol;\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

// Store where p holds (a predicate, not a branch: wgmma may be in flight).
__device__ __forceinline__ void st_global_if(float* ptr, float v, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n" ::"l"(
          ptr),
      "f"(v), "r"((int)p) : "memory");
}

// What one consumer warpgroup sees of the tile.
struct Ctx {
  uint64_t* full;
  uint64_t* empty;
  uint64_t* mask_full;
  uint64_t* mask_empty;
  uint32_t ring;
  uint32_t grad;     // shared address of G
  uint8_t* gradp;    // and as a pointer
  const uint8_t* mask;
  uint8_t* heads;  // 4 bf16 per point: g_sigma, g_r, g_g, g_b
  int stages, stage_bytes, tm, wg, arow, warp, lane;
  // The rows this warpgroup shares with its group (its own 64 at TM 128,
  // all 64 with the other warpgroup at TM 64) and the group's barrier.
  int r0, gtid, gthreads, bar_id;
  bool leader;
};

__device__ __forceinline__ void group_sync(const Ctx& cx) {
  named_bar(cx.bar_id, cx.gthreads);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float2 pair_at(const uint8_t* tile, int tm, int r, int c) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(tile + swz(tm, r, c)));
}

// Eight bf16 as floats.
__device__ __forceinline__ void unpack8(uint4 u, float* v) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Products of one plan entry for this warpgroup's NSL slices of output
// columns from c0, then (after every reader of G is done) its epilogue.
// Every consumer warp waits for and releases every ring entry, and waits for
// and releases every mask tile, so the barriers' phases stay in step whether
// or not it uses them. The k-loop and the ring protocol are train_fwd.cu's
// run_layer with one input segment, G.
template <int NSL>
__device__ __forceinline__ void run_product(float (&acc)[MAX_SLICES][32], const Prod& pr,
                                            const Params& p, const Ctx& cx, int& e,
                                            int& hk, int c0, int c1, int m0) {
  // Products of a ring entry stay in flight while the next entry's issue;
  // its stage is released once wgmma.wait_group 1 says they are done.
  int on = 0;
  int held = -1;
  const int nhalf = pr.N > BOX_ROWS ? 2 : 1;
  const int nchunk = (pr.K + CHUNK - 1) / CHUNK;
  // Accumulator i of a thread: row 16 * (warp % 4) + lane / 4 (+ 8 for
  // i % 4 >= 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the slice.
  const int row = cx.arow + 16 * (cx.warp & 3) + (cx.lane >> 2);
  // The mask of this thread's accumulators, one bit each (bit i of word q),
  // read before the products: the mask tile is released at once, so the
  // next layer's activations load under this product and its epilogue.
  const bool masked = pr.kind == KIND_MASK || pr.kind == KIND_MASK_SIGMA;
  uint32_t bits[MAX_SLICES];
  if (masked) {
    mbar_wait(cx.mask_full, hk & 1);
#pragma unroll
    for (int q = 0; q < NSL; ++q) {
      bits[q] = 0u;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = c0 + q * SLICE + 8 * g + 2 * (cx.lane & 3);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float2 hv = pair_at(cx.mask, cx.tm, row + 8 * rr, col);
          bits[q] |= (hv.x > 0.f ? 1u : 0u) << (4 * g + 2 * rr);
          bits[q] |= (hv.y > 0.f ? 1u : 0u) << (4 * g + 2 * rr + 1);
        }
      }
    }
    __syncwarp();
    mbar_arrive_if(cx.mask_empty, cx.lane == 0);
    ++hk;
  }
  for (int j = 0; j < nchunk; ++j) {
    for (int h = 0; h < nhalf; ++h, ++e) {
      const int st = e % cx.stages;
      mbar_wait(cx.full + st, (e / cx.stages) & 1);
      if (NSL == 0 || (nhalf == 2 && h != cx.wg)) {
        mbar_arrive_if(cx.empty + st, cx.lane == 0);
        continue;
      }
      // Every chunk runs 4 k-steps: G's columns past the product's K are
      // zero, and so are the box columns past the matrix's.
      const uint64_t da = kmajor_desc(cx.grad + j * cx.tm * 128 + cx.arow * 128);
      const uint64_t db = kmajor_desc(cx.ring + st * cx.stage_bytes +
                                      (nhalf == 1 ? c0 * 128 : 0));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < CHUNK / 16; ++kk) {
        wgmma_bf16<NSL>(&acc[0][0], da + 2 * kk, db + 2 * kk, on);
        on = 1;
      }
      wgmma_commit();
      wgmma_wait_one();
      mbar_arrive_if(cx.empty + held, cx.lane == 0 && held >= 0);
      held = st;
    }
  }
  wgmma_wait_all();
  mbar_arrive_if(cx.empty + held, cx.lane == 0 && held >= 0);
#pragma unroll
  for (int q = 0; q < NSL; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[q][i])::"memory");

  // G is the output tile: wait for the group's readers and for the row
  // store that still reads the previous output.
  bulk_wait_read_if(cx.leader);
  group_sync(cx);

  if (pr.kind == KIND_APP) {
#pragma unroll
    for (int q = 0; q < NSL; ++q) {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int col = c0 + q * SLICE + 8 * g + 2 * (cx.lane & 3);
        const int ac = pr.col + col;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int m = m0 + row + 8 * rr;
          float* dst = p.d_app + (size_t)m * p.app_dim + ac;
          const bool live = m < p.M && col < c1;
          st_global_if(dst, acc[q][4 * g + 2 * rr], live && ac < p.app_dim);
          st_global_if(dst + 1, acc[q][4 * g + 2 * rr + 1], live && ac + 1 < p.app_dim);
        }
      }
    }
    return;
  }
  const bool sigma = pr.kind == KIND_MASK_SIGMA;
  const float gs[2] = {__bfloat162float(*reinterpret_cast<const bf16*>(cx.heads + 8 * row)),
                       __bfloat162float(*reinterpret_cast<const bf16*>(cx.heads + 8 * row + 64))};
#pragma unroll
  for (int q = 0; q < NSL; ++q) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      // Branch-free (selects and a predicated store): accumulators read on
      // a divergent path make ptxas serialise the next product's wgmma.
      const int col = c0 + q * SLICE + 8 * g + 2 * (cx.lane & 3);
      const bool live = col < c1;
      const float2 ws = sigma ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                    p.w_sigma + (live ? col : 0)))
                              : make_float2(0.f, 0.f);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = row + 8 * rr;
        float v0 = acc[q][4 * g + 2 * rr];
        float v1 = acc[q][4 * g + 2 * rr + 1];
        v0 = sigma ? v0 + gs[rr] * ws.x : v0;
        v1 = sigma ? v1 + gs[rr] * ws.y : v1;
        const uint32_t b = masked ? bits[q] >> (4 * g + 2 * rr) : 3u;
        v0 = (b & 1u) ? v0 : 0.f;
        v1 = (b & 2u) ? v1 : 0.f;
        st_shared_if(cx.grad + swz(cx.tm, r, col), bf16_pair(v0, v1), live);
      }
    }
  }
}

// Columns [0, width) of the group's rows of G into the gradient rows at
// column col0: whole 64-column blocks by TMA store (the leader), the rest by
// 16-byte stores. The group's writes to G are fenced and synced.
__device__ void store_tile(const Params& p, const Maps& maps, const Ctx& cx,
                           const uint8_t* tile, int width, int col0, int m0) {
  const int nfull = width / 64;
  if (cx.leader) {
    for (int b = 0; b < nfull; ++b)
      tma_store(&maps.grad, smem_u32(tile + b * cx.tm * 128 + cx.r0 * 128),
                col0 + 64 * b, m0 + cx.r0);
    bulk_commit();
  }
  const int tail = (width - 64 * nfull) / 8;
  for (int idx = cx.gtid; idx < STORE_ROWS * tail; idx += cx.gthreads) {
    const int r = cx.r0 + idx / tail;
    const int c = 64 * nfull + 8 * (idx % tail);
    const int m = m0 + r;
    if (m < p.M)
      *reinterpret_cast<uint4*>(p.grad + (size_t)m * p.grad_stride + col0 + c) =
          *reinterpret_cast<const uint4*>(tile + swz(cx.tm, r, c));
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
train_bwd_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 B: tiles start on that boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  uint64_t* mask_full = empty + p.stages;
  uint64_t* mask_empty = mask_full + 1;
  uint64_t* g_full = mask_empty + 1;
  const uint32_t ring = smem_u32(smem + p.ring_off);
  const int m0 = blockIdx.x * p.tm;
  // Read from lane 0, so the compiler knows the warp (and warpgroup) index
  // is uniform: wgmma under a branch it cannot prove uniform is serialised.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    mbar_init(mask_full, 1);
    mbar_init(mask_empty, CONSUMER_WARPS);
    mbar_init(g_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // Producer warpgroup: it gives its registers to the consumers; one
    // thread keeps the ring full, product after product, another loads
    // h_{L-1} into G for the heads (with the branch) and then each mask
    // tile once every consumer warp has released the last.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int e = 0;
      for (int pi = 0; pi < p.nprod; ++pi) {
        const Prod pr = p.prod[pi];
        const int bytes = min(pr.N, BOX_ROWS) * 128;
        const int nhalf = pr.N > BOX_ROWS ? 2 : 1;
        for (int j = 0; j < (pr.K + CHUNK - 1) / CHUNK; ++j) {
          for (int h = 0; h < nhalf; ++h, ++e) {
            const int st = e % p.stages;
            const int use = e / p.stages;
            if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
            mbar_expect_tx(full + st, bytes);
            tma_load(ring + st * p.stage_bytes, &maps.w[pi], j * CHUNK,
                     pr.row0 + h * BOX_ROWS, full + st);
          }
        }
      }
    } else if (warp == CONSUMER_WARPS + 1 && lane == 0) {
      const uint32_t mask = smem_u32(smem + p.mask_off);
      const uint32_t gt = smem_u32(smem + p.grad_off);
      if (p.has_branch) {  // h_{L-1} into G for the sigma head
        const int nb = (p.D + 63) / 64;
        mbar_expect_tx(g_full, nb * p.tm * 128);
        for (int b = 0; b < nb; ++b)
          tma_load_first(gt + b * p.tm * 128, &maps.act, p.h_last + 64 * b, m0, g_full);
      }
      for (int k = 0; k < p.nmask; ++k) {
        if (k > 0) mbar_wait(mask_empty, (k - 1) & 1);
        const int nb = (p.mask_width[k] + 63) / 64;
        mbar_expect_tx(mask_full, nb * p.tm * 128);
        for (int b = 0; b < nb; ++b)
          tma_load_first(mask + b * p.tm * 128, &maps.act, p.mask_col[k] + 64 * b, m0,
                         mask_full);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  Ctx cx;
  cx.full = full;
  cx.empty = empty;
  cx.mask_full = mask_full;
  cx.mask_empty = mask_empty;
  cx.ring = ring;
  cx.gradp = smem + p.grad_off;
  cx.grad = smem_u32(cx.gradp);
  cx.mask = smem + p.mask_off;
  cx.heads = smem + p.heads_off;
  cx.stages = p.stages;
  cx.stage_bytes = p.stage_bytes;
  cx.tm = p.tm;
  cx.wg = warp >> 2;
  cx.warp = warp;
  cx.lane = lane;
  if (p.tm == 128) {
    cx.arow = cx.r0 = 64 * cx.wg;
    cx.gtid = threadIdx.x - 128 * cx.wg;
    cx.gthreads = 128;
    cx.bar_id = 1 + cx.wg;
  } else {
    cx.arow = cx.r0 = 0;
    cx.gtid = threadIdx.x;
    cx.gthreads = 256;
    cx.bar_id = 3;
  }
  cx.leader = cx.gtid == 0;
  const int gwarp = cx.gtid >> 5;
  const int gwarps = cx.gthreads >> 5;

  // 1. Output derivatives, one warp per point of the group's rows, from
  //    the saved rows in shared memory: h_{L-1} (for sigma) in G with the
  //    branch (loaded at the CTA's start), else in the first mask tile; the
  //    rgb head's input (the branch or h_{L-1}) in the first mask tile.
  //    Each lane keeps its head weights in registers; lane i fetches the
  //    cotangent and noise of the warp's i-th row up front, and after the
  //    shuffle tree lanes 0-3 take one derivative each.
  const uint8_t* hsig = p.has_branch ? cx.gradp : cx.mask;
  float2 wsig[MAX_SLICES * 2], wr[MAX_SLICES * 2][3];
#pragma unroll
  for (int k = 0; k < MAX_SLICES * 2; ++k) {
    const int c = 2 * lane + 64 * k;
    wsig[k] = c < p.D ? __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(p.w_sigma + c))
                      : make_float2(0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < MAX_SLICES * 2; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const int c = 2 * lane + 64 * k;
      wr[k][j] = c < p.rgb_in ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                    p.w_rgb + j * p.rgb_in + c))
                              : make_float2(0.f, 0.f);
    }
  // Lane j < 4 adds this bias to its pre-activation: sigma's (with the
  // noise) on lane 0, rgb channel j - 1's on lanes 1-3.
  const float bias = lane == 0 ? p.b_sigma[0] : (lane < 4 ? p.b_rgb[lane - 1] : 0.f);
  const int rn = cx.r0 + gwarp + lane * gwarps;
  const bool rn_live = rn < cx.r0 + STORE_ROWS && m0 + rn < p.M;
  const float4 gn = rn_live ? reinterpret_cast<const float4*>(p.g)[m0 + rn]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  const float nzn = (rn_live && p.noise != nullptr) ? p.noise[m0 + rn] : 0.f;
  if (p.has_branch) mbar_wait(g_full, 0);
  mbar_wait(mask_full, 0);
  for (int r = cx.r0 + gwarp, it = 0; r < cx.r0 + STORE_ROWS; r += gwarps, ++it) {
    const int m = m0 + r;
    float s = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_SLICES * 2; ++k) {
      const int c = 2 * lane + 64 * k;
      if (c < p.D) {
        const float2 hv = pair_at(hsig, p.tm, r, c);
        s += hv.x * wsig[k].x + hv.y * wsig[k].y;
      }
    }
#pragma unroll
    for (int k = 0; k < MAX_SLICES * 2; ++k) {
      const int c = 2 * lane + 64 * k;
      if (c < p.rgb_in) {
        const float2 hv = pair_at(cx.mask, p.tm, r, c);
        a0 += hv.x * wr[k][0].x + hv.y * wr[k][0].y;
        a1 += hv.x * wr[k][1].x + hv.y * wr[k][1].y;
        a2 += hv.x * wr[k][2].x + hv.y * wr[k][2].y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      a0 += __shfl_xor_sync(0xffffffffu, a0, o);
      a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    // Lane 0: g_sigma; lanes 1-3: g_rgb (the cotangent rounded to bf16,
    // the derivative in f32, the product rounded to bf16).
    const float gx = __shfl_sync(0xffffffffu, gn.x, it);
    const float gy = __shfl_sync(0xffffffffu, gn.y, it);
    const float gz = __shfl_sync(0xffffffffu, gn.z, it);
    const float gw = __shfl_sync(0xffffffffu, gn.w, it);
    const float gl = lane == 0 ? gw : (lane == 1 ? gx : (lane == 2 ? gy : gz));
    const float nz = __shfl_sync(0xffffffffu, nzn, it);
    float x = lane == 0 ? s : (lane == 1 ? a0 : (lane == 2 ? a1 : a2));
    x += bias;
    const float gb = __bfloat162float(__float2bfloat16_rn(gl));
    float gv;
    if (lane == 0) {
      if (p.noise != nullptr) x += nz;
      gv = gb * (p.shifted_softplus ? 1.f / (1.f + expf(-(x - 1.f))) : (x > 0.f ? 1.f : 0.f));
    } else {
      const float sj = 1.f / (1.f + expf(-x));
      gv = gb * sj * (1.f - sj);
    }
    gv = m < p.M ? __bfloat162float(__float2bfloat16_rn(gv)) : 0.f;
    const float gs = __shfl_sync(0xffffffffu, gv, 0);
    const float g0 = __shfl_sync(0xffffffffu, gv, 1);
    const float g1 = __shfl_sync(0xffffffffu, gv, 2);
    const float g2 = __shfl_sync(0xffffffffu, gv, 3);
    if (lane == 0) {
      if (m < p.M)
        *reinterpret_cast<uint4*>(p.grad + (size_t)m * p.grad_stride + p.grad_stride - 8) =
            make_uint4(bf16_pair(gs, g0), bf16_pair(g1, g2), 0u, 0u);
      *reinterpret_cast<uint2*>(cx.heads + 8 * r) =
          make_uint2(bf16_pair(gs, g0), bf16_pair(g1, g2));
    }
  }
  group_sync(cx);

  // G is zero past the first segment (once the heads have read h_{L-1}
  // from it): the products' A reads whole 64-column blocks.
  const int zch = ((p.D + 63) / 64 * 64 - p.first_width) / 8;
  for (int idx = cx.gtid; idx < STORE_ROWS * zch; idx += cx.gthreads) {
    const int r = cx.r0 + idx / zch;
    *reinterpret_cast<uint4*>(cx.gradp + swz(p.tm, r, p.first_width + 8 * (idx % zch))) =
        make_uint4(0u, 0u, 0u, 0u);
  }

  // 2. The first segment from the head derivatives, masked by the first
  //    mask tile: d_a = (g_rgb @ w_rgb) * (branch > 0), zero past D / 2;
  //    without the branch d_pre_{L-1} = (g_sigma w_sigma + g_rgb @ w_rgb)
  //    * (h_{L-1} > 0). Eight columns of a row a thread.
  {
    const int nch = p.first_width / 8;
    for (int idx = cx.gtid; idx < STORE_ROWS * nch; idx += cx.gthreads) {
      const int r = cx.r0 + idx / nch;
      const int c = 8 * (idx % nch);
      const uint2 hd = *reinterpret_cast<const uint2*>(cx.heads + 8 * r);
      const float2 h01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hd.x));
      const float2 h23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&hd.y));
      float mk[8], v[8];
      unpack8(*reinterpret_cast<const uint4*>(cx.mask + swz(p.tm, r, c)), mk);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = 0.f;
      if (c < p.rgb_in) {
        float w0[8], w1[8], w2[8];
        unpack8(ldg16(p.w_rgb + c), w0);
        unpack8(ldg16(p.w_rgb + p.rgb_in + c), w1);
        unpack8(ldg16(p.w_rgb + 2 * p.rgb_in + c), w2);
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = h01.y * w0[i] + h23.x * w1[i] + h23.y * w2[i];
        if (!p.has_branch) {
          float ws[8];
          unpack8(ldg16(p.w_sigma + c), ws);
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = h01.x * ws[i] + v[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = mk[i] > 0.f ? v[i] : 0.f;
      *reinterpret_cast<uint4*>(cx.gradp + swz(p.tm, r, c)) =
          make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                     bf16_pair(v[6], v[7]));
    }
  }
  __syncwarp();
  mbar_arrive_if(mask_empty, lane == 0);
  fence_async_smem();
  group_sync(cx);
  store_tile(p, maps, cx, cx.gradp, p.first_width, p.first_col, m0);

  // 3. The products, in the plan's order.
  float acc[MAX_SLICES][32];
  int e = 0;
  int hk = 1;
  for (int pi = 0; pi < p.nprod; ++pi) {
    const Prod pr = p.prod[pi];
    // This warpgroup's output columns [c0, c1).
    int c0 = 0, c1 = pr.N;
    if (p.tm != 128) {
      const int split = pr.N > BOX_ROWS ? BOX_ROWS : min(pr.N, (pr.N / 2 + 63) / 64 * 64);
      c0 = cx.wg ? split : 0;
      c1 = cx.wg ? pr.N : split;
    }
    const int nsl = c1 > c0 ? (c1 - c0 + SLICE - 1) / SLICE : 0;
    switch (nsl) {
      case 0: run_product<0>(acc, pr, p, cx, e, hk, c0, c1, m0); break;
      case 1: run_product<1>(acc, pr, p, cx, e, hk, c0, c1, m0); break;
      case 2: run_product<2>(acc, pr, p, cx, e, hk, c0, c1, m0); break;
      case 3: run_product<3>(acc, pr, p, cx, e, hk, c0, c1, m0); break;
      default: run_product<4>(acc, pr, p, cx, e, hk, c0, c1, m0); break;
    }
    if (pr.kind != KIND_APP) {
      fence_async_smem();
      group_sync(cx);
      store_tile(p, maps, cx, cx.gradp, pr.N, pr.col, m0);
    }
  }
  if (cx.leader) bulk_wait_all();
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

// rows x cols bf16 row-major at ptr, boxes of box_rows x 64 columns,
// 128-byte swizzle, out-of-range elements read as zero.
CUresult make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                  CUtensorMapL2promotion promo) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {CHUNK, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        promo, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

constexpr int ERR_NO_ENCODE = -1000;  // below: -CUresult of a failed encode

}  // namespace

extern "C" {

// ptrs: act, grad, g, noise (or 0), d_app (or 0), w_sigma, b_sigma, w_rgb,
//   b_rgb, then the transposed matmul weights (fused_train.py::
//   transposed_weights, in packed order).
// dims: M, D, has_branch, shifted_softplus, app_dim, act_stride,
//   grad_stride, h_last, rgb_col, rgb_in, first_col, first_width.
// plan: tm, stages, stage_bytes, grad_off, mask_off, ring_off, bar_off,
//   heads_off, smem_bytes, nprod, nmask, nmat.
// prods: (mat, row0, N, K, kind, col) per product; masks: (column, width)
//   per mask load; shapes: (rows, columns) per transposed matrix.
// Returns 0, a cudaError_t, or a negative code (train_bwd_error_string).
int train_bwd_launch(const long long* ptrs, const int* dims, const int* plan,
                     const int* prods, const int* masks, const int* shapes,
                     void* stream) {
  Params p;
  p.act = reinterpret_cast<const bf16*>(ptrs[0]);
  p.grad = reinterpret_cast<bf16*>(ptrs[1]);
  p.g = reinterpret_cast<const float*>(ptrs[2]);
  p.noise = reinterpret_cast<const float*>(ptrs[3]);
  p.d_app = reinterpret_cast<float*>(ptrs[4]);
  p.w_sigma = reinterpret_cast<const bf16*>(ptrs[5]);
  p.b_sigma = reinterpret_cast<const float*>(ptrs[6]);
  p.w_rgb = reinterpret_cast<const bf16*>(ptrs[7]);
  p.b_rgb = reinterpret_cast<const float*>(ptrs[8]);
  p.M = dims[0];
  p.D = dims[1];
  p.has_branch = dims[2];
  p.shifted_softplus = dims[3];
  p.app_dim = dims[4];
  p.act_stride = dims[5];
  p.grad_stride = dims[6];
  p.h_last = dims[7];
  p.rgb_col = dims[8];
  p.rgb_in = dims[9];
  p.first_col = dims[10];
  p.first_width = dims[11];
  p.tm = plan[0];
  p.stages = plan[1];
  p.stage_bytes = plan[2];
  p.grad_off = plan[3];
  p.mask_off = plan[4];
  p.ring_off = plan[5];
  p.bar_off = plan[6];
  p.heads_off = plan[7];
  const int smem = plan[8];
  p.nprod = plan[9];
  p.nmask = plan[10];
  const int nmat = plan[11];
  if (p.nprod > MAX_PRODUCTS || p.nmask > MAX_MASKS || nmat > MAX_MATS ||
      (p.tm != 128 && p.tm != 64) || p.D > 2 * BOX_ROWS || p.D % 16 ||
      p.first_width % 8 || (p.act_stride * 2) % 16 || (p.grad_stride * 2) % 16 ||
      ptrs[0] % 16 || ptrs[1] % 16 || ptrs[5] % 16 || ptrs[7] % 16 || p.rgb_in % 8)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < p.nprod; ++i) {
    p.prod[i] = {prods[6 * i], prods[6 * i + 1], prods[6 * i + 2], prods[6 * i + 3],
                 prods[6 * i + 4], prods[6 * i + 5]};
    if (p.prod[i].mat < 0 || p.prod[i].mat >= nmat ||
        p.prod[i].N > (p.tm == 128 ? BOX_ROWS : 2 * BOX_ROWS) || p.prod[i].K > p.D)
      return (int)cudaErrorInvalidValue;
  }
  for (int i = 0; i < p.nmask; ++i) {
    p.mask_col[i] = masks[2 * i];
    p.mask_width[i] = masks[2 * i + 1];
    if (p.mask_col[i] % 8 || p.mask_width[i] > p.D) return (int)cudaErrorInvalidValue;
  }
  if (p.M <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODE;
  Maps maps;
  CUresult r = CUDA_SUCCESS;
  for (int i = 0; i < p.nprod && r == CUDA_SUCCESS; ++i) {
    const int mat = p.prod[i].mat;
    r = make_map(&maps.w[i], reinterpret_cast<const void*>(ptrs[9 + mat]),
                 shapes[2 * mat], shapes[2 * mat + 1],
                 p.prod[i].N < BOX_ROWS ? p.prod[i].N : BOX_ROWS,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
  }
  if (r == CUDA_SUCCESS)
    r = make_map(&maps.act, p.act, p.M, p.act_stride, p.tm, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (r == CUDA_SUCCESS)
    r = make_map(&maps.grad, p.grad, p.M, p.grad_stride, STORE_ROWS,
                 CU_TENSOR_MAP_L2_PROMOTION_NONE);
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaError_t err = cudaFuncSetAttribute(
      train_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  train_bwd_kernel<<<(p.M + p.tm - 1) / p.tm, NTHREADS, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
}

const char* train_bwd_error_string(int code) {
  static char buf[96];
  if (code == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the driver";
  if (code < 0) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)", -code);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
