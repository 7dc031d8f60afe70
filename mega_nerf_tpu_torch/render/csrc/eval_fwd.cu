// Fused NeRF eval MLP for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `mega_nerf_tpu/render/pallas_mlp.py::_mlp_kernel`
// (reached through `fused_nerf_eval`): the f32 frequency encode of xyz and
// dirs (cos as sin(x 2^k + pi/2), precise sinf), the ReLU trunk with the
// skip concat [enc | h], the sigma head with shifted softplus or ReLU, and
// with the branch trunk_final, dir_a over [final | dir enc | app] and the
// rgb head with a sigmoid; bf16 operands, f32 accumulation and bias, each
// activation rounded to bf16. Output (M, 4) f32 [r, g, b, sigma].
//
// What bounds it on an H100: ~1.21 MFLOP per point at the paper width
// against ~140 B of inputs and outputs, so the tensor cores: the fg-fine
// launch of one 16,384-ray chunk (8,388,608 points) is 10.3 ms of dense
// bf16 at 989 TFLOP/s, its boundary bytes 0.35 ms at 3.35 TB/s.
//
// Design: the training forward's layer chain (train_fwd.cu, whose device
// helpers this file copies verbatim; each .cu stands alone) without the
// sigma noise and without the saved rows, walked persistently.
// - fused_train.py::train_fwd_plan gives the tile and the shared memory
//   layout, as for the training forward: TM = 128 points when D <= 256 (each
//   of two consumer warpgroups owns 64 points and every output column), else
//   64 (both warpgroups own the same 64 points and split the output
//   columns). A producer warpgroup (one thread issues the loads) keeps 40
//   registers and gives the rest to the consumers with setmaxnreg (232).
// - The activations stay in shared memory as bf16 tiles in the layout the
//   next wgmma reads: K-major, 128-byte swizzle, blocks of 64 columns (TM
//   rows x 128 B each; 16 B chunk c of row r sits at chunk c ^ (r % 8)).
//   The enc tile stays for the skip layer, the dir and app tiles for dir_a.
//   A layer's epilogue (bias, ReLU, bf16) writes its output in place over
//   its input, after the warpgroups that read it have waited for their
//   products (a named barrier over the threads that share the rows).
// - wgmma m64nNk16, A = the activation tile, B = the weights, both K-major
//   from shared memory; N is a warpgroup's output columns in slices of 64
//   (64, 128, 192 or 256), chosen at run time through a switch over a
//   template.
// - The weights come through a ring of TMA boxes (64 k-columns x up to 256
//   rows of the packed (N, Ktot) matrix, 128-byte swizzle, L2 evict_last)
//   on full/empty mbarriers. Every box runs four k-steps: the resident tiles
//   are zero past each segment's width.
// - Persistent: the launch has min(tiles, resident CTAs) CTAs and CTA b
//   walks tiles b, b + gridDim.x, ... (the trip count comes from blockIdx,
//   gridDim and M only, so ptxas sees it uniform). The producer's box
//   counter and every mbarrier phase run on across tiles, so the next
//   tile's first weight boxes load during this tile's heads and output
//   stores. Across a tile boundary the group barriers of one tile already
//   order the next: the encode of tile t + 1 follows the group barrier after
//   tile t's last epilogue (every product that read enc, dir and app is
//   done), and its first epilogue follows the group barrier after its
//   encode (every head of tile t has read the act tile). Rows past M encode
//   as zeros and write nothing, in whichever CTA the ragged tile falls.
// - Nothing that reads the accumulators or sits between products branches
//   on a value ptxas cannot prove warp-uniform (the warp index comes from a
//   shuffle, the epilogue's column mask and the ring's releases are
//   predicated instructions): a divergent path there makes ptxas serialise
//   every wgmma (warnings C7520/C7518).
// - The sigma and rgb heads are warp-per-point dot products over the
//   resident tile, the same code as the training forward's, so the output
//   equals train_fwd.cu's without noise bit for bit.
// Left for later work: clusters multicasting the weight boxes, two tiles
// per CTA in ping-pong, the heads as one thread per point.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int MAX_MATS = 16;       // trunk layers + trunk_final + dir_a
constexpr int CONSUMER_WARPS = 8;  // two warpgroups
constexpr int NTHREADS = CONSUMER_WARPS * 32 + 128;  // + the producer warpgroup
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: what the producer keeps
constexpr int CONSUMER_REGS = 232;  // and what each consumer thread gets
constexpr int CHUNK = 64;          // k columns of a weight box (one 128 B row)
constexpr int SLICE = 64;          // output columns of a slice
constexpr int MAX_SLICES = 4;
constexpr int BOX_ROWS = 256;      // weight rows of a box at most
constexpr int GROUP_ROWS = 64;     // points a group of threads shares

typedef __nv_bfloat16 bf16;

struct Params {
  const float* xyz;    // (M, xyz_dim)
  const float* dirs;   // (M, 3), or null
  const bf16* app;     // (M, app_dim), or null
  float* out;          // (M, 4)
  const bf16* w_sigma;
  const float* b_sigma;
  const bf16* w_rgb;   // (3, rgb_in)
  const float* b_rgb;
  const float* bias[MAX_MATS];
  int M, xyz_dim, nf_xyz, nf_dir, layers, D, app_dim, skip_mask, has_branch;
  int shifted_softplus, EP, DP, AP;
  // The plan (fused_train.py::train_fwd_plan): byte offsets from the
  // 1024-aligned base of shared memory.
  int tm, stages, stage_bytes, enc_off, dir_off, app_off, act_off, ring_off,
      bar_off, sig_off;
};

struct Maps {
  CUtensorMap w[MAX_MATS];  // packed (N, Ktot) weights, 64 x min(N, 256) boxes
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

// One matmul layer: input segments (resident tiles) against packed matrix
// `mat` (N, Ktot); the segments sit at columns kw of the matrix.
struct Seg {
  uint32_t a;  // shared address of the segment's tile (block 0, row 0)
  int K;       // columns, a multiple of 16
  int kw;      // first column in the packed matrix
};

struct Layer {
  Seg seg[3];
  int nseg, N, nhalf, relu;
};

// li < layers: trunk layer li; li == layers: trunk_final; li == layers + 1:
// dir_a (the matrices in fused_mlp.py::mat_layout order).
__device__ Layer make_layer(const Params& p, int li, uint32_t enc, uint32_t dir,
                            uint32_t app, uint32_t act) {
  Layer ly;
  ly.nseg = 0;
  ly.N = p.D;
  ly.relu = 1;
  if (li < p.layers) {
    const bool with_enc = li == 0 || ((p.skip_mask >> li) & 1);
    if (with_enc) ly.seg[ly.nseg++] = {enc, p.EP, 0};
    if (li > 0) ly.seg[ly.nseg++] = {act, p.D, with_enc ? p.EP : 0};
  } else if (li == p.layers) {
    ly.seg[ly.nseg++] = {act, p.D, 0};
    ly.relu = 0;
  } else {
    ly.N = p.D / 2;
    ly.seg[ly.nseg++] = {act, p.D, 0};
    if (p.DP) ly.seg[ly.nseg++] = {dir, p.DP, p.D};
    if (p.AP) ly.seg[ly.nseg++] = {app, p.AP, p.D + p.DP};
  }
  ly.nhalf = ly.N > BOX_ROWS ? 2 : 1;
  return ly;
}

// What one consumer warpgroup sees of the tile.
struct Ctx {
  uint64_t* full;
  uint64_t* empty;
  uint32_t ring;
  uint8_t* act;
  int stages, stage_bytes, tm, wg, arow, warp, lane;
  // The rows this warpgroup shares with its group (its own 64 at TM 128,
  // all 64 with the other warpgroup at TM 64) and the group's barrier.
  int r0, gtid, gthreads, bar_id;
};

__device__ __forceinline__ void group_sync(const Ctx& cx) {
  named_bar(cx.bar_id, cx.gthreads);
}

// Products of one layer for this warpgroup's NSL slices of output columns
// from c0, then (after every reader of the input tile is done) the epilogue
// into the act tile. Every consumer warp waits for and releases every ring
// entry, so the ring's phases stay in step whether or not it uses them.
template <int NSL>
__device__ __forceinline__ void run_layer(float (&acc)[MAX_SLICES][32],
                                          const Layer& ly, const Ctx& cx, int& e,
                                          int c0, int c1, const float* __restrict__ bias) {
  // Products of a ring entry stay in flight while the next entry's issue;
  // its stage is released once wgmma.wait_group 1 says they are done.
  int on = 0;
  int held = -1;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    if (s >= ly.nseg) break;
    const Seg sg = ly.seg[s];
    const int nchunk = (sg.K + CHUNK - 1) / CHUNK;
    for (int j = 0; j < nchunk; ++j) {
      for (int h = 0; h < ly.nhalf; ++h, ++e) {
        const int st = e % cx.stages;
        mbar_wait(cx.full + st, (e / cx.stages) & 1);
        if (NSL == 0 || (ly.nhalf == 2 && h != cx.wg)) {
          mbar_arrive_if(cx.empty + st, cx.lane == 0);
          continue;
        }
        // Every chunk runs 4 k-steps: the tile's columns past a segment
        // are zero, so the box columns they meet add nothing.
        const uint64_t da = kmajor_desc(sg.a + j * cx.tm * 128 + cx.arow * 128);
        const uint64_t db = kmajor_desc(cx.ring + st * cx.stage_bytes +
                                        (ly.nhalf == 1 ? c0 * 128 : 0));
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
  }
  wgmma_wait_all();
  mbar_arrive_if(cx.empty + held, cx.lane == 0 && held >= 0);
#pragma unroll
  for (int q = 0; q < NSL; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[q][i])::"memory");

  // The input tile may be the output tile: wait for the group's readers.
  group_sync(cx);

  // Accumulator i of a thread: row 16 * (warp % 4) + lane / 4 (+ 8 for
  // i % 4 >= 2), column 8 * (i / 4) + 2 * (lane % 4) + i % 2 of the slice.
  const int row = cx.arow + 16 * (cx.warp & 3) + (cx.lane >> 2);
  const uint32_t act = smem_u32(cx.act);
#pragma unroll
  for (int q = 0; q < NSL; ++q) {
#pragma unroll
    for (int g = 0; g < 8; ++g) {
      // Branch-free (a predicated store): accumulators read on a divergent
      // path make ptxas serialise the next layer's wgmma.
      const int col = c0 + q * SLICE + 8 * g + 2 * (cx.lane & 3);
      const bool live = col < c1;
      const float2 b = *reinterpret_cast<const float2*>(bias + (live ? col : 0));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float v0 = acc[q][4 * g + 2 * rr] + b.x;
        float v1 = acc[q][4 * g + 2 * rr + 1] + b.y;
        v0 = ly.relu ? fmaxf(v0, 0.f) : v0;
        v1 = ly.relu ? fmaxf(v1, 0.f) : v1;
        const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
        st_shared_if(act + swz(cx.tm, row + 8 * rr, col),
                     *reinterpret_cast<const uint32_t*>(&h), live);
      }
    }
  }
}

// A thread of the group owns one of its 64 rows and every (threads per
// row)-th piece of 8 columns; each piece is one 16-byte store.
__device__ __forceinline__ int piece_row(const Ctx& cx) { return cx.r0 + cx.gtid % GROUP_ROWS; }
__device__ __forceinline__ int piece_first(const Ctx& cx) { return 8 * (cx.gtid / GROUP_ROWS); }
__device__ __forceinline__ int piece_step(const Ctx& cx) { return 8 * (cx.gthreads / GROUP_ROWS); }

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Frequency encode of d <= 4 coordinates with nf frequencies into columns
// [0, width) of the group's rows of a tile: column c < d (1 + 2 nf) holds
// x[c % d] for block j = c / d = 0, else sin(x * 2^k + phase) with k = (j -
// 1) / 2 and phase pi/2 on cos blocks; columns past the live width are zero.
// The row's coordinates are loaded once: with one dependent load per
// element this loop waited on memory most of its time.
__device__ void encode_rows(const Ctx& cx, const float* __restrict__ src, int d,
                            int nf, int width, int m0, int M, uint8_t* tile) {
  const int live = d * (1 + 2 * nf);
  const int r = piece_row(cx);
  const int m = m0 + r;
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = (m < M && i < d) ? src[(size_t)m * d + i] : 0.f;
  for (int c0 = piece_first(cx); c0 < width; c0 += piece_step(cx)) {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int c = c0 + e;
      const int j = c / d;
      const int i = c - j * d;
      const float xi = i == 0 ? x[0] : (i == 1 ? x[1] : (i == 2 ? x[2] : x[3]));
      v[e] = 0.f;
      if (m < M && c < live) {
        if (j == 0) {
          v[e] = xi;
        } else {
          const int k = (j - 1) >> 1;
          float arg = xi * __int_as_float((k + 127) << 23);  // exact 2^k
          if ((j - 1) & 1) arg = arg + 1.57079632679489661923f;
          v[e] = sinf(arg);
        }
      }
    }
    *reinterpret_cast<uint4*>(tile + swz(cx.tm, r, c0)) =
        make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]), bf16_pair(v[4], v[5]),
                   bf16_pair(v[6], v[7]));
  }
}

__device__ __forceinline__ float2 tile_pair(const Ctx& cx, int r, int c) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(cx.act + swz(cx.tm, r, c)));
}

__global__ void __launch_bounds__(NTHREADS, 1)
eval_fwd_kernel(const __grid_constant__ Maps maps, const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 B: tiles start on that boundary.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  float* sig = reinterpret_cast<float*>(smem + p.sig_off);
  const uint32_t enc = smem_u32(smem + p.enc_off);
  const uint32_t dirt = smem_u32(smem + p.dir_off);
  const uint32_t appt = smem_u32(smem + p.app_off);
  const uint32_t act = smem_u32(smem + p.act_off);
  const uint32_t ring = smem_u32(smem + p.ring_off);
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  const int ntiles = (p.M + p.tm - 1) / p.tm;
  // Read from lane 0, so the compiler knows the warp (and warpgroup) index
  // is uniform: wgmma under a branch it cannot prove uniform is serialised.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // Producer warpgroup: it gives its registers to the consumers, and one
    // thread keeps the ring full, layer after layer and tile after tile.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int e = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        for (int li = 0; li < nmat; ++li) {
          const Layer ly = make_layer(p, li, 0, 0, 0, 0);
          const int bytes = min(ly.N, BOX_ROWS) * 128;
          for (int s = 0; s < ly.nseg; ++s) {
            const int nchunk = (ly.seg[s].K + CHUNK - 1) / CHUNK;
            for (int j = 0; j < nchunk; ++j) {
              for (int h = 0; h < ly.nhalf; ++h, ++e) {
                const int st = e % p.stages;
                const int use = e / p.stages;
                if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
                mbar_expect_tx(full + st, bytes);
                tma_load(ring + st * p.stage_bytes, &maps.w[li],
                         ly.seg[s].kw + j * CHUNK, h * BOX_ROWS, full + st);
              }
            }
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  Ctx cx;
  cx.full = full;
  cx.empty = empty;
  cx.ring = ring;
  cx.act = smem + p.act_off;
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
  const int gwarp = cx.gtid >> 5;
  const int gwarps = cx.gthreads >> 5;
  const int rgb_in = p.has_branch ? p.D / 2 : p.D;

  // Whole 64-column blocks: the columns past each width are zero (every
  // ring entry runs 4 k-steps over them). No epilogue writes the act
  // columns past D, so they are zeroed once for the whole walk.
  const auto padded = [](int w) { return (w + 63) / 64 * 64; };
  const int dpad = padded(p.D) - p.D;
  for (int idx = cx.gtid; idx < GROUP_ROWS * dpad; idx += cx.gthreads) {
    const int r = cx.r0 + idx / dpad;
    *reinterpret_cast<bf16*>(cx.act + swz(p.tm, r, p.D + idx % dpad)) =
        __float2bfloat16_rn(0.f);
  }

  float acc[MAX_SLICES][32];
  int e = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int m0 = t * p.tm;
    encode_rows(cx, p.xyz, p.xyz_dim, p.nf_xyz, padded(p.EP), m0, p.M,
                smem + p.enc_off);
    if (p.DP)
      encode_rows(cx, p.dirs, 3, p.nf_dir, padded(p.DP), m0, p.M, smem + p.dir_off);
    {
      const int r = piece_row(cx);
      const int m = m0 + r;
      for (int c0 = piece_first(cx); c0 < padded(p.AP); c0 += piece_step(cx)) {
        uint32_t w[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          uint32_t lo = 0, hi = 0;
          if (m < p.M && c0 + 2 * h < p.app_dim)
            lo = __bfloat16_as_ushort(p.app[(size_t)m * p.app_dim + c0 + 2 * h]);
          if (m < p.M && c0 + 2 * h + 1 < p.app_dim)
            hi = __bfloat16_as_ushort(p.app[(size_t)m * p.app_dim + c0 + 2 * h + 1]);
          w[h] = lo | (hi << 16);
        }
        *reinterpret_cast<uint4*>(smem + p.app_off + swz(p.tm, r, c0)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    // The encode is visible to wgmma, and every head of the previous tile
    // has read the act tile before this tile's first epilogue writes it.
    fence_async_smem();
    group_sync(cx);

    for (int li = 0; li < nmat; ++li) {
      const Layer ly = make_layer(p, li, enc, dirt, appt, act);
      // This warpgroup's output columns [c0, c1).
      int c0 = 0, c1 = ly.N;
      if (p.tm != 128) {
        const int split = ly.nhalf == 2 ? BOX_ROWS
                                        : min(ly.N, (ly.N / 2 + 63) / 64 * 64);
        c0 = cx.wg ? split : 0;
        c1 = cx.wg ? ly.N : split;
      }
      const int nsl = c1 > c0 ? (c1 - c0 + SLICE - 1) / SLICE : 0;
      const float* bias = p.bias[li];
      switch (nsl) {
        case 0: run_layer<0>(acc, ly, cx, e, c0, c1, bias); break;
        case 1: run_layer<1>(acc, ly, cx, e, c0, c1, bias); break;
        case 2: run_layer<2>(acc, ly, cx, e, c0, c1, bias); break;
        case 3: run_layer<3>(acc, ly, cx, e, c0, c1, bias); break;
        default: run_layer<4>(acc, ly, cx, e, c0, c1, bias); break;
      }
      fence_async_smem();
      group_sync(cx);

      if (li == p.layers - 1) {
        // Sigma head: one warp per point of the group's rows.
        for (int r = cx.r0 + gwarp; r < cx.r0 + GROUP_ROWS; r += gwarps) {
          float s = 0.f;
          for (int c = 2 * lane; c < p.D; c += 64) {
            const float2 hv = tile_pair(cx, r, c);
            const float2 wv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(p.w_sigma + c));
            s += hv.x * wv.x + hv.y * wv.y;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
          if (lane == 0) {
            s += p.b_sigma[0];
            if (p.shifted_softplus) {
              const float x = s - 1.f;
              s = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
            } else {
              s = fmaxf(s, 0.f);
            }
            sig[r] = s;
          }
        }
      }
    }

    // Rgb head + output: one warp per point (the same warp wrote sig[r]).
    for (int r = cx.r0 + gwarp; r < cx.r0 + GROUP_ROWS; r += gwarps) {
      float a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int c = 2 * lane; c < rgb_in; c += 64) {
        const float2 hv = tile_pair(cx, r, c);
        const float2 w0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + c));
        const float2 w1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + rgb_in + c));
        const float2 w2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + 2 * rgb_in + c));
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
      const int m = m0 + r;
      if (lane == 0 && m < p.M) {
        float4 o;
        o.x = 1.f / (1.f + expf(-(a0 + p.b_rgb[0])));
        o.y = 1.f / (1.f + expf(-(a1 + p.b_rgb[1])));
        o.z = 1.f / (1.f + expf(-(a2 + p.b_rgb[2])));
        o.w = sig[r];
        reinterpret_cast<float4*>(p.out)[m] = o;
      }
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

// ptrs, dims: fused_mlp.py::launch_tables (xyz, dirs, app, out, w_sigma,
//   b_sigma, w_rgb, b_rgb, then (matrix, bias) per matmul layer; M, xyz_dim,
//   nf_xyz, nf_dir, layers, D, app_dim, skip_mask, has_branch,
//   shifted_softplus, EP, DP, AP).
// plan: tm, stages, stage_bytes, enc_off, dir_off, app_off, act_off,
//   ring_off, bar_off, sig_off, smem_bytes (fused_train.py::train_fwd_plan).
// shapes: (N, Ktot) per matmul layer.
// grid: CTAs of the persistent walk (fused_mlp.py::eval_grid).
// Returns 0, a cudaError_t, or a negative code (eval_fwd_error_string).
int eval_fwd_launch(const long long* ptrs, const int* dims, const int* plan,
                    const int* shapes, int grid, void* stream) {
  Params p;
  p.xyz = reinterpret_cast<const float*>(ptrs[0]);
  p.dirs = reinterpret_cast<const float*>(ptrs[1]);
  p.app = reinterpret_cast<const bf16*>(ptrs[2]);
  p.out = reinterpret_cast<float*>(ptrs[3]);
  p.w_sigma = reinterpret_cast<const bf16*>(ptrs[4]);
  p.b_sigma = reinterpret_cast<const float*>(ptrs[5]);
  p.w_rgb = reinterpret_cast<const bf16*>(ptrs[6]);
  p.b_rgb = reinterpret_cast<const float*>(ptrs[7]);
  p.M = dims[0];
  p.xyz_dim = dims[1];
  p.nf_xyz = dims[2];
  p.nf_dir = dims[3];
  p.layers = dims[4];
  p.D = dims[5];
  p.app_dim = dims[6];
  p.skip_mask = dims[7];
  p.has_branch = dims[8];
  p.shifted_softplus = dims[9];
  p.EP = dims[10];
  p.DP = dims[11];
  p.AP = dims[12];
  p.tm = plan[0];
  p.stages = plan[1];
  p.stage_bytes = plan[2];
  p.enc_off = plan[3];
  p.dir_off = plan[4];
  p.app_off = plan[5];
  p.act_off = plan[6];
  p.ring_off = plan[7];
  p.bar_off = plan[8];
  p.sig_off = plan[9];
  const int smem = plan[10];
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  if (nmat > MAX_MATS || (p.tm != 128 && p.tm != 64) || p.D > 2 * BOX_ROWS ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  if (p.M <= 0) return 0;
  if (!encode_tiled()) return ERR_NO_ENCODE;
  Maps maps;
  CUresult r = CUDA_SUCCESS;
  for (int i = 0; i < MAX_MATS; ++i) {
    p.bias[i] = i < nmat ? reinterpret_cast<const float*>(ptrs[9 + 2 * i]) : nullptr;
    if (i < nmat && r == CUDA_SUCCESS) {
      const int n = shapes[2 * i], ktot = shapes[2 * i + 1];
      r = make_map(&maps.w[i], reinterpret_cast<const void*>(ptrs[8 + 2 * i]), n, ktot,
                   n < BOX_ROWS ? n : BOX_ROWS, CU_TENSOR_MAP_L2_PROMOTION_L2_256B);
    }
  }
  if (r != CUDA_SUCCESS) return -(int)r;
  cudaError_t err = cudaFuncSetAttribute(
      eval_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  eval_fwd_kernel<<<grid, NTHREADS, smem, reinterpret_cast<cudaStream_t>(stream)>>>(
      maps, p);
  return (int)cudaGetLastError();
}

// CTAs of eval_fwd_kernel with smem bytes of shared memory that the
// current device holds at once: per SM (the occupancy calculator) x SMs.
int eval_fwd_resident_ctas(int smem, int* ctas) {
  cudaError_t err = cudaFuncSetAttribute(
      eval_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, device = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, eval_fwd_kernel,
                                                      NTHREADS, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *ctas = per_sm * sms;
  return (int)err;
}

const char* eval_fwd_error_string(int code) {
  static char buf[96];
  if (code == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the driver";
  if (code < 0) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)", -code);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
