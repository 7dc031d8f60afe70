// The f32 forward of the fused NeRF MLP on Hopper's tensor cores: the one
// device path of eval_f32.cu (the eval kernel) and train_f32.cu's training
// forward, so that the two agree bit for bit without noise. The training
// forward adds only the saved-row stores and the sigma noise. train_f32.cu's
// backward-data kernel runs its products through the same `layer` /
// `products` (a product over one gradient tile, `OneSrc`, B the transposed
// matrices; its own epilogue: masks from the saved rows).
//
// f32 accuracy from TF32 tensor cores: every layer product is 3xTF32 on
// wgmma m64n64k8. Each operand x splits into hi, the raw f32 (the tensor
// cores read its top 19 bits and truncate the rest), and lo = x - trunc(x)
// (`tf32_rest`, exact in f32); lo*hi + hi*lo + hi*hi summed in f32 stays
// within ~2^-21 of each f32 product (lo*lo, ~2^-20 of a product before its
// own truncation, is left out). This is the split of the f32 wide GEMM
// (wide_f32.cu). No one-pass TF32 product and no bf16 product.
//
// A CTA owns a tile of tm points (fused_f32.py::f32_fwd_plan) and 384
// threads:
// - Activations stay in shared memory as f32, one tile per segment, point
//   p's column c at p * S + c with S = width + 4 (S = 4 mod 8: the A
//   fragment reads below hit 32 banks). To width 256 (tm = 64) a layer's
//   output goes in place: both consumer warpgroups hold all its columns in
//   registers, and write after a barrier. Past 256 (tm = 32, the wgmma rows
//   32-63 zero) the two activation tiles take turns (ping-pong).
// - W is read from the packed (N, Ktot) matrices, which are K-major as TF32
//   wgmma needs B: a TMA box of 128 output rows x 32 k columns (128-byte
//   swizzle) a stage, beside the same box of W's TF32 rests, into a ring of
//   `stages` (plan). The rests (same shapes) are made once per set of
//   packed weights by the wrapper (fused_f32.py::w_rests) and stay in
//   device memory: both are read from L2 once per tile, which the card
//   reads at ~22 TB/s when every SM reads the same weights
//   (scripts/f32_fwd_probe.py). One producer thread issues the boxes,
//   layer after layer.
// - Two consumer warpgroups take every stage: warpgroup w the box's rows
//   64 w .. 64 w + 63 (output columns) for the tile's 64 point rows. Per
//   stage each thread reads its A fragments (wgmma's register-A form,
//   CUTLASS's ALayout_64x8) from the activation tile and splits them in
//   registers; per 8-column k-step three products, A_lo W_hi, A_hi W_lo,
//   A_hi W_hi, into a chain. A chain runs CHAIN_STAGES stages from zero
//   (the tensor cores' f32 adds truncate, so a chain's error grows with
//   its length) and is then added into f32 totals by FADD. One fixed
//   order: every launch gives the same bits. Stages alternate between two
//   fragment register sets, a stage's fragments loading under the previous
//   stage's products; a set is held live (an empty asm that reads it) until
//   the wait that covers its products, since wgmma reads its A registers
//   after issue (without that hold ptxas reused them, and the rows of
//   warps 1-3 came out wrong).
// - Segments: a product runs over up to three K-segments of resident tiles
//   ([enc | h] at a skip layer, [final | dir enc | app] at dir_a), each
//   from its own columns of W. k-steps past a segment's width read zero
//   (W's columns there belong to the next segment, or lie past Ktot and
//   come in as zeros).
// - The encode (`encode_coord`, the arithmetic of f32_chain.cuh's
//   `encode_value`), the sigma head and the rgb head keep the FFMA code and
//   order of operations of the f32 chain they replace: a thread per point
//   for the heads, sums over the columns in order.
// - Each layer's totals start from its bias, loaded at the products' start;
//   the epilogue only applies ReLU and stores (the stamped copy of
//   scripts/f32_fwd_probe.py found the epilogues, the encode and the heads
//   taking about a third of a CTA with the loads where they stood).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include "f32_chain.cuh"

namespace f32fwd {

constexpr int NT = 384;          // 2 consumer warpgroups + the producer warpgroup
constexpr int CONSUMERS = 256;   // threads of the consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int BN = 128;          // W rows (output columns) of a stage: 64 a warpgroup
constexpr int BK = 32;           // k columns of a stage: one 128-byte swizzle row of f32
constexpr int BOX_BYTES = BN * BK * 4;       // 16 KB
constexpr int STAGE_BYTES = 2 * BOX_BYTES;   // the W box, then its rests
constexpr int CHAIN_STAGES = 4;  // k-stages of a chain before it joins the totals (even)
constexpr int MAX_MATS = 16;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int CONSUMER_BAR = 1;  // named barrier of the 256 consumer threads

struct FwdParams {
  const float* xyz;    // (M, xyz_dim)
  const float* dirs;   // (M, 3), or null
  const float* app;    // (M, app_dim), or null
  float* out;          // (M, 4)
  const float* w_sigma;
  const float* b_sigma;
  const float* w_rgb;  // (3, rgb_in)
  const float* b_rgb;
  const float* bias[MAX_MATS];
  int M, xyz_dim, nf_xyz, nf_dir, layers, D, app_dim, skip_mask, has_branch;
  int shifted_softplus, EP, DP, AP;
  // The plan (fused_f32.py::f32_fwd_plan): the tile, the ring's stages, and
  // byte offsets from the 1024-aligned base (x_off == y_off: in place).
  int tm, stages, ring_off, x_off, y_off, enc_off, dir_off, app_off, sig_off, bar_off;
  // The training forward: sigma noise (M,) or null, the saved rows (M,
  // act_width) or null (eval), and their columns (fused_train.py::act_layout).
  const float* noise;
  float* act;
  int act_width, act_final, act_dir, act_app, act_branch;
};

// Tensor maps of each packed matrix and of its TF32 rests: (N, Ktot) f32,
// boxes of min(N, 128) rows x 32 columns, 128-byte swizzle, zeros past N
// and Ktot. (4 KB: past the old 4 KB parameter limit, which CUDA 12.1
// raised to 32 KB.)
struct FwdMaps {
  CUtensorMap w[MAX_MATS];
  CUtensorMap wlo[MAX_MATS];
};

// ------------------------------------------------------------ primitives

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

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes) : "memory");
}

// Arrive on the barrier where p holds (a predicate, not a branch).
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %1, 0;\n"
      "@q mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"((int)p)
      : "memory");
}

// One box of `map` at (column c, row r) into shared memory at dst, kept in
// L2 (evict_last): every CTA reads every weight box.
__device__ __forceinline__ void tma_load_keep(uint32_t dst, const CUtensorMap* map, int c,
                                              int r, uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_last.b64 pol, 1.0;\n"
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%3, %4}], [%2], pol;\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c), "r"(r)
      : "memory");
}

// The 128-byte lines of [ptr, ptr + bytes) into L2, a line a thread of the
// producer's warps 9-11 (`t` < 96) at a time.
__device__ __forceinline__ void prefetch_l2(const float* ptr, int bytes, int t) {
  const char* base = reinterpret_cast<const char*>(ptr);
  for (int off = 128 * t; off < bytes; off += 128 * 96)
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(base + off));
}

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(CONSUMER_BAR), "n"(CONSUMERS) : "memory");
}

// wgmma descriptor of a K-major operand with the 128-byte swizzle: rows of
// 128 B (32 f32), 8-row groups 1024 B apart (SBO). A k-step of 8 f32 (32 B)
// adds 2 to the descriptor.
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

// d (64 x 64, f32) = A (64 x 8) * B (8 x 64) (+ d if accumulate), TF32: A
// from registers (this thread's fragment a[4]: rows g and g + 8 of its
// warp's 16, columns q and q + 4, where lane = 4 g + q), B K-major in
// shared memory. Accumulator i sits at row g (+ 8 for i % 4 >= 2), column
// 8 (i / 4) + 2 q + i % 2.
__device__ __forceinline__ void wgmma_tf32_n64(float* d, const uint32_t (&a)[4], uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// x - (x with its low 13 bits cleared): what the tensor cores leave of an
// f32 operand read as TF32, exact in f32 (wide_f32.cu's split).
__device__ __forceinline__ float tf32_rest(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// Where p holds, store (v0, v1) at a (predicated instructions, not
// branches: wgmma near a branch ptxas cannot prove uniform is serialised).
__device__ __forceinline__ void st_shared2_if(float* a, float v0, float v1, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %3, 0;\n@q st.shared.v2.f32 [%0], {%1, %2};\n}\n" ::"r"(
          smem_u32(a)),
      "f"(v0), "f"(v1), "r"((int)p)
      : "memory");
}
__device__ __forceinline__ void st_global2_if(float* a, float v0, float v1, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %3, 0;\n@q st.global.v2.f32 [%0], {%1, %2};\n}\n" ::"l"(
          a),
      "f"(v0), "f"(v1), "r"((int)p)
      : "memory");
}

// ---------------------------------------------------------------- layers

// Matrix li's output width: D, or D / 2 for dir_a.
__device__ __forceinline__ int out_width(const FwdParams& p, int li) {
  return li == p.layers + 1 ? p.D / 2 : p.D;
}

// The K-segments of matrix li: a trunk layer [enc | h] (enc at the first
// and the skip layers, h past the first), trunk_final [h], dir_a [final |
// dir enc | app] (the latter two where the model has them).
__device__ __forceinline__ int nsegments(const FwdParams& p, int li) {
  if (li < p.layers) return (li == 0 || ((p.skip_mask >> li) & 1)) + (li > 0);
  return li == p.layers ? 1 : 1 + (p.DP > 0) + (p.AP > 0);
}

// Segment s of matrix li: the tile it reads (0 enc, 1 the previous output,
// 2 dir enc, 3 app), its width K and its first column kw of W.
struct Seg {
  int kind, K, kw;
};

__device__ __forceinline__ Seg segment(const FwdParams& p, int li, int s) {
  if (li < p.layers) {
    const bool with_enc = li == 0 || ((p.skip_mask >> li) & 1);
    if (with_enc && s == 0) return {0, p.EP, 0};
    return {1, p.D, with_enc ? p.EP : 0};
  }
  if (s == 0) return {1, p.D, 0};
  if (s == 1 && p.DP) return {2, p.DP, p.D};
  return {3, p.AP, p.D + p.DP};
}

// Rows of matrix li's W boxes: 128, or N where N is smaller (TMA counts a
// box's bytes; the rows past N of a stage are never read into a stored
// column).
__device__ __forceinline__ int box_rows(const FwdParams& p, int li) {
  return min(out_width(p, li), BN);
}

// The activation tile that matrix li writes (and matrix li + 1 reads).
__device__ __forceinline__ float* out_tile(const FwdParams& p, uint8_t* smem, int li) {
  return reinterpret_cast<float*>(smem + ((li & 1) ? p.y_off : p.x_off));
}

struct Ring {
  uint32_t base;  // shared address of stage 0
  uint64_t* full;
  uint64_t* empty;
  int stages, st, phase;
  __device__ __forceinline__ void advance() {
    st = st + 1 == stages ? 0 : st + 1;
    phase ^= st == 0;
  }
};

// The consumer thread's place: warpgroup wg, its first A / accumulator row
// r0 = 16 (warp % 4) + g, column pair 2 q; `rows` holds where the warp's
// rows lie inside the tile (tm = 32: warps 2-3 of each warpgroup hold none).
struct Place {
  int wg, r0, g, q;
  bool rows;
};

// The consumer's activation tiles, by segment kind.
struct Tiles {
  const float* enc;
  const float* h;
  const float* dir;
  const float* app;
  int EP, D, DP, AP;
  __device__ __forceinline__ const float* tile(int kind) const {
    return kind == 0 ? enc : (kind == 1 ? h : (kind == 2 ? dir : app));
  }
  __device__ __forceinline__ int stride(int kind) const {
    return 4 + (kind == 0 ? EP : (kind == 1 ? D : (kind == 2 ? DP : AP)));
  }
};

// One K-segment of a product's A operand: a resident tile (point p's
// column c at p * S + c) and its width K.
struct ASeg {
  const float* tile;
  int S, K;
};

// The A segments of forward matrix li (`segment`, the tiles by kind).
struct FwdSrc {
  const FwdParams& p;
  int li;
  const Tiles& tl;
  __device__ __forceinline__ int count() const { return nsegments(p, li); }
  __device__ __forceinline__ ASeg seg(int s) const {
    const Seg g = segment(p, li, s);
    return {tl.tile(g.kind), tl.stride(g.kind), g.K};
  }
};

// A product over one resident tile (train_f32.cu's backward-data chain).
struct OneSrc {
  ASeg a;
  __device__ __forceinline__ int count() const { return 1; }
  __device__ __forceinline__ ASeg seg(int) const { return a; }
};

// The walk over a product's k-stages: segment s, its box j.
struct Walk {
  int s, j;
  ASeg a;
  template <class Src>
  __device__ __forceinline__ void start(const Src& src, int s_) {
    s = s_;
    j = 0;
    a = src.seg(s);
  }
  template <class Src>
  __device__ __forceinline__ void next(const Src& src) {
    if (++j * BK >= a.K) start(src, s + 1);
  }
};

// This thread's A fragments of the walk's stage, split: per k-step its rows
// r0 and r0 + 8 at columns q and q + 4. Rows past the tile and k-steps past
// the segment read zero (from a valid address: a select, not a branch).
__device__ __forceinline__ void load_frags(uint32_t (&ah)[BK / 8][4], uint32_t (&al)[BK / 8][4],
                                           const Walk& w, const Place& pl) {
  const float* a0 = w.a.tile + pl.r0 * w.a.S + pl.q;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const int col = w.j * BK + 8 * kk;
    const bool live = pl.rows && col < w.a.K;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float raw = *(live ? a0 + (v & 1) * 8 * w.a.S + col + 4 * (v >> 1) : w.a.tile);
      const float x = live ? raw : 0.f;
      ah[kk][v] = __float_as_uint(x);
      al[kk][v] = __float_as_uint(tf32_rest(x));
    }
  }
}

// The stage's 3xTF32 products into the chain (the first from zero where
// `fresh`), one commit group.
__device__ __forceinline__ void issue(float (&ch)[32], const uint32_t (&ah)[BK / 8][4],
                                      const uint32_t (&al)[BK / 8][4], uint32_t stage,
                                      bool fresh) {
  const uint64_t db = kmajor_desc(stage);
  const uint64_t dbl = kmajor_desc(stage + BOX_BYTES);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    wgmma_tf32_n64(ch, al[kk], db + 2 * kk, !fresh || kk > 0);
    wgmma_tf32_n64(ch, ah[kk], dbl + 2 * kk, 1);
    wgmma_tf32_n64(ch, ah[kk], db + 2 * kk, 1);
  }
  wgmma_commit();
}

// Hold a fragment set's registers live to here.
__device__ __forceinline__ void hold(const uint32_t (&ah)[BK / 8][4],
                                     const uint32_t (&al)[BK / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
    asm volatile("" ::"r"(ah[kk][0]), "r"(ah[kk][1]), "r"(ah[kk][2]), "r"(ah[kk][3]),
                 "r"(al[kk][0]), "r"(al[kk][1]), "r"(al[kk][2]), "r"(al[kk][3]));
}

// acc += the product of the segments of `src` with B's rows [128 nb + 64
// wg, + 64) (this warpgroup's 64 output columns of block nb), over the
// stages the producer issues for it, in chains of CHAIN k-stages (even;
// the forward's CHAIN_STAGES). The caller seeds the totals (the forward
// with the bias, loaded just before: under the first chain's products, not
// in the epilogue, where its latency stood alone).
template <int CHAIN, class Src>
__device__ __forceinline__ void products(float (&acc)[32], float (&ch)[32], const Src& src,
                                         Ring& ring, const Place& pl, int lane) {
  const int nseg = src.count();
  int nk = 0;
  for (int s = 0; s < nseg; ++s) nk += (src.seg(s).K + BK - 1) / BK;
  const uint32_t half = pl.wg * (BOX_BYTES / 2);  // this warpgroup's 64 rows of a box
  Walk w;
  w.start(src, 0);
  uint32_t ah0[BK / 8][4], al0[BK / 8][4], ah1[BK / 8][4], al1[BK / 8][4];
  mbar_wait(ring.full + ring.st, ring.phase);
  load_frags(ah0, al0, w, pl);
  int pending = -1;  // the ring slot of a set-1 stage whose products may be in flight
  for (int c = 0; c < nk; c += 2) {
    // Set 0 holds stage c's fragments (loaded under the previous stage's
    // products); stage c starts a chain every CHAIN stages.
    const int st0 = ring.st;
    issue(ch, ah0, al0, ring.base + st0 * STAGE_BYTES + half, c % CHAIN == 0);
    ring.advance();
    w.next(src);
    if (pending >= 0) {
      // Stage c - 1 done: its slot back to the producer, set 1 free.
      wgmma_wait_one();
      hold(ah1, al1);
      mbar_arrive_if(ring.empty + pending, lane == 0);
      pending = -1;
    }
    const bool two = c + 1 < nk;
    const int st1 = ring.st;
    if (two) {
      mbar_wait(ring.full + st1, ring.phase);
      load_frags(ah1, al1, w, pl);
      issue(ch, ah1, al1, ring.base + st1 * STAGE_BYTES + half, false);
      ring.advance();
      w.next(src);
      wgmma_wait_one();
    } else {
      wgmma_wait_all();
    }
    // Stage c done: its slot back to the producer (refilled under stage
    // c + 1's products) and set 0 free for stage c + 2's fragments.
    hold(ah0, al0);
    mbar_arrive_if(ring.empty + st0, lane == 0);
    if (c + 2 < nk) {
      mbar_wait(ring.full + ring.st, ring.phase);
      load_frags(ah0, al0, w, pl);
    }
    if ((c + 2) % CHAIN == 0 || c + 2 >= nk) {
      // The chain ends: every product done, the chain into the totals.
      wgmma_wait_all();
      if (two) hold(ah1, al1);
      mbar_arrive_if(ring.empty + st1, lane == 0 && two);
#pragma unroll
      for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(ch[i])::"memory");
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = acc[i] + ch[i];
    } else {
      pending = st1;  // stage c + 1 runs on under stage c + 2's products
    }
  }
}

// The epilogue of block nb of matrix li from this warpgroup's totals (the
// bias already in them): ReLU unless trunk_final, into the output tile
// (stride S) and, in the training forward, into the saved rows from column
// `col`. Columns past N and rows past tm or M are not stored (predicated
// stores).
__device__ __forceinline__ void epilogue(const float (&acc)[32], const FwdParams& p, int li,
                                         int nb, float* dst, int S, int col, int m0,
                                         const Place& pl) {
  const int N = out_width(p, li);
  const bool relu = li != p.layers;
  const int n0 = BN * nb + 64 * pl.wg + 2 * pl.q;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = relu ? fmaxf(acc[i], 0.f) : acc[i];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + 8 * j;
    const bool live = pl.rows && n < N;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = pl.r0 + 8 * rr;
      st_shared2_if(dst + (live ? r * S + n : 0), v[4 * j + 2 * rr], v[4 * j + 2 * rr + 1],
                    live);
    }
  }
  if (p.act == nullptr) return;  // eval: no saved rows (a branch on a parameter)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int m = m0 + pl.r0 + 8 * rr;
    float* row = p.act + (size_t)min(m, p.M - 1) * p.act_width + col;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j;
      st_global2_if(row + min(n, N - 2), v[4 * j + 2 * rr], v[4 * j + 2 * rr + 1],
                    pl.rows && n < N && m < p.M);
    }
  }
}

// The forward's epilogue of matrix li (for `layer`): totals seeded with the
// bias, then `epilogue` into the tile `dst` and the saved rows from `col`.
struct FwdEpi {
  const FwdParams& p;
  int li, col, m0;
  float* dst;
  const Place& pl;
  __device__ __forceinline__ void start(float (&acc)[32], int nb) const {
    const int N = out_width(p, li);
    const float* __restrict__ bias = p.bias[li];
    const int n0 = BN * nb + 64 * pl.wg + 2 * pl.q;
#pragma unroll
    for (int i = 0; i < 32; ++i)
      acc[i] = __ldg(bias + min(n0 + 8 * (i / 4) + i % 2, N - 1));
  }
  __device__ __forceinline__ void finish(float (&)[32], int) const {}
  __device__ __forceinline__ void store(const float (&acc)[32], int nb) const {
    epilogue(acc, p, li, nb, dst, p.D + 4, col, m0, pl);
  }
};

// A product of N output columns over the tile: its blocks of 128 columns in
// pairs, a pair's totals in registers. The epilogue `e` seeds a block's
// totals (`start`), acts on them before the barrier of an in-place layer
// (`finish`: its loads wait there) and writes them (`store`): in place
// after that barrier (every read of the input done), or to another tile.
// Chains of CHAIN k-stages. Ends with a barrier: the output is in its tile.
template <int CHAIN, class Src, class E>
__device__ __forceinline__ void layer(float (&acc0)[32], float (&acc1)[32], float (&ch)[32],
                                      const Src& src, int N, bool in_place, const E& e,
                                      Ring& ring, const Place& pl, int lane) {
  const int nblocks = (N + BN - 1) / BN;
  for (int nb = 0; nb < nblocks; nb += 2) {
    const bool two = nb + 1 < nblocks;
    e.start(acc0, nb);
    products<CHAIN>(acc0, ch, src, ring, pl, lane);
    if (two) {
      e.start(acc1, nb + 1);
      products<CHAIN>(acc1, ch, src, ring, pl, lane);
    }
    e.finish(acc0, nb);
    if (two) e.finish(acc1, nb + 1);
    if (in_place) consumer_sync();
    e.store(acc0, nb);
    if (two) e.store(acc1, nb + 1);
  }
  consumer_sync();
}

// The encode of nf frequencies into a tile of `width` columns (stride
// width + 4), zero for points past M; with the saved rows, also into them
// from column `col`. Four consumer threads a point: each loads the point's
// coordinates once (a load per element left the loop waiting on memory)
// and takes every 4th column, in `encode_coord`'s arithmetic.
__device__ __forceinline__ void encode_tile(const float* __restrict__ src, int d, int nf,
                                            int width, int m0, int M, int tm, float* tile,
                                            float* rows, int ld, int col) {
  const int live = d * (1 + 2 * nf);
  const int tid = threadIdx.x;
  for (int pt = tid >> 2; pt < tm; pt += CONSUMERS / 4) {
    const int m = m0 + pt;
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = (m < M && i < d) ? __ldg(src + (size_t)m * d + i) : 0.f;
    // Column c = block j of coordinate i; c steps by 4 (no division in
    // the loop, whose iterations the compiler interleaves).
    int j = (tid & 3) / d, i = (tid & 3) - j * d;
#pragma unroll 4
    for (int c = tid & 3; c < width; c += 4) {
      const float xi = i == 0 ? x[0] : (i == 1 ? x[1] : (i == 2 ? x[2] : x[3]));
      const float v = (m < M && c < live) ? f32chain::encode_coord(xi, j) : 0.f;
      tile[pt * (width + 4) + c] = v;
      if (rows != nullptr && m < M) rows[(size_t)m * ld + col + c] = v;
      for (i += 4; i >= d; i -= d) ++j;
    }
  }
}

// The appearance rows into a tile of AP columns (zero past app_dim): four
// consumer threads a point, every 4th column, the loads of a point issued
// together.
__device__ __forceinline__ void app_tile(const FwdParams& p, int m0, float* tile) {
  const int tid = threadIdx.x;
  for (int pt = tid >> 2; pt < p.tm; pt += CONSUMERS / 4) {
    const int m = m0 + pt;
    const float* __restrict__ row = p.app + (size_t)m * p.app_dim;
#pragma unroll 4
    for (int c = tid & 3; c < p.AP; c += 4) {
      const float v = (m < p.M && c < p.app_dim) ? __ldg(row + c) : 0.f;
      tile[pt * (p.AP + 4) + c] = v;
      if (p.act != nullptr && m < p.M) p.act[(size_t)m * p.act_width + p.act_app + c] = v;
    }
  }
}

// The sigma head of the tile's points (consumer thread `tid` per point) on
// the last trunk output h, into `sig`: the sum over the columns in order,
// the bias, the noise, the activation.
__device__ __forceinline__ void sigma_head(const FwdParams& p, const float* h, int m0,
                                           float* sig, int tid) {
  if (tid >= p.tm) return;
  // float4 reads (the row starts on 16 B; 8 rows a phase hit 8 slots).
  const float4* hr = reinterpret_cast<const float4*>(h + tid * (p.D + 4));
  const float4* ws = reinterpret_cast<const float4*>(p.w_sigma);
  float s = 0.f;
#pragma unroll 4
  for (int n = 0; n < p.D / 4; ++n) {
    const float4 hv = hr[n], wv = __ldg(ws + n);
    s = fmaf(hv.x, wv.x, s);
    s = fmaf(hv.y, wv.y, s);
    s = fmaf(hv.z, wv.z, s);
    s = fmaf(hv.w, wv.w, s);
  }
  s = s + p.b_sigma[0];
  const int m = m0 + tid;
  if (p.noise != nullptr && m < p.M) s = s + __ldg(p.noise + m);
  if (p.shifted_softplus) {
    const float x = s - 1.f;
    s = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
  } else {
    s = fmaxf(s, 0.f);
  }
  sig[tid] = s;
}

// The rgb head and the output row of point t (a consumer thread per point)
// from rgb_in columns of `last`, with sig[t].
__device__ __forceinline__ void rgb_head(const FwdParams& p, const float* last, int rgb_in,
                                         const float* sig, int m0, int t) {
  if (t >= p.tm) return;
  const float4* xr = reinterpret_cast<const float4*>(last + t * (p.D + 4));
  const float4* w0 = reinterpret_cast<const float4*>(p.w_rgb);
  const float4* w1 = reinterpret_cast<const float4*>(p.w_rgb + rgb_in);
  const float4* w2 = reinterpret_cast<const float4*>(p.w_rgb + 2 * rgb_in);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 2
  for (int n = 0; n < rgb_in / 4; ++n) {
    const float4 x = xr[n], u0 = __ldg(w0 + n), u1 = __ldg(w1 + n), u2 = __ldg(w2 + n);
    a0 = fmaf(x.x, u0.x, a0);
    a1 = fmaf(x.x, u1.x, a1);
    a2 = fmaf(x.x, u2.x, a2);
    a0 = fmaf(x.y, u0.y, a0);
    a1 = fmaf(x.y, u1.y, a1);
    a2 = fmaf(x.y, u2.y, a2);
    a0 = fmaf(x.z, u0.z, a0);
    a1 = fmaf(x.z, u1.z, a1);
    a2 = fmaf(x.z, u2.z, a2);
    a0 = fmaf(x.w, u0.w, a0);
    a1 = fmaf(x.w, u1.w, a1);
    a2 = fmaf(x.w, u2.w, a2);
  }
  const int m = m0 + t;
  if (m < p.M) {
    float4 o;
    o.x = 1.f / (1.f + expf(-(a0 + p.b_rgb[0])));
    o.y = 1.f / (1.f + expf(-(a1 + p.b_rgb[1])));
    o.z = 1.f / (1.f + expf(-(a2 + p.b_rgb[2])));
    o.w = sig[t];
    reinterpret_cast<float4*>(p.out)[m] = o;
  }
}

// The whole forward of the CTA's tile: encode, trunk (sigma head after its
// last layer), trunk_final and dir_a with the branch, the rgb head; writes
// (M, 4) [rgb, sigma] and, in the training forward, the saved rows.
__device__ __forceinline__ void forward_tile(const FwdMaps& maps, const FwdParams& p) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 B: the ring starts on it.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
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
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // Producer warpgroup: it gives its registers to the consumers, and one
    // thread keeps the ring full, layer after layer.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp > CONSUMER_WARPS) {
      // Warps 9-11: the tile's directions and appearance rows into L2 now,
      // so that dir_a's tiles, made after the trunk, find them there.
      const int t = threadIdx.x - (CONSUMER_WARPS + 1) * 32;
      const int n = min(p.tm, p.M - m0);
      if (p.app != nullptr) prefetch_l2(p.app + (size_t)m0 * p.app_dim, 4 * n * p.app_dim, t);
      if (p.dirs != nullptr) prefetch_l2(p.dirs + (size_t)m0 * 3, 12 * n, t);
    }
    if (warp == CONSUMER_WARPS && lane == 0) {
      int st = 0, use = 0;
      for (int li = 0; li < nmat; ++li) {
        const int nseg = nsegments(p, li);
        const int nblocks = (out_width(p, li) + BN - 1) / BN;
        const int bytes = box_rows(p, li) * BK * 4;
        for (int nb = 0; nb < nblocks; ++nb) {
          for (int s = 0; s < nseg; ++s) {
            const Seg sg = segment(p, li, s);
            for (int j = 0; j * BK < sg.K; ++j) {
              if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
              mbar_expect_tx(full + st, 2 * bytes);
              const uint32_t stage = smem_u32(smem + p.ring_off + st * STAGE_BYTES);
              tma_load_keep(stage, &maps.w[li], sg.kw + j * BK, BN * nb, full + st);
              tma_load_keep(stage + BOX_BYTES, &maps.wlo[li], sg.kw + j * BK, BN * nb,
                            full + st);
              if (++st == p.stages) st = 0, ++use;
            }
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  Place pl;
  pl.wg = warp >> 2;
  pl.g = lane >> 2;
  pl.q = lane & 3;
  pl.r0 = 16 * (warp & 3) + pl.g;
  pl.rows = 16 * (warp & 3) < p.tm;
  Ring ring = {smem_u32(smem + p.ring_off), full, empty, p.stages, 0, 0};
  float* enc = reinterpret_cast<float*>(smem + p.enc_off);
  float* dirt = reinterpret_cast<float*>(smem + p.dir_off);
  float* appt = reinterpret_cast<float*>(smem + p.app_off);
  float* sig = reinterpret_cast<float*>(smem + p.sig_off);

  encode_tile(p.xyz, p.xyz_dim, p.nf_xyz, p.EP, m0, p.M, p.tm, enc, p.act, p.act_width, 0);
  consumer_sync();

  float acc0[32], acc1[32], ch[32];
  for (int li = 0; li < nmat; ++li) {
    const Tiles tl = {enc, out_tile(p, smem, li - 1), dirt, appt, p.EP, p.D, p.DP, p.AP};
    const int col = li < p.layers ? p.EP + li * p.D
                                  : (li == p.layers ? p.act_final : p.act_branch);
    layer<CHAIN_STAGES>(acc0, acc1, ch, FwdSrc{p, li, tl}, out_width(p, li), p.x_off == p.y_off,
                        FwdEpi{p, li, col, m0, out_tile(p, smem, li), pl}, ring, pl, lane);
    if (li != p.layers - 1) continue;
    sigma_head(p, out_tile(p, smem, li), m0, sig, threadIdx.x);
    // dir_a's direction and appearance tiles, in the encode's room (no
    // layer reads the encode past the trunk); the barrier at the end of
    // trunk_final orders these stores before dir_a's reads.
    if (p.has_branch) {
      if (p.DP)
        encode_tile(p.dirs, 3, p.nf_dir, p.DP, m0, p.M, p.tm, dirt, p.act, p.act_width,
                    p.act_dir);
      if (p.AP) app_tile(p, m0, appt);
    }
  }
  // Rgb head and output: a thread per point (the one that wrote its sigma).
  rgb_head(p, out_tile(p, smem, p.has_branch ? p.layers + 1 : p.layers - 1),
           p.has_branch ? p.D / 2 : p.D, sig, m0, threadIdx.x);
}

// ------------------------------------------------------------------ host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime so the
// library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

constexpr int ERR_NO_ENCODE = -1000;  // below: -CUresult of a failed encode

// The forward's launch tables into params and tensor maps (eval_f32_launch
// documents them) -> 0, a cudaError_t, ERR_NO_ENCODE or -CUresult.
inline int fwd_setup(const long long* ptrs, const int* dims, const int* plan,
                     const int* shapes, const long long* rests, FwdParams& p, FwdMaps& maps,
                     int& smem) {
  memset(&p, 0, sizeof p);
  memset(&maps, 0, sizeof maps);
  p.xyz = reinterpret_cast<const float*>(ptrs[0]);
  p.dirs = reinterpret_cast<const float*>(ptrs[1]);
  p.app = reinterpret_cast<const float*>(ptrs[2]);
  p.out = reinterpret_cast<float*>(ptrs[3]);
  p.w_sigma = reinterpret_cast<const float*>(ptrs[4]);
  p.b_sigma = reinterpret_cast<const float*>(ptrs[5]);
  p.w_rgb = reinterpret_cast<const float*>(ptrs[6]);
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
  p.ring_off = plan[2];
  p.x_off = plan[3];
  p.y_off = plan[4];
  p.enc_off = plan[5];
  p.dir_off = plan[6];
  p.app_off = plan[7];
  p.sig_off = plan[8];
  p.bar_off = plan[9];
  smem = plan[10];
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  // tm = 64 writes in place (x == y): a layer's 2 x 128 output columns fit
  // the consumers' two totals; past that the tiles take turns.
  if (nmat > MAX_MATS || p.xyz_dim < 1 || p.xyz_dim > 4 || p.D % 16 || p.D < 16 ||
      p.EP % 16 || p.DP % 16 || p.AP % 16 || p.stages < 2 ||
      !((p.tm == 64 && p.x_off == p.y_off && p.D <= 2 * BN) ||
        (p.tm == 32 && p.x_off != p.y_off)) ||
      p.ring_off % 1024)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nmat; ++i) {
    const void* w = reinterpret_cast<const void*>(ptrs[8 + 2 * i]);
    const void* wlo = reinterpret_cast<const void*>(rests[i]);
    p.bias[i] = reinterpret_cast<const float*>(ptrs[9 + 2 * i]);
    const int n = shapes[2 * i], kt = shapes[2 * i + 1];
    // TMA reads W and its rests: 16-byte aligned bases and row pitches.
    if ((reinterpret_cast<uintptr_t>(w) & 15) || (reinterpret_cast<uintptr_t>(wlo) & 15) ||
        kt % 4 || n < 1)
      return (int)cudaErrorInvalidValue;
    if (p.M <= 0) continue;
    if (!encode_tiled()) return ERR_NO_ENCODE;
    const cuuint64_t gdims[2] = {(cuuint64_t)kt, (cuuint64_t)n};
    const cuuint64_t strides[1] = {(cuuint64_t)kt * 4};
    const cuuint32_t box[2] = {BK, (cuuint32_t)(n < BN ? n : BN)};  // box_rows()
    const cuuint32_t estr[2] = {1, 1};
    for (int h = 0; h < 2; ++h) {
      const CUresult r = encode_tiled()(
          h ? &maps.wlo[i] : &maps.w[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
          const_cast<void*>(h ? wlo : w), gdims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return -(int)r;
    }
  }
  return 0;
}

// Launch `kernel` (a __global__ taking (maps, params) and running
// forward_tile) over ceil(M / tm) CTAs.
template <typename K>
int fwd_launch(K kernel, const FwdMaps& maps, const FwdParams& p, int smem,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(p.M + p.tm - 1) / p.tm, NT, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

inline const char* fwd_error_string(int code) {
  static char buf[96];
  if (code == ERR_NO_ENCODE) return "cuTensorMapEncodeTiled not found in the driver";
  if (code < 0) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled failed (CUresult %d)", -code);
    return buf;
  }
  return cudaGetErrorString((cudaError_t)code);
}

}  // namespace f32fwd
