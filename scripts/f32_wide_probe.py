#!/usr/bin/env python3
"""Probe of the PyTorch/CUDA port's f32 kernels at their main shapes on one
NVIDIA GPU.

    python3 scripts/f32_wide_probe.py [--parent DIR] [--dw_parent DIR] [--no_gemm]

1. Unless --no_gemm, the f32 wide GEMM (`wide_f32_gemm_kernel` of
   `mega_nerf_tpu_torch/render/csrc/wide_f32.cu`, 3xTF32 on wgmma) at
   524,288 points x 1024 x 1024, as a forward layer (bias, ReLU) and as a
   masked dX job: the checkout's kernel against the variants tried
   (GEMM_VARIANTS: chain lengths, 3 stages, A rests in shared memory,
   warpgroups 2 stages apart), diagnostic copies (GEMM_DIAGNOSTICS, timed
   only), with --parent DIR the parent's kernel (a checkout whose GEMM
   takes (ptrs, dims, stream): the SIMT FFMA kernel this one replaced) and one
   F.linear (f32, TF32 off), in turns (three rounds, the order reversed
   each round; each copy's median); each accurate copy's error against f64
   products of the same rows and whether it equals the checkout's bit for
   bit; a cycle-stamped copy's shares of a CTA's walk (GEMM_STAMPS). Before
   them the card's wgmma m64n128k8 TF32 rate from shared memory at the
   GEMM's shape, pipelined and with the chain ends' drains (`wgmma_peak`):
   the ceiling of the design.
2. With --dw_parent DIR, a checkout of a commit whose f32 weight gradient
   is the FFMA pair (`train_f32.cu`'s `wg_partial_kernel`, per-job
   operands, 11 values a job row): that pair against this checkout's
   (3xTF32 on `mma.sync`) and four variants of it (one chain a split;
   chains of 16 k-steps; 32-point stages; cvt.rna for both halves of the
   split) and one f32 `torch.mm` a job (TF32 off), in turns (tree,
   variants, parent, `torch.mm`, then back), at the paper model's fg-fine
   pass (524,288 points, width 256, f32) and at one 1024 x 1024 layer's dW
   step of the wide route; each copy's relative error against f64 sums of
   the same rows, whether the variants equal the tree bit for bit and
   whether the tree repeats; the SASS opcode counts of both kernels
   (cuobjdump); and before them the card's mma.sync TF32 rate with
   operands in registers (`mma_peak`), the ceiling of that design.

Copies are built with nvcc for sm_90a under `.exp/f32_wide_probe/`; the
script prints each copy's ptxas line for the kernel, the times (ms a launch,
CUDA events over 5 or 10 launches after one) and the card's name, power
limit and SM clock. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / ".exp" / "f32_wide_probe"
M = 524_288


def build_many(specs):
    """Build each (name, source, kernel) of `specs` (a train_f32.cu or
    wide_f32.cu text) as library `name` beside a copy of f32_chain.cuh, one
    nvcc each, all at once -> {name: the loaded library}; prints each
    copy's ptxas line for `kernel`."""
    from mega_nerf_tpu_torch.render import _build

    procs = {}
    for name, source, kernel in specs:
        out = OUT / name
        out.mkdir(parents=True, exist_ok=True)
        cu = out / ("wide_f32.cu" if "wide_f32_gemm_kernel" in source else "train_f32.cu")
        cu.write_text(source)
        shutil.copy(_build.CSRC / "f32_chain.cuh", out / "f32_chain.cuh")
        procs[name] = (kernel, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (kernel, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if kernel in line and "Function properties" in line:
                print(f"{name}: {' '.join(x.strip() for x in lines[i + 1:i + 3])}")
            if "(C75" in line:  # ptxas on the wgmma pipeline
                print(f"{name}: {line.strip()[:160]}")
        libs[name] = ctypes.CDLL(str(OUT / name / "lib.so"))
    return libs


def ms(fn, n: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _bind_gemm(lib):
    """A built copy of this checkout's wide_f32.cu, bound as
    fused_wide_f32._library binds it."""
    vp = ctypes.c_void_p
    lib.wide_f32_gemm_launch.argtypes = [vp, vp, vp, ctypes.c_int, vp]
    lib.wide_f32_gemm_launch.restype = ctypes.c_int
    lib.wide_f32_resident_ctas.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.wide_f32_resident_ctas.restype = ctypes.c_int
    lib.error_string = lib.wide_f32_error_string
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


WGMMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mma(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db));
}

// Two warpgroups a CTA, one CTA an SM, each issuing the GEMM's stage of
// products (12 m64n128k8 TF32 wgmmas from shared memory) `rounds` times,
// one stage in flight behind the next; with drain > 0 every drain-th stage
// waits for all its products (the GEMM's chain ends). No loads.
__global__ void __launch_bounds__(256, 1) wgmma_peak_kernel(float* out, int rounds, int drain) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  for (int i = threadIdx.x; i < 4 * 16384 / 4; i += 256) reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  float d[64];
  for (int i = 0; i < 64; ++i) d[i] = 0.f;
  const uint64_t da = desc(base + wg * 8192), db = desc(base + 32768);
  for (int r = 0; r < rounds; ++r) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma(d, da + 2 * kk, db + 2 * kk);
      mma(d, da + 2 * kk, db + 2 * kk);
      mma(d, da + 2 * kk, db + 2 * kk);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (drain > 0 && r % drain == drain - 1)
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    else
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < 64; ++i) s += d[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int wgmma_peak_launch(float* out, int ctas, int rounds, int drain, void* stream) {
  const int smem = 4 * 16384 + 1024;
  cudaFuncSetAttribute(wgmma_peak_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  wgmma_peak_kernel<<<ctas, 256, smem, (cudaStream_t)stream>>>(out, rounds, drain);
  return (int)cudaGetLastError();
}
"""


def wgmma_peak() -> None:
    """The card's wgmma m64n128k8 TF32 rate with both operands in shared
    memory and no loads, at the GEMM's shape (two warpgroups a CTA, one CTA
    an SM, 12 products a stage, one stage in flight): the ceiling of its
    design; then with every 2nd stage drained (its chain ends)."""
    import torch

    from mega_nerf_tpu_torch.render import _build

    out_dir = OUT / "wgmma_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "wgmma_peak.cu").write_text(WGMMA_PEAK_CU)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / "lib.so"),
                          str(out_dir / "wgmma_peak.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for wgmma_peak:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    lib.wgmma_peak_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p]
    lib.wgmma_peak_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = torch.empty(sms * 256, device="cuda")
    rounds, rates = 4_000, {}
    for drain in (0, 2):
        def run():
            if lib.wgmma_peak_launch(out.data_ptr(), sms, rounds, drain, stream):
                raise RuntimeError("wgmma_peak did not launch")
        t = ms(run, 5)
        flops = sms * 2 * rounds * 12 * 2.0 * 64 * 128 * 8
        rates["pipelined" if drain == 0 else f"drained every {drain} stages"] = round(
            flops / t / 1e9, 1)
    print(f"wgmma m64n128k8 TF32 from shared memory, TFLOP/s at two warpgroups a CTA, one "
          f"CTA an SM ({sms} SMs): {rates}")


# Variants of the GEMM: string edits of wide_f32.cu, each with the plan
# constants of fused_wide_f32 its launcher checks. A rests in shared memory:
# the design before A from registers (each warpgroup writes its rows' rests
# into a fourth box of the stage, at the A box's swizzled offsets, fences
# them for wgmma and waits at a warpgroup barrier; both A operands by
# descriptor): four boxes a stage, so 3 stages.
# The products with both operands by descriptor, for the A-rests variant.
GEMM_SS_HELPER = r'''// Generic-proxy writes to shared memory become visible to wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x 128, f32) = A (64 x 8) * B (8 x 128) (+ d if accumulate), both
// K-major TF32 in shared memory: the tensor cores read each f32 operand's
// top 19 bits (sign, exponent, 10 mantissa bits), its rest truncated.
__device__ __forceinline__ void wgmma_tf32_n128_ss(float* d, uint64_t da, uint64_t db,
                                                int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

'''
GEMM_STAGES_EDIT = ("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")
GEMM_SMEM_A_RESTS = (
    ("""constexpr int STAGES = 4;
constexpr int BOX_BYTES = 128 * BK * 4;  // 16 KB
constexpr int B_OFF = BOX_BYTES;
constexpr int BLO_OFF = 2 * BOX_BYTES;
constexpr int STAGE_BYTES = 3 * BOX_BYTES;
constexpr int TMA_BYTES = STAGE_BYTES;  // A, W, W rests""",
     """constexpr int STAGES = 3;
constexpr int BOX_BYTES = 128 * BK * 4;  // 16 KB
constexpr int HALF_A = BOX_BYTES / 2;
constexpr int ALO_OFF = BOX_BYTES;
constexpr int B_OFF = 2 * BOX_BYTES;
constexpr int BLO_OFF = 3 * BOX_BYTES;
constexpr int STAGE_BYTES = 4 * BOX_BYTES;
constexpr int TMA_BYTES = 3 * BOX_BYTES;  // A, W, W rests"""),
    ("// x - (x with its low 13 bits cleared)",
     GEMM_SS_HELPER + "// x - (x with its low 13 bits cleared)"),
    ("""        const uint8_t* a = smem + st * STAGE_BYTES + arow;
        uint32_t ah[BK / 8][4], al[BK / 8][4];
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const float x = *reinterpret_cast<const float*>(
                a + (v & 1) * 1024 + (((2 * kk + (v >> 1)) ^ g) << 4));
            ah[kk][v] = __float_as_uint(x);
            al[kk][v] = __float_as_uint(tf32_rest(x));
          }
        }
        const uint32_t base = ring + st * STAGE_BYTES;
        const uint64_t db = kmajor_desc(base + B_OFF);
        const uint64_t dbl = kmajor_desc(base + BLO_OFF);
""", """        const int tid = threadIdx.x & 127;
        uint8_t* stage = smem + st * STAGE_BYTES;
        const float4* a4 = reinterpret_cast<const float4*>(stage + wg * HALF_A);
        float4* l4 = reinterpret_cast<float4*>(stage + ALO_OFF + wg * HALF_A);
#pragma unroll
        for (int i = 0; i < HALF_A / 16 / 128; ++i) {
          const float4 v = a4[tid + 128 * i];
          l4[tid + 128 * i] =
              make_float4(tf32_rest(v.x), tf32_rest(v.y), tf32_rest(v.z), tf32_rest(v.w));
        }
        fence_async_smem();
        named_bar(1 + wg, 128);
        const uint32_t base = ring + st * STAGE_BYTES;
        const uint64_t da = kmajor_desc(base + wg * HALF_A);
        const uint64_t dl = kmajor_desc(base + ALO_OFF + wg * HALF_A);
        const uint64_t db = kmajor_desc(base + B_OFF);
        const uint64_t dbl = kmajor_desc(base + BLO_OFF);
"""),
    ("""          wgmma_tf32_n128(ch, al[kk], db + 2 * kk, !fresh || kk > 0);
          wgmma_tf32_n128(ch, ah[kk], dbl + 2 * kk, 1);
          wgmma_tf32_n128(ch, ah[kk], db + 2 * kk, 1);""",
     """          wgmma_tf32_n128_ss(ch, dl + 2 * kk, db + 2 * kk, !fresh || kk > 0);
          wgmma_tf32_n128_ss(ch, da + 2 * kk, dbl + 2 * kk, 1);
          wgmma_tf32_n128_ss(ch, da + 2 * kk, db + 2 * kk, 1);"""),
)


def _smem(stages: int, boxes: int) -> int:
    """The GEMM's shared memory at `stages` stages of `boxes` 16 KB boxes."""
    return stages * boxes * 16_384 + 2 * stages * 8 + 1024


# name: (edits, plan constants of fused_wide_f32 the launcher checks).
GEMM_VARIANTS = {
    "chains of 1 k-stage": ((("constexpr int CHAIN_STAGES = 2;",
                              "constexpr int CHAIN_STAGES = 1;"),), {"GEMM_CHAIN": 1}),
    "chains of 4 k-stages": ((("constexpr int CHAIN_STAGES = 2;",
                               "constexpr int CHAIN_STAGES = 4;"),), {"GEMM_CHAIN": 4}),
    "one chain a tile": ((("constexpr int CHAIN_STAGES = 2;",
                           "constexpr int CHAIN_STAGES = 32;"),), {"GEMM_CHAIN": 32}),
    "3 stages": ((GEMM_STAGES_EDIT,), {"GEMM_STAGES": 3, "GEMM_SMEM": _smem(3, 3)}),
    "A rests in shared memory": (GEMM_SMEM_A_RESTS, {"GEMM_STAGES": 3,
                                                    "GEMM_SMEM": _smem(3, 4)}),
    # Warpgroup 1 starts once warpgroup 0 has issued 2 k-stages, so that
    # the two reach their epilogues 2 stages apart and each one's products
    # run under the other's epilogue.
    "warpgroups 2 stages apart": ((
        ("    int st = 0, phase = 0;\n",
         "    int st = 0, phase = 0;\n"
         "    if (wg == 1) asm volatile(\"bar.sync 1, 256;\\n\" ::: \"memory\");\n"),
        ("        phase ^= st == 0;\n",
         "        phase ^= st == 0;\n"
         "        if (wg == 0 && t == (int)blockIdx.x && c + 1 == min(2, p.nk))\n"
         "          asm volatile(\"bar.arrive 1, 256;\\n\" ::: \"memory\");\n")), {}),
}

# Diagnostic copies (not f32 accurate, timed only): W's rests not loaded
# (the W box read twice: a third less TMA traffic); no A split (A's raw
# bits as both A operands: no rest computed).
GEMM_DIAGNOSTICS = {
    "diagnostic: W rests not loaded": ((
        ("            tma_load_keep(dst + BLO_OFF, &maps.wlo, p.kcol[s] + j * BK, n0, "
         "full + st);\n", ""),
        ("constexpr int TMA_BYTES = STAGE_BYTES;", "constexpr int TMA_BYTES = 2 * BOX_BYTES;"),
        ("const uint64_t dbl = kmajor_desc(base + BLO_OFF);",
         "const uint64_t dbl = kmajor_desc(base + B_OFF);")), {}),
    "diagnostic: no A split": ((
        ("al[kk][v] = __float_as_uint(tf32_rest(x));", "al[kk][v] = ah[kk][v];"),), {}),
    "diagnostic: no mask loads": ((
        ("          tmp[4 * g + 2 * rr] = v.x;\n          tmp[4 * g + 2 * rr + 1] = v.y;\n",
         "          tmp[4 * g + 2 * rr] = 1.f;\n          tmp[4 * g + 2 * rr + 1] = 1.f;\n"),),
        {}),
    "diagnostic: no L2 prefetch": ((
        ("  p.prefetch = masked &&", "  p.prefetch = false &&"),), {}),
}

# A copy of the GEMM that counts SM cycles (clock64) per CTA: each consumer
# warpgroup's whole walk, its waits for a full stage, its A fragments and
# splits, and its epilogues; the producer's walk and its waits for an empty
# stage. Thread 0 of each role stores them by a predicated store (a branch
# near the products would serialise the wgmmas).
GEMM_STAMPS = (
    ("namespace {\n", "__device__ unsigned long long g_stamps[1024 * 8];\n"
     "__device__ __forceinline__ void stamp_if(int i, long long v, bool p) {\n"
     "  asm volatile(\"{\\n.reg .pred q;\\nsetp.ne.s32 q, %2, 0;\\n\"\n"
     "               \"@q st.global.u64 [%0], %1;\\n}\\n\""
     " :: \"l\"(g_stamps + i), \"l\"(v), \"r\"((int)p) : \"memory\");\n}\n\nnamespace {\n"),
    ("      int st = 0, use = 0;\n",
     "      int st = 0, use = 0;\n      long long pall = clock64(), pw = 0;\n"),
    ("            if (use > 0) mbar_wait(empty + st, (use - 1) & 1);\n",
     "            const long long pt = clock64();\n"
     "            if (use > 0) mbar_wait(empty + st, (use - 1) & 1);\n"
     "            pw += clock64() - pt;\n"),
    ("            if (++st == STAGES) st = 0, ++use;\n          }\n        }\n      }\n",
     "            if (++st == STAGES) st = 0, ++use;\n          }\n        }\n      }\n"
     "      stamp_if(8 * blockIdx.x + 6, clock64() - pall, true);\n"
     "      stamp_if(8 * blockIdx.x + 7, pw, true);\n"),
    ("    float acc[64], ch[64];  // the f32 totals, the running chain\n",
     "    float acc[64], ch[64];  // the f32 totals, the running chain\n"
     "    long long tall = clock64(), tw = 0, tp = 0, te = 0;\n"),
    ("        mbar_wait(full + st, phase);\n",
     "        const long long t0 = clock64();\n        mbar_wait(full + st, phase);\n"
     "        tw += clock64() - t0;\n"),
    ("        const uint8_t* a = smem + st * STAGE_BYTES + arow;\n",
     "        const long long t1 = clock64();\n"
     "        const uint8_t* a = smem + st * STAGE_BYTES + arow;\n"),
    ("        const uint32_t base = ring + st * STAGE_BYTES;\n",
     "        tp += clock64() - t1;\n        const uint32_t base = ring + st * STAGE_BYTES;\n"),
    ("      const int m_top = m0 + 64 * wg + r0;\n",
     "      const long long t2 = clock64();\n      const int m_top = m0 + 64 * wg + r0;\n"),
    ("        gemm_epilogue<false>(p, acc, ch, col_add, m_top, n0, q);\n    }\n",
     "        gemm_epilogue<false>(p, acc, ch, col_add, m_top, n0, q);\n"
     "      te += clock64() - t2;\n    }\n"
     "    stamp_if(8 * blockIdx.x + 3 * wg, clock64() - tall, lane == 0 && warp % 4 == 0);\n"
     "    stamp_if(8 * blockIdx.x + 3 * wg + 1, tw, lane == 0 && warp % 4 == 0);\n"
     "    stamp_if(8 * blockIdx.x + 3 * wg + 2, tp + ((long long)te << 32), "
     "lane == 0 && warp % 4 == 0);\n"),
    ('extern "C" {\n', 'extern "C" {\n\nint read_stamps(unsigned long long* out, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(out, g_stamps, n * sizeof(unsigned long long));\n}\n\n"),
)


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"wide_f32.cu holds {src.count(old)} copies of {old!r}")
        src = src.replace(old, new)
    return src


def gemm_stamps(lib, fns) -> None:
    """Run the cycle-stamped copy once per form (after one warm launch) and
    print, over the CTAs, the mean share of each consumer warpgroup's walk
    spent waiting for a full stage, on its A rests and in its epilogues,
    and of the producer's walk spent waiting for an empty stage."""
    import numpy as np
    import torch

    lib.read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.read_stamps.restype = ctypes.c_int
    ctas = torch.cuda.get_device_properties(0).multi_processor_count
    for form, fn in zip(("layer", "masked dX"), fns):
        fn()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        buf = np.zeros(8 * ctas, np.uint64)
        if lib.read_stamps(buf.ctypes.data, buf.size):
            raise RuntimeError("read_stamps failed")
        v = buf.reshape(ctas, 8).astype(np.float64)
        share = {}
        for wg in (0, 1):
            total = v[:, 3 * wg]
            te = np.floor(v[:, 3 * wg + 2] / 2.0 ** 32)
            tp = v[:, 3 * wg + 2] - te * 2.0 ** 32
            share[f"wg{wg} waits for a full stage"] = float(np.mean(v[:, 3 * wg + 1] / total))
            share[f"wg{wg} A fragments and splits"] = float(np.mean(tp / total))
            share[f"wg{wg} epilogues"] = float(np.mean(te / total))
        share["producer waits for an empty stage"] = float(np.mean(v[:, 7] / v[:, 6]))
        cyc = float(np.mean(v[:, 0]))
        print(f"wide_f32_gemm {form}, share of a CTA's walk by SM cycles (clock64, mean over "
              f"{ctas} CTAs; walk {cyc:.4g} cycles): "
              f"{ {k: round(x, 4) for k, x in share.items()} }")


def gemm_probe(parent: Optional[Path]) -> None:
    """The f32 wide GEMM at 524,288 points x 1024 x 1024, as a forward layer
    (bias, ReLU) and as a masked dX job: this checkout's kernel (3xTF32 on
    wgmma, A from registers, a 4-stage ring, chains of 2 k-stages) against
    GEMM_VARIANTS (chains of 1 and 4 k-stages and one chain a tile; 3
    stages; A rests in shared memory), GEMM_DIAGNOSTICS, the parent's kernel
    (with --parent: its wide_f32.cu, for a parent whose GEMM takes (ptrs,
    dims, stream), the SIMT FFMA kernel this one replaced) and one F.linear (f32, TF32
    off, no mask), in turns (three rounds, the order reversed each round);
    the cycle-stamped copy's
    shares (GEMM_STAMPS); each accurate copy's relative error (Frobenius)
    against f64 products of the same f32 rows, whether it equals the tree
    bit for bit and whether the tree repeats."""
    import torch
    import torch.nn.functional as F

    from mega_nerf_tpu_torch.render import _build
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf
    from mega_nerf_tpu_torch.render.fused_train_wide import DX_MASK

    src = (_build.CSRC / "wide_f32.cu").read_text()
    copies = {"tree": ((), {}), **GEMM_VARIANTS, **GEMM_DIAGNOSTICS,
              "stamps": (GEMM_STAMPS, {})}
    keys = {name: f"gemm_{i}" for i, name in enumerate(copies)}
    specs = [(keys[name], _edit(src, edits), "wide_f32_gemm_kernel")
             for name, (edits, _) in copies.items()]
    if parent is not None:
        specs.append(("gemm_parent",
                      (parent / "mega_nerf_tpu_torch/render/csrc/wide_f32.cu").read_text(),
                      "wide_f32_gemm_kernel"))
    built = build_many(specs)
    libs = {name: _bind_gemm(built[keys[name]]) for name in copies}
    dev, d = torch.device("cuda"), 1024
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((M, d), generator=gen, device=dev).relu()
    g = torch.randn((M, d), generator=gen, device=dev) * 1e-2 * (
        torch.rand((M, d), generator=gen, device=dev) > 0.5)
    mask = torch.randn((M, d), generator=gen, device=dev)
    w = torch.randn((d, d), generator=gen, device=dev) / 32
    b = torch.randn(d, generator=gen, device=dev)
    y = torch.empty((M, d), device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def tree_fns(name):
        plan = {"_library": lambda: libs[name], **copies[name][1]}

        def use(fn):
            def run():
                saved = {k: getattr(fwf, k) for k in plan}
                for k, v in plan.items():
                    setattr(fwf, k, v)
                try:
                    fn()
                finally:
                    for k, v in saved.items():
                        setattr(fwf, k, v)
            return run
        return (use(lambda: fwf.wide_f32_layer([x], w, b, True, y)),
                use(lambda: fwf.wide_f32_gemm([g], w, d, DX_MASK, y, [0], mask=mask)))

    def parent_fns():
        lib = built["gemm_parent"]
        lib.wide_f32_gemm_launch.argtypes = [ctypes.c_void_p] * 3
        lib.wide_f32_gemm_launch.restype = ctypes.c_int

        def launch(a, mode, extra):
            ptrs = (ctypes.c_longlong * 9)(a.data_ptr(), 0, 0, w.data_ptr(), *extra,
                                           y.data_ptr())
            dims = (ctypes.c_int * 17)(M, d, 1, d, d, mode, d, 16, d, d, 0, 0, 0, 0, 0, 0, 0)

            def run():
                if lib.wide_f32_gemm_launch(ptrs, dims, stream):
                    raise RuntimeError("the parent's GEMM did not launch")
            return run
        return (launch(x, fwf.EPI_LAYER_RELU, (b.data_ptr(), 0, 0, 0)),
                launch(g, DX_MASK, (0, mask.data_ptr(), 0, 0)))

    fns = {name: tree_fns(name) for name in copies if name != "stamps"}
    if parent is not None:
        fns["parent (SIMT FFMA)"] = parent_fns()
    fns["F.linear"] = (lambda: F.linear(x, w, b), lambda: F.linear(g, w))
    # Three rounds, the order reversed each round (the card's clock drifts
    # with its power draw); each copy's median of the three.
    times = {name: [] for name in fns}
    order = list(fns)
    for r in range(3):
        for name in order if r % 2 == 0 else order[::-1]:
            times[name].append((round(ms(fns[name][0], 3), 3), round(ms(fns[name][1], 3), 3)))
    print(f"wide_f32_gemm at {M} x {d} x {d}, (layer, masked dX) ms in turns: {times}")
    median = {name: tuple(sorted(v[i] for v in t)[1] for i in (0, 1)) for name, t in times.items()}
    print(f"wide_f32_gemm medians (layer, masked dX) ms: {median}")
    gemm_stamps(libs["stamps"], tree_fns("stamps"))
    for name in GEMM_DIAGNOSTICS:
        del fns[name]
    refs = ((x.double() @ w.double().T + b.double()).clamp_min(0),
            (g.double() @ w.double().T) * (mask > 0))
    errs, bits = {}, {}
    for form, ref in enumerate(refs):
        outs = {}
        for name in fns:
            if name == "F.linear":
                continue
            fns[name][form]()
            outs[name] = y.clone()
        fns["tree"][form]()
        torch.cuda.synchronize()
        bits[("layer", "masked dX")[form]] = {
            "tree repeats": torch.equal(y, outs["tree"]),
            **{k: torch.equal(v, outs["tree"]) for k, v in outs.items() if k != "tree"}}
        norm = ref.norm().item()
        for name, o in outs.items():
            errs.setdefault(name, []).append(f"{(o.double() - ref).norm().item() / norm:.3e}")
        del outs
        torch.cuda.empty_cache()
    print(f"relative error against f64 (layer, masked dX): {errs}; bit-equal to the tree: "
          f"{bits}")


PARENT_WG_SPLIT = (1024, 2048, 32)  # the FFMA pair's F32_WG_CTAS, MIN_SPLIT, CHUNK
PARENT_WG_JOB = 11  # the FFMA pair's job row: no copy flags


def _bind(lib):
    lib.weight_grad_f32_launch.argtypes = [ctypes.c_void_p] * 3
    lib.weight_grad_f32_launch.restype = ctypes.c_int
    lib.error_string = lib.train_f32_error_string
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def sass_counts(lib_path: Path, kernel: str) -> str:
    """Opcode counts of `kernel`'s SASS in a built library (cuobjdump), the
    most frequent first."""
    from mega_nerf_tpu_torch.render import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    res = subprocess.run([str(tool), "-sass", str(lib_path)], capture_output=True, text=True)
    counts, inside = {}, False
    for line in res.stdout.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        hit = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
        if inside and hit:
            counts[hit.group(1)] = counts.get(hit.group(1), 0) + 1
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:12]
    return ", ".join(f"{k} {v}" for k, v in top) or f"no SASS found ({res.returncode})"


MMA_PEAK_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// Each warp: 16 independent m16n8k8 TF32 products a round, operands in
// registers, no loads: the card's mma.sync TF32 rate at a given occupancy.
__global__ void __launch_bounds__(256) mma_peak_kernel(float* out, int rounds) {
  const uint32_t v = __float_as_uint(1e-3f * (1 + (threadIdx.x & 7))) & 0xffffe000u;
  const uint32_t a[4] = {v, v ^ 0x2000u, v ^ 0x4000u, v ^ 0x6000u};
  float c[16][4] = {};
  for (int it = 0; it < rounds; ++it) {
#pragma unroll
    for (int t = 0; t < 16; ++t)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
                   "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(c[t][0]), "+f"(c[t][1]), "+f"(c[t][2]), "+f"(c[t][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[t & 3]), "r"(v));
  }
  float s = 0.f;
#pragma unroll
  for (int t = 0; t < 16; ++t) s += c[t][0] + c[t][1] + c[t][2] + c[t][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_peak_launch(float* out, int ctas, int rounds, void* stream) {
  mma_peak_kernel<<<ctas, 256, 0, (cudaStream_t)stream>>>(out, rounds);
  return (int)cudaGetLastError();
}
"""


def mma_peak() -> None:
    """The mma.sync m16n8k8 TF32 rate with operands in registers (no
    loads, 16 independent products a warp in flight), at one and two
    CTAs of 8 warps an SM: the ceiling of the weight gradient's design."""
    import torch

    from mega_nerf_tpu_torch.render import _build

    out_dir = OUT / "mma_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "mma_peak.cu").write_text(MMA_PEAK_CU)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / "lib.so"),
                          str(out_dir / "mma_peak.cu")], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for mma_peak:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(out_dir / "lib.so"))
    lib.mma_peak_launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.mma_peak_launch.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rounds, rates = 20_000, {}
    for per_sm in (1, 2):
        ctas = per_sm * sms
        out = torch.empty(ctas * 256, device="cuda")

        def run():
            if lib.mma_peak_launch(out.data_ptr(), ctas, rounds, stream):
                raise RuntimeError("mma_peak did not launch")
        t = ms(run, 5)
        flops = ctas * 8 * rounds * 16 * 2.0 * 16 * 8 * 8
        rates[per_sm] = round(flops / t / 1e9, 1)
    print(f"mma.sync m16n8k8 TF32 from registers, TFLOP/s at 1 and 2 CTAs of 8 warps an SM "
          f"({sms} SMs): {rates}")


def weight_grad_parent(parent: Path) -> None:
    """The parent's f32 weight gradient (FFMA `wg_partial_kernel`, per-job
    operands) against this checkout's (3xTF32 on mma.sync through a cp.async
    ring) and four variants of it, in turns, at the narrow fg-fine pass
    (paper model, 524,288 points, width 256: the jobs of
    `fused_train.weight_grad_jobs`) and at one 1024 x 1024 layer's dW step
    of the wide route (one job, bias included), beside one f32 torch.mm a
    job (TF32 off, no bias sums); each copy's relative error (norm over dW
    and db) against the f64 sums of the same f32 rows. The
    variants: one chain of products a split (no f32 totals until its end)
    and chains of 16 k-steps, in place of 8 (a stage); 32-point stages (a
    chain then two stages); hi and lo both rounded by cvt.rna.tf32.f32 (the
    tree rounds hi by an integer add and mask, the same bits for finite
    values, and leaves lo to the tensor cores' truncation)."""
    import torch

    from mega_nerf_tpu_torch.models import NeRF, NeRFConfig
    from mega_nerf_tpu_torch.render import _build, fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    src = (_build.CSRC / "train_f32.cu").read_text()
    chunk = "constexpr int WG_P = 64;"
    chain = "constexpr int WG_CHAIN = 8;"
    split = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
             "  lo = __float_as_uint(x - __uint_as_float(hi));\n")
    cvt = ('  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));\n'
           '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(x - __uint_as_float(hi)));\n')
    for key in (chunk, chain, split):
        if key not in src:
            raise RuntimeError(f"train_f32.cu no longer holds {key!r}")
    built = build_many([
        ("wg_parent", (parent / "mega_nerf_tpu_torch/render/csrc/train_f32.cu").read_text(),
         "wg_partial"),
        ("wg_tree", src, "wg_tf32x3"),
        ("wg_one_chain", src.replace(chain, chain.replace("8;", "1 << 24;")), "wg_tf32x3"),
        ("wg_chain16", src.replace(chain, chain.replace("8;", "16;")), "wg_tf32x3"),
        ("wg_p32", src.replace(chunk, chunk.replace("64;", "32;")), "wg_tf32x3"),
        ("wg_cvt", src.replace(split, cvt), "wg_tf32x3")])
    libs = {"parent": built["wg_parent"], "tree": _bind(built["wg_tree"]),
            "one chain a split": _bind(built["wg_one_chain"]),
            "chains of 16 k-steps": _bind(built["wg_chain16"]),
            "32-point stages": _bind(built["wg_p32"]),
            "cvt.rna for hi and lo": _bind(built["wg_cvt"])}
    chunks = {"32-point stages": 32}  # point ranges of whole stages
    libs["parent"].weight_grad_f32_launch.argtypes = [ctypes.c_void_p] * 3
    libs["parent"].weight_grad_f32_launch.restype = ctypes.c_int
    print(f"wg_tf32x3_kernel SASS opcodes: {sass_counts(OUT / 'wg_tree' / 'lib.so', 'wg_tf32x3')}")
    print(f"wg_partial_kernel (parent) SASS opcodes: "
          f"{sass_counts(OUT / 'wg_parent' / 'lib.so', 'wg_partial')}")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1)
    cfg = NeRFConfig(xyz_dim=3, layer_dim=256, pos_xyz_dim=12, pos_dir_dim=4, layers=8,
                     skip_layers=(4,), appearance_dim=48, compute_dtype="float32")
    packed = fused_mlp.pack_params(NeRF(cfg).to(dev))
    act = torch.rand((M, ft.act_layout(packed)["width"]), generator=gen, device=dev)
    grad = torch.randn((M, ft.grad_layout(packed)["width"]), generator=gen, device=dev)
    grad *= torch.rand(grad.shape, generator=gen, device=dev) > 0.5  # ReLU-masked rows
    narrow = [fused_f32.WgJob(grad, act, *job) for job in fused_f32.f32_wg_plan(packed, M).jobs]
    total = ft._offsets(ft.packed_shapes(packed))[-1]
    d = 1024
    h1 = torch.relu(torch.randn((M, d), generator=gen, device=dev))
    gp = torch.randn((M, d), generator=gen, device=dev) * 1e-2 * (
        torch.rand((M, d), generator=gen, device=dev) > 0.5)
    wide = [fused_f32.WgJob(gp, h1, 0, d, 0, d, 0, d, d * d)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def parent_fn(jobs, out):
        ctas, min_split, chunk = PARENT_WG_SPLIT
        tiles = fused_f32.f32_wg_tiles([(j.n, j.k) for j in jobs])
        splits = max(1, min(-(-ctas // len(tiles)), -(-M // min_split)))
        split_len = -(-max(-(-M // splits), 1) // chunk) * chunk
        splits = -(-M // split_len)
        rows = [v for row in fused_f32.f32_wg_job_rows(jobs) for v in row[:PARENT_WG_JOB]]
        table = torch.tensor(rows + [v for t in tiles for v in t], dtype=torch.int64,
                             device=dev)
        scratch = torch.empty(splits * len(tiles) * fused_f32.F32_WG_ELEMS, device=dev)
        ptrs = (ctypes.c_longlong * 3)(out.data_ptr(), scratch.data_ptr(), table.data_ptr())
        dims = (ctypes.c_int * 5)(M, len(jobs), len(tiles), splits, split_len)

        def run():
            if libs["parent"].weight_grad_f32_launch(ptrs, dims, stream):
                raise RuntimeError("the parent's weight gradient did not launch")
        run.keep = (table, scratch)  # alive while the launches read them
        return run

    def tree_fn(lib, jobs, out, chunk=fused_f32.F32_WG_CHUNK):
        def run():
            fused_f32._train_lib = lambda: lib
            fused_f32.F32_WG_CHUNK = chunk
            try:
                fused_f32.weight_grad_f32_jobs(jobs, out)
            finally:
                fused_f32.F32_WG_CHUNK = default_chunk
        return run

    def reference(jobs, n_out):
        ref = torch.zeros(n_out, dtype=torch.float64, device=dev)
        live = torch.zeros(n_out, dtype=torch.bool, device=dev)
        for j in jobs:
            dd = j.d[:, j.d_col:j.d_col + j.n].double()
            w = dd.T @ j.x[:, j.x_col:j.x_col + j.k].double()
            rows = ref[j.out_off:j.out_off + j.n * j.stride].view(j.n, j.stride)
            rows[:, :j.k] = w
            live[j.out_off:j.out_off + j.n * j.stride].view(j.n, j.stride)[:, :j.k] = True
            if j.bias_off >= 0:
                ref[j.bias_off:j.bias_off + j.n] = dd.sum(0)
                live[j.bias_off:j.bias_off + j.n] = True
        return ref, live

    library, default_chunk = fused_f32._train_lib, fused_f32.F32_WG_CHUNK
    try:
        for shape, jobs, n_out in (("narrow fg-fine pass (524,288 points, width 256)",
                                    narrow, total),
                                   ("one 1024 x 1024 wide layer's dW step (524,288 points)",
                                    wide, d * d + d)):
            outs = {name: torch.zeros(n_out, device=dev) for name in libs}
            fns = {name: tree_fn(lib, jobs, outs[name], chunks.get(name, default_chunk))
                   for name, lib in libs.items() if name != "parent"}
            fns["parent"] = parent_fn(jobs, outs["parent"])

            def library(jobs=jobs):
                for j in jobs:
                    torch.mm(j.d[:, j.d_col:j.d_col + j.n].T, j.x[:, j.x_col:j.x_col + j.k])
            fns["torch.mm"] = library
            times = {name: [] for name in fns}
            order = list(fns)
            for name in order + order[::-1]:
                times[name].append(round(ms(fns[name], 10), 3))
            for name in libs:
                outs[name].zero_()
                fns[name]()
            del fns["torch.mm"]
            torch.cuda.synchronize()
            ref, live = reference(jobs, n_out)
            norm = ref[live].norm().item()
            errs = {name: (o.double()[live] - ref[live]).norm().item() / norm
                    for name, o in outs.items()}
            again = torch.zeros_like(outs["tree"])
            tree_fn(libs["tree"], jobs, again)()
            torch.cuda.synchronize()
            print(f"the f32 weight gradient at the {shape}, ms in turns: {times}; relative "
                  f"error against f64 (dW and db): "
                  f"{ {k: f'{v:.3e}' for k, v in errs.items()} }; variants bit-equal to the "
                  f"tree: { {k: torch.equal(outs[k], outs['tree']) for k in libs} }; the "
                  f"tree repeats bit for bit: {torch.equal(again, outs['tree'])}")
            del outs, fns, ref, live, again
            torch.cuda.empty_cache()
    finally:
        fused_f32._train_lib = library


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout whose f32 wide GEMM takes (ptrs, dims, stream): "
                             "timed in turns beside this checkout's")
    parser.add_argument("--dw_parent", type=Path, default=None,
                        help="a checkout whose f32 weight gradient is the FFMA pair with "
                             "per-job operands")
    parser.add_argument("--no_gemm", action="store_true",
                        help="skip the wide GEMM's comparison")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("f32_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    if not args.no_gemm:
        wgmma_peak()
        gemm_probe(args.parent)
    if args.dw_parent is not None:
        mma_peak()
        weight_grad_parent(args.dw_parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
