#!/usr/bin/env python3
"""Probe of the PyTorch/CUDA port's f32 layer chain (the eval kernel, the
training forward and the backward-data kernel of `--compute_dtype float32`,
3xTF32 on wgmma) on one NVIDIA GPU.

    python3 scripts/f32_fwd_probe.py [--parent DIR]

1. The card's L2 read rate with every SM reading the same buffer (as every
   CTA of the forward reads all the weights): float4 loads, one CTA of 1024
   threads an SM, over 2.4 MB (the paper model's fg weights) and 24 MB.
2. The card's wgmma TF32 rate at the forward's shape (m64n64k8, A from
   registers, B from shared memory, two warpgroups a CTA, one CTA an SM,
   12 products a stage, one stage in flight; then with every 2nd stage
   drained, the chain ends) and, beside it, at m64n128k8.
3. The eval kernel at the paper model's fg-fine shape (8,388,608 points,
   one 16,384-ray chunk; f32, TF32 off) against copies built from exact
   string edits of `csrc/f32_forward.cuh` (FWD_VARIANTS: other designs,
   each checked against the tree's output; and diagnostics that drop a
   part of the work, timed only: where the time goes), in turns (tree,
   copies, then back; three rounds, each copy's median); then a copy that
   stamps %globaltimer at each phase of the first STAMP_TILES CTAs
   (FWD_STAMPS): the encode, each layer's products beside their time at
   495 TFLOP/s, barrier waits, epilogues, the heads.
4. The same for the backward-data kernel at the fg-fine pass of a 1024-ray
   step (524,288 points, on the tree's training-forward rows): its copies
   (BWD_VARIANTS, edits of `csrc/train_f32.cu` and `csrc/f32_forward.cuh`)
   in turns, the worst gradient-row segment of each (not a diagnostic)
   against the plain version's f64 sums; then a stamped copy (BWD_STAMPS):
   the heads and elementwise start, each product's products, barrier wait
   and epilogue.
5. With --parent DIR (a checkout of an earlier commit, e.g. the parent of
   a change to these kernels): the parent's `eval_f32_kernel`, training
   forward and backward-data kernel, built from DIR's sources and called
   through DIR's `render/fused_f32.py`, and this checkout's, in turns
   (tree, parent, parent, tree; three rounds) at the paper model's fg-fine
   shapes: eval 8,388,608 points, training forward and backward-data
   524,288 points (one 1024-ray step), and the backward-data of the model
   at width 512 on as many points; the relative difference of the two
   outputs.

Copies are built with nvcc for sm_90a under `.exp/f32_fwd_probe/`; the
script prints each kernel's ptxas lines, the times (ms a launch, CUDA
events over 3 launches after one) and the card's name, power limit and SM
clock. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / ".exp" / "f32_fwd_probe"

PROBE_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

// Every CTA reads the whole buffer (n float4) `passes` times: the loads of
// a warp cover 512 contiguous bytes.
__global__ void __launch_bounds__(1024, 1) l2_read_kernel(const float4* buf, long long n,
                                                          int passes, float* out) {
  float s = 0.f;
  for (int r = 0; r < passes; ++r)
    for (long long i = threadIdx.x; i < n; i += 1024) {
      const float4 v = __ldcg(buf + i);
      s += v.x + v.y + v.z + v.w;
    }
  out[blockIdx.x * 1024 + threadIdx.x] = s;
}

extern "C" int l2_read_launch(const float* buf, long long n, int passes, float* out,
                              int ctas, void* stream) {
  l2_read_kernel<<<ctas, 1024, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(buf), n, passes, out);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ uint64_t desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

#define D16(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
    "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]), "+f"(d[o + 8]), "+f"(d[o + 9]),          \
    "+f"(d[o + 10]), "+f"(d[o + 11]), "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]),     \
    "+f"(d[o + 15])

__device__ __forceinline__ void mma64(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      : D16(0), D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

__device__ __forceinline__ void mma128(float* d, const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1;\n"
      : D16(0), D16(16), D16(32), D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Two warpgroups a CTA, one CTA an SM, each issuing a stage of the
// forward's products (4 k-steps x 3 TF32 wgmmas, A from registers)
// `rounds` times, one stage in flight behind the next; with drain > 0 every
// drain-th stage waits for all its products (the chain ends). No loads.
template <int N>
__global__ void __launch_bounds__(256, 1) wgmma_rate_kernel(float* out, int rounds,
                                                            int drain) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem);
  for (int i = threadIdx.x; i < 16384 / 4; i += 256) reinterpret_cast<float*>(smem)[i] = 0.f;
  __syncthreads();
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  uint32_t a[4][4];
  for (int k = 0; k < 4; ++k)
    for (int v = 0; v < 4; ++v) a[k][v] = __float_as_uint(1e-3f * (threadIdx.x + k + v));
  const uint64_t db = desc(base);
  for (int r = 0; r < rounds; ++r) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        if constexpr (N == 64) mma64(d, a[kk], db + 2 * kk);
        else mma128(d, a[kk], db + 2 * kk);
      }
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (drain > 0 && r % drain == drain - 1)
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    else
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int i = 0; i < N / 2; ++i) s += d[i];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}

extern "C" int wgmma_rate_launch(int n, float* out, int ctas, int rounds, int drain,
                                 void* stream) {
  const int smem = 16384 + 1024;
  if (n == 64) {
    cudaFuncSetAttribute(wgmma_rate_kernel<64>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    wgmma_rate_kernel<64><<<ctas, 256, smem, (cudaStream_t)stream>>>(out, rounds, drain);
  } else {
    cudaFuncSetAttribute(wgmma_rate_kernel<128>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    wgmma_rate_kernel<128><<<ctas, 256, smem, (cudaStream_t)stream>>>(out, rounds, drain);
  }
  return (int)cudaGetLastError();
}
"""


# Copies of the forward: (edits of f32_forward.cuh, ring stages or None for
# the plan's, diagnostic). A diagnostic drops part of the work: its output
# is wrong and only its time is read.
FWD_VARIANTS = {
    "stages3": ([], 3, False),
    "stages2": ([], 2, False),
    # Diagnostics.
    "no_heads": ([("  if (tid >= p.tm) return;\n", "  if (tid >= 0) return;\n"),
                  ("  if (t >= p.tm) return;\n", "  if (t >= 0) return;\n")], None, True),
    "no_products": ([("    issue(ch, ah0, al0, ring.base + st0 * STAGE_BYTES + half, c % CHAIN == 0);\n",
                      ""),
                     ("      issue(ch, ah1, al1, ring.base + st1 * STAGE_BYTES + half, false);\n",
                      "")], None, True),
    "no_products_w_only": ([("    issue(ch, ah0, al0, ring.base + st0 * STAGE_BYTES + half, c % CHAIN == 0);\n",
                      ""),
                            ("      issue(ch, ah1, al1, ring.base + st1 * STAGE_BYTES + half, false);\n",
                             ""),
                            ("mbar_expect_tx(full + st, 2 * bytes);", "mbar_expect_tx(full + st, bytes);"),
                            ("""tma_load_keep(stage + BOX_BYTES, &maps.wlo[li], sg.kw + j * BK, BN * nb,
                            full + st);""", "")], None, True),
    "no_products_no_frags": ([("    issue(ch, ah0, al0, ring.base + st0 * STAGE_BYTES + half, c % CHAIN == 0);\n",
                      ""),
                              ("      issue(ch, ah1, al1, ring.base + st1 * STAGE_BYTES + half, false);\n",
                               ""),
                              ("    load_frags(ah0, al0, w, pl);\n", ""),
                              ("      load_frags(ah1, al1, w, pl);\n", ""),
                              ("    hold(ah0, al0);\n", ""),
                              ("    if (two) hold(ah1, al1);\n", "")],
                             None, True),
    # W's rests not loaded (their boxes stale): what the rest boxes' bytes
    # cost with the products running.
    "no_rest_loads": ([("mbar_expect_tx(full + st, 2 * bytes);", "mbar_expect_tx(full + st, bytes);"),
                       ("""tma_load_keep(stage + BOX_BYTES, &maps.wlo[li], sg.kw + j * BK, BN * nb,
                            full + st);""", "")], None, True),
    "no_epilogue_stores": ([("""v[4 * j + 2 * rr + 1],
                    live);""", """v[4 * j + 2 * rr + 1],
                    false);""")], None, True),
}


# A copy of the forward that stamps %globaltimer from thread 0 of the first
# STAMP_TILES CTAs (one point tile each) at each phase (predicated stores,
# no branch near the products): the encode, each layer's products, the wait
# before an in-place epilogue, the epilogue with its barrier, the sigma head
# with dir_a's tiles, the rgb head. Its output is the tree's.
STAMP_TILES = 2048
FWD_STAMPS = [
    ("namespace f32fwd {\n", """constexpr int STAMP_TILES = %d;
__device__ unsigned long long fwd_stamps[STAMP_TILES * 64];

__device__ __forceinline__ void stamp(int tile, int k) {
  const bool on = threadIdx.x == 0 && tile < STAMP_TILES;
  asm volatile(
      "{\\n.reg .pred q;\\n.reg .u64 t;\\nsetp.ne.s32 q, %%1, 0;\\n"
      "mov.u64 t, %%%%globaltimer;\\n@q st.global.u64 [%%0], t;\\n}\\n" ::"l"(
          fwd_stamps + (on ? tile * 64 + k : 0)),
      "r"((int)on)
      : "memory");
}

extern "C" int fwd_read_stamps(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, fwd_stamps, sizeof fwd_stamps);
}

namespace f32fwd {
""" % STAMP_TILES),
    # `layer` marks 3 + 3 li (+ 1, + 2 for the backward's product q) through
    # its epilogue's `mark`.
    ("    if (in_place) consumer_sync();\n",
     "    e.mark(0);\n    if (in_place) consumer_sync();\n    e.mark(1);\n"),
    ("  }\n  consumer_sync();\n}\n", "  }\n  consumer_sync();\n  e.mark(2);\n}\n"),
    ("  __device__ __forceinline__ void finish(float (&)[32], int) const {}\n",
     "  __device__ __forceinline__ void finish(float (&)[32], int) const {}\n"
     "  __device__ __forceinline__ void mark(int k) const {"
     " stamp(blockIdx.x, 3 + 3 * li + k); }\n"),
    ("  float* sig = reinterpret_cast<float*>(smem + p.sig_off);\n\n",
     "  float* sig = reinterpret_cast<float*>(smem + p.sig_off);\n  stamp(blockIdx.x, 0);\n\n"),
    ("  consumer_sync();\n\n  float acc0[32], acc1[32], ch[32];",
     "  consumer_sync();\n  stamp(blockIdx.x, 1);\n\n  float acc0[32], acc1[32], ch[32];"),
    ("      if (p.AP) app_tile(p, m0, appt);\n    }\n  }\n",
     "      if (p.AP) app_tile(p, m0, appt);\n    }\n    stamp(blockIdx.x, 60);\n  }\n"),
    ("           p.has_branch ? p.D / 2 : p.D, sig, m0, threadIdx.x);\n}\n",
     "           p.has_branch ? p.D / 2 : p.D, sig, m0, threadIdx.x);\n  stamp(blockIdx.x, 61);\n}\n"),
]


# Copies of the backward-data kernel: (edits of f32_forward.cuh, edits of
# train_f32.cu, ring stages or None for the plan's, diagnostic).
BWD_VARIANTS = {
    "stages3": ([], [], 3, False),
    "stages2": ([], [], 2, False),
    # Chains of 4 k-stages, the forward's (the tree: BWD_CHAIN_STAGES = 2):
    # another order of sums, more of the tensor cores' truncation in a chain.
    "chain4": ([], [("constexpr int BWD_CHAIN_STAGES = 2;",
                     "constexpr int BWD_CHAIN_STAGES = 4;")], None, False),
    # Diagnostics.
    "no_products": (FWD_VARIANTS["no_products"][0], [], None, True),
    "no_masks": ([], [("    if (pr.mcol < 0) return;  // a branch on the product, the same for "
                       "every thread\n", "    return;\n")], None, True),
    # Every tile's masks read from the first tile's rows (hot in L2).
    "masks_hot": ([], [("      const int m = min(m0 + pl.r0 + 8 * rr, p.M - 1);\n"
                        "      const float* row = p.act",
                        "      const int m = pl.r0 + 8 * rr;\n      const float* row = p.act")],
                  None, True),
    "no_row_stores": ([], [("                      pl.rows && n < pr.N && m < p.M);",
                            "                      false);")], None, True),
}

# The backward's stamps (with FWD_STAMPS' `stamp` and `layer` marks): 0 the
# consumers' start, 60 h_{L-1}'s rows in, 62 sigma and the branch rows in,
# 61 the heads, 1 the elementwise start, then 3 + 3 q (+ 1, + 2) for product
# q: products done, after the barrier, after the epilogue. (The paper model
# has the branch.)
BWD_STAMPS = [
    ("  const Place& pl;\n\n  __device__ __forceinline__ int col0(int nb)",
     "  const Place& pl;\n  int q;\n"
     "  __device__ __forceinline__ void mark(int k) const {"
     " stamp(blockIdx.x, 3 + 3 * q + k); }\n"
     "\n  __device__ __forceinline__ int col0(int nb)"),
    ("BwdEpi{p, pr, dst, m0, hd, pl}", "BwdEpi{p, pr, dst, m0, hd, pl, q}"),
    ("  const int t = threadIdx.x;\n\n", "  const int t = threadIdx.x;\n  stamp(blockIdx.x, 0);\n\n"),
    ("  rows_to_tile(p, p.act_h0 + (p.layers - 1) * p.D, p.D, m0, x);\n  consumer_sync();\n",
     "  rows_to_tile(p, p.act_h0 + (p.layers - 1) * p.D, p.D, m0, x);\n  consumer_sync();\n"
     "  stamp(blockIdx.x, 60);\n"),
    ("    rows_to_tile(p, p.act_branch, p.D / 2, m0, x);\n    consumer_sync();\n  }\n",
     "    rows_to_tile(p, p.act_branch, p.D / 2, m0, x);\n    consumer_sync();\n"
     "    stamp(blockIdx.x, 62);\n  }\n"),
    ("  heads(p, x, s, g, hd, m0, t);\n  consumer_sync();\n",
     "  heads(p, x, s, g, hd, m0, t);\n  consumer_sync();\n  stamp(blockIdx.x, 61);\n"),
    ("  first(p, x, hd, m0);\n  consumer_sync();\n",
     "  first(p, x, hd, m0);\n  consumer_sync();\n  stamp(blockIdx.x, 1);\n"),
]


def nvcc(name: str, sources, out: Path):
    """Start nvcc (sm_90a, the port's flags) on `sources` into `out`."""
    from mega_nerf_tpu_torch.render import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    return name, subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), *map(str, sources)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(name: str, log: str) -> None:
    """Print the ptxas lines of the forward kernels in an nvcc log."""
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Function properties" in line and any(k in line for k in ("f32_fwd", "eval_f32",
                                                                     "f32_bwd")):
            print(f"{name}: {line.strip()[:90]} {' '.join(x.strip() for x in lines[i + 1:i + 3])}")
        if "(C75" in line:  # ptxas on the wgmma pipeline
            print(f"{name}: {line.strip()[:160]}")


def finish(name: str, proc) -> None:
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    ptxas_lines(name, log)


def ms(fn, n: int = 3) -> float:
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


def rates(lib) -> None:
    """1 and 2: the L2 read rate and the wgmma TF32 rates."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = torch.empty(sms * 1024, device="cuda")
    for mbytes in (2.4, 24.0):
        n = int(mbytes * 1e6) // 16
        buf = torch.randn(n * 4, device="cuda")
        passes = max(1, int(40 / mbytes))

        def run():
            if lib.l2_read_launch(buf.data_ptr(), n, passes, out.data_ptr(), sms, stream):
                raise RuntimeError("l2_read did not launch")

        t = ms(run, 5)
        print(f"L2 read, every SM ({sms}) reading the same {n * 16 / 1e6:.2f} MB x {passes}: "
              f"{t:.3f} ms = {sms * passes * n * 16 / t / 1e9:.2f} TB/s")
    rounds = 4_000
    for n in (64, 128):
        got = {}
        for drain in (0, 2):
            def run():
                if lib.wgmma_rate_launch(n, out.data_ptr(), sms, rounds, drain, stream):
                    raise RuntimeError("wgmma_rate did not launch")

            t = ms(run, 5)
            flops = sms * 2 * rounds * 12 * 2.0 * 64 * n * 8
            got["pipelined" if drain == 0 else "drained every 2 stages"] = round(
                flops / t / 1e9, 1)
        print(f"wgmma m64n{n}k8 TF32, A from registers, TFLOP/s at two warpgroups a CTA, one "
              f"CTA an SM ({sms} SMs): {got}")


def edited(edits, what: str, once: bool = False, name: str = "f32_forward.cuh") -> str:
    """csrc/`name` with `edits` applied (every occurrence, or exactly one
    with `once`); exits naming `what` where an edit no longer matches."""
    from mega_nerf_tpu_torch.render import _build

    text = (_build.CSRC / name).read_text()
    for old, new in edits:
        if old not in text or (once and text.count(old) != 1):
            raise SystemExit(f"f32_fwd_probe: {what} no longer matches {name}: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def start_copy(label: str, source: str, texts) -> tuple:
    """Start nvcc on a copy of csrc/`source`.cu beside the checkout's
    headers, with `texts` ({file name: text}) in place of the tree's, under
    OUT / label -> (name, proc)."""
    from mega_nerf_tpu_torch.render import _build

    out = OUT / label
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for src in _build.CSRC.glob("*.cuh"):
        shutil.copy(src, out / src.name)
    shutil.copy(_build.CSRC / f"{source}.cu", out / f"{source}.cu")
    for name, text in texts.items():
        (out / name).write_text(text)
    return nvcc(label, [out / f"{source}.cu"], out / f"lib{source}.so")


def start_copies():
    """Start one nvcc per FWD_VARIANTS copy of eval_f32.cu, per BWD_VARIANTS
    copy of train_f32.cu and per stamped copy; every edit is checked before
    any build starts -> [(name, proc)]."""
    fwd = {name: edited(edits, f"variant {name}") for name, (edits, _, _) in
           FWD_VARIANTS.items()}
    bwd = {name: {"f32_forward.cuh": edited(fe, f"variant {name}"),
                  "train_f32.cu": edited(be, f"variant {name}", name="train_f32.cu")}
           for name, (fe, be, _, _) in BWD_VARIANTS.items()}
    fwd_stamps = edited(FWD_STAMPS, "the stamps", once=True)
    bwd_stamps = edited(BWD_STAMPS, "the backward's stamps", once=True, name="train_f32.cu")
    jobs = [start_copy(f"var_{name}", "eval_f32", {"f32_forward.cuh": text})
            for name, text in fwd.items()]
    jobs += [start_copy(f"bwd_{name}", "train_f32", texts) for name, texts in bwd.items()]
    jobs.append(start_copy("stamps", "eval_f32", {"f32_forward.cuh": fwd_stamps}))
    jobs.append(start_copy("bwd_stamps", "train_f32", {"f32_forward.cuh": fwd_stamps,
                                                       "train_f32.cu": bwd_stamps}))
    return jobs


def read_stamps(lib, run):
    """Run `run` (a launch of a stamped copy) once, and read its stamps ->
    (ms, (STAMP_TILES, 64) array of us)."""
    import numpy as np

    lib.fwd_read_stamps.argtypes = [ctypes.c_void_p]
    lib.fwd_read_stamps.restype = ctypes.c_int
    t = ms(run, 1)
    buf = np.zeros(STAMP_TILES * 64, np.uint64)
    if lib.fwd_read_stamps(buf.ctypes.data):
        raise RuntimeError("fwd_read_stamps failed")
    return t, buf.reshape(STAMP_TILES, 64).astype(np.float64) / 1e3  # ns -> us


def stamps() -> None:
    """The stamped copy at fg fine: each phase's mean time over the first
    STAMP_TILES tiles, beside each layer's products at the card's 495
    TFLOP/s of TF32 (an SM's share)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    packed, xyz, dirs, app, _ = paper_case(1024 * 8192)
    lib = bind_eval(OUT / "stamps" / "libeval_f32.so")
    tree = fused_f32._eval_lib
    fused_f32._eval_lib = lambda: lib
    try:
        with torch.no_grad():
            t, st = read_stamps(lib, lambda: fused_f32.fused_nerf_eval_f32(packed, xyz, dirs,
                                                                            app))
    finally:
        fused_f32._eval_lib = tree
    cfg = packed.config
    nmat = cfg.layers + 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_rate = 495e12 / sms
    rows = [("encode", st[:, 1] - st[:, 0], None)]
    prev = st[:, 1]
    for li in range(nmat):
        k = sum(-(-w // 32) * 32 for w in _seg_widths(packed, li))
        n = packed.mats[li].shape[0]
        ideal = 2 * 3 * 64 * (-(-n // 128) * 128) * k / sm_rate * 1e6
        rows.append((f"layer {li} products", st[:, 3 + 3 * li] - prev, ideal))
        rows.append((f"layer {li} wait", st[:, 4 + 3 * li] - st[:, 3 + 3 * li], None))
        rows.append((f"layer {li} epilogue", st[:, 5 + 3 * li] - st[:, 4 + 3 * li], None))
        prev = st[:, 5 + 3 * li]
        if li == cfg.layers - 1:
            rows.append(("sigma head, dir/app tiles", st[:, 60] - prev, None))
            prev = st[:, 60]
    rows.append(("rgb head", st[:, 61] - prev, None))
    report(f"f32 eval fg fine, stamped copy: {t:.3f} ms", rows, st[:, 61] - st[:, 0],
           t * 1e3 / (-(-xyz.shape[0] // 64) / sms))


def report(head: str, rows, total, per_tile: float) -> None:
    """Print a stamped copy's phases: each one's mean over the tiles, its
    share of a CTA and, for products, their time at 495 TFLOP/s."""
    print(f"{head}; a CTA {total.mean():.2f} us from its first stamp to its last (mean of "
          f"{STAMP_TILES}), {per_tile:.2f} us of an SM's time a CTA")
    products = sum(r[1].mean() for r in rows if "products" in r[0])
    ideal_all = sum(r[2] for r in rows if r[2] is not None)
    for name, d, ideal in rows:
        extra = "" if ideal is None else f" (at 495 TFLOP/s: {ideal:.2f} us)"
        print(f"  {name}: {d.mean():.2f} us ({d.mean() / total.mean():.1%}){extra}")
    print(f"  all products {products:.2f} us against {ideal_all:.2f} us at 495 TFLOP/s")


def bwd_products(packed):
    """(name, N, K) of the backward-data kernel's products in its order
    (train_f32.cu `bwd_product`)."""
    from mega_nerf_tpu_torch.render.fused_train import branch_k

    cfg = packed.config
    d, kb = cfg.layer_dim, branch_k(cfg)
    out = []
    if packed.has_branch:
        if cfg.appearance_dim:
            out.append(("d_app", cfg.appearance_dim, kb))
        out += [("d_final", d, kb), ("trunk_final", d, d)]
    return out + [(f"trunk {i}", d, d) for i in range(cfg.layers - 1, 0, -1)]


def bwd_case(m: int, seed: int = 5, width: int = 256):
    """paper_case(m, seed, width) with the tree's training-forward rows and
    a seeded cotangent -> (packed, act, g, noise)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32

    packed, xyz, dirs, app, noise = paper_case(m, seed, width)
    g = torch.randn((m, 4), generator=torch.Generator(device="cuda").manual_seed(seed + 2),
                    device="cuda")
    with torch.no_grad():
        _, act = fused_f32.fused_nerf_train_fwd_f32(packed, xyz, dirs, app, noise)
    return packed, act, g, noise


def bwd_stamps() -> None:
    """The backward's stamped copy at fg fine (524,288 points): the heads
    and start, each product's products (beside 495 TFLOP/s), barrier wait
    and epilogue, mean over the first STAMP_TILES tiles."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    packed, act, g, noise = bwd_case(1024 * 512)
    lib = bind_train(OUT / "bwd_stamps" / "libtrain_f32.so")
    tree = fused_f32._train_lib
    fused_f32._train_lib = lambda: lib
    try:
        with torch.no_grad():
            t, st = read_stamps(lib, lambda: fused_f32.train_bwd_data_f32(packed, act, g, noise))
    finally:
        fused_f32._train_lib = tree
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_rate = 495e12 / sms
    tm = fused_f32.f32_bwd_plan(packed.config).tm
    rows = [("h_{L-1} rows in", st[:, 60] - st[:, 0], None),
            ("sigma, branch rows in", st[:, 62] - st[:, 60], None),
            ("heads", st[:, 61] - st[:, 62], None),
            ("elementwise start", st[:, 1] - st[:, 61], None)]
    prev = st[:, 1]
    prods = bwd_products(packed)
    for q, (name, n, k) in enumerate(prods):
        ideal = 2 * 3 * 64 * (-(-n // 128) * 128) * (-(-k // 32) * 32) / sm_rate * 1e6
        rows.append((f"{name} products", st[:, 3 + 3 * q] - prev, ideal))
        rows.append((f"{name} wait", st[:, 4 + 3 * q] - st[:, 3 + 3 * q], None))
        rows.append((f"{name} epilogue", st[:, 5 + 3 * q] - st[:, 4 + 3 * q], None))
        prev = st[:, 5 + 3 * q]
    report(f"f32 backward-data fg fine, stamped copy: {t:.3f} ms", rows, prev - st[:, 0],
           t * 1e3 / (-(-act.shape[0] // tm) / sms))


def _seg_widths(packed, li):
    """K-segment widths of matrix li (f32_forward.cuh::segment)."""
    cfg = packed.config
    if li < cfg.layers:
        with_enc = li == 0 or li in cfg.skip_layers
        return ([packed.ep] if with_enc else []) + ([cfg.layer_dim] if li else [])
    if li == cfg.layers:
        return [cfg.layer_dim]
    return [cfg.layer_dim] + [w for w in (packed.dp, packed.ap) if w]


def bind_eval(path: Path):
    """A built copy of eval_f32.cu, bound as fused_f32._eval_lib binds it."""
    lib = ctypes.CDLL(str(path))
    lib.eval_f32_launch.argtypes = [ctypes.c_void_p] * 6
    lib.eval_f32_launch.restype = ctypes.c_int
    lib.error_string = lib.eval_f32_error_string
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def bind_train(path: Path):
    """A built copy of train_f32.cu, bound as fused_f32._train_lib binds it."""
    lib = ctypes.CDLL(str(path))
    for fn, nargs in (("train_f32_fwd_launch", 8), ("train_f32_bwd_launch", 6),
                      ("weight_grad_f32_launch", 3)):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * nargs
        getattr(lib, fn).restype = ctypes.c_int
    lib.error_string = lib.train_f32_error_string
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def paper_case(m: int, seed: int = 5, width: int = 256):
    """The paper model's fg MLP in f32 (seeded weights, small random biases;
    layer width `width`) on the card, packed, and m seeded points ->
    (packed, xyz, dirs, app, noise)."""
    import torch

    from mega_nerf_tpu_torch.eval import get_eval_opts
    from mega_nerf_tpu_torch.models import init_weights, make_nerf
    from mega_nerf_tpu_torch.render import fused_mlp

    hp = get_eval_opts(["--exp_name", "unused", "--dataset_path", "unused",
                        "--pos_xyz_dim", "12", "--pos_dir_dim", "4", "--layers", "8",
                        "--skip_layers", "4", "--layer_dim", str(width),
                        "--bg_layer_dim", str(width),
                        "--appearance_dim", "48", "--compute_dtype", "float32"])
    bundle = make_nerf(hp, 16)
    gen = torch.Generator().manual_seed(seed)
    init_weights(bundle.module, gen)
    with torch.no_grad():
        for name, p in bundle.module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    bundle.module.cuda().eval()
    packed = fused_mlp.pack_params(bundle.module)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    xyz = 1.5 * (2 * torch.rand((m, 3), generator=gen, device="cuda") - 1)
    d = torch.randn((m, 3), generator=gen, device="cuda")
    dirs = d / d.norm(dim=-1, keepdim=True)
    app = torch.randn((m, 48), generator=gen, device="cuda")
    noise = torch.rand((m,), generator=gen, device="cuda")
    return packed, xyz, dirs, app, noise


def variants() -> None:
    """3: the eval kernel against FWD_VARIANTS' copies, in turns."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    packed, xyz, dirs, app, _ = paper_case(1024 * 8192)
    tree_lib, plan_ints = fused_f32._eval_lib(), fused_f32._fwd_plan_ints
    libs = {"tree": (tree_lib, None)}
    for name, (_, stages, _) in FWD_VARIANTS.items():
        libs[name] = (bind_eval(OUT / f"var_{name}" / "libeval_f32.so"), stages)

    def run(name):
        lib, stages = libs[name]
        fused_f32._eval_lib = lambda: lib
        fused_f32._fwd_plan_ints = (plan_ints if stages is None else
                                    lambda plan: [plan.tm, stages, *plan_ints(plan)[2:]])
        try:
            return fused_f32.fused_nerf_eval_f32(packed, xyz, dirs, app)
        finally:
            fused_f32._eval_lib, fused_f32._fwd_plan_ints = lambda: tree_lib, plan_ints

    with torch.no_grad():
        want = run("tree")
        same = {}
        for name, (_, _, diag) in FWD_VARIANTS.items():
            if not diag:
                same[name] = torch.equal(run(name), want)
        del want
        order = list(libs)
        got = {k: [] for k in order}
        for r in range(3):
            for name in (order if r % 2 == 0 else order[::-1]):
                got[name].append(round(ms(lambda: run(name)), 3))
    tree = statistics.median(got["tree"])
    for name in order:
        med = statistics.median(got[name])
        kind = ("tree" if name == "tree" else
                "diagnostic" if FWD_VARIANTS[name][2] else
                f"equals the tree bit for bit: {same[name]}")
        print(f"f32 eval fg fine, {name}: {got[name]} ms (median {med:.3f}, "
              f"{med / tree:.3f}x the tree's); {kind}")


def worst_f64(packed, rows, ref) -> float:
    """The largest relative error (Frobenius) of a gradient-row segment of
    `rows` (each d_pre, d_final, d_a) against f64 rows `ref`."""
    from mega_nerf_tpu_torch.render.fused_train import grad_layout

    d, gl = packed.config.layer_dim, grad_layout(packed)
    cuts = [(i * d, (i + 1) * d) for i in range(packed.config.layers)]
    if packed.has_branch:
        cuts += [(gl["dfinal"], gl["dfinal"] + d), (gl["da"], gl["heads"])]
    return max(((rows[:, a:b].double() - ref[:, a:b]).norm() / ref[:, a:b].norm()).item()
               for a, b in cuts)


def bwd_variants() -> None:
    """4: the backward-data kernel against BWD_VARIANTS' copies, in turns, at
    fg fine (524,288 points)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32, fused_train

    torch.backends.cuda.matmul.allow_tf32 = False
    packed, act, g, noise = bwd_case(1024 * 512)
    tree_lib, plan_ints = fused_f32._train_lib(), fused_f32._bwd_plan_ints
    libs = {"tree": (tree_lib, None)}
    for name, (_, _, stages, _) in BWD_VARIANTS.items():
        libs[name] = (bind_train(OUT / f"bwd_{name}" / "libtrain_f32.so"), stages)

    def run(name):
        lib, stages = libs[name]
        fused_f32._train_lib = lambda: lib
        fused_f32._bwd_plan_ints = (plan_ints if stages is None else
                                    lambda plan: [plan.tm, stages, *plan_ints(plan)[2:]])
        try:
            return fused_f32.train_bwd_data_f32(packed, act, g, noise)[0]
        finally:
            fused_f32._train_lib, fused_f32._bwd_plan_ints = lambda: tree_lib, plan_ints

    with torch.no_grad():
        ref = fused_train.train_bwd_data_plain(packed, act, g, noise, acc=torch.float64)[0]
        want = run("tree")
        f64 = {"tree": worst_f64(packed, want, ref)}
        same = {}
        for name, (_, _, _, diag) in BWD_VARIANTS.items():
            if not diag:
                got = run(name)
                same[name] = torch.equal(got, want)
                f64[name] = worst_f64(packed, got, ref)
                del got
        del want, ref
        order = list(libs)
        got = {k: [] for k in order}
        for r in range(3):
            for name in (order if r % 2 == 0 else order[::-1]):
                got[name].append(round(ms(lambda: run(name)), 3))
    tree = statistics.median(got["tree"])
    for name in order:
        med = statistics.median(got[name])
        kind = ("tree" if name == "tree" else
                "diagnostic" if BWD_VARIANTS[name][3] else
                f"equals the tree bit for bit: {same[name]}")
        err = f"; worst segment against f64 {f64[name]:.3e}" if name in f64 else ""
        print(f"f32 backward-data fg fine, {name}: {got[name]} ms (median {med:.3f}, "
              f"{med / tree:.3f}x the tree's); {kind}{err}")


def load_parent(parent: Path):
    """DIR's render/fused_f32.py as module `parent_fused_f32`, bound by its
    own code to its kernel libraries built from DIR's sources (started by
    the caller)."""
    from mega_nerf_tpu_torch.render import _build

    spec = importlib.util.spec_from_file_location(
        "parent_fused_f32", parent / "mega_nerf_tpu_torch" / "render" / "fused_f32.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    built = {n: ctypes.CDLL(str(OUT / "parent" / f"lib{n}.so")) for n in ("eval_f32",
                                                                         "train_f32")}
    tree = _build.load_library
    _build.load_library = lambda name: built[name]
    try:
        libs = {"eval_f32": mod._eval_lib(), "train_f32": mod._train_lib()}
    finally:
        _build.load_library = tree
    mod._eval_lib = lambda: libs["eval_f32"]
    mod._train_lib = lambda: libs["train_f32"]
    return mod


def turns(parent_mod) -> None:
    """5: the tree's and the parent's f32 kernels in turns at fg fine."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, m in (("eval", 1024 * 8192), ("training forward", 1024 * 512),
                    ("backward-data", 1024 * 512), ("backward-data at width 512", 1024 * 512)):
        fns = {}
        if kind.startswith("backward-data"):
            packed, act, g, noise = bwd_case(m, width=512 if kind.endswith("512") else 256)
            for label, mod in (("tree", fused_f32), ("parent", parent_mod)):
                fns[label] = (lambda mod=mod: mod.train_bwd_data_f32(packed, act, g, noise)[0])
        else:
            packed, xyz, dirs, app, noise = paper_case(m)
            for label, mod in (("tree", fused_f32), ("parent", parent_mod)):
                if kind == "eval":
                    fns[label] = (lambda mod=mod: mod.fused_nerf_eval_f32(packed, xyz, dirs,
                                                                          app))
                else:
                    fns[label] = (lambda mod=mod: mod.fused_nerf_train_fwd_f32(
                        packed, xyz, dirs, app, noise)[0])
        with torch.no_grad():
            outs = {k: f() for k, f in fns.items()}
            diff = ((outs["tree"] - outs["parent"]).norm() / outs["parent"].norm()).item()
            del outs
            got = {"tree": [], "parent": []}
            for _ in range(3):
                for label in ("tree", "parent", "parent", "tree"):
                    got[label].append(round(ms(fns[label]), 3))
        print(f"f32 {kind}, fg fine ({m} points), turns tree/parent/parent/tree x 3: tree "
              f"{got['tree']} (median {statistics.median(got['tree']):.3f}) ms, parent "
              f"{got['parent']} (median {statistics.median(got['parent']):.3f}) ms; output "
              f"relative difference {diff:.3e}")
        del fns, packed
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout of an earlier commit: its f32 kernels timed in "
                             "turns beside this checkout's")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("f32_fwd_probe: no CUDA device", file=sys.stderr)
        return 2
    from mega_nerf_tpu_torch.render import _build

    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "probe.cu").write_text(PROBE_CU)
    jobs = [*start_copies(), nvcc("probe", [OUT / "probe.cu"], OUT / "probe.so")]
    if args.parent is not None:
        src = OUT / "parent"
        shutil.rmtree(src, ignore_errors=True)
        shutil.copytree(args.parent / "mega_nerf_tpu_torch" / "render" / "csrc", src)
        jobs += [nvcc(f"parent {n}", [src / f"{n}.cu"], src / f"lib{n}.so")
                 for n in ("eval_f32", "train_f32")]
    for name, log in _build.build_all().items():
        if name in ("eval_f32", "train_f32"):
            ptxas_lines(name, log)
    for name, proc in jobs:
        finish(name, proc)
    lib = ctypes.CDLL(str(OUT / "probe.so"))
    vp = ctypes.c_void_p
    lib.l2_read_launch.argtypes = [vp, ctypes.c_longlong, ctypes.c_int, vp, ctypes.c_int, vp]
    lib.l2_read_launch.restype = ctypes.c_int
    lib.wgmma_rate_launch.argtypes = [ctypes.c_int, vp, ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, vp]
    lib.wgmma_rate_launch.restype = ctypes.c_int
    rates(lib)
    variants()
    stamps()
    bwd_variants()
    bwd_stamps()
    if args.parent is not None:
        turns(load_parent(args.parent))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
