#!/usr/bin/env python3
"""Probe of the PyTorch/CUDA port's f32 forward (the eval kernel and the
training forward of `--compute_dtype float32`, 3xTF32 on wgmma) on one
NVIDIA GPU.

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
4. With --parent DIR (a checkout of a commit whose f32 forward is the FFMA
   chain over transposed weights, e.g. the commit before the tensor-core
   forward): the parent's `eval_f32_kernel` and training forward, built
   from DIR's sources and called through DIR's `render/fused_f32.py`, and
   this checkout's, in turns (tree, parent, parent, tree; three rounds) at
   the paper model's fg-fine shapes: eval 8,388,608 points, training
   forward 524,288 points (one 1024-ray step); the relative difference of
   the two outputs.

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
    "no_products": ([("    issue(ch, ah0, al0, ring.base + st0 * STAGE_BYTES + half, c % CHAIN_STAGES == 0);\n",
                      ""),
                     ("      issue(ch, ah1, al1, ring.base + st1 * STAGE_BYTES + half, false);\n",
                      "")], None, True),
    "no_products_w_only": ([("    issue(ch, ah0, al0, ring.base + st0 * STAGE_BYTES + half, c % CHAIN_STAGES == 0);\n",
                      ""),
                            ("      issue(ch, ah1, al1, ring.base + st1 * STAGE_BYTES + half, false);\n",
                             ""),
                            ("mbar_expect_tx(full + st, 2 * bytes);", "mbar_expect_tx(full + st, bytes);"),
                            ("""tma_load_keep(stage + BOX_BYTES, &maps.wlo[li], sg.kw + j * BK, BN * nb,
                            full + st);""", "")], None, True),
    "no_products_no_frags": ([("    issue(ch, ah0, al0, ring.base + st0 * STAGE_BYTES + half, c % CHAIN_STAGES == 0);\n",
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
    ("    if (p.x_off == p.y_off) consumer_sync();  // every read of the input done\n",
     "    stamp(m0 / p.tm, 3 + 3 * li);\n    if (p.x_off == p.y_off) consumer_sync();\n"
     "    stamp(m0 / p.tm, 4 + 3 * li);\n"),
    ("  }\n  consumer_sync();\n}\n", "  }\n  consumer_sync();\n  stamp(m0 / p.tm, 5 + 3 * li);\n}\n"),
    ("  float* sig = reinterpret_cast<float*>(smem + p.sig_off);\n\n",
     "  float* sig = reinterpret_cast<float*>(smem + p.sig_off);\n  stamp(blockIdx.x, 0);\n\n"),
    ("  consumer_sync();\n\n  float acc0[32], acc1[32], ch[32];",
     "  consumer_sync();\n  stamp(blockIdx.x, 1);\n\n  float acc0[32], acc1[32], ch[32];"),
    ("      if (p.AP) app_tile(p, m0, appt);\n    }\n  }\n",
     "      if (p.AP) app_tile(p, m0, appt);\n    }\n    stamp(blockIdx.x, 60);\n  }\n"),
    ("           p.has_branch ? p.D / 2 : p.D, sig, m0, threadIdx.x);\n}\n",
     "           p.has_branch ? p.D / 2 : p.D, sig, m0, threadIdx.x);\n  stamp(blockIdx.x, 61);\n}\n"),
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
        if "Function properties" in line and ("f32_fwd" in line or "eval_f32" in line):
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


def edited(edits, what: str, once: bool = False) -> str:
    """f32_forward.cuh with `edits` applied (every occurrence, or exactly
    one with `once`); exits naming `what` where an edit no longer
    matches."""
    from mega_nerf_tpu_torch.render import _build

    text = (_build.CSRC / "f32_forward.cuh").read_text()
    for old, new in edits:
        if old not in text or (once and text.count(old) != 1):
            raise SystemExit(f"f32_fwd_probe: {what} no longer matches f32_forward.cuh: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    return text


def start_variants():
    """Start one nvcc per FWD_VARIANTS copy of eval_f32.cu (beside the
    checkout's headers, f32_forward.cuh edited) -> [(name, proc)]."""
    from mega_nerf_tpu_torch.render import _build

    jobs = []
    texts = {name: edited(edits, f"variant {name}") for name, (edits, _, _) in
             FWD_VARIANTS.items()}
    edited(FWD_STAMPS, "the stamps", once=True)  # every edit checked before any build
    for name, text in texts.items():
        out = OUT / f"var_{name}"
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        for src in _build.CSRC.glob("*.cuh"):
            shutil.copy(src, out / src.name)
        shutil.copy(_build.CSRC / "eval_f32.cu", out / "eval_f32.cu")
        (out / "f32_forward.cuh").write_text(text)
        jobs.append(nvcc(f"var {name}", [out / "eval_f32.cu"], out / "libeval_f32.so"))
    return jobs


def start_stamps():
    """Start nvcc on the FWD_STAMPS copy of eval_f32.cu -> (name, proc)."""
    from mega_nerf_tpu_torch.render import _build

    text = edited(FWD_STAMPS, "the stamps", once=True)
    out = OUT / "stamps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for src in _build.CSRC.glob("*.cuh"):
        shutil.copy(src, out / src.name)
    shutil.copy(_build.CSRC / "eval_f32.cu", out / "eval_f32.cu")
    (out / "f32_forward.cuh").write_text(text)
    return nvcc("stamps", [out / "eval_f32.cu"], out / "libeval_f32.so")


def stamps() -> None:
    """The stamped copy at fg fine: each phase's mean time over the first
    STAMP_TILES tiles, beside each layer's products at the card's 495
    TFLOP/s of TF32 (an SM's share)."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch.render import fused_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    packed, xyz, dirs, app, _ = paper_case(1024 * 8192)
    lib = bind_eval(OUT / "stamps" / "libeval_f32.so")
    lib.fwd_read_stamps.argtypes = [ctypes.c_void_p]
    lib.fwd_read_stamps.restype = ctypes.c_int
    tree = fused_f32._eval_lib
    fused_f32._eval_lib = lambda: lib
    try:
        with torch.no_grad():
            fused_f32.fused_nerf_eval_f32(packed, xyz, dirs, app)
            t = ms(lambda: fused_f32.fused_nerf_eval_f32(packed, xyz, dirs, app), 1)
    finally:
        fused_f32._eval_lib = tree
    buf = np.zeros(STAMP_TILES * 64, np.uint64)
    if lib.fwd_read_stamps(buf.ctypes.data):
        raise RuntimeError("fwd_read_stamps failed")
    st = buf.reshape(STAMP_TILES, 64).astype(np.float64) / 1e3  # ns -> us
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
    total = st[:, 61] - st[:, 0]
    per_tile = t * 1e3 / (-(-xyz.shape[0] // 64) / sms)
    print(f"f32 eval fg fine, stamped copy: {t:.3f} ms; a CTA {total.mean():.2f} us from its "
          f"first stamp to its last (mean of {STAMP_TILES}), {per_tile:.2f} us of an SM's "
          f"time a CTA")
    products = sum(r[1].mean() for r in rows if "products" in r[0])
    ideal_all = sum(r[2] for r in rows if r[2] is not None)
    for name, d, ideal in rows:
        extra = "" if ideal is None else f" (at 495 TFLOP/s: {ideal:.2f} us)"
        print(f"  {name}: {d.mean():.2f} us ({d.mean() / total.mean():.1%}){extra}")
    print(f"  all products {products:.2f} us against {ideal_all:.2f} us at 495 TFLOP/s")


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


def paper_case(m: int, seed: int = 5):
    """The paper model's fg MLP in f32 (seeded weights, small random biases)
    on the card, packed, and m seeded points -> (packed, xyz, dirs, app,
    noise)."""
    import torch

    from mega_nerf_tpu_torch.eval import get_eval_opts
    from mega_nerf_tpu_torch.models import init_weights, make_nerf
    from mega_nerf_tpu_torch.render import fused_mlp

    hp = get_eval_opts(["--exp_name", "unused", "--dataset_path", "unused",
                        "--pos_xyz_dim", "12", "--pos_dir_dim", "4", "--layers", "8",
                        "--skip_layers", "4", "--layer_dim", "256", "--bg_layer_dim", "256",
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


def load_parent(parent: Path):
    """DIR's render/fused_f32.py as module `parent_fused_f32`, its kernel
    libraries built from DIR's sources (started by the caller)."""
    spec = importlib.util.spec_from_file_location(
        "parent_fused_f32", parent / "mega_nerf_tpu_torch" / "render" / "fused_f32.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    libs = {}
    for name, exports in (("eval_f32", [("eval_f32_launch", 5)]),
                          ("train_f32", [("train_f32_fwd_launch", 7),
                                         ("train_f32_bwd_launch", 5),
                                         ("weight_grad_f32_launch", 3)])):
        lib = ctypes.CDLL(str(OUT / "parent" / f"lib{name}.so"))
        for fn, nargs in exports:
            getattr(lib, fn).argtypes = [ctypes.c_void_p] * nargs
            getattr(lib, fn).restype = ctypes.c_int
        lib.error_string = getattr(lib, f"{name}_error_string")
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    mod._eval_lib = lambda: libs["eval_f32"]
    mod._train_lib = lambda: libs["train_f32"]
    return mod


def turns(parent_mod) -> None:
    """4: the tree's and the parent's forwards in turns at fg fine."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32

    torch.backends.cuda.matmul.allow_tf32 = False
    for kind, m in (("eval", 1024 * 8192), ("training forward", 1024 * 512)):
        packed, xyz, dirs, app, noise = paper_case(m)
        fns = {}
        for label, mod in (("tree", fused_f32), ("parent", parent_mod)):
            if kind == "eval":
                fns[label] = (lambda mod=mod: mod.fused_nerf_eval_f32(packed, xyz, dirs, app))
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
        del packed, xyz, dirs, app, noise
        torch.cuda.empty_cache()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout whose f32 forward is the FFMA chain: timed in "
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
    jobs = [*start_variants(), start_stamps(), nvcc("probe", [OUT / "probe.cu"], OUT / "probe.so")]
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
    if args.parent is not None:
        turns(load_parent(args.parent))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
