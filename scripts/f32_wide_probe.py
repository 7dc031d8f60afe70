#!/usr/bin/env python3
"""Probe of the PyTorch/CUDA port's f32 kernels at their main shapes on one
NVIDIA GPU.

    python3 scripts/f32_wide_probe.py [--parent DIR] [--no_gemm]

1. Unless --no_gemm, the f32 wide GEMM (`wide_f32_gemm_kernel` of
   `mega_nerf_tpu_torch/render/csrc/wide_f32.cu`) at 524,288 points x 1024
   x 1024, as a forward layer (bias, ReLU) and as a masked dX job, with its
   launch bounds as committed, (256, 2), against a copy with (256, 1), in
   turns ((256, 2), (256, 1), (256, 1), (256, 2)); the two copies' layer
   outputs must be equal bit for bit.
2. With --parent DIR, a checkout of a commit whose f32 weight gradient is
   the FFMA pair (`train_f32.cu`'s `wg_partial_kernel`, per-job operands,
   11 values a job row): that pair against this checkout's (3xTF32 on
   `mma.sync`) and four variants of it (one chain a split; chains of 16
   k-steps; 32-point stages; cvt.rna for both halves of the split) and
   one f32 `torch.mm` a job (TF32 off), in turns (tree, variants, parent,
   `torch.mm`, then back), at the paper model's fg-fine pass (524,288
   points, width 256, f32) and at one 1024 x 1024 layer's dW step of the
   wide route;
   each copy's relative error against f64 sums of the same rows, whether
   the variants equal the tree bit for bit and whether the tree repeats;
   the SASS opcode counts of both kernels (cuobjdump); and before them the
   card's mma.sync TF32 rate with operands in registers (`mma_peak`), the
   ceiling of that design.

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


def gemm_launch_bounds() -> None:
    import torch

    from mega_nerf_tpu_torch.render import _build
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf
    from mega_nerf_tpu_torch.render.fused_train_wide import DX_MASK

    src = (_build.CSRC / "wide_f32.cu").read_text()
    key = "__launch_bounds__(NT, 2) wide_f32_gemm_kernel"
    if key not in src:
        raise RuntimeError(f"wide_f32.cu no longer holds {key!r}")
    built = build_many([("gemm_lb2", src, "wide_f32_gemm_kernel"),
                        ("gemm_lb1", src.replace(key, key.replace("2)", "1)")),
                         "wide_f32_gemm_kernel")])
    libs = {"(256, 2)": built["gemm_lb2"], "(256, 1)": built["gemm_lb1"]}
    for lib in libs.values():
        lib.wide_f32_gemm_launch.argtypes = [ctypes.c_void_p] * 3
        lib.wide_f32_gemm_launch.restype = ctypes.c_int
        lib.error_string = lib.wide_f32_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
    dev, d = torch.device("cuda"), 1024
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((M, d), generator=gen, device=dev)
    mask = torch.randn((M, d), generator=gen, device=dev)
    w = torch.randn((d, d), generator=gen, device=dev) / 32
    b = torch.randn(d, generator=gen, device=dev)
    y = torch.empty((M, d), device=dev)
    times, outs = {k: [] for k in libs}, {}
    library = fwf._library
    try:
        for name in ("(256, 2)", "(256, 1)", "(256, 1)", "(256, 2)"):
            fwf._library = lambda lib=libs[name]: lib
            layer = ms(lambda: fwf.wide_f32_layer([x], w, b, True, y), 5)
            outs[name] = y.clone()
            dx = ms(lambda: fwf.wide_f32_dx(x, w, 0, d, DX_MASK, mask), 5)
            times[name].append((round(layer, 3), round(dx, 3)))
    finally:
        fwf._library = library
    print(f"wide_f32_gemm at {M} x {d} x {d}, (layer, masked dX) ms in turns: {times}; "
          f"layer outputs bit-equal: {torch.equal(outs['(256, 2)'], outs['(256, 1)'])}")


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
                        help="a checkout whose f32 weight gradient is the FFMA pair with "
                             "per-job operands")
    parser.add_argument("--no_gemm", action="store_true",
                        help="skip the wide GEMM's launch-bounds comparison")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("f32_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    if not args.no_gemm:
        gemm_launch_bounds()
    if args.parent is not None:
        mma_peak()
        weight_grad_parent(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
