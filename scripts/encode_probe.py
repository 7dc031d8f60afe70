#!/usr/bin/env python3
"""Probe of the PyTorch/CUDA port's wide encode kernel on one NVIDIA GPU.

    python3 scripts/encode_probe.py --parent DIR [--tree] [--out OUT]

DIR is a checkout of the commit whose `eval_wide_encode_kernel` (the one
thread per point and 8-column piece design) is split. The script writes
copies of that commit's `mega_nerf_tpu_torch/render/csrc/eval_wide.cu`
under `.exp/encode_probe/` with string edits, builds each with nvcc for
sm_90a (all at once), and times each copy's encode launch at one 524,288-point
sub-chunk of the fg (xyz_dim 3) and bg (xyz_dim 4) shapes, with 12 xyz and 4
dir frequencies:

- base: the kernel as it is;
- nosin: `sinf(arg)` replaced by `arg`;
- fastsin: `sinf` replaced by the `__sinf` intrinsic;
- nodiv: the per-item 64-bit division and the per-column division by d
  replaced by divisions by compile-time constants;
- nostore: the 16-byte stores kept behind a condition no value meets.

With --tree it also times copies of this checkout's kernel (one lane per
point and coordinate, staged rows) at the same shapes, in turns with the
parent's copies:

- tree: the kernel as it is;
- tree_lb6: launch bounds asking for six CTAs per SM (40 registers);
- tree_unroll2: the frequency loop unrolled by two;
- tree_cta128: CTAs of 128 threads on tiles of 64 points;
- tree_cs: the rows stored with the streaming (evict-first) hint;
- tree_cvt: q = rint(a 2/pi) and its float by conversion instructions (as
  sinf), and one bf16 conversion per column;
- tree_nosin: the reduction and polynomial replaced by the identity;
- tree_nostore: the staged rows not stored.

It prints each copy's ptxas line for the encode kernel (registers, stack
frame, spills), writes the base copy's SASS for the kernel (and the
tree's, with --tree) into OUT (default `.exp/encode_probe/`) and
counts its instructions, reads the SM clock (CUDA events around
`torch.cuda._sleep`), and writes the PTX of a kernel calling `sinf` into
OUT with its f32 constants printed. Needs one card and nvcc.
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
SRC = Path("mega_nerf_tpu_torch/render/csrc/eval_wide.cu")
NVCC = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
M = 524_288

STORE_ENC = """      *reinterpret_cast<uint4*>(p.enc + m * p.EP + 8 * piece) =
          encode_piece(x0, x1, x2, x3, d, p.nf_xyz, 8 * piece);"""
STORE_DIR = """      *reinterpret_cast<uint4*>(p.dir + m * p.DP + 8 * q) =
          encode_piece(x0, x1, x2, x3, d, p.nf_dir, 8 * q);"""
NEVER = ("{{ const uint4 u_ = encode_piece(x0, x1, x2, x3, d, p.{nf}, 8 * {c});\n"
         "        if ((u_.x & u_.y & u_.z & u_.w) == 0xFFFFFFFFu)\n"
         "          *reinterpret_cast<uint4*>(p.{out} + m * p.{ld} + 8 * {c}) = u_; }}")
EDITS = {
    "base": [],
    "nosin": [("v[e] = sinf(arg);", "v[e] = arg;")],
    "fastsin": [("v[e] = sinf(arg);", "v[e] = __sinf(arg);")],
    "nodiv": [("const long long m = idx / (pe + pd);",
               "const long long m = pe + pd == 14 ? idx / 14 : idx / 18;"),
              ("const int j = c / d;", "const int j = d == 3 ? c / 3 : c / 4;")],
    "nostore": [(STORE_ENC, NEVER.format(nf="nf_xyz", c="piece", out="enc", ld="EP")),
                (STORE_DIR, NEVER.format(nf="nf_dir", c="q", out="dir", ld="DP"))],
}

TREE_EDITS = {
    "tree": [],
    "tree_lb6": [("__launch_bounds__(ENCODE_THREADS)\neval_wide_encode_kernel",
                  "__launch_bounds__(ENCODE_THREADS, 6)\neval_wide_encode_kernel")],
    "tree_unroll2": [("  for (int k = 0; k < nf; ++k, col += 2 * DD) {",
                      "#pragma unroll 2\n  for (int k = 0; k < nf; ++k, col += 2 * DD) {")],
    "tree_cta128": [("constexpr int ENCODE_THREADS = 256;", "constexpr int ENCODE_THREADS = 128;")],
    "tree_cs": [("    reinterpret_cast<uint4*>(dst)[g] = make_uint4(src[0], src[1], src[2], src[3]);",
                 "    __stcs(reinterpret_cast<uint4*>(dst) + g, make_uint4(src[0], src[1], src[2], "
                 "src[3]));")],
    "tree_cvt": [("  const float t = __fadd_rn(__fmul_rn(a, cf(TWO_OVER_PI)), cf(ROUNDER));\n"
                  "  const int q = __float_as_int(t);\n"
                  "  const float j = __fsub_rn(t, cf(ROUNDER));",
                  "  const int q = __float2int_rn(__fmul_rn(a, cf(TWO_OVER_PI)));\n"
                  "  const float j = __int2float_rn(q);"),
                 ("    const __nv_bfloat162 pair = __floats2bfloat162_rn(sa, sb);",
                  "    __nv_bfloat162 pair;\n    pair.x = __float2bfloat16_rn(sa);\n"
                  "    pair.y = __float2bfloat16_rn(sb);")],
    "tree_nosin": [("__device__ __forceinline__ float sin_reduced(float a) {",
                    "__device__ __forceinline__ float sin_reduced(float a) {\n  return a;")],
    "tree_nostore": [("    store_tile(enc_s,", "    if (p.M < 0) store_tile(enc_s,"),
                     ("if (p.DP) store_tile(dir_s,", "if (p.M < 0) store_tile(dir_s,")],
}

SIN_PTX = r"""
extern "C" __global__ void sin_probe(const float* in, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = sinf(in[i]);
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    sys.exit("nvcc not found")


def build(work: Path, variants: dict) -> dict:
    """variants: {name: (checkout, edits)} -> {name: nvcc log}."""
    procs = {}
    for name, (root, edits) in variants.items():
        src = (root / SRC).read_text()
        for old, new in edits:
            if src.count(old) != 1:
                sys.exit(f"{name}: edit target not found once: {old[:60]!r}")
            src = src.replace(old, new)
        (work / f"{name}.cu").write_text(src)
        cmd = [nvcc(), *NVCC, "-o", str(work / f"lib{name}.so"), str(work / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{logs[name]}")
    return logs


def ptxas_line(log_text: str, kernel: str) -> str:
    """The ptxas -v lines that follow each of the kernel's 'Compiling entry'
    lines (one per template instance)."""
    lines = log_text.splitlines()
    found = [" | ".join(s.split("info    : ")[-1] for s in lines[i + 1:i + 4])
             for i, line in enumerate(lines) if "Compiling entry" in line and kernel in line]
    return " || ".join(found) or "not found"


def sass_of(lib: Path, kernel: str) -> list:
    out = subprocess.run(["cuobjdump", "-sass", str(lib)], capture_output=True,
                         text=True).stdout
    body, inside = [], False
    for line in out.splitlines():
        if line.strip().startswith("Function :"):
            inside = kernel in line
            continue
        if inside and re.search(r"/\*[0-9a-f]{4,5}\*/", line):
            body.append(line.strip())
    return body


def sm_clock_ghz(torch) -> float:
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / (a.elapsed_time(b) * 1e6)


def inputs(torch, xyz_dim: int):
    gen = torch.Generator().manual_seed(7 + xyz_dim)
    if xyz_dim == 3:
        xyz = 1.5 * (2 * torch.rand((M, 3), generator=gen) - 1)
    else:
        p = torch.randn((M, 3), generator=gen)
        xyz = torch.cat([p / p.norm(dim=-1, keepdim=True),
                         torch.rand((M, 1), generator=gen)], -1)
    d = torch.randn((M, 3), generator=gen)
    return xyz.cuda().contiguous(), (d / d.norm(dim=-1, keepdim=True)).cuda().contiguous()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--tree", action="store_true")
    ap.add_argument("--out", type=Path, default=ROOT / ".exp" / "encode_probe")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    work = ROOT / ".exp" / "encode_probe"
    work.mkdir(parents=True, exist_ok=True)
    args.out.mkdir(parents=True, exist_ok=True)
    variants = {n: (args.parent.resolve(), e) for n, e in EDITS.items()}
    if args.tree:
        variants.update({n: (ROOT, e) for n, e in TREE_EDITS.items()})
    logs = build(work, variants)
    for name in variants:
        log(f"ptxas {name}: {ptxas_line(logs[name], 'eval_wide_encode_kernel')}")
    body = sass_of(work / "libbase.so", "eval_wide_encode_kernel")
    (args.out / "base_encode.sass").write_text("\n".join(body) + "\n")
    ops = {}
    for line in body:
        m = re.search(r"\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if m:
            ops[m.group(2).split(".")[0]] = ops.get(m.group(2).split(".")[0], 0) + 1
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:24]
    log(f"base encode SASS: {len(body)} instructions; by opcode: {top}")
    if args.tree:
        body = sass_of(work / "libtree.so", "eval_wide_encode_kernel")
        (args.out / "tree_encode.sass").write_text("\n".join(body) + "\n")
        log(f"tree encode SASS (both instances): {len(body)} instructions")

    ptx = work / "sin_probe.cu"
    ptx.write_text(SIN_PTX)
    subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-ptx",
                    "-o", str(args.out / "sinf.ptx"), str(ptx)], check=True)
    text = (args.out / "sinf.ptx").read_text()
    consts = []
    for h in re.findall(r"0f([0-9A-F]{8})", text):
        v = torch.tensor([int(h, 16)], dtype=torch.int64).to(torch.int32).view(
            torch.float32).item()
        consts.append(f"0f{h}={v:.9g}")
    log(f"sinf PTX: {len(text.splitlines())} lines; f32 constants in order: {consts}")

    name_limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True,
                                text=True).stdout.strip()
    log(f"card: {name_limit}")
    shapes = {"fg": (3, 80), "bg": (4, 112)}
    data = {k: inputs(torch, d) for k, (d, _) in shapes.items()}
    libs = {n: ctypes.CDLL(str(work / f"lib{n}.so")) for n in variants}
    sys.path.insert(0, str(ROOT))
    from mega_nerf_tpu_torch.render.fused_mlp import encode
    from mega_nerf_tpu_torch.render.fused_wide import encode_plan, encode_smem
    for lib in libs.values():
        lib.eval_wide_encode_launch.argtypes = [ctypes.c_void_p] * 3
        lib.eval_wide_encode_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for shape, (d, ep) in shapes.items():
        xyz, dirs = data[shape]
        enc = torch.empty((M, ep), dtype=torch.bfloat16, device="cuda")
        dr = torch.empty((M, 32), dtype=torch.bfloat16, device="cuda")
        ptrs = (ctypes.c_longlong * 4)(xyz.data_ptr(), dirs.data_ptr(), enc.data_ptr(),
                                       dr.data_ptr())
        dims = (ctypes.c_int * 6)(M, d, 12, 4, ep, 32)
        tree_dims = (ctypes.c_int * 8)(M, d, 12, 4, ep, 32, *encode_plan(d, ep, 32))
        if args.tree:  # the tree's kernel against the plain version, bit for bit
            ref = torch.cat([encode(xyz, 12, ep), encode(dirs, 4, 32)], 1).to(torch.bfloat16)
            err = libs["tree"].eval_wide_encode_launch(ptrs, tree_dims, ctypes.c_void_p(stream))
            torch.cuda.synchronize()
            got = torch.cat([enc, dr], 1)
            log(f"{shape} tree against plain: launch {err}, bf16 bit-equal "
                f"{100 * (got.view(torch.int16) == ref.view(torch.int16)).float().mean().item():.5f}%")
        for turn in range(2):  # every variant twice, in turns
            for name, lib in libs.items():
                dm = tree_dims if name.startswith("tree") else dims
                if name == "tree_cta128":
                    dm = (ctypes.c_int * 8)(M, d, 12, 4, ep, 32, 64, encode_smem(64, d, ep, 32))

                def launch():
                    err = lib.eval_wide_encode_launch(ptrs, dm, ctypes.c_void_p(stream))
                    if err:
                        raise RuntimeError(f"{name}: launch error {err}")
                for _ in range(3):
                    launch()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    launch()
                b.record()
                torch.cuda.synchronize()
                results.setdefault((shape, name), []).append(a.elapsed_time(b) / 20)
        fill = lambda: (enc.zero_(), dr.zero_())  # noqa: E731
        fill()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fill()
        b.record()
        torch.cuda.synchronize()
        results[(shape, "zero_ (same output bytes)")] = [a.elapsed_time(b) / 20]
        clock = sm_clock_ghz(torch)
        items = M * (ep // 8 + 4)
        for (s, name), ts in results.items():
            if s != shape:
                continue
            t = min(ts)
            per_item = t * 1e-3 * clock * 1e9 * 4 * 132 / (items / 32) if "zero" not in name \
                else float("nan")
            log(f"{shape} {name}: {' / '.join(f'{x:.4f}' for x in ts)} ms "
                f"(SM clock {clock:.3f} GHz; {per_item:.0f} scheduler issue slots per "
                f"warp of 8-column items at that clock)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
