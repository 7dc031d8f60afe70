#!/usr/bin/env python3
"""Probe of the PyTorch/CUDA port's wide encode kernels on one NVIDIA GPU.

    python3 scripts/encode_probe.py --parent DIR [--tree] [--out OUT]
    python3 scripts/encode_probe.py --f32 --parent DIR [--step] [--out OUT]

The bf16 mode (without --f32) splits `eval_wide.cu`'s encode, as below. The
f32 mode (`f32_probe`) times `wide_f32.cu`'s encode: DIR is then a checkout
of the commit whose `wide_f32_encode_kernel` is the one thread per element
design (its `mega_nerf_tpu_torch/render/csrc/` is enough), built beside
copies of this checkout's kernel and its variants (`F32_EDITS`); each
(variant, tile) of `F32_TILES` is held `torch.equal` to the parent's
kernel (fg, bg, ragged M, past the reduction limit, xyz_dim 1 and 2), then
timed in turns with it at the fg and bg shapes beside a `zero_` of the same
output bytes; it prints each copy's ptxas line, the SASS instruction count
of each loop of the parent's and the tree's kernel per trig column, and the
card's name and power limit (~1.5 min of card time). With --step it also
runs the wide f32 training step and view with the parent's library, the
tree's and `tree_wb`'s in turns (`f32_step_and_view`, ~3 min more). It
also times the host's cost of a launch of the parent's kernel and the
tree's.

In the bf16 mode, DIR is a checkout of the commit whose `eval_wide_encode_kernel` (the one
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
import time
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


F32_SRC = Path("mega_nerf_tpu_torch/render/csrc/wide_f32.cu")
F32_SHAPES = {"fg": (3, 80), "bg": (4, 112)}  # xyz_dim, EP; 12 / 4 frequencies, DP 32

_F32_READS = """    uint32_t b0 = src[rot], b1 = src[(rot + 1) & 3], b2 = src[(rot + 2) & 3],
             b3 = src[(rot + 3) & 3], t;
    if (rot & 1) t = b3, b3 = b2, b2 = b1, b1 = b0, b0 = t;
    if (rot & 2) t = b0, b0 = b2, b2 = t, t = b1, b1 = b3, b3 = t;
"""
_F32_STORE = "    __stcs(reinterpret_cast<uint4*>(dst) + g, make_uint4(b0, b1, b2, b3));"
_F32_PREV_STORES = """      store_tile(enc_s, p.enc_stride, p.enc + prev_m0 * p.EP, prev_n * (p.EP / 4), ew);
      if (p.DP) store_tile(dir_s, p.dir_stride, p.dir + prev_m0 * p.DP, prev_n * (p.DP / 4), dw);
"""
# String edits of this checkout's wide_f32.cu, each an exact source string.
F32_EDITS = {
    "tree": [],
    # Two buffers of coordinates and staged rows, one barrier a tile: tile
    # t's rows are stored while tile t + 1's sines run.
    "tree_db": [
        ("""  float* xyz_s = reinterpret_cast<float*>(enc_smem);
  float* dirs_s = xyz_s + p.tile * D;
  uint8_t* enc_s = reinterpret_cast<uint8_t*>(dirs_s + p.tile * 3);
  uint8_t* dir_s = enc_s + p.tile * p.enc_stride;
""", """  const int buf_bytes = p.tile * (D + 3) * 4 + p.tile * (p.enc_stride + p.dir_stride);
  float* xyz_s;
  float* dirs_s;
  uint8_t* enc_s;
  uint8_t* dir_s;
  const auto use = [&](int b) {
    xyz_s = reinterpret_cast<float*>(enc_smem + b * buf_bytes);
    dirs_s = xyz_s + p.tile * D;
    enc_s = reinterpret_cast<uint8_t*>(dirs_s + p.tile * 3);
    dir_s = enc_s + p.tile * p.enc_stride;
  };
"""),
        ("  for (int r = warp; r < p.tile; r += ENCODE_THREADS / 32) {",
         "  for (int b = 0; b < 2; ++b)\n"
         "  for (int r = (use(b), warp); r < p.tile; r += ENCODE_THREADS / 32) {"),
        ("  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {\n",
         "  long long prev_m0 = 0;\n  int prev_n = 0, buf = 0;\n"
         "  for (int t = blockIdx.x; t < tiles; t += gridDim.x, buf ^= 1) {\n    use(buf);\n"),
        ("    if (t + (int)gridDim.x < tiles) fetch(t + gridDim.x);\n",
         "    if (t + (int)gridDim.x < tiles) fetch(t + gridDim.x);\n    if (prev_n) {\n"
         "      use(buf ^ 1);\n" + _F32_PREV_STORES + "      use(buf);\n    }\n"),
        ("""    __syncthreads();  // the staged rows are complete
    store_tile(enc_s, p.enc_stride, p.enc + m0 * p.EP, n * (p.EP / 4), ew);
    if (p.DP) store_tile(dir_s, p.dir_stride, p.dir + m0 * p.DP, n * (p.DP / 4), dw);
  }
""", """    prev_m0 = m0;
    prev_n = n;
  }
  __syncthreads();
  if (prev_n) {
    use(buf ^ 1);
""" + _F32_PREV_STORES + "  }\n"),
        ("  return tile * (d + 3) * 4 + tile * (4 * ep + 4) + (dp ? tile * (4 * dp + 4) : 0);",
         "  return 2 * (tile * (d + 3) * 4 + tile * (4 * ep + 4) + (dp ? tile * (4 * dp + 4) : 0));"),
    ],
    # The staged rows' words read in order (lanes l, l + 8, l + 16, l + 24
    # in one bank: 4-way conflicts), as eval_wide.cu reads them.
    "tree_conflicts": [(_F32_READS + _F32_STORE,
                        "    __stcs(reinterpret_cast<uint4*>(dst) + g, make_uint4(src[0], "
                        "src[1], src[2], src[3]));")],
    # The row stores without the streaming (evict-first) hint.
    "tree_wb": [(_F32_STORE, "    reinterpret_cast<uint4*>(dst)[g] = "
                             "make_uint4(b0, b1, b2, b3);")],
    # Diagnostics: no sines (the reduction and polynomial are the identity);
    # no row stores.
    "tree_nosin": [("__device__ __forceinline__ float sin_reduced(float a) {",
                    "__device__ __forceinline__ float sin_reduced(float a) {\n  return a;")],
    "tree_nostore": [("    store_tile(enc_s,", "    if (p.M < 0) store_tile(enc_s,"),
                     ("    if (p.DP) store_tile(dir_s,", "    if (p.M < 0) store_tile(dir_s,")],
}
# (variant, tile) pairs timed; the tile's shared memory is encode_smem's
# (twice it for the double-buffered copies). None: fused_wide.encode_plan's
# tile.
F32_TILES = [("tree", None), ("tree", 64), ("tree", 32), ("tree_conflicts", None),
             ("tree_wb", None), ("tree_db", 64), ("tree_db", 128), ("tree_nosin", None),
             ("tree_nostore", None)]


def f32_build(work: Path, variants: dict) -> dict:
    """variants: {name: (checkout, edits)} -> {name: nvcc log}; each copy in
    its own directory beside its checkout's `.cuh` files."""
    procs = {}
    for name, (root, edits) in variants.items():
        src = (root / F32_SRC).read_text()
        for old, new in edits:
            if src.count(old) != 1:
                sys.exit(f"{name}: edit target not found once: {old[:60]!r}")
            src = src.replace(old, new)
        d = work / name
        d.mkdir(parents=True, exist_ok=True)
        for h in (root / F32_SRC).parent.glob("*.cuh"):
            shutil.copy(h, d / h.name)
        (d / "wide_f32.cu").write_text(src)
        cmd = [nvcc(), *NVCC, "-o", str(d / "libwide_f32.so"), str(d / "wide_f32.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    logs = {}
    for name, proc in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"nvcc failed for {name}:\n{logs[name]}")
    return logs


def sass_loops(body: list) -> list:
    """(instructions, sines, local-memory accesses) of each loop of a SASS
    listing (a branch back to an earlier address closes one); sines counts
    the FMULs by 2/pi, one per reduced argument, so instructions / sines is
    the loop's instructions a trig column."""
    rows = []
    for line in body:
        m = re.search(r"/\*([0-9a-f]{4,5})\*/\s+(.*)", line)
        if m:
            rows.append((int(m.group(1), 16), m.group(2)))
    found = []
    for addr, text in rows:
        b = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if b and int(b.group(1), 16) < addr:
            loop = [t for a, t in rows if int(b.group(1), 16) <= a <= addr]
            found.append((len(loop), sum("0.6366197" in t for t in loop),
                          sum(bool(re.search(r"\b(STL|LDL)\b", t)) for t in loop)))
    return found


def f32_inputs(torch, xyz_dim: int, m: int, spread: float = 1.0, seed: int = 7):
    """The renderer's ranges (fg xyz in [-1.5, 1.5], bg a unit vector and an
    inverse depth, unit dirs) times `spread`, at xyz_dim 1-4."""
    gen = torch.Generator().manual_seed(seed + xyz_dim)
    if xyz_dim == 4:
        p = torch.randn((m, 3), generator=gen)
        xyz = torch.cat([p / p.norm(dim=-1, keepdim=True), torch.rand((m, 1), generator=gen)], -1)
    else:
        xyz = 1.5 * (2 * torch.rand((m, xyz_dim), generator=gen) - 1)
    d = torch.randn((m, 3), generator=gen)
    return ((spread * xyz).cuda().contiguous(),
            (spread * d / d.norm(dim=-1, keepdim=True)).cuda().contiguous())


def f32_step_and_view(torch, work: Path, libs: dict) -> bool:
    """The wide f32 training step and view (fg and bg 8x1024, f32 compute,
    seeded random weights, `chip_smoke.py`'s scene and batches) with each
    of `libs` ({name: wide_f32 library}) as the port's `wide_f32` library,
    in turns: first one step's loss and gradients from the same state and
    the val view with each library and then the first one again, each held
    bit-equal to the first (only the encode differs between them); then, 4
    rounds in alternating order, ms a
    step over 3 chained steps after a warm-up step and s a view."""
    import tempfile

    import numpy as np

    import chip_smoke as cs
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import _build
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner

    tmp = Path(tempfile.mkdtemp(dir=work))
    ds = tmp / "dataset"
    cs.write_dataset(ds, hw=128, n_train=4, seed=11, smooth=True)
    runner = Runner(cs.train_hparams(ds, tmp / "exp", [*cs.WIDE_TRAIN, *cs.F32]),
                    set_experiment_path=False)
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(runner.hparams), 5e-4,
                     0.1, 1000, runner.sphere_center, runner.sphere_radius)
    device = runner.device
    batches = []
    for host in runner._make_dataset().batches(1024, np.random.default_rng(3)):
        batches.append({"rgbs": torch.from_numpy(host["rgbs"]).to(device),
                        "rays": torch.from_numpy(host["rays"]).to(device),
                        "img_indices": torch.from_numpy(host["img_indices"]).long().to(device)})
        if len(batches) == 4:
            break
    meta = runner.val_items[0]
    params = [q for b in (runner.fg, runner.bg) for q in b.module.parameters()]

    def loss_and_grads():
        for q in params:
            q.grad = None
        loss, _, _ = step.loss(batches[0], torch.Generator(device=device).manual_seed(5))
        loss.backward()
        return [loss.detach()] + [q.grad.detach().clone() for q in params if q.grad is not None]

    firsts = []  # each library, then the first again: is the step itself repeatable?
    for name in [*libs, next(iter(libs))]:
        _build._LIBS["wide_f32"] = libs[name]
        with torch.no_grad():
            view = runner.render_image(meta)
        firsts.append((name, (loss_and_grads(), view)))
    (g0, v0), same = firsts[0][1], True
    for name, (g, v) in firsts[1:]:
        g_eq = len(g) == len(g0) and all(torch.equal(a, b) for a, b in zip(g, g0))
        v_eq = all(np.array_equal(v[k], v0[k]) for k in v0)
        same &= g_eq and v_eq
        log(f"with {name}'s library against {next(iter(libs))}'s: the step's loss and "
            f"{len(g) - 1} gradients {'bit-equal' if g_eq else 'DIFFERENT'}; the val view's "
            f"{', '.join(sorted(v))} {'bit-equal' if v_eq else 'DIFFERENT'}")
    times = {}
    names = list(libs)
    for rnd in range(4):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            _build._LIBS["wide_f32"] = libs[name]
            step(batches[0])  # warm-up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[1:]:
                step(b)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / (len(batches) - 1) * 1e3
            t0 = time.perf_counter()
            with torch.no_grad():
                runner.render_image(meta)
            torch.cuda.synchronize()
            times.setdefault(name, []).append((step_ms, time.perf_counter() - t0))
    for name, ts in times.items():
        log(f"wide f32 step (fg + bg 8x1024, batch 1024) with {name}'s library: "
            f"{' / '.join(f'{a:.2f}' for a, _ in ts)} ms; the val view (128x128): "
            f"{' / '.join(f'{b:.4f}' for _, b in ts)} s")
    return same


def f32_probe(args) -> int:
    """The f32 mode: see the module docstring."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    from mega_nerf_tpu_torch.render.fused_wide import encode_plan, encode_smem

    work = ROOT / ".exp" / "encode_probe_f32"
    work.mkdir(parents=True, exist_ok=True)
    args.out.mkdir(parents=True, exist_ok=True)
    variants = {"parent": (args.parent.resolve(), [])}
    variants.update({n: (ROOT, e) for n, e in F32_EDITS.items()})
    logs = f32_build(work, variants)
    for name in variants:
        log(f"ptxas {name}: {ptxas_line(logs[name], 'wide_f32_encode_kernel')}")
    for name, kernel in (("parent", "wide_f32_encode_kernel"),
                         ("tree", "wide_f32_encode_kernelILi3E"),
                         ("tree", "wide_f32_encode_kernelILi4E")):
        body = sass_of(work / name / "libwide_f32.so", kernel)
        (args.out / f"{name}_{kernel}.sass").write_text("\n".join(body) + "\n")
        loops = sass_loops(body)
        per = [f"{n} instructions, {k} sines, {lm} local" + (f" ({n / k:.1f} a trig column)"
                                                              if k else "")
               for n, k, lm in sorted(loops)]
        log(f"{name} f32 encode SASS ({kernel}): {len(body)} instructions; loops: {per}")
    name_limit = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                 "--format=csv,noheader"], capture_output=True,
                                text=True).stdout.strip()
    log(f"card: {name_limit}")
    libs = {}
    for n in variants:
        lib = ctypes.CDLL(str(work / n / "libwide_f32.so"))
        lib.wide_f32_encode_launch.argtypes = [ctypes.c_void_p] * 3
        lib.wide_f32_encode_launch.restype = ctypes.c_int
        libs[n] = lib
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def launcher(name, tile, xyz, dirs, enc, dr, d, ep, dp):
        m = xyz.shape[0]
        ptrs = (ctypes.c_longlong * 4)(xyz.data_ptr(), dirs.data_ptr() if dp else 0,
                                       enc.data_ptr(), dr.data_ptr() if dp else 0)
        if name == "parent":
            dims = (ctypes.c_int * 6)(m, d, 12, 4 if dp else 0, ep, dp)
        else:
            t, smem = encode_plan(d, ep, dp, 4)
            if tile is not None:
                t, smem = tile, encode_smem(tile, d, ep, dp, 4)
            if name.endswith("_db"):
                smem *= 2
            dims = (ctypes.c_int * 8)(m, d, 12, 4 if dp else 0, ep, dp, t, smem)

        def launch():
            err = libs[name].wide_f32_encode_launch(ptrs, dims, stream)
            if err:
                raise RuntimeError(f"{name} (tile {tile}): launch error {err}")
        return launch

    def outputs(m, ep, dp):
        return (torch.full((m, ep), float("nan"), device="cuda"),
                torch.full((m, max(dp, 4)), float("nan"), device="cuda"))

    # Bit for bit: every kernel that computes the encode against the parent's.
    cases = [("fg", 3, 80, 32, M, 1.0), ("bg", 4, 112, 32, M, 1.0), ("fg ragged", 3, 80, 32, 1, 1.0),
             ("fg ragged", 3, 80, 32, 1000, 1.0), ("fg ragged", 3, 80, 32, 200_003, 1.0),
             ("bg ragged", 4, 112, 32, 200_003, 1.0),
             ("fg past the reduction limit", 3, 80, 32, 100_003, 1e4 / 1.5),
             ("bg past the reduction limit", 4, 112, 32, 100_003, 1e4 / 1.5),
             ("xyz_dim 1", 1, 32, 32, 1000, 1.0), ("xyz_dim 2, no dirs", 2, 64, 0, 1000, 1.0)]
    same = True
    for label, d, ep, dp, m, spread in cases:
        xyz, dirs = f32_inputs(torch, d, m, spread)
        ref = outputs(m, ep, dp)
        launcher("parent", None, xyz, dirs, *ref, d, ep, dp)()
        verdicts = []
        for name, tile in F32_TILES:
            if name in ("tree_nosin", "tree_nostore"):
                continue
            got = outputs(m, ep, dp)
            launcher(name, tile, xyz, dirs, *got, d, ep, dp)()
            ok = torch.equal(got[0], ref[0]) and (not dp or torch.equal(got[1], ref[1]))
            same &= ok
            verdicts.append(f"{name}@{tile or 'plan'} {'equal' if ok else 'DIFFERS'}")
        torch.cuda.synchronize()
        log(f"{label} (xyz_dim {d}, M {m}, spread {spread:g}) against the parent: "
            + ", ".join(verdicts))
    results = {}
    for shape, (d, ep) in F32_SHAPES.items():
        xyz, dirs = f32_inputs(torch, d, M)
        bufs = outputs(M, ep, 32)
        entries = [("parent", None)] + F32_TILES
        for rnd in range(4):  # in turns: forwards, then backwards
            for name, tile in (entries if rnd % 2 == 0 else entries[::-1]):
                launch = launcher(name, tile, xyz, dirs, *bufs, d, ep, 32)
                for _ in range(3):
                    launch()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                for _ in range(20):
                    launch()
                b.record()
                torch.cuda.synchronize()
                results.setdefault((shape, name, tile), []).append(a.elapsed_time(b) / 20)
        fill = lambda: (bufs[0].zero_(), bufs[1].zero_())  # noqa: E731
        fill()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(20):
            fill()
        b.record()
        torch.cuda.synchronize()
        results[(shape, "zero_ (the output bytes written, nothing read)", None)] = [
            a.elapsed_time(b) / 20]
        clock = sm_clock_ghz(torch)
        nbytes = 4.0 * M * (d + 3 + ep + 32)
        trig = M * 2 * (12 * d + 4 * 3)  # trig columns a sub-chunk
        log(f"{shape}: {M} points, xyz_dim {d}, {ep} + 32 columns; byte bound "
            f"{nbytes / 3.35e9:.4f} ms ({nbytes:.4g} B at 3.35 TB/s); SM clock {clock:.3f} GHz")
        for (s_, name, tile), ts in results.items():
            if s_ != shape:
                continue
            t = min(ts)
            slots = t * 1e-3 * clock * 1e9 * 4 * 132 / (trig / 32)
            log(f"{shape} {name}@{tile or 'plan'}: {' / '.join(f'{x:.4f}' for x in ts)} ms "
                f"(best {t:.4f}: {nbytes / t / 1e9:.3f} TB/s, {100 * nbytes / 3.35e9 / t:.1f}% of "
                f"the byte bound; {slots:.1f} scheduler issue slots a warp's trig column)")
    log(f"every variant bit-equal to the parent: {same}")
    # The host's cost of a launch: 500 launches at M = 1 (the device's work
    # is next to nothing), in turns.
    xyz, dirs = f32_inputs(torch, 3, 1)
    bufs = outputs(1, 80, 32)
    host = {}
    for rnd in range(4):
        for name in (["parent", "tree"] if rnd % 2 == 0 else ["tree", "parent"]):
            launch = launcher(name, None, xyz, dirs, *bufs, 3, 80, 32)
            for _ in range(10):
                launch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(500):
                launch()
            torch.cuda.synchronize()
            host.setdefault(name, []).append((time.perf_counter() - t0) / 500 * 1e6)
    for name, us in host.items():
        log(f"{name}: {' / '.join(f'{u:.2f}' for u in us)} us of host time a launch (M = 1)")
    if args.step:
        same &= f32_step_and_view(torch, work,
                                  {n: libs[n] for n in ("parent", "tree", "tree_wb")})
    return 0 if same else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--tree", action="store_true")
    ap.add_argument("--out", type=Path, default=ROOT / ".exp" / "encode_probe")
    ap.add_argument("--f32", action="store_true",
                    help="probe wide_f32.cu's encode against DIR's (f32_probe)")
    ap.add_argument("--step", action="store_true",
                    help="with --f32: also the wide f32 step and view with DIR's "
                         "library and this checkout's, in turns (f32_step_and_view)")
    args = ap.parse_args()
    if args.f32:
        return f32_probe(args)
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
