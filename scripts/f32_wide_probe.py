#!/usr/bin/env python3
"""Probe of the PyTorch/CUDA port's f32 kernels at their main shapes on one
NVIDIA GPU.

    python3 scripts/f32_wide_probe.py [--parent DIR]

1. The f32 wide GEMM (`wide_f32_gemm_kernel` of
   `mega_nerf_tpu_torch/render/csrc/wide_f32.cu`) at 524,288 points x 1024
   x 1024, as a forward layer (bias, ReLU) and as a masked dX job, with its
   launch bounds as committed, (256, 2), against a copy with (256, 1), in
   turns ((256, 2), (256, 1), (256, 1), (256, 2)); the two copies' layer
   outputs must be equal bit for bit.
2. With --parent DIR, a checkout of a commit whose f32 weight gradient
   (`train_f32.cu`'s `weight_grad_f32_launch`) still takes the saved rows
   and the gradient rows as launch parameters: that kernel pair against
   this checkout's (per-job operand pointers) at the paper model's fg-fine
   pass (524,288 points, width 256, f32), in turns (parent, tree, tree,
   parent, parent, tree); the outputs must be equal bit for bit.

Copies are built with nvcc for sm_90a under `.exp/f32_wide_probe/`; the
script prints each copy's ptxas line for the kernel, the times (ms a launch,
CUDA events over 5 or 10 launches after one) and the card's name, power
limit and SM clock. Needs one card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / ".exp" / "f32_wide_probe"
M = 524_288


def build(name: str, source: str, kernel: str):
    """Build `source` (a train_f32.cu or wide_f32.cu text) as library `name`
    beside a copy of f32_chain.cuh -> the loaded library."""
    from mega_nerf_tpu_torch.render import _build

    out = OUT / name
    out.mkdir(parents=True, exist_ok=True)
    cu = out / ("wide_f32.cu" if "wide_f32_gemm_kernel" in source else "train_f32.cu")
    cu.write_text(source)
    shutil.copy(_build.CSRC / "f32_chain.cuh", out / "f32_chain.cuh")
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / "lib.so"),
                          str(cu)], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
    lines = (res.stdout + res.stderr).splitlines()
    for i, line in enumerate(lines):
        if kernel in line and "Function properties" in line:
            print(f"{name}: {' '.join(x.strip() for x in lines[i + 1:i + 3])}")
    return ctypes.CDLL(str(out / "lib.so"))


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
    libs = {"(256, 2)": build("gemm_lb2", src, "wide_f32_gemm_kernel"),
            "(256, 1)": build("gemm_lb1", src.replace(key, key.replace("2)", "1)")),
                              "wide_f32_gemm_kernel")}
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


def weight_grad_parent(parent: Path) -> None:
    import torch

    from mega_nerf_tpu_torch.models import NeRF, NeRFConfig
    from mega_nerf_tpu_torch.render import _build, fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    old = build("wg_parent", (parent / "mega_nerf_tpu_torch/render/csrc/train_f32.cu")
                .read_text(), "wg_partial")
    new = build("wg_tree", (_build.CSRC / "train_f32.cu").read_text(), "wg_partial")
    for lib in (old, new):
        lib.weight_grad_f32_launch.argtypes = [ctypes.c_void_p] * 3
        lib.weight_grad_f32_launch.restype = ctypes.c_int
    new.error_string = new.train_f32_error_string
    new.error_string.argtypes = [ctypes.c_int]
    new.error_string.restype = ctypes.c_char_p
    dev = torch.device("cuda")
    cfg = NeRFConfig(xyz_dim=3, layer_dim=256, pos_xyz_dim=12, pos_dir_dim=4, layers=8,
                     skip_layers=(4,), appearance_dim=48, compute_dtype="float32")
    packed = fused_mlp.pack_params(NeRF(cfg).to(dev))
    gen = torch.Generator(device=dev).manual_seed(1)
    act = torch.randn((M, ft.act_layout(packed)["width"]), generator=gen, device=dev)
    grad = torch.randn((M, ft.grad_layout(packed)["width"]), generator=gen, device=dev)
    plan = fused_f32.f32_wg_plan(packed, M)
    tables = torch.tensor([v for j in plan.jobs for v in j]
                          + [v for t in plan.tiles for v in t], dtype=torch.int32).to(dev)
    scratch = torch.empty(plan.splits * len(plan.tiles) * fused_f32.F32_WG_ELEMS, device=dev)
    flat_old = torch.empty(ft._offsets(ft.packed_shapes(packed))[-1], device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run_parent():
        # The parent's interface: act, grad, out, scratch, jobs, tiles; M,
        # act width, grad width, tiles, splits, split length.
        ptrs = (ctypes.c_longlong * 6)(act.data_ptr(), grad.data_ptr(), flat_old.data_ptr(),
                                        scratch.data_ptr(), tables.data_ptr(),
                                        tables.data_ptr() + 4 * 7 * len(plan.jobs))
        dims = (ctypes.c_int * 6)(M, act.shape[1], grad.shape[1], len(plan.tiles),
                                  plan.splits, plan.split_len)
        if old.weight_grad_f32_launch(ptrs, dims, stream):
            raise RuntimeError("the parent's weight gradient did not launch")

    library = fused_f32._train_lib
    fused_f32._train_lib = lambda: new
    try:
        times = {"parent": [], "tree": []}
        for name in ("parent", "tree", "tree", "parent", "parent", "tree"):
            fn = run_parent if name == "parent" else (
                lambda: fused_f32.weight_grad_f32(packed, act, grad))
            times[name].append(round(ms(fn, 10), 3))
        run_parent()
        got = fused_f32.weight_grad_f32(packed, act, grad)
        torch.cuda.synchronize()
    finally:
        fused_f32._train_lib = library
    print(f"the narrow f32 weight gradient at the paper fg-fine pass ({M} points, width "
          f"256), ms in turns: {times}; bit-equal: {torch.equal(flat_old, got)}")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout whose f32 weight gradient takes act and grad "
                             "as launch parameters")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("f32_wide_probe: no CUDA device", file=sys.stderr)
        return 2
    gemm_launch_bounds()
    if args.parent is not None:
        weight_grad_parent(args.parent)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
