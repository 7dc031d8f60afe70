"""The wide eval MLP (512 < layer_dim <= 2048): one layer at a time.

Counterpart of the JAX package's `render/pallas_mlp.py::_mlp_kernel` at the
widths its eval gate admits past the port's fused chain (`fused_mlp.py`,
<= 512): bf16 compute to 2048, f32 compute to 1024. The hand-written
Hopper kernels of bf16 compute are in `csrc/eval_wide.cu`:

- `eval_wide_encode` writes the f32 frequency encodes of xyz and dirs as
  bf16 operands, (M, EP) and (M, DP), in the fused chain's form (cos as
  sin(x 2^k + pi/2), sinf's results, zero columns past the live width):
  tiles of `encode_plan` points, a lane per point walking one coordinate's
  frequencies (`encode_walk` mirrors which columns each thread writes),
  rows staged in shared memory and stored as one contiguous range;
- `eval_wide_layer` is one matmul layer, Y = act(sum_s X_s W_s^T + b),
  bf16 out, its A operand read from up to three tensors as separate
  K-segments ([enc | h] at a skip layer, [final | dir | app] for dir_a);
- `eval_wide_heads` is the sigma head over the last trunk output and the
  rgb head over the branch, in `eval_fwd.cu`'s arithmetic, -> (M, 4) f32.

Between layers the activations pass through device memory: at width 2048
a layer does ~1,000 FLOP per byte it moves, far above the card's ridge, so
keeping the activation tile on chip (the fused chain's design, which needs
256 KB of shared memory per 64 points at this width) buys nothing.

`wide_plan(cfg)` gives the GEMM tile, ring, output buffer and shared memory
(the kernel's constants, checked by its launcher; `train_wide_dx` runs on
the same plan) and the sub-chunk: the points one pass of the layer chain
takes, so that its scratch (two activation buffers, the branch and the
encodes) stays within `WIDE_SCRATCH_LIMIT`. The GEMM is persistent:
`wide_grid` CTAs, as many as the card holds, walk the output tiles in the
order `tile_walk` mirrors.

In f32 compute (`--compute_dtype float32`, to width 1024) each wrapper
hands CUDA tensors to its counterpart in `fused_wide_f32.py` (the true-f32
kernels of `csrc/wide_f32.cu`, which count their own launches), as
`fused_mlp.fused_nerf_eval` hands f32 to `fused_f32.py`; the composition
and its buffers follow the compute dtype.

Each kernel wrapper runs its plain version on CPU tensors and launches its
kernel on CUDA tensors or raises; wrappers count launches in `.launches`,
plain versions their calls in `.calls`. `fused_nerf_eval_wide` composes
the three kernels, `fused_nerf_eval_wide_plain` their plain versions; on
the same inputs the latter equals `fused_mlp.fused_nerf_eval_plain`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from mega_nerf_tpu_torch.models.nerf import NeRFConfig
from mega_nerf_tpu_torch.render.fused_mlp import (
    MMA_K,
    PackedMLP,
    _check,
    _raise_if,
    _resident_ctas,
    _round_up,
    check_inputs,
    encode,
)
from mega_nerf_tpu_torch.render.fused_train import _ints, _stream

WIDE_TILE_M = 128  # points of a GEMM tile: two consumer warpgroups of 64
WIDE_TILE_N = 256  # output columns of a GEMM tile (wgmma m64n256k16)
WIDE_TILE_K = 64  # k columns of a ring stage: one 128-byte swizzle row
WIDE_STAGES = 3
WIDE_ALIGN = 1024  # the kernel aligns its base to the swizzle period
WIDE_MAX_SEGMENTS = 3
# A ring stage: an A box (tile_m x tile_k) and a B box (tile_n x tile_k), bf16.
WIDE_STAGE_BYTES = 2 * WIDE_TILE_K * (WIDE_TILE_M + WIDE_TILE_N)
# The bf16 output tile staged for its TMA store (and, in train_wide_dx, the
# mask tile before it); per consumer warpgroup two 1 KB copies (tile
# parity) of the tile's epilogue operands (bias, or w_sigma and g_sigma).
WIDE_OUT_BYTES = 2 * WIDE_TILE_M * WIDE_TILE_N
WIDE_PARAMS_BYTES = 2 * 2 * 1024
# full and empty per stage; per warpgroup ready, freed and mask landed.
WIDE_BARRIERS = 2 * WIDE_STAGES + 6
# The ring, the output buffer, the epilogue operands, the mbarriers, the
# alignment slack (both GEMM kernels: eval_wide_layer and train_wide_dx).
WIDE_SMEM_BYTES = (WIDE_STAGES * WIDE_STAGE_BYTES + WIDE_OUT_BYTES + WIDE_PARAMS_BYTES
                   + 8 * WIDE_BARRIERS + WIDE_ALIGN)
# CTAs per cluster: eval_wide_layer's two share each stage's weight box;
# train_wide_dx runs without clusters.
WIDE_CLUSTER = 2
DX_CLUSTER = 1
# The encode kernels (bf16 rows in eval_wide.cu, f32 rows in wide_f32.cu):
# 256 threads (8 warps) per CTA walk tiles of at most ENCODE_TILE points, a
# lane per point; the tile halves (to 32) while its shared memory
# (coordinates and staged rows) exceeds ENCODE_SMEM_TARGET.
ENCODE_TILE = 128
ENCODE_WARPS = 8
ENCODE_SMEM_TARGET = 96 * 1024
ENCODE_MAX_SMEM = 232_448  # a CTA's most shared memory on sm_90
# Scratch of one pass of the layer chain at most, and the most points a
# pass takes (32,768 point tiles).
WIDE_SCRATCH_LIMIT = 8 * 2 ** 30
WIDE_MAX_SUB_CHUNK = 2 ** 22


@dataclasses.dataclass(frozen=True)
class WidePlan:
    tile_m: int
    tile_n: int
    tile_k: int
    stages: int
    stage_bytes: int
    out_bytes: int
    smem_bytes: int
    sub_chunk: int  # points per pass of the layer chain
    scratch_bytes: int  # device scratch of one pass at sub_chunk points


def scratch_bytes_per_point(cfg: NeRFConfig) -> int:
    """Scratch one point takes in a pass, in the compute dtype (2 bytes an
    element in bf16, 4 in f32): two activation buffers (trunk outputs
    alternate between them; trunk_final writes the one that does not hold
    the last trunk output), the branch, the encodes and a padded copy of
    the appearance rows."""
    d = cfg.layer_dim
    ep = _round_up(cfg.enc_in, MMA_K)
    dp = _round_up(cfg.dir_in, MMA_K)
    ap = _round_up(cfg.appearance_dim, MMA_K)
    branch = d // 2 if cfg.uses_dir_branch else 0
    return cfg.dtype.itemsize * (2 * d + branch + ep + dp + ap)


@functools.lru_cache(maxsize=None)
def wide_plan(cfg: NeRFConfig) -> WidePlan:
    """The wide kernels' tile and sub-chunk for `cfg`. The sub-chunk is the
    largest power of two of points, at least one tile, whose scratch fits
    `WIDE_SCRATCH_LIMIT` (524,288 points, 5.6 GB at width 2048 in bf16 and
    at 1024 in f32)."""
    per_point = scratch_bytes_per_point(cfg)
    sub = WIDE_TILE_M
    while sub * 2 <= WIDE_MAX_SUB_CHUNK and sub * 2 * per_point <= WIDE_SCRATCH_LIMIT:
        sub *= 2
    return WidePlan(WIDE_TILE_M, WIDE_TILE_N, WIDE_TILE_K, WIDE_STAGES,
                    WIDE_STAGE_BYTES, WIDE_OUT_BYTES, WIDE_SMEM_BYTES, sub,
                    sub * per_point)


def wide_plan_ints() -> List[int]:
    """The GEMM plan both launchers check against their constants: tile_m,
    tile_n, tile_k, stages, output buffer bytes, shared-memory bytes."""
    return [WIDE_TILE_M, WIDE_TILE_N, WIDE_TILE_K, WIDE_STAGES, WIDE_OUT_BYTES,
            WIDE_SMEM_BYTES]


def wide_units(m: int, n: int, cluster: int) -> int:
    """What one cluster of `cluster` CTAs computes at a time: `cluster`
    neighbouring point tiles of one N tile."""
    return -(-m // (cluster * WIDE_TILE_M)) * -(-n // WIDE_TILE_N)


def wide_grid(m: int, n: int, resident: int, cluster: int = WIDE_CLUSTER) -> int:
    """CTAs of a persistent GEMM launch: whole clusters, one per unit of
    work, at most as many as the card holds at once."""
    return cluster * max(1, min(wide_units(m, n, cluster), resident // cluster))


def tile_walk(m: int, n: int, grid: int,
              cluster: int = WIDE_CLUSTER) -> List[List[Tuple[int, int]]]:
    """(first point, first column) of the tiles each of `grid` CTAs (whole
    clusters) computes, in order, mirroring the kernels: cluster c = b //
    cluster takes units u = c, c + grid / cluster, ..., unit u at point
    tiles cluster (u // ntn) + r (r < cluster) and N tile u % ntn, CTA b
    the one of rank r = b % cluster. A CTA whose unit has no point tile of
    its rank (the count of point tiles is not a multiple of the cluster)
    computes a tile wholly past m and stores nothing; it is left out here."""
    ntm, ntn = -(-m // WIDE_TILE_M), -(-n // WIDE_TILE_N)
    walk = []
    for b in range(grid):
        tiles = []
        for u in range(b // cluster, wide_units(m, n, cluster), grid // cluster):
            mt = cluster * (u // ntn) + b % cluster
            if mt < ntm:
                tiles.append((mt * WIDE_TILE_M, (u % ntn) * WIDE_TILE_N))
        walk.append(tiles)
    return walk


def wide_resident_ctas(lib: ctypes.CDLL, name: str, device: torch.device) -> int:
    """CTAs of library `name`'s GEMM kernel the card holds at once (its
    `<name>_resident_ctas` export at WIDE_SMEM_BYTES: whole clusters),
    cached per device."""
    return _resident_ctas(lib, device, WIDE_SMEM_BYTES, f"{name}_resident_ctas")


def encode_smem(tile: int, xyz_dim: int, ep: int, dp: int, itemsize: int = 2) -> int:
    """Shared memory of an encode tile: the f32 xyz and dirs rows, the
    staged enc and dir rows at `itemsize` EP + 4 and `itemsize` DP + 4
    bytes (2 in bf16, `eval_wide.cu`; 4 in f32, `wide_f32.cu`): an odd
    number of words, so the 32 lanes' stores at one column fall in 32
    banks."""
    return (tile * (xyz_dim + 3) * 4 + tile * (itemsize * ep + 4)
            + (tile * (itemsize * dp + 4) if dp else 0))


def encode_plan(xyz_dim: int, ep: int, dp: int, itemsize: int = 2) -> Tuple[int, int]:
    """(points per tile, shared-memory bytes) of the encode kernel of rows of
    `itemsize` bytes an element: ENCODE_TILE points, halved down to 32
    while the tile needs more than ENCODE_SMEM_TARGET (at 12 / 4
    frequencies a tile takes 33-41 KB in bf16, 61-78 KB in f32)."""
    tile = ENCODE_TILE
    while tile > 32 and encode_smem(tile, xyz_dim, ep, dp, itemsize) > ENCODE_SMEM_TARGET:
        tile //= 2
    return tile, encode_smem(tile, xyz_dim, ep, dp, itemsize)


def encode_walk(xyz_dim: int, nf_xyz: int, nf_dir: int, has_dir: bool,
                tile: int = ENCODE_TILE) -> dict:
    """What each thread of the encode kernels (`eval_wide.cu`'s bf16 one and
    `wide_f32.cu`'s f32 one walk alike) writes into a tile's staged rows,
    in its order, mirroring their loops -> {(warp, lane): [(operand,
    point, column, coordinate, k, phase), ...]}: operand 0 is enc, 1 dir;
    k = -1 marks the identity column; phase 1 the cos column (argument
    x 2^k + pi/2). Warp w takes tasks w, w + ENCODE_WARPS, ... of the
    (stream s, 32-point group g) tasks, task = s * groups + g; streams are
    the xyz coordinates, then the three direction coordinates; lane l
    takes point 32 g + l and walks k, the columns from the loop indices.
    The pad columns, zeroed once per CTA, are not listed."""
    groups = tile // 32
    streams = xyz_dim + (3 if has_dir else 0)
    walk = {}
    for warp in range(ENCODE_WARPS):
        for task in range(warp, streams * groups, ENCODE_WARPS):
            s, g = divmod(task, groups)
            operand, i, d, nf = ((0, s, xyz_dim, nf_xyz) if s < xyz_dim
                                 else (1, s - xyz_dim, 3, nf_dir))
            for lane in range(32):
                out = walk.setdefault((warp, lane), [])
                point = 32 * g + lane
                out.append((operand, point, i, i, -1, 0))
                col = d + i
                for k in range(nf):
                    for phase in (0, 1):
                        out.append((operand, point, col, i, k, phase))
                        col += d
    return walk


def sub_chunks(m: int, sub: int) -> List[Tuple[int, int]]:
    """[start, end) of each pass over m points, sub points at most each."""
    return [(m0, min(m0 + sub, m)) for m0 in range(0, m, sub)]


def segment_columns(widths: Sequence[int]) -> List[int]:
    """First packed-matrix column of each A segment: each segment's width
    rounds up to the MMA depth in `pack_params`' layout."""
    cols, c = [], 0
    for w in widths:
        cols.append(c)
        c += _round_up(w, MMA_K)
    return cols


# ---------------------------------------------------------------- plain


def eval_wide_encode_plain(packed: PackedMLP, xyz: torch.Tensor,
                           dirs: Optional[torch.Tensor]):
    """-> (enc (M, EP), dir enc (M, DP) or None) in the compute dtype."""
    eval_wide_encode_plain.calls += 1
    cfg = packed.config
    enc = encode(xyz, cfg.pos_xyz_dim, packed.ep).to(cfg.dtype)
    dir_enc = None
    if packed.dp:
        dir_enc = encode(dirs, cfg.pos_dir_dim, packed.dp).to(cfg.dtype)
    return enc, dir_enc


def eval_wide_layer_plain(xs: Sequence[torch.Tensor], w: torch.Tensor,
                          b: torch.Tensor, relu: bool) -> torch.Tensor:
    """act([x_0 | x_1 | ...] W^T + b) rounded to W's dtype: each segment
    zero-padded to its packed width, operands as given (compute dtype),
    float32 accumulation and bias."""
    eval_wide_layer_plain.calls += 1
    parts = [F.pad(x, (0, _round_up(x.shape[1], MMA_K) - x.shape[1])) for x in xs]
    inp = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
    y = inp.float() @ w.float().T + b
    return (torch.relu(y) if relu else y).to(w.dtype)


def eval_wide_heads_plain(packed: PackedMLP, h: torch.Tensor,
                          branch: Optional[torch.Tensor]) -> torch.Tensor:
    """(M, 4) f32 [sigmoid rgb, activated sigma] from the last trunk output
    h (sigma head) and the branch (rgb head; h without the branch)."""
    eval_wide_heads_plain.calls += 1
    sigma_pre = h.float() @ packed.sigma_w.float() + packed.sigma_b
    x = branch if branch is not None else h
    rgb_pre = x.float() @ packed.rgb_w.float().T + packed.rgb_b
    if packed.config.shifted_softplus:
        sigma = F.softplus(sigma_pre - 1.0)
    else:
        sigma = torch.relu(sigma_pre)
    return torch.cat([torch.sigmoid(rgb_pre), sigma[:, None]], -1)


def fused_nerf_eval_wide_plain(
    packed: PackedMLP,
    xyz: torch.Tensor,
    dirs: Optional[torch.Tensor] = None,
    app: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The three plain versions composed, one sub-chunk at a time -> (M, 4)
    f32 [rgb, sigma]; the arithmetic of `fused_mlp.fused_nerf_eval_plain`."""
    fused_nerf_eval_wide_plain.calls += 1
    cfg = packed.config
    out = torch.empty((xyz.shape[0], 4), dtype=torch.float32, device=xyz.device)
    for m0, m1 in sub_chunks(xyz.shape[0], wide_plan(cfg).sub_chunk):
        enc, dir_enc = eval_wide_encode_plain(
            packed, xyz[m0:m1], None if dirs is None else dirs[m0:m1])
        h = enc
        for i in range(cfg.layers):
            xs = [enc, h] if i in cfg.skip_layers else [h]
            h = eval_wide_layer_plain(xs, packed.mats[i], packed.biases[i], True)
        branch = None
        if packed.has_branch:
            final = eval_wide_layer_plain([h], packed.mats[cfg.layers],
                                          packed.biases[cfg.layers], False)
            xs = [final] + ([dir_enc] if packed.dp else [])
            if packed.ap:
                xs.append(app[m0:m1].to(cfg.dtype))
            branch = eval_wide_layer_plain(xs, packed.mats[cfg.layers + 1],
                                           packed.biases[cfg.layers + 1], True)
        out[m0:m1] = eval_wide_heads_plain(packed, h, branch)
    return out


for _fn in (eval_wide_encode_plain, eval_wide_layer_plain, eval_wide_heads_plain,
            fused_nerf_eval_wide_plain):
    _fn.calls = 0


# ---------------------------------------------------------------- kernels


def _wide_library() -> ctypes.CDLL:
    from mega_nerf_tpu_torch.render._build import load_library

    lib = load_library("eval_wide")
    if not getattr(lib, "_wide_bound", False):
        vp = ctypes.c_void_p
        lib.eval_wide_encode_launch.argtypes = [vp, vp, vp]
        lib.eval_wide_layer_launch.argtypes = [vp, vp, vp, ctypes.c_int, vp]
        lib.eval_wide_resident_ctas.argtypes = [ctypes.c_int, vp]
        lib.eval_wide_resident_ctas.restype = ctypes.c_int
        lib.eval_wide_heads_launch.argtypes = [vp, vp, vp]
        for fn in (lib.eval_wide_encode_launch, lib.eval_wide_layer_launch,
                   lib.eval_wide_heads_launch):
            fn.restype = ctypes.c_int
        lib.error_string = lib.eval_wide_error_string
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._wide_bound = True
    return lib


def _device_rule(name: str, t: torch.Tensor) -> bool:
    """True on a CUDA tensor (launch the kernel), False on a CPU tensor
    (run the plain version); raises on any other device."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


def check_weights_dtype(name: str, packed: PackedMLP) -> None:
    """Raise unless every packed matrix and head weight is in the compute
    dtype (the kernels of that dtype read them)."""
    dt = packed.config.dtype
    if any(t.dtype != dt for t in [*packed.mats, packed.sigma_w, packed.rgb_w]):
        raise ValueError(f"{name}: packed weights are not in the compute dtype "
                         f"{packed.config.compute_dtype}")


def _longs(values) -> ctypes.Array:
    return (ctypes.c_longlong * len(values))(*values)


def _check_rows(name: str, t: torch.Tensor, dtype, rows: int, cols: int) -> None:
    """A row-major 2-D view TMA can read: `dtype`, (rows, cols), unit
    column stride, 16-byte aligned base and row stride."""
    ok = (t.dtype == dtype and t.dim() == 2 and tuple(t.shape) == (rows, cols)
          and t.stride(1) == 1 and (t.stride(0) * t.element_size()) % 16 == 0
          and t.data_ptr() % 16 == 0)
    if not ok:
        raise ValueError(
            f"{name}: expected a {dtype} ({rows}, {cols}) view with unit column "
            f"stride and 16-byte aligned base and rows, got {t.dtype} "
            f"{tuple(t.shape)} strides {t.stride()}")


def eval_wide_encode(packed: PackedMLP, xyz: torch.Tensor,
                     dirs: Optional[torch.Tensor], enc: Optional[torch.Tensor] = None,
                     dir_enc: Optional[torch.Tensor] = None):
    """-> (enc (M, EP), dir enc (M, DP) or None), bf16. On CUDA tensors the
    kernel writes into `enc` / `dir_enc` when given (contiguous, 16-byte
    aligned: the kernel stores 16-byte chunks), else into new tensors;
    xyz_dim 3 or 4. In f32 compute: `fused_wide_f32.wide_f32_encode`."""
    if not _device_rule("eval_wide_encode", xyz):
        return eval_wide_encode_plain(packed, xyz, dirs)
    cfg = packed.config
    if cfg.dtype == torch.float32:
        from mega_nerf_tpu_torch.render.fused_wide_f32 import wide_f32_encode

        return wide_f32_encode(packed, xyz, dirs, enc, dir_enc)
    if cfg.dtype != torch.bfloat16:
        raise NotImplementedError(f"eval_wide_encode: no kernel computes in "
                                  f"{cfg.compute_dtype}")
    if cfg.xyz_dim not in (3, 4):
        raise ValueError(f"eval_wide_encode: xyz_dim {cfg.xyz_dim} (the kernel takes 3 or 4)")
    tile, smem = encode_plan(cfg.xyz_dim, packed.ep, packed.dp)
    if smem > ENCODE_MAX_SMEM:
        raise ValueError(f"eval_wide_encode: {cfg.pos_xyz_dim} / {cfg.pos_dir_dim} "
                         f"frequencies need {smem} bytes of shared memory per tile")
    m = xyz.shape[0]
    _check("xyz", xyz, torch.float32, (m, cfg.xyz_dim))
    if packed.dp:
        _check("dirs", dirs, torch.float32, (m, 3))
    if enc is None:
        enc = torch.empty((m, packed.ep), dtype=torch.bfloat16, device=xyz.device)
    _check("enc", enc, torch.bfloat16, (m, packed.ep))
    if packed.dp:
        if dir_enc is None:
            dir_enc = torch.empty((m, packed.dp), dtype=torch.bfloat16,
                                  device=xyz.device)
        _check("dir_enc", dir_enc, torch.bfloat16, (m, packed.dp))
    else:
        dir_enc = None
    for name, t in (("enc", enc), ("dir_enc", dir_enc)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"eval_wide_encode: {name} is not 16-byte aligned")
    if m == 0:
        return enc, dir_enc
    lib = _wide_library()
    ptrs = [xyz.data_ptr(), dirs.data_ptr() if packed.dp else 0, enc.data_ptr(),
            dir_enc.data_ptr() if packed.dp else 0]
    dims = [m, cfg.xyz_dim, cfg.pos_xyz_dim, cfg.pos_dir_dim, packed.ep, packed.dp,
            tile, smem]
    err = lib.eval_wide_encode_launch(_longs(ptrs), _ints(dims), _stream(xyz))
    eval_wide_encode.launches += 1
    _raise_if(lib, err, "eval_wide_encode")
    return enc, dir_enc


def eval_wide_layer(xs: Sequence[torch.Tensor], w: torch.Tensor, b: torch.Tensor,
                    relu: bool, out: Optional[torch.Tensor] = None,
                    grid: Optional[int] = None) -> torch.Tensor:
    """act(sum_s X_s W[:, col_s : col_s + K_s]^T + b) -> (M, N) bf16.

    xs: 1-3 segments (M, K_s), in `pack_params`' column order (each at the
    column `segment_columns` gives); w (N, Ktot) bf16 packed matrix; b (N,)
    f32. On CUDA tensors each segment may be a row-strided view (TMA reads
    it in place, zeros past its width), `out` (contiguous (M, N) bf16, N a
    multiple of 8: TMA stores its rows) is written when given. `grid` (the
    tests' only; even: clusters of WIDE_CLUSTER) launches that many CTAs in
    place of `wide_grid`'s. f32 weights (f32 compute) go to
    `fused_wide_f32.wide_f32_layer`, which takes no `grid`."""
    if not _device_rule("eval_wide_layer", w):
        return eval_wide_layer_plain(xs, w, b, relu)
    if w.dtype == torch.float32:
        from mega_nerf_tpu_torch.render.fused_wide_f32 import wide_f32_layer

        if grid is not None:
            raise ValueError("eval_wide_layer: the f32 layer GEMM takes no grid")
        return wide_f32_layer(xs, w, b, relu, out)
    if not 1 <= len(xs) <= WIDE_MAX_SEGMENTS:
        raise ValueError(f"eval_wide_layer: 1-{WIDE_MAX_SEGMENTS} segments, got {len(xs)}")
    m = xs[0].shape[0]
    n, ktot = w.shape
    widths = [x.shape[1] for x in xs]
    cols = segment_columns(widths)
    if cols[-1] + _round_up(widths[-1], MMA_K) != ktot:
        raise ValueError(f"eval_wide_layer: segments of widths {widths} do not "
                         f"fill the packed matrix's {ktot} columns")
    for i, x in enumerate(xs):
        if x.device != w.device:
            raise ValueError("eval_wide_layer: segments and weights on different devices")
        _check_rows(f"segment {i}", x, torch.bfloat16, m, widths[i])
    _check_rows("w", w, torch.bfloat16, n, ktot)
    _check("b", b, torch.float32, (n,))
    if n % 8:
        raise ValueError(f"eval_wide_layer: {n} output columns (TMA stores rows of "
                         "a multiple of 8)")
    if out is None:
        out = torch.empty((m, n), dtype=torch.bfloat16, device=w.device)
    _check("out", out, torch.bfloat16, (m, n))
    if m == 0:
        return out
    lib = _wide_library()
    if grid is None:
        grid = wide_grid(m, n, wide_resident_ctas(lib, "eval_wide", w.device))
    ptrs = [x.data_ptr() for x in xs] + [0] * (WIDE_MAX_SEGMENTS - len(xs))
    ptrs += [w.data_ptr(), b.data_ptr(), out.data_ptr()]
    dims = [m, n, ktot, len(xs), int(relu)]
    for i in range(WIDE_MAX_SEGMENTS):
        dims += ([widths[i], xs[i].stride(0), cols[i]] if i < len(xs) else [0, 0, 0])
    err = lib.eval_wide_layer_launch(_longs(ptrs), _ints(dims), _ints(wide_plan_ints()),
                                     int(grid), _stream(w))
    eval_wide_layer.launches += 1
    _raise_if(lib, err, "eval_wide_layer")
    return out


def eval_wide_heads(packed: PackedMLP, h: torch.Tensor, branch: Optional[torch.Tensor],
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(M, 4) f32 [rgb, sigma] from the last trunk output h (M, D) and the
    branch (M, D / 2) (None without it); `out` (contiguous) is written when
    given. In f32 compute: `fused_wide_f32.wide_f32_heads_fwd` without
    noise."""
    if not _device_rule("eval_wide_heads", h):
        return eval_wide_heads_plain(packed, h, branch)
    cfg = packed.config
    if cfg.dtype == torch.float32:
        from mega_nerf_tpu_torch.render.fused_wide_f32 import wide_f32_heads_fwd

        return wide_f32_heads_fwd(packed, h, branch, None, train=False, out=out)
    m, d = h.shape[0], cfg.layer_dim
    _check("h", h, torch.bfloat16, (m, d))
    if packed.has_branch:
        _check("branch", branch, torch.bfloat16, (m, d // 2))
    for t in (packed.sigma_w, packed.rgb_w):
        if t.dtype != torch.bfloat16 or t.device != h.device:
            raise ValueError("eval_wide_heads: head weights must be bf16 on h's device")
    if out is None:
        out = torch.empty((m, 4), dtype=torch.float32, device=h.device)
    _check("out", out, torch.float32, (m, 4))
    if m == 0:
        return out
    lib = _wide_library()
    rgb_in = d // 2 if packed.has_branch else d
    ptrs = [h.data_ptr(), branch.data_ptr() if packed.has_branch else 0,
            packed.sigma_w.data_ptr(), packed.sigma_b.data_ptr(),
            packed.rgb_w.data_ptr(), packed.rgb_b.data_ptr(), out.data_ptr()]
    dims = [m, d, rgb_in, int(packed.has_branch), int(cfg.shifted_softplus)]
    err = lib.eval_wide_heads_launch(_longs(ptrs), _ints(dims), _stream(h))
    eval_wide_heads.launches += 1
    _raise_if(lib, err, "eval_wide_heads")
    return out


for _fn in (eval_wide_encode, eval_wide_layer, eval_wide_heads):
    _fn.launches = 0


def fused_nerf_eval_wide(
    packed: PackedMLP,
    xyz: torch.Tensor,
    dirs: Optional[torch.Tensor] = None,
    app: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(M, 4) f32 [rgb, sigma] for M points, the wide route.

    xyz (M, xyz_dim) f32; dirs (M, 3) f32 direction coordinates (after the
    ref_packed_dirs swap) when the model reads directions; app
    (M, appearance_dim) per-point appearance rows when it has appearance.
    CPU tensors run `fused_nerf_eval_wide_plain`; CUDA tensors launch the
    kernels of `csrc/eval_wide.cu` in bf16 compute, of `csrc/wide_f32.cu`
    in f32 (`fused_wide_f32.py`), one sub-chunk of
    `wide_plan(cfg).sub_chunk` points at a time, or raise."""
    if not _device_rule("fused_nerf_eval_wide", xyz):
        return fused_nerf_eval_wide_plain(packed, xyz, dirs, app)
    cfg = packed.config
    check_inputs(packed, xyz, dirs, app)
    check_weights_dtype("fused_nerf_eval_wide", packed)
    m, d = xyz.shape[0], cfg.layer_dim
    dev = xyz.device
    out = torch.empty((m, 4), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    sub = min(wide_plan(cfg).sub_chunk, m)
    like = dict(dtype=cfg.dtype, device=dev)
    bufs = [torch.empty((sub, d), **like), torch.empty((sub, d), **like)]
    branch_buf = torch.empty((sub, d // 2), **like) if packed.has_branch else None
    enc_buf = torch.empty((sub, packed.ep), **like)
    dir_buf = torch.empty((sub, packed.dp), **like) if packed.dp else None
    # The kernels read rows 16-byte aligned: other appearance widths get a
    # padded copy.
    app_pad = packed.ap and (cfg.appearance_dim * cfg.dtype.itemsize) % 16 != 0
    for m0, m1 in sub_chunks(m, sub):
        k = m1 - m0
        enc, dir_enc = eval_wide_encode(
            packed, xyz[m0:m1], None if dirs is None else dirs[m0:m1],
            enc_buf[:k], None if dir_buf is None else dir_buf[:k])
        h, free = enc, 0
        for i in range(cfg.layers):
            xs = [enc, h] if i in cfg.skip_layers else [h]
            h = eval_wide_layer(xs, packed.mats[i], packed.biases[i], True,
                                bufs[free][:k])
            free = 1 - free
        branch = None
        if packed.has_branch:
            final = eval_wide_layer([h], packed.mats[cfg.layers],
                                    packed.biases[cfg.layers], False, bufs[free][:k])
            xs = [final] + ([dir_enc] if packed.dp else [])
            if packed.ap:
                rows = app[m0:m1]
                xs.append(F.pad(rows, (0, packed.ap - rows.shape[1])) if app_pad
                          else rows)
            branch = eval_wide_layer(xs, packed.mats[cfg.layers + 1],
                                     packed.biases[cfg.layers + 1], True,
                                     branch_buf[:k])
        eval_wide_heads(packed, h, branch, out[m0:m1])
    return out


def wide_kernel_launches() -> int:
    """Launches of the three wide kernels since their counters were zeroed."""
    return (eval_wide_encode.launches + eval_wide_layer.launches
            + eval_wide_heads.launches)


__all__ = [
    "WidePlan", "wide_plan", "wide_plan_ints", "wide_units", "wide_grid",
    "tile_walk", "WIDE_CLUSTER", "DX_CLUSTER", "encode_smem", "encode_plan",
    "encode_walk",
    "wide_resident_ctas", "sub_chunks", "segment_columns",
    "scratch_bytes_per_point", "eval_wide_encode", "eval_wide_layer",
    "eval_wide_heads", "fused_nerf_eval_wide", "eval_wide_encode_plain",
    "eval_wide_layer_plain", "eval_wide_heads_plain", "fused_nerf_eval_wide_plain",
    "wide_kernel_launches", "check_weights_dtype",
]
