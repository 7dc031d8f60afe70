"""The wide eval route (`fused_wide.py` around `csrc/eval_wide.cu`),
checked without a GPU: the eval and train gates against the JAX package's
`supports_fused_kernels`, the wrapper's CPU path (its plain version)
against the JAX package's Pallas eval kernel in interpret mode and against
the narrow chain's plain version, the plan's sub-chunks, the wrappers'
device rules, and `render_rays` in eval mode through the wide route against
the JAX package's renderer. All inputs come from numpy seeds."""

import dataclasses
from argparse import Namespace
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.models.nerf import NeRFConfig as JNeRFConfig
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.render import pallas_mlp as j_pallas
from mega_nerf_tpu.render import render_rays as j_render_rays
from mega_nerf_tpu.render import rendering as j_rendering
from mega_nerf_tpu_torch.models import (
    NeRFConfig,
    make_bg_nerf,
    make_nerf,
    state_from_flax_params,
)
from mega_nerf_tpu_torch.render import fused_mlp, fused_wide, rendering
from mega_nerf_tpu_torch.render.rendering import RenderSettings, render_rays


def _hparams(width, **kw):
    base = dict(pos_xyz_dim=12, pos_dir_dim=4, layers=3, skip_layers=[2],
                layer_dim=width, bg_layer_dim=width, appearance_dim=48,
                affine_appearance=False, use_cascade=False, sh_deg=None,
                shifted_softplus=True, compute_dtype="bfloat16")
    base.update(kw)
    return Namespace(**base)


def _configs(width, dtype):
    kw = dict(pos_xyz_dim=12, pos_dir_dim=4, layers=8, skip_layers=(4,),
              layer_dim=width, appearance_dim=48, compute_dtype=dtype)
    return NeRFConfig(**kw), JNeRFConfig(**kw)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("width", [256, 512, 640, 1024, 2048, 4096])
def test_gates_match_jax(width, train, dtype, monkeypatch):
    """The port's eval and train gates against the JAX gate as it decides
    on a TPU (`jax.default_backend` patched for this test): they agree at
    every width and compute dtype here, eval and training. Past 512 the
    port's wide route takes bf16 to 2048 in eval and to 1024 in training,
    and f32 to 1024 in both (the f32 wide kernels), as the JAX gate runs
    Pallas; past those widths both take the eager module / XLA, with the
    reason. A Mega-NeRF mixture (eval only in the port): the JAX gate
    sends every mixture to XLA, the port runs each submodule through the
    route a single model of its architecture takes, with the same output
    to the kernels' tolerance."""
    monkeypatch.setattr(j_pallas.jax, "default_backend", lambda: "tpu")
    cfg, jcfg = _configs(width, dtype)
    port, why = fused_mlp.supports_fused_kernel(cfg, train)
    ref = j_pallas.supports_fused_kernels(jcfg, train)
    assert port == ref
    assert bool(why) == (not port)
    if port:
        assert fused_mlp.is_wide(cfg) == (width > 512)
    mixture = SimpleNamespace(config=cfg, is_mega=True, cascade=False)
    assert not j_rendering._supports_fused(
        SimpleNamespace(config=jcfg, is_mega=True, cascade=False), train)
    if not train:
        assert rendering.fused_gate(mixture, RenderSettings(), train, "cpu") == (port, why)


@pytest.mark.parametrize("width,dtype,admitted", [
    (576, "bfloat16", True),  # a multiple of 64, not of 128: the port's rule
    (1984, "bfloat16", True),
    (528, "bfloat16", False),  # a multiple of 16 only
    (2112, "bfloat16", False),
    (576, "float32", True),  # the f32 wide kernels, eval and training
    (1088, "float32", False),  # f32 stops at 1024, as the JAX f32 gate
    (1984, "float32", False),
    (496, "float32", True),  # the narrow chain's gate admits f32 (ROADMAP)
])
def test_eval_gate_port_rule(width, dtype, admitted):
    """Past 512 the eval gate admits bf16 multiples of 64 up to 2048 and f32
    multiples of 64 up to 1024; the training gate the same up to 1024 in
    both (the wide training route)."""
    cfg, _ = _configs(width, dtype)
    assert fused_mlp.supports_fused_kernel(cfg)[0] == admitted
    assert fused_mlp.supports_fused_kernel(cfg, train=True)[0] == (
        admitted and width <= 1024)


def _flax_bundle(hp, bg, count, seed):
    """The JAX model, its seeded Flax params and the port's bundle holding
    them (carried over by `state_from_flax_params`)."""
    jb = (j_make_bg_nerf if bg else j_make_nerf)(hp, count)
    params = jax.device_get(jb.init(jax.random.key(seed)))
    tb = (make_bg_nerf if bg else make_nerf)(hp, count)
    tb.module.load_state_dict(state_from_flax_params(tb.config, params))
    tb.module.eval()
    return jb, params, tb


def _points(cfg, n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, cfg.xyz_dim)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    return xyz, dirs, rng.integers(0, cfg.appearance_count, n)


@pytest.mark.parametrize("width", [576, 640])
@pytest.mark.parametrize("use_dirs", [True, False])
@pytest.mark.parametrize("bg", [False, True])
def test_wide_wrapper_on_cpu_matches_pallas_interpret(bg, use_dirs, width):
    """`fused_nerf_eval_wide` on CPU tensors (its plain version) against
    the JAX package's Pallas eval kernel in interpret mode: the same Flax
    weights (carried over by `state_from_flax_params` at a width past 512)
    and numpy inputs, 3 layers with the skip at 2, f32 compute, 5e-5
    absolute (as the narrow wrapper's test); 200 points, not a multiple of
    the JAX block."""
    hp = _hparams(width, compute_dtype="float32", appearance_dim=8,
                  pos_dir_dim=4 if use_dirs else 0)
    count = 5
    jb, params, tb = _flax_bundle(hp, bg, count, 3)
    module, cfg = tb.module, tb.config
    n, block = 200, 128
    xyz, dirs, idx = _points(cfg, n, 4)
    app = np.asarray(params["appearance"]["embedding"])[idx]
    m_pad = -(-n // block) * block
    pad = lambda a: jnp.asarray(  # noqa: E731
        np.concatenate([a, np.repeat(a[-1:], m_pad - n, 0)]))
    want = j_pallas.fused_nerf_eval(
        j_pallas.pack_params(jb.config, params), pad(xyz),
        pad(dirs) if use_dirs else None, pad(app), block=block, interpret=True)[:n]
    packed = fused_mlp.pack_params(module)
    calls = fused_wide.fused_nerf_eval_wide_plain.calls
    launches = fused_wide.wide_kernel_launches()
    got = fused_wide.fused_nerf_eval_wide(
        packed, torch.from_numpy(xyz), torch.from_numpy(dirs) if use_dirs else None,
        torch.from_numpy(app))
    assert fused_wide.fused_nerf_eval_wide_plain.calls == calls + 1
    assert fused_wide.wide_kernel_launches() == launches
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


@pytest.mark.parametrize("kw", [
    {},
    {"appearance_dim": 0},
    {"appearance_dim": 0, "pos_dir_dim": 0},
    {"appearance_dim": 5},  # rows not 16-byte wide: the padded segment
])
@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("width", [640, 1024])
def test_wide_plain_equals_narrow_plain_bitwise(width, bg, kw):
    """In bf16 the wide route's plain version (encode, layer by layer, heads)
    gives the narrow chain's plain version's bits: the same operands,
    products and roundings."""
    bundle = (make_bg_nerf if bg else make_nerf)(_hparams(width, **kw), 4)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in bundle.module.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / np.sqrt(p.shape[-1]))
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = _points(cfg, 300, 1)
    dirs_t = torch.from_numpy(dirs) if cfg.pos_dir_dim else None
    app = (bundle.module.appearance(torch.from_numpy(idx) % 4)
           if cfg.appearance_dim else None)
    with torch.no_grad():
        got = fused_wide.fused_nerf_eval_wide_plain(packed, torch.from_numpy(xyz),
                                                    dirs_t, app)
        want = fused_mlp.fused_nerf_eval_plain(packed, torch.from_numpy(xyz),
                                               dirs_t, app)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


@pytest.mark.parametrize("width", [576, 640, 1024, 1536, 2048])
def test_wide_plan_scratch_and_sub_chunk(width):
    """The sub-chunk is a power of two of whole 128-point tiles whose scratch
    (two activation buffers, the branch, the encodes, an appearance copy)
    fits 8 GiB and doubling it would not; 524,288 points (5.6 GB) at 2048.
    The tile and ring match the layer kernel's constants."""
    cfg, _ = _configs(width, "bfloat16")
    plan = fused_wide.wide_plan(cfg)
    per_point = fused_wide.scratch_bytes_per_point(cfg)
    sub = plan.sub_chunk
    assert sub % plan.tile_m == 0 and sub & (sub - 1) == 0
    assert plan.scratch_bytes == sub * per_point <= fused_wide.WIDE_SCRATCH_LIMIT
    assert (2 * sub * per_point > fused_wide.WIDE_SCRATCH_LIMIT
            or 2 * sub > fused_wide.WIDE_MAX_SUB_CHUNK)
    assert sub // plan.tile_m <= 65535
    assert (plan.tile_m, plan.tile_n, plan.tile_k, plan.stages) == (128, 256, 64, 3)
    # Ring, output tile, two bias copies per warpgroup, 12 mbarriers, slack.
    assert plan.out_bytes == 128 * 256 * 2
    assert plan.smem_bytes == 3 * (128 + 256) * 64 * 2 + 65536 + 4096 + 96 + 1024
    assert plan.smem_bytes <= 232_448
    if width == 2048:
        assert sub == 524_288 and plan.scratch_bytes < 6e9


def cu_constants(name):
    """The `constexpr int` constants of `csrc/<name>.cu`, evaluated in
    order (each is an integer expression over the ones before it)."""
    import re

    src = (Path(fused_wide.__file__).parent / "csrc" / f"{name}.cu").read_text()
    values = {}
    for key, expr in re.findall(r"constexpr int (\w+) =\s*([^;]+);", src):
        values[key] = eval(expr.replace("/", "//"), {}, dict(values))  # noqa: S307
    return values


def test_wide_plan_matches_the_layer_kernel_constants():
    """The plan `eval_wide_layer` passes is what its launcher checks
    (`eval_wide.cu`'s constants), and its shared memory fits a CTA: a
    3-stage ring, the 64 KB output tile, the bias copies and mbarriers."""
    c = cu_constants("eval_wide")
    assert fused_wide.wide_plan_ints() == [c["TILE_M"], c["TILE_N"], c["TILE_K"],
                                           c["STAGES"], c["OUT_BYTES"], c["SMEM_BYTES"]]
    assert c["PARAMS_BYTES"] == fused_wide.WIDE_PARAMS_BYTES
    assert c["BARRIERS"] == fused_wide.WIDE_BARRIERS
    assert c["OUT_BYTES"] == 4 * 2 * c["OUT_BOX"]  # four 64 x 64 boxes per half
    assert c["SMEM_BYTES"] <= 232_448  # what a CTA may use on the card (227 KB)
    src = (Path(fused_wide.__file__).parent / "csrc" / "eval_wide.cu").read_text()
    assert src.count(f"__cluster_dims__({fused_wide.WIDE_CLUSTER}, 1, 1)") == 1


@pytest.mark.parametrize("cluster", [fused_wide.WIDE_CLUSTER, fused_wide.DX_CLUSTER])
@pytest.mark.parametrize("clusters", [1, 7, 66, 10_000])
@pytest.mark.parametrize("m,n", [(1, 256), (37, 640), (1000, 2048), (100_003, 1024),
                                 (100_003, 320), (4096, 48), (129, 256)])
def test_tile_walk_covers_every_tile_once(m, n, clusters, cluster):
    """The persistent GEMMs' walk, mirrored (clusters of two for the layer
    GEMM, single CTAs for dX): the tiles of all CTAs cover each (point
    tile, N tile) of a ragged M x N output exactly once, for cluster counts
    below, at and above the units of work; the CTAs of a cluster always
    hold the same N tile and neighbouring point tiles (they share the
    weight boxes); the launch grid is whole clusters, never more than the
    units or the resident CTAs."""
    grid = clusters * cluster
    walk = fused_wide.tile_walk(m, n, grid, cluster)
    ntm, ntn = -(-m // 128), -(-n // 256)
    tiles = [t for cta in walk for t in cta]
    assert sorted(tiles) == [(i * 128, j * 256) for i in range(ntm) for j in range(ntn)]
    assert len(tiles) == ntm * ntn
    units = fused_wide.wide_units(m, n, cluster)
    assert units == -(-ntm // cluster) * ntn
    for c in range(clusters):
        ctas = walk[c * cluster:(c + 1) * cluster]
        assert len(ctas[0]) == len(range(c, units, clusters))
        for rank, cta in enumerate(ctas):
            for (m0, n0), (m1, n1) in zip(ctas[0], cta):
                assert n1 == n0 and m1 == m0 + 128 * rank and m0 % (128 * cluster) == 0
    got = fused_wide.wide_grid(m, n, grid, cluster)
    assert got % cluster == 0 and got == cluster * max(1, min(units, clusters))


@pytest.mark.parametrize("sub", [128, 1024, 4096])
@pytest.mark.parametrize("m", [0, 1, 127, 128, 129, 1000, 4097, 8_388_608])
def test_sub_chunks_cover_every_point_once(m, sub):
    """The passes of the layer chain cover [0, m) once, in order, each at
    most one sub-chunk long and none empty."""
    chunks = fused_wide.sub_chunks(m, sub)
    assert len(chunks) == -(-m // sub)
    starts = [a for a, _ in chunks]
    ends = [b for _, b in chunks]
    assert starts == sorted(starts) and (not chunks or (starts[0], ends[-1]) == (0, m))
    assert all(0 < b - a <= sub for a, b in chunks)
    assert all(b == a2 for (_, b), (a2, _) in zip(chunks, chunks[1:]))


def _config_encodes():
    """(xyz_dim, pos_xyz_dim, pos_dir_dim) of every file in `configs/` (the
    options' defaults, 12 and 4, where a file sets none), fg and bg."""
    import yaml

    found = set()
    for path in sorted((Path(__file__).resolve().parents[1] / "configs").glob("*/*.yaml")):
        opts = yaml.safe_load(path.read_text()) or {}
        nf = (opts.get("pos_xyz_dim", 12), opts.get("pos_dir_dim", 4))
        found |= {(3, *nf), (4, *nf)}
    return sorted(found)


ENCODES = _config_encodes() + [(4, 0, 4), (4, 1, 4), (4, 16, 4)]


def test_config_encodes_are_the_paper_ones():
    """What the encode cases below cover: every family in `configs/` uses
    12 xyz frequencies with 4 dir frequencies or none."""
    assert ENCODES[:4] == [(3, 12, 0), (3, 12, 4), (4, 12, 0), (4, 12, 4)]
    assert len(ENCODES) == 7


def _itemsize_cases(cases, f32_only=()):
    """Each case in bf16 rows (itemsize 2, `eval_wide.cu`, the case's own id)
    and in f32 rows (itemsize 4, `wide_f32.cu`, id "f32-..."), then the
    `f32_only` cases (the f32 kernel alone takes xyz_dim 1 and 2)."""
    ids = lambda case: "-".join(map(str, case))  # noqa: E731
    return ([pytest.param(*case, 2, id=ids(case)) for case in cases]
            + [pytest.param(*case, 4, id="f32-" + ids(case))
               for case in [*cases, *f32_only]])


@pytest.mark.parametrize("xyz_dim,nf_xyz,nf_dir,itemsize",
                         _itemsize_cases(ENCODES, [(1, 12, 4), (2, 12, 0), (1, 0, 4)]))
def test_encode_walk_matches_the_jax_encode_layout(xyz_dim, nf_xyz, nf_dir, itemsize):
    """The encode kernels' column assignment, mirrored (`encode_walk`; the
    bf16 kernel of `eval_wide.cu` and the f32 one of `wide_f32.cu` walk
    alike): within a tile every live column of every point's enc and dir
    rows is written exactly once, by the lane of that point, and carries
    the JAX package's `encode_layout` column (source coordinate, scale 2^k,
    kind, pi/2 phase on the cos columns); no pad column is written (the
    kernel zeroes them once per CTA). Also the staged rows' odd word
    strides and the tile's shared memory at the rows' element size."""
    ep = fused_mlp._round_up(xyz_dim * (1 + 2 * nf_xyz), fused_mlp.MMA_K)
    dp = fused_mlp._round_up(3 * (1 + 2 * nf_dir), fused_mlp.MMA_K) if nf_dir else 0
    tile, smem = fused_wide.encode_plan(xyz_dim, ep, dp, itemsize)
    assert tile == fused_wide.ENCODE_TILE and smem == fused_wide.encode_smem(
        tile, xyz_dim, ep, dp, itemsize) <= fused_wide.ENCODE_SMEM_TARGET
    assert smem == tile * ((xyz_dim + 3) * 4 + itemsize * ep + 4
                           + (itemsize * dp + 4 if dp else 0))
    walk = fused_wide.encode_walk(xyz_dim, nf_xyz, nf_dir, dp > 0, tile)
    assert set(walk) == {(w, lane) for w in range(fused_wide.ENCODE_WARPS)
                         for lane in range(32)}
    layouts = [j_pallas.encode_layout(((xyz_dim, nf_xyz),), ep)]
    widths = [ep]
    if dp:
        layouts.append(j_pallas.encode_layout(((3, nf_dir),), dp))
        widths.append(dp)
    seen = {}
    for (warp, lane), writes in walk.items():
        for operand, point, col, coord, k, phase in writes:
            assert point % 32 == lane and 0 <= point < tile
            assert (operand, point, col) not in seen
            seen[operand, point, col] = (coord, k, phase)
    for operand, (layout, width) in enumerate(zip(layouts, widths)):
        assert (itemsize * width + 4) // 4 % 2 == 1  # odd words: 32 lanes, 32 banks
        colsrc, scale, phase, kind = layout.np_arrays()
        for point in range(tile):
            for col in range(width):
                got = seen.get((operand, point, col))
                if col >= layout.live_cols:
                    assert got is None and colsrc[col] == -1 and kind[col] == 0
                    continue
                c, k, ph = got
                assert c == colsrc[col]
                assert kind[col] == (k >= 0)
                assert scale[col] == np.float32(2.0 ** max(k, 0))
                assert phase[col] == (np.float32(np.pi / 2) if ph else 0)
    assert len(seen) == tile * sum(lay.live_cols for lay in layouts)


@pytest.mark.parametrize("xyz_dim,nf_xyz,tile,itemsize", [
    pytest.param(4, 12, 128, 2, id="4-12-128"), pytest.param(4, 16, 128, 2, id="4-16-128"),
    pytest.param(4, 64, 64, 2, id="4-64-64"), pytest.param(3, 64, 64, 2, id="3-64-64"),
    pytest.param(4, 128, 32, 2, id="4-128-32"),
    # f32 rows: the same rule halves sooner (4 bytes an element).
    pytest.param(4, 12, 128, 4, id="f32-4-12-128"), pytest.param(4, 16, 128, 4, id="f32-4-16-128"),
    pytest.param(4, 64, 32, 4, id="f32-4-64-32"), pytest.param(3, 64, 32, 4, id="f32-3-64-32"),
    pytest.param(4, 128, 32, 4, id="f32-4-128-32"), pytest.param(1, 12, 128, 4, id="f32-1-12-128"),
    pytest.param(2, 64, 64, 4, id="f32-2-64-64"), pytest.param(1, 64, 128, 4, id="f32-1-64-128"),
])
def test_encode_plan_halves_the_tile_for_many_frequencies(xyz_dim, nf_xyz, tile, itemsize):
    """The encode tile: 128 points while its coordinates and staged rows (of
    `itemsize` bytes an element) fit ENCODE_SMEM_TARGET, halved down to 32
    past it, within a CTA's shared memory; `ENCODE_MAX_SMEM` and the warps
    are the kernel's own constants (`eval_wide.cu` in bf16, `wide_f32.cu`
    in f32)."""
    ep = fused_mlp._round_up(xyz_dim * (1 + 2 * nf_xyz), fused_mlp.MMA_K)
    got, smem = fused_wide.encode_plan(xyz_dim, ep, 32, itemsize)
    assert got == tile and smem == fused_wide.encode_smem(tile, xyz_dim, ep, 32, itemsize)
    assert smem <= fused_wide.ENCODE_SMEM_TARGET or tile == 32
    assert smem <= fused_wide.ENCODE_MAX_SMEM
    c = cu_constants("eval_wide" if itemsize == 2 else "wide_f32")
    assert c["ENCODE_MAX_SMEM"] == fused_wide.ENCODE_MAX_SMEM
    assert c["ENCODE_THREADS"] == 32 * fused_wide.ENCODE_WARPS


def test_wide_plain_sub_chunking_matches_one_pass(monkeypatch):
    """The plain composite cut into 128-point sub-chunks (a ragged last
    one) gives the one-pass result on 300 points: the sub-chunks only slice
    the rows. Within 1e-6, not bit for bit: the CPU's f32 matmul blocks its
    sums by the row count (the card test holds the kernels bit for bit)."""
    bundle = make_nerf(_hparams(640), 4)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = _points(cfg, 300, 2)
    args = (packed, torch.from_numpy(xyz), torch.from_numpy(dirs),
            bundle.module.appearance(torch.from_numpy(idx) % 4))
    with torch.no_grad():
        whole = fused_wide.fused_nerf_eval_wide_plain(*args)
        plan = fused_wide.wide_plan(cfg)
        monkeypatch.setattr(fused_wide, "wide_plan",
                            lambda c: dataclasses.replace(plan, sub_chunk=128))
        calls = fused_wide.eval_wide_heads_plain.calls
        cut = fused_wide.fused_nerf_eval_wide_plain(*args)
    assert fused_wide.eval_wide_heads_plain.calls == calls + 3
    torch.testing.assert_close(cut, whole, rtol=0, atol=1e-6)


def test_segment_columns_follow_the_packed_layout():
    """The layer's A segments land on `pack_params`' columns: the skip
    layer's [enc | h] and dir_a's [final | dir enc | app]."""
    bundle = make_nerf(_hparams(640, appearance_dim=5), 4)
    cfg, packed = bundle.config, fused_mlp.pack_params(bundle.module)
    layout = fused_mlp.mat_layout(cfg)
    skip = [dst for _, dst, _ in layout[2][2]]
    assert fused_wide.segment_columns([packed.ep, 640]) == skip
    dir_a = [dst for _, dst, _ in layout[-1][2]]
    assert fused_wide.segment_columns([640, packed.dp, cfg.appearance_dim]) == dir_a
    assert packed.mats[-1].shape[1] == 640 + packed.dp + packed.ap


@pytest.mark.parametrize("which", ["encode", "layer", "heads", "eval"])
def test_wide_wrappers_device_rules(which):
    """CPU tensors run the plain version (no launch); any device but CPU
    and CUDA raises."""
    bundle = make_nerf(_hparams(640), 4)
    packed = fused_mlp.pack_params(bundle.module)
    m = 4
    calls = {
        "encode": lambda dev: fused_wide.eval_wide_encode(
            packed, torch.zeros((m, 3), device=dev), torch.zeros((m, 3), device=dev)),
        "layer": lambda dev: fused_wide.eval_wide_layer(
            [torch.zeros((m, 640), dtype=torch.bfloat16, device=dev)],
            packed.mats[1].to(dev), packed.biases[1].to(dev), True),
        "heads": lambda dev: fused_wide.eval_wide_heads(
            packed, torch.zeros((m, 640), dtype=torch.bfloat16, device=dev),
            torch.zeros((m, 320), dtype=torch.bfloat16, device=dev)),
        "eval": lambda dev: fused_wide.fused_nerf_eval_wide(
            packed, torch.zeros((m, 3), device=dev), torch.zeros((m, 3), device=dev),
            torch.zeros((m, 48), dtype=torch.bfloat16, device=dev)),
    }
    launches = fused_wide.wide_kernel_launches()
    out = calls[which]("cpu")
    assert fused_wide.wide_kernel_launches() == launches
    first = out[0] if isinstance(out, tuple) else out
    assert first.shape[0] == m and first.device.type == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        calls[which]("meta")


CENTER = np.array([0.05, -0.1, 0.0], np.float32)
RADIUS = np.array([1.4, 1.1, 1.2], np.float32)


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = (rng.uniform(-0.3, 0.3, size=(n, 3)) * 0.5).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    near = np.full((n, 1), 0.05, np.float32)
    far = np.where(np.arange(n)[:, None] % 2 == 0, 1e5, 0.8).astype(np.float32)
    return np.concatenate([o, d, near, far], -1)


def test_render_rays_through_the_wide_route_matches_jax(capsys, monkeypatch):
    """`render_rays` in eval mode with 640-wide fg and bg models (bf16
    compute: the wide route's domain) against the JAX package's renderer
    (XLA MLP path, merge compositor) on the same Flax weights and rays;
    the logged route names the wide kernel. Tolerances: depth rtol 5e-4 as
    the f32 render test; rgb 1e-3 absolute with a mean under 1e-4, since
    a float32 sum taken in another order can flip one bf16 rounding of an
    activation (the f32 test's 1e-4 holds for the mean)."""
    monkeypatch.setattr(rendering, "_LOGGED_MLP_PATHS", set())
    hp = _hparams(640, pos_xyz_dim=4, pos_dir_dim=2, appearance_dim=4)
    count = 5
    (jfg, pfg, tfg), (jbg, pbg, tbg) = [
        _flax_bundle(hp, bg, count, seed) for bg, seed in ((False, 0), (True, 1))]
    rays = _rays(48, seed=3)
    idx = np.arange(48, dtype=np.int32) % count
    jset = JSettings(coarse_samples=16, fine_samples=24, use_pallas=False,
                     eval_compositor="merge", get_depth=True, get_bg_fg_rgb=True)
    want, _ = jax.jit(lambda fp, bp: j_render_rays(
        jfg, jbg, fp, bp, jnp.asarray(rays), jnp.asarray(idx), jset, jnp.asarray(CENTER),
        jnp.asarray(RADIUS), train=False))(pfg, pbg)
    tset = RenderSettings(coarse_samples=16, fine_samples=24, get_depth=True,
                          get_bg_fg_rgb=True)
    calls = fused_wide.fused_nerf_eval_wide_plain.calls
    with torch.no_grad():
        got, _ = render_rays(tfg, tbg, torch.from_numpy(rays),
                             torch.from_numpy(idx).long(), tset,
                             torch.from_numpy(CENTER), torch.from_numpy(RADIUS))
    assert fused_wide.fused_nerf_eval_wide_plain.calls == calls + 4
    logged = capsys.readouterr().out
    assert logged.count("fused eval (wide kernel's plain version)") == 4
    assert "eager" not in logged
    for key in ("rgb_fine", "fg_rgb_fine", "bg_rgb_fine"):
        diff = np.abs(got[key].numpy() - np.asarray(want[key]))
        assert diff.max() <= 1e-3 and diff.mean() <= 1e-4, key
    for key in ("depth_fine", "fg_depth_fine"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=5e-4, atol=1e-5, err_msg=key)
    assert set(got) == set(want)
