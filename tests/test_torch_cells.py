"""The port's Mega-NeRF grid workflow against the JAX package's, on the CPU.

One 20x20 synthetic scene (5 train views + 1 val) partitioned on a 2 x 1
grid, shared by the module:
- cluster masks: the port's `scripts/create_cluster_masks` and the JAX
  script on the same scene write the same `params.pt` (keys and values) and
  centroids; the ratio pass agrees to 1e-5 relative, and the masks are equal
  wherever |ratio - margin| > 1e-5; `--resume` rewrites only what does not
  read back; `--segmentation_path` ANDs the masks with the segmentation;
- per-cell streams: the port's `CellDataset` yields the JAX `CellDataset`'s
  batches across an epoch end, memory and filesystem (`img_indices` and
  `rgbs` bit for bit, rays to 1e-5: each package makes them with its own
  ops), and `set_state` fast-forwards to the same batches;
- grid steps: two steps of `CellParallelTrainStep` from the JAX package's
  stacked cell parameters against the JAX `make_cell_parallel_train_step`
  (no noise, no jitter, f32): per-cell loss, parameters and Adam moments
  within 1e-5; a cell whose rows hold no background ray leaves its bg
  parameters and Adam state as they were while the other cell's change;
- `CellRunner` (`train_cells.main`): the per-cell checkpoint layout and
  keys, a run resumed from cell 1's mid-run checkpoint bit-equal to the
  uninterrupted one (memory and filesystem), the per-cell metric keys,
  validation of cell i rendering cell i's current weights, and
  `--cell_axis` / `--data_axis` above 1 in one process raising, naming
  both numbers and the world size (the layouts over several processes are
  `tests/test_torch_multiprocess_cells.py`).
"""

import json
from argparse import Namespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.create_cluster_masks as j_ccm
from mega_nerf_tpu.data.cell_dataset import CellDataset as JCellDataset
from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.ops.rays import get_ray_directions as j_get_ray_directions
from mega_nerf_tpu.ops.rays import get_rays as j_get_rays
from mega_nerf_tpu.parallel.cell_parallel import (
    make_cell_parallel_train_step as j_make_cell_step,
)
from mega_nerf_tpu.parallel.cell_parallel import make_cell_train_state as j_make_cell_state
from mega_nerf_tpu.parallel.cell_parallel import place_cell_parallel
from mega_nerf_tpu.parallel.mesh import make_mesh
from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.runtime.cell_runner import CellRunner as JCellRunner
from mega_nerf_tpu_torch import train_cells
from mega_nerf_tpu_torch.data.cell_dataset import CellDataset
from mega_nerf_tpu_torch.data.torch_io import load_mask_zip, load_pt, save_mask_zip
from mega_nerf_tpu_torch.models import flax_params_from_state, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.parallel.cell_parallel import (
    CellParallelTrainStep,
    mixture_states_from_flax,
    make_cell_train_state,
)
from mega_nerf_tpu_torch.render.rendering import RenderSettings
from mega_nerf_tpu_torch.runtime.cell_runner import CellRunner
from mega_nerf_tpu_torch.scripts import create_cluster_masks as ccm
from tests.synthetic import make_synthetic_dataset
from tests.test_models import tiny_hparams
from tests.test_torch_train_loop import (
    CENTER,
    RADIUS,
    _assert_trees_close,
    _rays,
    _torch_moments,
)

GRID = (2, 1)
MARGIN = 1.15
ALT = ["-10", "10"]
SAMPLES = 64


def _mask_args(ds, out, extra=()):
    return ["--dataset_path", str(ds), "--output", str(out), "--grid_dim",
            *map(str, GRID), "--ray_samples", str(SAMPLES), "--ray_altitude_range",
            *ALT, "--near", "0.5", "--far", "3.5", "--device", "cpu", *extra]


def _j_mask_hparams(ds, out, **kw):
    base = dict(dataset_path=str(ds), segmentation_path=None, output=str(out),
                grid_dim=list(GRID), ray_samples=SAMPLES, ray_chunk_size=48 * 1024,
                resume=False, ray_altitude_range=[-10.0, 10.0], near=0.5, far=3.5,
                center_pixels=True, cluster_2d=False, boundary_margin=MARGIN)
    base.update(kw)
    return Namespace(**base)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("cells")
    ds = make_synthetic_dataset(root / "ds", n_train=5, n_val=1, hw=(20, 20))
    ccm.main(ccm.get_mask_opts(_mask_args(ds, root / "masks")))
    j_ccm.main(_j_mask_hparams(ds, root / "j_masks"))
    return root, ds


def _view_ratios(ds, stem, cluster_2d=False):
    """The ratio pass of both packages on one view's rays -> (port, jax)."""
    meta = load_pt(next(ds.glob(f"*/metadata/{stem}.pt")))
    params = load_pt(ds.parent / "masks" / "params.pt")
    alt = params["ray_altitude_range"]
    start = 1 if cluster_2d else 0
    rays = ccm.view_rays(meta, 0.5, 3.5, alt, True, "cpu")
    port = ccm.view_ratios(rays, torch.from_numpy(params["centroids"]), SAMPLES,
                           start, 48 * 1024)
    intr = [float(x) for x in meta["intrinsics"]]
    j_rays = j_get_rays(j_get_ray_directions(int(meta["W"]), int(meta["H"]), *intr, True),
                        jnp.asarray(meta["c2w"]), 0.5, 3.5, alt).reshape(-1, 8)
    want = np.asarray(j_ccm.min_dist_ratios_for_rays(
        j_rays, jnp.asarray(params["centroids"]), SAMPLES, start))
    return port, want


def _stems(ds):
    return sorted(p.stem for p in ds.glob("*/metadata/*.pt"))


def test_mask_params_and_centroids_match_the_jax_script(scene):
    root, ds = scene
    port, want = load_pt(root / "masks" / "params.pt"), load_pt(root / "j_masks" / "params.pt")
    assert set(port) == set(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(port[key]), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_array_equal(
        ccm.make_centroids(GRID, port["min_position"], port["max_position"]),
        j_ccm.make_centroids(GRID, want["min_position"], want["max_position"]))
    for k in range(GRID[0] * GRID[1]):
        assert sorted(p.name for p in (root / "masks" / str(k)).iterdir()) == \
            [f"{s}.pt" for s in _stems(ds)]


@pytest.mark.parametrize("grid", [(2, 1), (3, 4), (1, 5)])
def test_make_centroids_matches_jax(grid):
    rng = np.random.default_rng(sum(grid))
    lo = rng.uniform(-2, 0, 3)
    hi = lo + rng.uniform(0.5, 3, 3)
    np.testing.assert_array_equal(ccm.make_centroids(grid, lo, hi),
                                  j_ccm.make_centroids(grid, lo, hi))


def test_mask_ratios_and_masks_match_the_jax_script(scene):
    root, ds = scene
    band = 0
    for stem in _stems(ds):
        port, want = _view_ratios(ds, stem)
        np.testing.assert_allclose(port, want, rtol=1e-5, err_msg=stem)
        for k in range(port.shape[1]):
            off = np.abs(want[:, k] - MARGIN).reshape(20, 20) > 1e-5
            band += int((~off).sum())
            got = load_mask_zip(root / "masks" / str(k) / f"{stem}.pt")
            exp = load_mask_zip(root / "j_masks" / str(k) / f"{stem}.pt")
            assert got.shape == (20, 20)
            np.testing.assert_array_equal(got[off], exp[off], err_msg=f"{stem} cell {k}")
            np.testing.assert_array_equal(got, port[:, k].reshape(20, 20) <= MARGIN)
    assert band < 10  # the margin band holds a handful of rays at most


@pytest.mark.parametrize("cluster_2d", [False, True])
@pytest.mark.parametrize("block", [7, 100])
def test_ratio_pass_matches_jax(cluster_2d, block):
    rng = np.random.default_rng(3)
    n = 300
    o = rng.uniform(-1, 1, (n, 3))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rays = np.concatenate([o, d, np.full((n, 1), 0.1), rng.uniform(1, 3, (n, 1))],
                          -1).astype(np.float32)
    cents = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    start = 1 if cluster_2d else 0
    got = ccm.min_dist_ratios_for_rays(torch.from_numpy(rays), torch.from_numpy(cents),
                                       50, start, sample_block=block).numpy()
    want = np.asarray(j_ccm.min_dist_ratios_for_rays(jnp.asarray(rays), jnp.asarray(cents),
                                                     50, start, sample_block=block))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert (got.min(-1) <= 1.0).all()  # the nearest centroid's ratio


def test_mask_resume_rewrites_only_what_does_not_read_back(scene, tmp_path):
    root, ds = scene
    out = tmp_path / "masks"
    ccm.main(ccm.get_mask_opts(_mask_args(ds, out)))
    stems = _stems(ds)
    missing, broken, kept = (out / "0" / f"{stems[0]}.pt", out / "1" / f"{stems[1]}.pt",
                             out / "0" / f"{stems[2]}.pt")
    missing.unlink()
    broken.write_bytes(b"not a zip")
    kept_time = kept.stat().st_mtime_ns
    with pytest.raises(FileExistsError):  # an existing output needs --resume
        ccm.main(ccm.get_mask_opts(_mask_args(ds, out)))
    ccm.main(ccm.get_mask_opts(_mask_args(ds, out, ["--resume"])))
    assert kept.stat().st_mtime_ns == kept_time
    for path in (missing, broken):
        np.testing.assert_array_equal(
            load_mask_zip(path), load_mask_zip(root / "masks" / path.parent.name / path.name))


def test_segmentation_path_ands_the_masks(scene, tmp_path):
    root, ds = scene
    seg = tmp_path / "seg"
    seg.mkdir()
    rng = np.random.default_rng(5)
    segs = {}
    for stem in _stems(ds):
        segs[stem] = rng.uniform(size=(20, 20)) < 0.6
        save_mask_zip(segs[stem], seg / f"{stem}.pt")
    ccm.main(ccm.get_mask_opts(_mask_args(ds, tmp_path / "m", ["--segmentation_path",
                                                               str(seg)])))
    j_ccm.main(_j_mask_hparams(ds, tmp_path / "jm", segmentation_path=str(seg)))
    for stem in _stems(ds):
        for k in range(GRID[0] * GRID[1]):
            for out, plain in (("m", "masks"), ("jm", "j_masks")):
                got = load_mask_zip(tmp_path / out / str(k) / f"{stem}.pt")
                without = load_mask_zip(root / plain / str(k) / f"{stem}.pt")
                np.testing.assert_array_equal(got, without & segs[stem])


def test_mask_script_runs_on_cuda_by_default(scene, tmp_path):
    _, ds = scene
    hp = ccm.get_mask_opts([a for a in _mask_args(ds, tmp_path / "m")
                            if a not in ("--device", "cpu")])
    assert hp.device == "cuda" and hp.ray_chunk_size == 48 * 1024
    hp_default = ccm.get_mask_opts(["--dataset_path", "d", "--output", "o",
                                    "--grid_dim", "2", "2"])
    assert hp_default.ray_samples == 1000
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ccm.main(hp)


# ------------------------------------------------------------------ streams

def _port_args(ds, exp, masks, extra=()):
    return ["--dataset_path", str(ds), "--exp_name", str(exp),
            "--cluster_mask_path", str(masks), "--dataset_type", "memory",
            "--near", "0.5", "--far", "3.5", "--ray_altitude_range", *ALT,
            "--coarse_samples", "16", "--fine_samples", "16",
            "--pos_xyz_dim", "6", "--pos_dir_dim", "2", "--layers", "4",
            "--skip_layers", "2", "--layer_dim", "32", "--bg_layer_dim", "32",
            "--appearance_dim", "4", "--batch_size", "64", "--lr", "5e-3",
            "--train_iterations", "4", "--ckpt_interval", "2",
            "--val_interval", "100000", "--val_scale_factor", "1",
            "--compute_dtype", "float32", "--device", "cpu", *extra]


def _j_cell_hparams(ds, masks, exp):
    from mega_nerf_tpu.opts import get_opts_base, parse_opts

    parser = get_opts_base()
    parser.add_argument("--exp_name", type=str)
    parser.add_argument("--dataset_path", type=str)
    args = [a for a in _port_args(ds, exp, masks) if a not in ("--device", "cpu")]
    return parse_opts(parser, args)


def _stream_pair(scene, tmp_path, dataset_type):
    root, ds = scene
    masks = root / "masks"
    port = CellRunner(train_cells.get_train_cells_opts(
        _port_args(ds, tmp_path / "p", masks)))
    j_runner = JCellRunner(_j_cell_hparams(ds, masks, tmp_path / "j"))
    kw = {}
    if dataset_type == "filesystem":
        kw = dict(dataset_type="filesystem", num_chunks=2, disk_flush_size=500)

    def make(cls, runner, chunks):
        extra = dict(kw, chunk_paths=[chunks]) if kw else {}
        return cls(runner.cell_items, runner.near, runner.far, runner.ray_altitude_range,
                   True, 42, **extra)

    return make(CellDataset, port, tmp_path / "pc"), make(JCellDataset, j_runner,
                                                          tmp_path / "jc")


@pytest.mark.parametrize("dataset_type", ["memory", "filesystem"])
def test_cell_streams_match_the_jax_cell_dataset(scene, tmp_path, dataset_type):
    port, want = _stream_pair(scene, tmp_path, dataset_type)
    epochs = set()
    for i in range(14):
        got, exp = port.next_batch(256), want.next_batch(256)
        assert got["rays"].shape == (2, 256, 8)
        for k in ("img_indices", "rgbs"):
            np.testing.assert_array_equal(got[k], exp[k], err_msg=f"batch {i} {k}")
        np.testing.assert_allclose(got["rays"], exp["rays"], rtol=1e-5, atol=1e-5,
                                   err_msg=f"batch {i}")
        assert port.state() == want.state()
        epochs.update(s["epoch"] for s in port.state())
    assert max(epochs) >= 1  # every cell crossed an epoch end
    port.close()


@pytest.mark.parametrize("dataset_type", ["memory", "filesystem"])
def test_cell_stream_set_state_fast_forwards(scene, tmp_path, dataset_type):
    port, _ = _stream_pair(scene, tmp_path, dataset_type)
    for _ in range(9):
        port.next_batch(128)
    state = port.state()
    after = [port.next_batch(128) for _ in range(5)]
    port.close()
    fresh, _ = _stream_pair(scene, tmp_path / "again", dataset_type)
    fresh.set_state(state, 128)
    assert fresh.state() == state
    for a in after:
        b = fresh.next_batch(128)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    fresh.close()


# --------------------------------------------------------------- grid steps

def test_grid_steps_match_jax_and_each_cell_keeps_its_bg_skip():
    hp = tiny_hparams(appearance_dim=4, compute_dtype="float32")
    cells = 2
    jfg, jbg = j_make_nerf(hp, 5), j_make_bg_nerf(hp, 5)
    opt = j_make_optimizer(1e-3, 0.1, 50)
    state = j_make_cell_state(jfg, jbg, opt, jax.random.key(0), cells)
    mesh = make_mesh(cell_axis=cells, data_axis=1)
    jset = JSettings(coarse_samples=16, fine_samples=16, use_pallas=False,
                     perturb=0.0, sigma_noise=False)
    j_step = jax.jit(j_make_cell_step(jfg, jbg, jset, opt, mesh, jnp.asarray(CENTER),
                                      jnp.asarray(RADIUS)))

    tset = RenderSettings(coarse_samples=16, fine_samples=16, perturb=0.0,
                          sigma_noise=False)
    port = make_cell_train_state(lambda: make_nerf(hp, 5), lambda: make_bg_nerf(hp, 5),
                                 tset, 1e-3, 0.1, 50, cells, 0, torch.device("cpu"),
                                 torch.from_numpy(CENTER), torch.from_numpy(RADIUS))
    host = jax.device_get(state)
    for side in ("fg", "bg"):
        cfg = getattr(port[0], side).config
        for c, sd in enumerate(mixture_states_from_flax(cfg, getattr(host, f"{side}_params"),
                                                     cells)):
            getattr(port[c], side).module.load_state_dict(sd)
    step = CellParallelTrainStep(port)

    rng = np.random.default_rng(9)
    for i in range(2):
        # Step 2: cell 0's rows hold no background ray, cell 1's do.
        far_bg = [(0.8 if i == 1 else 1e5), 1e5]
        b = {"rays": np.stack([_rays(16, seed=20 + 2 * i + c, far_bg=far_bg[c])
                               for c in range(cells)]),
             "rgbs": rng.uniform(size=(cells, 16, 3)).astype(np.float32),
             "img_indices": np.tile((np.arange(16) % 5).astype(np.int32), (cells, 1))}
        bg_before = [{k: v.clone() for k, v in cell.bg.module.state_dict().items()}
                     for cell in port]
        bg_mu_before = [None if i == 0 else _torch_moments(
            cell.step.bg_opt, cell.bg.module, cell.bg.config, "exp_avg") for cell in port]
        with mesh:
            state_p, batch_p = place_cell_parallel(mesh, state, b)
            state, jm = j_step(state_p, batch_p)
        tm = step({"rays": torch.from_numpy(b["rays"]), "rgbs": torch.from_numpy(b["rgbs"]),
                   "img_indices": torch.from_numpy(b["img_indices"]).long()})
        assert tm["loss"].shape == (cells,)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]), atol=1e-5)
        host = jax.device_get(state)
        for c, cell in enumerate(port):
            take = lambda t: jax.tree.map(lambda x: np.asarray(x)[c], t)  # noqa: E731
            for side in ("fg", "bg"):
                b_ = getattr(cell, side)
                opt_t = getattr(cell.step, f"{side}_opt")
                _assert_trees_close(flax_params_from_state(b_.config, b_.module.state_dict()),
                                    take(getattr(host, f"{side}_params")), 1e-5,
                                    f"step {i} cell {c} {side} params")
                adam = take(getattr(host, f"{side}_opt"))[0]
                _assert_trees_close(_torch_moments(opt_t, b_.module, b_.config, "exp_avg"),
                                    adam.mu, 1e-5, f"step {i} cell {c} {side} mu")
                _assert_trees_close(_torch_moments(opt_t, b_.module, b_.config, "exp_avg_sq"),
                                    adam.nu, 1e-5, f"step {i} cell {c} {side} nu")
        if i == 1:
            for k, v in port[0].bg.module.state_dict().items():
                assert torch.equal(v, bg_before[0][k]), k
            _assert_trees_close(_torch_moments(port[0].step.bg_opt, port[0].bg.module,
                                               port[0].bg.config, "exp_avg"),
                                bg_mu_before[0], 0, "cell 0 bg mu")
            assert port[0].step.bg_sched.last_epoch == 1
            assert port[1].step.bg_sched.last_epoch == 2
            assert any(not torch.equal(v, bg_before[1][k])
                       for k, v in port[1].bg.module.state_dict().items())


def test_cells_start_from_distinct_seeded_weights():
    hp = tiny_hparams(appearance_dim=0)
    make = lambda: make_cell_train_state(  # noqa: E731
        lambda: make_nerf(hp, 1), None, RenderSettings(), 1e-3, 0.1, 10, 3, 7,
        torch.device("cpu"))
    a, b = make(), make()
    w = [c.fg.module.state_dict()["xyz_encodings.0.0.weight"] for c in a]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    for x, y in zip(a, b):
        assert torch.equal(x.fg.module.state_dict()["xyz_encodings.0.0.weight"],
                           y.fg.module.state_dict()["xyz_encodings.0.0.weight"])
        assert torch.equal(x.generator.get_state(), y.generator.get_state())


# -------------------------------------------------------------- CellRunner

def _train(scene, exp, dataset_type="memory", extra=()):
    root, ds = scene
    args = _port_args(ds, exp, root / "masks", extra)
    if dataset_type == "filesystem":
        args += ["--dataset_type", "filesystem", "--chunk_paths", str(exp.parent / "chunks"),
                 "--num_chunks", "2"]
    runner = CellRunner(train_cells.get_train_cells_opts(args))
    runner.train()
    return runner


@pytest.fixture(scope="module", params=["memory", "filesystem"])
def grid_run(scene, request):
    """An uninterrupted 4-step run (checkpoints at 2 and 4, validation at 2)
    whose every validation render is recorded by cell."""
    root, _ = scene
    exp = root / f"run_{request.param}" / "sub"
    renders = []
    real = CellRunner.render_image

    def recording(self, meta):
        out = real(self, meta)
        renders.append((self.fg, out["rgb_fine"]))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(CellRunner, "render_image", recording)
        runner = _train(scene, exp, request.param, ["--val_interval", "2"])
    return {"runner": runner, "exp": exp, "type": request.param, "renders": renders}


def test_cell_checkpoint_layout_and_keys(grid_run):
    exp, runner = grid_run["exp"], grid_run["runner"]
    for cell in range(2):
        cell_dir = exp.parent / f"sub{cell}" / "0"
        assert sorted(p.name for p in (cell_dir / "models").iterdir()) == ["2.pt", "4.pt"]
        for name in ("hparams.txt", "command.txt", "image_indices.txt"):
            assert (cell_dir / name).exists(), name
        ck = torch.load(cell_dir / "models" / "4.pt", weights_only=False)
        assert {"model_state_dict", "bg_model_state_dict", "optimizers", "iteration",
                "dataset_state", "generator_state", "cell_index", "num_cells",
                "exp_prefix"} <= set(ck)
        assert ck["cell_index"] == cell and ck["num_cells"] == 2 and ck["iteration"] == 4
        assert ck["exp_prefix"] == str(exp.absolute())
        assert set(ck["optimizers"]) == {"nerf", "bg_nerf"}
        state = runner.cells[cell]
        for k, v in state.fg.module.state_dict().items():
            assert torch.equal(ck["model_state_dict"][k], v), k
    assert not (exp.parent / "sub1" / "0" / "tb").exists()  # one log, cell 0's


def test_cell_metrics_log_has_per_cell_keys(grid_run):
    lines = (grid_run["exp"].parent / "sub0" / "0" / "tb" / "metrics.jsonl").read_text()
    keys = {k for line in lines.splitlines() for k in json.loads(line)}
    for cell in range(2):
        assert any(k.startswith(f"val/cell{cell}/psnr") for k in keys), keys
        assert f"train/loss/cell{cell}" in keys
    assert {"train/loss", "train/psnr", "train/rays_per_sec"} <= keys


def test_resumed_from_any_cell_is_bit_equal(grid_run, scene):
    full = grid_run["runner"]
    ckpt = grid_run["exp"].parent / "sub1" / "0" / "models" / "2.pt"
    resumed = _train(scene, grid_run["exp"].parent / "resumed" / "sub", grid_run["type"],
                     ["--ckpt_path", str(ckpt)])
    for a, b in zip(full.cells, resumed.cells):
        for side in ("fg", "bg"):
            sa, sb = getattr(a, side).module.state_dict(), getattr(b, side).module.state_dict()
            for k in sa:
                assert torch.equal(sa[k], sb[k]), (side, k)
            oa = getattr(a.step, f"{side}_opt").state_dict()["state"]
            ob = getattr(b.step, f"{side}_opt").state_dict()["state"]
            for i in oa:
                for key in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(torch.as_tensor(oa[i][key]),
                                       torch.as_tensor(ob[i][key])), (side, i, key)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())
    resumed_ck = torch.load(grid_run["exp"].parent / "resumed" / "sub0" / "0" / "models"
                            / "4.pt", weights_only=False)
    full_ck = torch.load(grid_run["exp"].parent / "sub0" / "0" / "models" / "4.pt",
                         weights_only=False)
    assert resumed_ck["dataset_state"] == full_ck["dataset_state"]


def test_cell_validation_renders_each_cells_current_weights(grid_run):
    runner, renders = grid_run["runner"], grid_run["renders"]
    # The validation at step 2 rendered each cell once, on its own modules.
    assert len(renders) == 2
    assert all(fg is c.fg for (fg, _), c in zip(renders, runner.cells))
    assert not np.array_equal(renders[0][1], renders[1][1])
    # Two steps later (weights changed, packed caches from step 2 in place)
    # a validation renders what freshly packed weights give.
    recorded = []

    def recording(meta):
        out = CellRunner.render_image(runner, meta)
        recorded.append(out["rgb_fine"])
        return out

    own = runner.fg, runner.bg
    runner.render_image = recording
    try:
        runner._run_cell_validation(99)
    finally:
        del runner.render_image
    assert (runner.fg, runner.bg) == own  # the runner's own modules restored
    assert len(recorded) == 2
    for cell, got in zip(runner.cells, recorded):
        for b in (cell.fg, cell.bg):
            b.packed = None
        runner.fg, runner.bg = cell.fg, cell.bg
        try:
            fresh = runner.render_image(runner.val_items[0])["rgb_fine"]
        finally:
            runner.fg, runner.bg = own
        np.testing.assert_array_equal(got, fresh)
    assert not np.array_equal(recorded[0], renders[0][1])


@pytest.mark.parametrize("flag", ["--cell_axis", "--data_axis"])
def test_mesh_axes_raise_naming_the_roadmap(scene, tmp_path, flag):
    root, ds = scene
    hp = train_cells.get_train_cells_opts(_port_args(ds, tmp_path / "sub", root / "masks",
                                                     [flag, "2"]))
    want = ("--cell_axis 2 x --data_axis 1" if flag == "--cell_axis"
            else "--cell_axis 1 x --data_axis 2")
    with pytest.raises(ValueError, match=f"{want} = 2 ranks, but the world has 1"):
        train_cells.main(hp)


def test_train_cells_needs_the_mask_root_and_a_matching_grid(scene, tmp_path):
    root, ds = scene
    args = _port_args(ds, tmp_path / "sub", root / "masks")
    i = args.index("--cluster_mask_path")
    hp = train_cells.get_train_cells_opts(args[:i] + args[i + 2:])
    with pytest.raises(ValueError, match="--cluster_mask_path"):
        train_cells.main(hp)
    hp = train_cells.get_train_cells_opts([a for a in args if a not in ("--device", "cpu")])
    assert hp.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cells.main(hp)
    # A checkpoint of another grid is refused.
    other = tmp_path / "other.pt"
    torch.save({"num_cells": 3, "iteration": 2}, other)
    with pytest.raises(ValueError, match="3 cells"):
        _train(scene, tmp_path / "x" / "sub", extra=["--ckpt_path", str(other)])
