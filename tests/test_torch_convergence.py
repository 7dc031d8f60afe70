"""The port's convergence workflows against the JAX package's, on the CPU.

- `scripts.cell_convergence_run --smoke` (2x1 grid, 4 steps, a checkpoint
  every 2, `--bake` at depth 1): the JAX script's summary keys, the
  per-cell `{iter}.pt`, the container, the octree, two frames; a second
  run with `--resume` restarts every cell from the newest iteration all
  cells have (cell 1's newest file removed: iteration 2) and runs to 6; a
  workdir built for another grid is refused;
- `scripts.convergence_run` at a tiny width (`model_args`): the JAX
  script's summary keys and a val PSNR at each `--val_interval`;
- `scripts.cell_diagnostics --synthetic` on the smoke run's merged
  container at `--grid_res 9`, against the JAX script on the same file:
  `own_points` and `boundary_band_frac` equal, each voxel count and
  occupied fraction within 2 voxels, `boundary_alpha_spread` within 1e-4;
- both packages' `Runner.train` (ROADMAP.md C.5) for 200 steps at 2 x 32,
  32 + 64 samples, batch 64, f32, from the same initial weights (the JAX
  init carried by `state_from_flax_params`) on the same batch stream of
  the port's ring scene, perturbation and sigma noise off, on every ray
  and on cell 0's rays of a 2x1 grid (`convergence_run`'s masks): the
  final val PSNR within 0.1 dB, the loss at each logged step (every 20)
  beside it.
"""

import ast
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import mega_nerf_tpu.runtime.runner as j_runner_mod
import mega_nerf_tpu_torch.runtime.runner as t_runner_mod
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.render.rendering import RenderSettings as JSettings
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch.data.synthetic import make_synthetic_dataset
from mega_nerf_tpu_torch.models import state_from_flax_params
from mega_nerf_tpu_torch.render.rendering import RenderSettings as TSettings
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from mega_nerf_tpu_torch.scripts import cell_convergence_run as ccr
from mega_nerf_tpu_torch.scripts import cell_diagnostics as cdiag
from mega_nerf_tpu_torch.scripts import convergence_run as cvr
from mega_nerf_tpu_torch.train import get_train_opts
from tests.test_torch_eval import _j_hparams

REPO = Path(__file__).resolve().parents[1]
SMOKE_DIMS = ["--layers", "2", "--skip_layers", "1", "--layer_dim", "32",
              "--bg_layer_dim", "32", "--pos_xyz_dim", "6", "--pos_dir_dim", "2",
              "--appearance_dim", "8"]


@pytest.fixture(scope="module", autouse=True)
def no_tensorboard():
    """Both packages' metrics writers keep to their JSON lines (the
    TensorBoard import pulls TensorFlow in, ~10 s a process)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        yield


def jax_summary_keys(script: str):
    """(keys every summary of the JAX script has, keys only some have):
    the string keys of its `summary = {...}` literal and of the
    `bake[...]` entries it spreads into it, and those set later by
    `summary[...] = ...`."""
    tree = ast.parse((REPO / "scripts" / script).read_text())
    always, sometimes = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == "summary" and isinstance(node.value, ast.Dict):
            always |= {k.value for k in node.value.keys if isinstance(k, ast.Constant)}
        elif isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript):
            target = node.targets[0]
            if isinstance(target.value, ast.Name) and isinstance(target.slice, ast.Constant):
                {"bake": always, "summary": sometimes}.get(target.value.id, set()).add(
                    target.slice.value)
    return always, sometimes


# ------------------------------------------------------ the grid workflow

@pytest.fixture(scope="module")
def smoke_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("cell_convergence") / "work"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ccr, "BAKE_DEPTH", 1)
        summary = ccr.main(["--smoke", "--steps", "4", "--ckpt_interval", "2", "--bake",
                            "--workdir", str(work), "--device", "cpu"])
    return work, summary


def test_smoke_run_writes_the_jax_scripts_summary(smoke_run):
    work, summary = smoke_run
    always, sometimes = jax_summary_keys("cell_convergence_run.py")
    assert sometimes == {"resumed_from_iteration"}
    assert set(summary) == always
    assert json.loads((work / "summary.json").read_text()) == summary
    assert summary["steps"] == 4 and summary["num_cells"] == 2
    assert np.isfinite(summary["merged_val_psnr"])
    assert summary["flythrough_frames"] == 2
    for cell in range(2):
        for it in (2, 4):
            ckpt = torch.load(work / f"sub{cell}" / "0" / "models" / f"{it}.pt",
                              weights_only=False)
            assert (ckpt["cell_index"], ckpt["iteration"]) == (cell, it)
    assert (work / "merged.pt").exists() and (work / "octree.npz").exists()
    assert sorted(p.name for p in (work / "frames" / "cells").iterdir()) == [
        "000000.jpg", "000001.jpg"]


def test_a_workdir_of_another_grid_is_refused(smoke_run):
    work, _ = smoke_run
    with pytest.raises(SystemExit, match="was built with"):
        ccr.main(["--smoke", "--grid", "1", "2", "--steps", "4", "--workdir", str(work),
                  "--device", "cpu"])


def test_cell_diagnostics_match_the_jax_script(smoke_run, tmp_path, monkeypatch):
    work, _ = smoke_run
    import scripts.cell_diagnostics as j_diag

    flags = ["--container", str(work / "merged.pt"), "--grid_res", "9", "--synthetic",
             "--sigma_thresh", "0.35", *SMOKE_DIMS]
    out = {}
    for name in ("jax", "port"):
        (tmp_path / name).mkdir()
        argv = ["--workdir", str(tmp_path / name), *flags]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["cell_diagnostics.py", *argv])
            j_diag.main()
        else:
            cdiag.main(argv + ["--device", "cpu"], compute_dtype="float32")
        out[name] = json.loads((tmp_path / name / "cell_diagnostics.json").read_text())
    want, got = out["jax"], out["port"]
    assert set(got["summary"]) == set(want["summary"])
    for key in ("cells", "grid_res", "boundary_band_frac"):
        assert got["summary"][key] == want["summary"][key], key
    for key in ("total_floater_voxels", "total_missing_voxels"):
        assert abs(got["summary"][key] - want["summary"][key]) <= 2, key
    fracs = []
    for g, w in zip(got["cells"], want["cells"]):
        assert set(g) == set(w)
        assert (g["cell"], g["centroid"], g["own_points"]) == (
            w["cell"], w["centroid"], w["own_points"])
        for key in ("floater_voxels", "missing_voxels"):
            assert abs(g[key] - w[key]) <= 2, key
        # Fractions as voxels (the rows round them to 4 decimals).
        for key in ("own_occupied_frac", "floater_frac_of_region"):
            assert abs(g[key] - w[key]) * g["own_points"] <= 2 + 1e-4 * g["own_points"], key
        assert abs(g["boundary_alpha_spread"] - w["boundary_alpha_spread"]) <= 1e-4 + 1e-12
        fracs.append(w["own_occupied_frac"])
    # The threshold splits each region, so the comparison has voxels to count.
    assert all(0.05 < f < 0.95 for f in fracs), fracs


def test_resume_restarts_every_cell_from_the_common_checkpoint(smoke_run):
    work, _ = smoke_run
    (work / "sub1" / "0" / "models" / "4.pt").unlink()  # cell 1's newest: 2
    assert ccr.common_checkpoint(work, 2) == (0, 2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ccr, "BAKE_DEPTH", 1)
        summary = ccr.main(["--smoke", "--steps", "6", "--resume", "--bake",
                            "--workdir", str(work), "--device", "cpu"])
    always, sometimes = jax_summary_keys("cell_convergence_run.py")
    assert set(summary) == always | sometimes
    assert summary["resumed_from_iteration"] == 2 and summary["steps"] == 6
    for cell in range(2):
        ckpt = torch.load(work / f"sub{cell}" / "1" / "models" / "6.pt", weights_only=False)
        assert ckpt["iteration"] == 6 and ckpt["cell_index"] == cell
        assert not list((work / f"sub{cell}" / "1" / "models").glob("[0-5].pt"))
    assert np.isfinite(summary["merged_val_psnr"]) and summary["flythrough_frames"] == 2


def test_convergence_run_at_a_tiny_width(tmp_path):
    tiny = ["--coarse_samples", "16", "--fine_samples", "32", *SMOKE_DIMS,
            "--batch_size", "64"]
    summary = cvr.main(["--steps", "4", "--val_interval", "2", "--hw", "16",
                        "--n_train", "4", "--workdir", str(tmp_path), "--device", "cpu"],
                       model_args=tiny)
    always, sometimes = jax_summary_keys("convergence_run.py")
    assert not sometimes and set(summary) == always
    assert json.loads((tmp_path / "summary.json").read_text()) == json.loads(
        json.dumps(summary))
    assert [s for s, _ in summary["val_psnr_curve"]] == [2, 4]
    assert all(np.isfinite(p) for _, p in summary["val_psnr_curve"])
    assert (Path(summary["experiment"]) / "models" / "4.pt").exists()
    assert sorted(p.name for p in (tmp_path / "masks").iterdir()) == ["0", "1", "params.pt"]


# ------------------------------------------- C.5: training against the JAX package

PARITY_STEPS = 200
LOG_EVERY = 20


def _parity_args(ds, exp):
    return [
        "--dataset_path", str(ds), "--exp_name", str(exp), "--dataset_type", "memory",
        "--near", "0.5", "--ray_altitude_range", "-2.0", "2.0",
        "--coarse_samples", "32", "--fine_samples", "64", "--pos_xyz_dim", "6",
        "--pos_dir_dim", "2", "--layers", "2", "--skip_layers", "1", "--layer_dim", "32",
        "--bg_layer_dim", "32", "--appearance_dim", "4", "--compute_dtype", "float32",
        "--batch_size", "64", "--lr", "5e-3", "--perturb", "0",
        "--train_iterations", str(PARITY_STEPS), "--ckpt_interval", "100000",
        "--val_interval", "100000", "--val_scale_factor", "1",
    ]


def _losses(exp):
    with open(Path(exp) / "0" / "tb" / "metrics.jsonl") as f:
        return {rec["step"]: rec["train/loss"] for rec in map(json.loads, f)
                if "train/loss" in rec}


def _val_psnr(exp):
    """The mean over the val views of the last validation's PSNRs (each
    view's `val/psnr/{i}` scalar in `metrics.jsonl`)."""
    with open(Path(exp) / "0" / "tb" / "metrics.jsonl") as f:
        recs = [rec for rec in map(json.loads, f) if any(k.startswith("val/psnr/") for k in rec)]
    last = max(rec["step"] for rec in recs)
    views = {k: v for rec in recs if rec["step"] == last
             for k, v in rec.items() if k.startswith("val/psnr/")}
    return float(np.mean(list(views.values())))


def _no_noise(settings_cls):
    """`RenderSettings` whose `from_hparams` turns the sigma noise off."""
    class NoNoise:
        @staticmethod
        def from_hparams(hparams, **overrides):
            return settings_cls.from_hparams(hparams, **{"sigma_noise": False, **overrides})
    return NoNoise


@pytest.mark.parametrize("cell", [None, 0], ids=["all_rays", "cell0_mask"])
def test_training_matches_the_jax_runner_over_200_steps(tmp_path, cell):
    """Without masks, and on cell 0's rays of a 2x1 grid as
    `convergence_run` trains (the masks' val-view rebalancing included;
    with masks neither Runner validates at the end, so both validate at
    step 200)."""
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=6, n_val=1, hw=(16, 16),
                                device="cpu")
    extra = []
    if cell is not None:
        cvr.build_masks(ds, tmp_path / "masks", cvr.MASK_GRID, "cpu")
        extra = ["--cluster_mask_path", str(tmp_path / "masks" / str(cell)),
                 "--val_interval", str(PARITY_STEPS)]
    init = {}

    def recording_state(fg, bg, optimizer, key):
        state = jax.jit(lambda k: j_make_state(fg, bg, optimizer, k))(key)
        init.update(fg=jax.device_get(state.fg_params), bg=jax.device_get(state.bg_params))
        return state

    j_hp = _j_hparams(_parity_args(ds, tmp_path / "jexp") + extra + ["--data_axis", "1"])
    t_hp = get_train_opts(_parity_args(ds, tmp_path / "texp") + extra + ["--device", "cpu"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_runner_mod, "make_train_state", recording_state)
        mp.setattr(j_runner_mod, "RenderSettings", _no_noise(JSettings))
        mp.setattr(j_runner_mod, "METRICS_CHECK_INTERVAL", LOG_EVERY)
        JRunner(j_hp).train()

        def jax_init(module, generator):
            side = "fg" if generator.initial_seed() == t_hp.random_seed else "bg"
            module.load_state_dict(state_from_flax_params(module.config, init[side]))

        mp.setattr(t_runner_mod, "init_weights", jax_init)
        mp.setattr(t_runner_mod, "RenderSettings", _no_noise(TSettings))
        mp.setattr(t_runner_mod, "METRICS_CHECK_INTERVAL", LOG_EVERY)
        t_final = TRunner(t_hp).train()

    j_psnr, t_psnr = _val_psnr(tmp_path / "jexp"), _val_psnr(tmp_path / "texp")
    if cell is None:  # the final validation's average, as metrics.txt has it
        assert t_psnr == pytest.approx(t_final["val/psnr"], abs=1e-9)
    j_loss, t_loss = _losses(tmp_path / "jexp"), _losses(tmp_path / "texp")
    assert sorted(j_loss) == sorted(t_loss) == list(range(LOG_EVERY, PARITY_STEPS + 1,
                                                          LOG_EVERY))
    table = "; ".join(f"step {s}: loss jax {j_loss[s]:.6f} port {t_loss[s]:.6f}"
                      for s in sorted(j_loss))
    print(f"val PSNR jax {j_psnr:.4f} port {t_psnr:.4f}; {table}")
    steps = sorted(t_loss)
    first = np.mean([t_loss[s] for s in steps[:3]])
    assert np.mean([t_loss[s] for s in steps[-3:]]) < 0.6 * first, table  # it learns
    assert abs(t_psnr - j_psnr) <= 0.1, f"val PSNR jax {j_psnr:.4f} port {t_psnr:.4f}; {table}"


# ------------------------------------------ the init against flax's defaults

def test_init_draws_the_jax_packages_distributions():
    """`init_weights` draws what the JAX package's flax modules draw, at
    the paper config: every weight LeCun normal as `lecun_normal` (unit
    variance after the 1/fan_in scaling, nothing past 2 / 0.8796 standard
    deviations, the bound flax's own draw keeps too), every bias zero, the
    appearance embedding an untruncated normal of variance 1/dim (flax's
    `nn.Embed`)."""
    import flax.linen as nn
    import jax.numpy as jnp

    from mega_nerf_tpu_torch.models import init_weights, make_nerf

    hp = get_train_opts(["--dataset_path", ".", "--exp_name", ".", *cvr.PAPER_MODEL])
    module = make_nerf(hp, 30).module
    init_weights(module, torch.Generator().manual_seed(0))
    bound = 2.0 / 0.87962566103423978
    ref = np.asarray(nn.initializers.lecun_normal()(jax.random.PRNGKey(0), (256, 256),
                                                    jnp.float32)) * 16.0
    assert np.abs(ref).max() <= bound * (1 + 1e-6) and abs(ref.std() - 1.0) < 0.02
    seen = set()
    for name, p in module.named_parameters():
        z = p.detach().numpy() * p.shape[-1] ** 0.5
        if name.endswith("bias"):
            assert not z.any(), name
        elif "embedding_a" in name:
            assert p.shape == (30, 48) and abs(z.std() - 1.0) < 0.1 and np.abs(z).max() > bound
            seen.add("embedding")
        else:
            assert np.abs(z).max() <= bound * (1 + 1e-5), name
            if p.numel() >= 4096:
                assert abs(z.std() - 1.0) < 0.05, name
            seen.add("weight")
    assert seen == {"embedding", "weight"}
