"""A port run resumed and evaluated from the JAX package's `.ckpt`, on the
CPU.

- (a) the JAX `make_train_step` takes 2 steps (perturb 0, no sigma noise,
  f32; the second without a bg ray), its state saved by the JAX package's
  `save_checkpoint`; the port reads it into a `TrainStep`, and both take 2
  more steps on the same batches, the last without a bg ray: loss,
  parameters and Adam moments atol 1e-5, the bg count behind fg's in both;
- (b) the JAX `Runner.train` writes `2.ckpt`; the port's `train.main
  --ckpt_path 2.ckpt` runs to 4 on the batches the JAX Runner took for its
  steps 3-4, with the schedules at their Adam counts; the port's
  `eval.main` on `2.ckpt` is within 0.01 dB PSNR of the JAX `Runner.eval`;
- (c) a joint-mixture (`--train_mega_nerf`) `.ckpt` read exactly, resumed,
  and evaluated densely and routed;
- (d) flags that disagree with the checkpoint raise, naming the key;
- (e) the reader runs in an interpreter without jax, flax or msgpack;
- `chip_smoke.py`'s own `.ckpt` writer: its file restores through the JAX
  package's `load_checkpoint` leaf for leaf, and reads through the port
  as a file the JAX package wrote from the same state does.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import mega_nerf_tpu.runtime.runner as j_runner_mod
from mega_nerf_tpu.data.torch_io import save_pt
from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.parallel.train_step import make_train_step as j_make_step
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu.runtime import checkpoints as j_ckpt
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.models import flax_params_from_state, make_bg_nerf, make_nerf
from mega_nerf_tpu_torch.parallel.train_step import TrainStep, adam_steps
from mega_nerf_tpu_torch.render.rendering import RenderSettings
from mega_nerf_tpu_torch.runtime.checkpoints import load_checkpoint, read_jax_checkpoint
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from tests.synthetic import make_synthetic_dataset
from tests.test_models import tiny_hparams
from tests.test_torch_cells_ckpt import _assert_same_tree
from tests.test_torch_eval import _args, _j_hparams, _metric
from tests.test_torch_train_loop import CENTER, RADIUS, _assert_trees_close, _rays

REPO = Path(__file__).resolve().parent.parent
COUNT = 5  # appearance rows of the tiny models
OPT = dict(lr=1e-3, lr_decay_factor=0.1, train_iterations=50)
AUX = {"iteration": 2, "dataset_state": {"epoch": 0, "batch_index": 1},
       "np_rng_state": np.random.default_rng(0).bit_generator.state}
CENTROIDS = np.array([[0.0, -0.7, 0.0], [0.0, 0.7, 0.0]], np.float32)


@pytest.fixture(scope="module", autouse=True)
def quick_setup():
    """Both packages' metrics writers keep to their JSON lines (the
    TensorBoard import pulls TensorFlow in, ~10 s a process), and the JAX
    Runner makes its train state in one compiled program (`_state`)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "torch.utils.tensorboard", None)
        mp.setattr(j_runner_mod, "make_train_state", _state)
        yield


def _state(fg, bg, optimizer, key):
    """The JAX `make_train_state` as one compiled program: run eagerly, its
    flax init compiles each op on its own (~10 s on the CPU)."""
    return jax.jit(lambda k: j_make_state(fg, bg, optimizer, k))(key)


def _tiny_hparams(**kw):
    return tiny_hparams(**{"appearance_dim": 4, "compute_dtype": "float32", **OPT, **kw})


def _batch(i, far_bg):
    rng = np.random.default_rng(20 + i)
    return {"rays": _rays(16, seed=10 + i, far_bg=far_bg),
            "rgbs": rng.uniform(size=(16, 3)).astype(np.float32),
            "img_indices": (np.arange(16) % COUNT).astype(np.int32)}


def _torch_batch(b):
    return {"rays": torch.from_numpy(b["rays"]), "rgbs": torch.from_numpy(b["rgbs"]),
            "img_indices": torch.from_numpy(b["img_indices"]).long()}


def _moments(opt, bundle, key):
    """A torch Adam's moments of one NeRF as a Flax tree."""
    return flax_params_from_state(
        bundle.config, {n: opt.state[p][key] for n, p in bundle.module.named_parameters()})


def _random_state(fg, bg, optimizer, seed, fg_count, bg_count):
    """A JAX train state of the bundles' structure without running the
    init: every float leaf seeded noise (the second moments its
    magnitude), the fg and bg (Adam and schedule) counts the given ones."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: j_make_state(fg, bg, optimizer, k),
                            jax.random.PRNGKey(0))
    state = jax.tree.map(
        lambda x: (0.3 * rng.normal(size=x.shape)).astype(x.dtype)
        if np.issubdtype(x.dtype, np.floating) else np.zeros(x.shape, x.dtype), shapes)

    def opt(tree, count):
        adam, sched = tree
        return (adam._replace(count=np.asarray(count, np.int32),
                              nu=jax.tree.map(np.abs, adam.nu)),
                sched._replace(count=np.asarray(count, np.int32)))

    return state.replace(fg_opt=opt(state.fg_opt, fg_count),
                         bg_opt=opt(state.bg_opt, bg_count))


# ------------------------------------------------------------ (a) the step

def test_two_resumed_steps_match_jax_with_the_bg_skip(tmp_path):
    hp = _tiny_hparams()
    jfg, jbg = j_make_nerf(hp, COUNT), j_make_bg_nerf(hp, COUNT)
    # lr 1e-3, as `test_two_train_steps_match_jax_and_bg_skip`: Adam turns
    # float noise in a near-eps gradient into an update of up to lr.
    opt = j_make_optimizer(1e-3, 0.1, 50)
    state = _state(jfg, jbg, opt, jax.random.PRNGKey(0))
    j_step = jax.jit(j_make_step(jfg, jbg, JSettings(
        coarse_samples=16, fine_samples=16, use_pallas=False, perturb=0.0,
        sigma_noise=False), opt, jnp.asarray(CENTER), jnp.asarray(RADIUS)))
    # The second and the fourth batch hold no background ray.
    batches = [_batch(i, far_bg) for i, far_bg in enumerate((1e5, 0.8, 1e5, 0.8))]
    for b in batches[:2]:
        state, _ = j_step(state, {k: jnp.asarray(v) for k, v in b.items()})
    path = tmp_path / "2.ckpt"
    j_ckpt.save_checkpoint(path, jax.device_get(state), AUX)

    loaded = load_checkpoint(path, hp, COUNT)
    assert loaded["iteration"] == 2 and loaded["dataset_state"] == AUX["dataset_state"]
    assert "generator_state" not in loaded
    tfg, tbg = make_nerf(hp, COUNT), make_bg_nerf(hp, COUNT)
    tfg.module.load_state_dict(loaded["model_state_dict"])
    tbg.module.load_state_dict(loaded["bg_model_state_dict"])
    step = TrainStep(tfg, tbg, RenderSettings(coarse_samples=16, fine_samples=16,
                                              perturb=0.0, sigma_noise=False),
                     1e-3, 0.1, 50, torch.from_numpy(CENTER), torch.from_numpy(RADIUS))
    step.load_optimizer_states(loaded["optimizers"])
    assert (step.fg_sched.last_epoch, step.bg_sched.last_epoch) == (2, 1)
    assert step.fg_opt.param_groups[0]["lr"] == pytest.approx(1e-3 * 0.1 ** (2 / 50))
    sides = (("fg", tfg, step.fg_opt), ("bg", tbg, step.bg_opt))
    for side, bundle, t_opt in sides:  # the `.ckpt`'s state, exactly
        adam = getattr(state, f"{side}_opt")[0]
        _assert_trees_close(flax_params_from_state(bundle.config, bundle.module.state_dict()),
                            getattr(state, f"{side}_params"), 0, f"{side} params")
        _assert_trees_close(_moments(t_opt, bundle, "exp_avg"), adam.mu, 0, f"{side} mu")
        _assert_trees_close(_moments(t_opt, bundle, "exp_avg_sq"), adam.nu, 0, f"{side} nu")

    for i, b in enumerate(batches[2:], start=3):
        state, jm = j_step(state, {k: jnp.asarray(v) for k, v in b.items()})
        tm = step(_torch_batch(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), atol=1e-5)
        for side, bundle, t_opt in sides:
            adam = getattr(state, f"{side}_opt")[0]
            _assert_trees_close(
                flax_params_from_state(bundle.config, bundle.module.state_dict()),
                getattr(state, f"{side}_params"), 1e-5, f"step {i} {side} params")
            _assert_trees_close(_moments(t_opt, bundle, "exp_avg"), adam.mu, 1e-5,
                                f"step {i} {side} mu")
            _assert_trees_close(_moments(t_opt, bundle, "exp_avg_sq"), adam.nu, 1e-5,
                                f"step {i} {side} nu")
    # The bg count stays behind fg's in both packages.
    assert [int(state.fg_opt[j].count) for j in (0, 1)] == [4, 4]
    assert [int(state.bg_opt[j].count) for j in (0, 1)] == [2, 2]
    assert step.fg_sched.last_epoch == adam_steps(step.fg_opt) == 4
    assert step.bg_sched.last_epoch == adam_steps(step.bg_opt) == 2


# ---------------------------------------------------------- (b) the Runner

def _run_args(ds, exp, steps, extra=()):
    return _args(ds, exp, True) + [
        "--dataset_type", "memory", "--batch_size", "64", "--train_iterations",
        str(steps), "--ckpt_interval", "2", "--val_interval", "100000", "--lr", "5e-3",
        *extra]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX `Runner.train` to 4 (a `.ckpt` at 2 and 4), its batches
    recorded (validation stubbed out: the batches and files only)."""
    tmp = tmp_path_factory.mktemp("jax_run")
    ds = make_synthetic_dataset(tmp / "ds", n_train=3, n_val=1, hw=(16, 16))
    batches = []
    shard = j_runner_mod.shard_batch

    def recording_shard(mesh, batch):
        batches.append({k: np.asarray(v) for k, v in batch.items()})
        return shard(mesh, batch)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_runner_mod, "shard_batch", recording_shard)
        mp.setattr(JRunner, "_run_validation", lambda self, *a, **k: {})
        # One device: the JAX step compiles for one, not for the 8 virtual ones.
        JRunner(_j_hparams(_run_args(ds, tmp / "jexp", 4, ["--data_axis", "1"]))).train()
    return {"ds": ds, "tmp": tmp, "models": tmp / "jexp" / "0" / "models",
            "batches": batches}


def test_train_main_resumes_a_jax_runner_ckpt(jax_run):
    run = jax_run
    ckpt = run["models"] / "2.ckpt"
    steps, batches = [], []
    call = TrainStep.__call__

    def recording(self, batch, generator=None):
        steps.append(self)
        batches.append({k: v.numpy().copy() for k, v in batch.items()})
        return call(self, batch, generator)

    exp = run["tmp"] / "resumed"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TrainStep, "__call__", recording)
        val = port_train.main(port_train.get_train_opts(_run_args(
            run["ds"], exp, 4, ["--ckpt_path", str(ckpt), "--device", "cpu"])))
    assert np.isfinite(val["val/psnr"])
    got = torch.load(exp / "0" / "models" / "4.pt", weights_only=False)
    assert got["iteration"] == 4
    # The batches of the JAX Runner's steps 3 and 4, from the same stream
    # position (rays made by each package's own ops: 1e-5).
    want = run["batches"][2:]
    assert len(batches) == len(want) == 2
    assert got["dataset_state"] == read_jax_checkpoint(run["models"] / "4.ckpt")[1][
        "dataset_state"]
    for i, (g, w) in enumerate(zip(batches, want)):
        np.testing.assert_array_equal(g["img_indices"], w["img_indices"], err_msg=f"batch {i}")
        np.testing.assert_array_equal(g["rgbs"], w["rgbs"], err_msg=f"batch {i}")
        np.testing.assert_allclose(g["rays"], w["rays"], rtol=1e-5, atol=1e-5,
                                   err_msg=f"batch {i}")
    # Each schedule stands at its own Adam count, the JAX run's counts.
    step = steps[-1]
    j_arrays, _ = read_jax_checkpoint(run["models"] / "4.ckpt")
    for side, sched, opt in (("fg", step.fg_sched, step.fg_opt),
                             ("bg", step.bg_sched, step.bg_opt)):
        want_count = int(j_arrays[f"{side}_opt"]["0"]["count"])
        assert sched.last_epoch == adam_steps(opt) == want_count, side
    assert step.fg_sched.last_epoch == 4


def test_eval_of_a_jax_ckpt_matches_the_jax_eval(jax_run):
    run = jax_run
    ckpt = run["models"] / "2.ckpt"
    metrics = port_eval.main(port_eval.get_eval_opts(_args(
        run["ds"], run["tmp"] / "teval", True) + ["--ckpt_path", str(ckpt), "--device", "cpu"]))
    JRunner(_j_hparams(_args(run["ds"], run["tmp"] / "jeval", True)
                       + ["--ckpt_path", str(ckpt)])).eval()
    assert np.isfinite(metrics["val/psnr"])
    assert abs(_metric(run["tmp"] / "jeval", "val/psnr") - metrics["val/psnr"]) < 0.01


# ----------------------------------------------------- (c) a joint mixture

def test_a_joint_mixture_ckpt_resumes_and_evaluates(tmp_path):
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))
    params = tmp_path / "params.pt"
    save_pt({"centroids": CENTROIDS, "cluster_2d": False, "grid_dim": [2, 1],
             "min_position": np.full(3, -1.5, np.float32),
             "max_position": np.full(3, 1.5, np.float32)}, params)
    mega = ["--train_mega_nerf", str(params)]
    hp = port_train.get_train_opts(_run_args(ds, tmp_path / "unused", 5,
                                             mega + ["--device", "cpu"]))
    runner = TRunner(hp, set_experiment_path=False)
    count = len(runner.train_items)
    j_hp = _j_hparams(_args(ds, tmp_path / "unused", True))
    j_hp._mega_centroid_metadata = {"centroids": CENTROIDS, "cluster_2d": False}
    state = _random_state(j_make_nerf(j_hp, count), j_make_bg_nerf(j_hp, count),
                          j_make_optimizer(5e-3, 0.1, 5), 3, fg_count=3, bg_count=2)
    ckpt = tmp_path / "3.ckpt"
    j_ckpt.save_checkpoint(ckpt, state, {**AUX, "iteration": 3})

    # Read exactly: every submodule's weights and moments, its own counts.
    runner._load_weights(ckpt)
    loaded = load_checkpoint(ckpt, hp, count)
    for side, bundle, opt_name in (("fg", runner.fg, "nerf"), ("bg", runner.bg, "bg_nerf")):
        assert bundle.is_mega and len(bundle.module) == 2
        names = [n for n, _ in bundle.module.named_parameters()]
        entries = loaded["optimizers"][opt_name]["state"]
        for key, moment in (("model", None), ("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            sub_trees = [flax_params_from_state(bundle.config, {
                n[2:]: (p.detach() if moment is None else entries[names.index(n)][moment])
                for n, p in bundle.module.named_parameters() if n.startswith(f"{k}.")})
                for k in range(2)]
            stacked = jax.tree.map(lambda *xs: np.stack(xs), *sub_trees)
            adam = getattr(state, f"{side}_opt")[0]
            want = {"model": getattr(state, f"{side}_params"), "mu": adam.mu,
                    "nu": adam.nu}[key]
            _assert_trees_close(stacked, want, 0, f"{side} {key}")
        assert {float(e["step"]) for e in entries.values()} == {3.0 if side == "fg" else 2.0}

    port_train.main(port_train.get_train_opts(_run_args(
        ds, tmp_path / "resumed", 5, mega + ["--ckpt_path", str(ckpt), "--device", "cpu"])))
    got = torch.load(tmp_path / "resumed" / "0" / "models" / "5.pt", weights_only=False)
    assert got["iteration"] == 5
    assert {float(e["step"]) for e in got["optimizers"]["nerf"]["state"].values()} == {5.0}
    psnrs = {}
    for routing in ("dense", "routed"):
        psnrs[routing] = port_eval.main(port_eval.get_eval_opts(
            _args(ds, tmp_path / f"e_{routing}", True) + mega + [
                "--ckpt_path", str(ckpt), "--device", "cpu", "--mega_routing", routing])
        )["val/psnr"]
    assert np.isfinite(psnrs["dense"])
    assert abs(psnrs["dense"] - psnrs["routed"]) <= 0.01


# ------------------------------------------------- (d), (e): the reader

@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    """A `.ckpt` of the tiny fg + bg models, with seeded Adam moments."""
    hp = _tiny_hparams()
    state = _random_state(j_make_nerf(hp, COUNT), j_make_bg_nerf(hp, COUNT),
                          j_make_optimizer(1e-3, 0.1, 50), 5, fg_count=2, bg_count=1)
    path = tmp_path_factory.mktemp("tiny_ckpt") / "2.ckpt"
    j_ckpt.save_checkpoint(path, state, AUX)
    return path


@pytest.mark.parametrize("flags, count, key", [
    ({"layer_dim": 32}, COUNT, r"xyz_encodings\.0\.0\.weight"),
    ({"bg_layer_dim": 8}, COUNT, r"bg_params: xyz_encodings\.0\.0\.weight"),
    ({"layers": 4, "skip_layers": [2]}, COUNT, r"trunk_3/kernel \(xyz_encodings\.3\.0\.weight\)"),
    ({"appearance_dim": 8}, COUNT, r"embedding_a\.weight"),
    ({}, COUNT + 1, r"embedding_a\.weight"),
    ({"appearance_dim": 0}, COUNT, r"appearance/embedding"),
], ids=["layer_dim", "bg_layer_dim", "layers", "appearance_dim", "appearance_count",
        "no_appearance"])
def test_flags_that_disagree_with_the_ckpt_raise_naming_the_key(tiny_ckpt, flags, count, key):
    with pytest.raises(ValueError, match=key):
        load_checkpoint(tiny_ckpt, _tiny_hparams(**flags), count)


def test_reader_needs_no_jax_flax_or_msgpack(tiny_ckpt, tmp_path):
    hp = vars(_tiny_hparams())
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack', 'optax'):\n"
        "    sys.modules[name] = None  # any import of them fails\n"
        "from argparse import Namespace\n"
        "import torch\n"
        "from mega_nerf_tpu_torch.runtime.checkpoints import load_checkpoint\n"
        f"loaded = load_checkpoint({str(tiny_ckpt)!r}, Namespace(**{hp!r}), {COUNT})\n"
        f"torch.save(loaded, {str(tmp_path / 'read.pt')!r})\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and m.split('.')[0] in ('jax', 'flax', 'msgpack', 'optax', 'mega_nerf_tpu')]\n"
        "assert not bad, bad\n"
        "print('read', sorted(loaded))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = torch.load(tmp_path / "read.pt", weights_only=False)
    want = load_checkpoint(tiny_ckpt, _tiny_hparams(), COUNT)
    assert sorted(got) == sorted(want) == ["bg_model_state_dict", "dataset_state",
                                           "iteration", "model_state_dict", "optimizers"]
    for key in ("model_state_dict", "bg_model_state_dict"):
        assert got[key].keys() == want[key].keys()
        assert all(torch.equal(got[key][k], want[key][k]) for k in want[key])
    for name in ("nerf", "bg_nerf"):
        g, w = got["optimizers"][name], want["optimizers"][name]
        assert g["param_groups"] == w["param_groups"] and g["state"].keys() == w["state"].keys()
        for i, entry in w["state"].items():
            assert all(torch.equal(g["state"][i][k], v) for k, v in entry.items())
    assert float(got["optimizers"]["bg_nerf"]["state"][0]["step"]) == 1.0


# --------------------------------------------- chip_smoke.py's own writer

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_writer_restores_in_jax_and_reads_like_a_jax_file(tmp_path):
    smoke = _chip_smoke()
    hp = _tiny_hparams()
    tfg, tbg = make_nerf(hp, COUNT), make_bg_nerf(hp, COUNT)
    for seed, bundle in enumerate((tfg, tbg)):
        torch.manual_seed(seed)
        for p in bundle.module.parameters():
            torch.nn.init.normal_(p, std=0.3)
    step = TrainStep(tfg, tbg, RenderSettings(coarse_samples=16, fine_samples=16),
                     1e-3, 0.1, 50, torch.from_numpy(CENTER), torch.from_numpy(RADIUS))
    for i, far_bg in enumerate((1e5, 0.8)):  # the second without a bg ray
        step(_torch_batch(_batch(i, far_bg)), torch.Generator().manual_seed(i))
    pt = {"model_state_dict": tfg.module.state_dict(),
          "bg_model_state_dict": tbg.module.state_dict(),
          "optimizers": step.optimizer_states(), "iteration": 2,
          "dataset_state": AUX["dataset_state"]}
    tree = smoke.jax_train_state_tree(pt, tfg, tbg, key=[0, 7])
    assert int(tree["fg_opt"]["0"]["count"]) == 2 and int(tree["bg_opt"]["1"]["count"]) == 1
    path = smoke.write_jax_checkpoint(tmp_path / "smoke.ckpt", tree, AUX)

    # The JAX package restores it into its TrainState, leaf for leaf.
    template = _random_state(j_make_nerf(hp, COUNT), j_make_bg_nerf(hp, COUNT),
                             j_make_optimizer(1e-3, 0.1, 50), 0, 0, 0)
    restored, aux = j_ckpt.load_checkpoint(path, template)
    assert aux == AUX
    _assert_same_tree(jax.tree.map(np.asarray, serialization.to_state_dict(restored)), tree)
    # The port reads it as it reads the file the JAX package writes of it,
    # and back into the `{iter}.pt` it came from.
    j_ckpt.save_checkpoint(tmp_path / "jax.ckpt", restored, aux)
    got, want = read_jax_checkpoint(path), read_jax_checkpoint(tmp_path / "jax.ckpt")
    _assert_same_tree(got[0], want[0])
    assert got[1] == want[1]
    back = load_checkpoint(path, hp, COUNT)
    for key in ("model_state_dict", "bg_model_state_dict"):
        assert all(torch.equal(back[key][k], v) for k, v in pt[key].items())
    for name in ("nerf", "bg_nerf"):
        want_opt = pt["optimizers"][name]
        assert back["optimizers"][name]["param_groups"][0]["lr"] == pytest.approx(
            want_opt["param_groups"][0]["lr"], rel=1e-12)
        for i, entry in want_opt["state"].items():
            for k, v in entry.items():
                assert torch.equal(back["optimizers"][name]["state"][i][k], v), (name, i, k)
