"""The port's multi-process paths over two real processes (gloo, CPU).

One start of two ranks (`tests/torch_multiprocess_worker.py two`) on a
16x16 synthetic scene (3 train + 2 val views) drives every check here:

- the data-parallel `Runner.train` (memory dataset, global batch 64, no
  perturbation or sigma noise): both ranks' weights bit-equal, and after 2
  steps equal to the JAX package's one-process `make_train_step` from the
  same initial weights on the same global batches, parameters within 1e-5
  (the two-Adam-step tolerance of `tests/test_torch_train_loop.py`; the
  elements whose gradient lies within 100 Adam eps of zero left out, as in
  `tests/test_torch_train_wide.py`); the first Adam moments of both steps
  equal to the one-process port's within a relative 1e-5 per tensor and to
  JAX's within 1e-3;
- a step whose background rays all lie in rank 0's half moves the bg
  parameters on both ranks, bit-equal;
- `metrics.jsonl` is rank 0's alone, and the final validation strided over
  the 2 val views equals the one-process port's `eval` of the same
  checkpoint within 1e-6;
- both chunk-store feeding modes (per-rank chunk streams of a stamped
  store, a shared chunk of a store without `chunk_rows`): no row on both
  ranks, the same batch count per epoch on both (the assertions of
  `tests/test_multiprocess.py`);
- a run cut at step 2 and resumed to step 4 (perturbation and noise on,
  each rank its own generator) ends bit-equal to the uninterrupted run;
- `create_cluster_masks` over both ranks writes the masks one process
  writes (payloads byte-equal), and `render_images` over both ranks the
  frames one process writes (files byte-equal), with no FileExistsError.
"""

import dataclasses
import json
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mega_nerf_tpu.models import make_bg_nerf as j_make_bg_nerf
from mega_nerf_tpu.models import make_nerf as j_make_nerf
from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.parallel.train_step import make_train_step as j_make_step
from mega_nerf_tpu.render import RenderSettings as JSettings
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.data.torch_io import load_pt
from mega_nerf_tpu_torch.models import flax_params_from_state, init_weights
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from mega_nerf_tpu_torch.scripts import create_cluster_masks as ccm
from mega_nerf_tpu_torch.scripts import render_images
from tests.synthetic import make_synthetic_dataset
from tests.test_torch_eval import _j_hparams
from tests.torch_multiprocess_worker import (
    MASK_ARGS,
    MODEL_ARGS,
    no_sigma_noise,
    spawn,
    train_args,
)

FRAMES = 3  # rank 0 renders frames 0 and 2, rank 1 frame 1


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    work = tmp_path_factory.mktemp("mp2")
    ds = make_synthetic_dataset(work / "ds", n_train=3, n_val=2, hw=(16, 16))
    poses = work / "poses"
    poses.mkdir()
    lines, intr = [], []
    for i, path in enumerate(sorted(ds.glob("*/metadata/*.pt"))[:FRAMES]):
        meta = load_pt(path)
        lines.append(" ".join(str(float(v)) for v in np.asarray(meta["c2w"]).reshape(-1)))
        intr.append("16 16 " + " ".join(str(float(v)) for v in meta["intrinsics"]))
    (poses / "poses.txt").write_text("\n".join(lines) + "\n")
    (poses / "intrinsics.txt").write_text("\n".join(intr) + "\n")
    (poses / "embeddings.txt").write_text("".join(f"{i}\n" for i in range(FRAMES)))
    return work, ds, spawn("two", work, 2)


def _flax_like(port_tree, jax_tree):
    """The port's flax-layout params as a tree of `jax_tree`'s structure."""
    by_path = dict(jax.tree_util.tree_leaves_with_path(port_tree))
    return jax.tree_util.tree_map_with_path(lambda p, _: jnp.asarray(by_path[p]), jax_tree)


ADAM_NOISE_G = 1e-6  # 100 x Adam's eps, as in tests/test_torch_train_wide.py


def _leaves(tree):
    return {path: np.asarray(leaf) for path, leaf in
            jax.tree_util.tree_leaves_with_path(jax.device_get(tree))}


def _moments(ck, side, bundle):
    """A `{iter}.pt`'s first Adam moments of one side, in the flax layout."""
    state = ck["optimizers"]["nerf" if side == "fg" else "bg_nerf"]["state"]
    names = [n for n, _ in bundle.module.named_parameters()]
    return _leaves(flax_params_from_state(
        bundle.config, {n: state[i]["exp_avg"] for i, n in enumerate(names)}))


def _rel(got, want) -> float:
    """A tensor's relative error: |got - want| / |want| in the 2-norm."""
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def test_data_parallel_ranks_bit_equal_and_match_jax(two, tmp_path, monkeypatch):
    """Adam divides each gradient element g by |g| + eps, so where |g| is
    within a few hundred eps the float noise of two summation orders moves
    the update by up to ~lr: here one element is 2.8e-4 off after two
    steps, in the one-process port as well. As in
    `tests/test_torch_train_wide.py`, elements with 0 < |g| < 1e-6 at either
    step, in either package (g from the first moments; 3% of the fg and 13%
    of the bg elements here),
    are left out of the parameter check; every other parameter agrees to
    1e-5, and most of them moved by ten times that.

    Adam's update hides the gradient's scale, so the first moments (0.1 g
    after step 1) are held too, each tensor by its relative error: against
    the one-process port on the same global batches within 1e-5 (measured
    1.7e-6), and against JAX within 1e-3. The JAX bound is wider because
    one fine sample's pre-activation in trunk_2 lies 4.6e-6 from zero, and
    the ~1e-6 by which the two packages place fine depths flips its ReLU
    mask; that moves the fg trunk_0-2 gradients by up to 5e-4 of their
    norm, and leaves every other tensor within 3e-5. A sum over the ranks
    without the division, or a mean over the wrong group, is off by 0.5 or
    more in every tensor."""
    work, ds, results = two
    assert results[0]["backend"] == "gloo"
    assert results[0]["a_hash"] == results[1]["a_hash"]

    args = train_args(ds, work / "unused", 2, ["--perturb", "0"])
    hp = port_train.get_train_opts(args)
    runner = TRunner(hp, set_experiment_path=False)
    n = len(runner.train_items)
    # The Runner's initial weights, as it seeds them.
    init_weights(runner.fg.module, torch.Generator().manual_seed(hp.random_seed))
    init_weights(runner.bg.module, torch.Generator().manual_seed(hp.random_seed + 1))
    dataset = runner._make_dataset()
    batches = dataset.batches(hp.batch_size, np.random.default_rng((hp.random_seed, 0)))
    global_batches = [next(batches) for _ in range(2)]

    j_hp = _j_hparams([a for a in args if a not in ("--device", "cpu")])
    jfg, jbg = j_make_nerf(j_hp, n), j_make_bg_nerf(j_hp, n)
    opt = j_make_optimizer(hp.lr, hp.lr_decay_factor, hp.train_iterations)
    state = j_make_state(jfg, jbg, opt, jax.random.key(0))
    state = state.replace(
        fg_params=_flax_like(flax_params_from_state(runner.fg.config,
                                                    runner.fg.module.state_dict()),
                             state.fg_params),
        bg_params=_flax_like(flax_params_from_state(runner.bg.config,
                                                    runner.bg.module.state_dict()),
                             state.bg_params))
    jset = dataclasses.replace(JSettings.from_hparams(j_hp), use_pallas=False, perturb=0.0,
                               sigma_noise=False)
    step = jax.jit(j_make_step(jfg, jbg, jset, opt,
                               jnp.asarray(runner.sphere_center.numpy()),
                               jnp.asarray(runner.sphere_radius.numpy())))
    states = [state]
    for b in global_batches:
        states.append(step(states[-1], {k: jnp.asarray(v) for k, v in b.items()})[0])

    cks = [torch.load(work / "exp_a" / "0" / "models" / f"{i}.pt", weights_only=False)
           for i in (1, 2)]
    assert cks[1]["iteration"] == 2

    # metrics.jsonl only: TensorBoard's import would pull TensorFlow in.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    restore = no_sigma_noise()
    try:
        port_train.main(port_train.get_train_opts(train_args(
            ds, tmp_path / "one", 2, ["--perturb", "0", "--ckpt_interval", "1"])))
    finally:
        restore()
    for i, ck in enumerate(cks, 1):
        one = torch.load(tmp_path / "one" / "0" / "models" / f"{i}.pt", weights_only=False)
        for name, slots in one["optimizers"].items():
            for j, slot in slots["state"].items():
                assert _rel(ck["optimizers"][name]["state"][j]["exp_avg"].numpy(),
                            slot["exp_avg"].numpy()) <= 1e-5, (i, name, j)
    for side, bundle, key in (("fg", runner.fg, "model_state_dict"),
                              ("bg", runner.bg, "bg_model_state_dict")):
        p0 = _leaves(getattr(states[0], f"{side}_params"))
        want = _leaves(getattr(states[2], f"{side}_params"))
        got = _leaves(flax_params_from_state(bundle.config, cks[1][key]))
        j_mu = [_leaves(getattr(s, f"{side}_opt")[0].mu) for s in states[1:]]
        p_mu = [_moments(ck, side, bundle) for ck in cks]
        held = total = moved = 0
        for path, w in want.items():
            keep = np.ones(w.shape, bool)
            for mus in (j_mu, p_mu):
                for g in (mus[0][path] / 0.1, (mus[1][path] - 0.9 * mus[0][path]) / 0.1):
                    keep &= ~((np.abs(g) < ADAM_NOISE_G) & (g != 0))
            held, total = held + keep.sum(), total + keep.size
            for i in range(2):
                assert _rel(p_mu[i][path], j_mu[i][path]) <= 1e-3, (
                    side, i + 1, jax.tree_util.keystr(path))
            moved += (np.abs(w - p0[path])[keep] > 10 * 1e-5).sum()
            np.testing.assert_allclose(got[path][keep], w[keep], atol=1e-5,
                                       err_msg=f"{side} {jax.tree_util.keystr(path)}")
        assert held >= 0.75 * total and moved >= 0.5 * held, (side, held, total, moved)


def test_background_rays_of_one_rank_move_both_ranks_bg(two):
    _, _, results = two
    assert [r["b_local_bg"] for r in results] == [True, False]
    assert all(r["b_bg_moved"] for r in results)
    assert [r["b_bg_steps"] for r in results] == [1, 1]
    assert results[0]["b_hash"] == results[1]["b_hash"]


def test_metrics_log_on_rank_0_and_strided_validation(two, monkeypatch):
    work, ds, results = two
    # metrics.jsonl only: TensorBoard's import would pull TensorFlow in.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert results[1]["experiment_path"] is None
    assert sorted(p.name for p in (work / "exp_a").iterdir()) == ["0"]
    lines = [json.loads(x) for x in
             (work / "exp_a" / "0" / "tb" / "metrics.jsonl").read_text().splitlines()]
    pairs = [(d["step"], k) for d in lines for k in d if k not in ("t", "step")]
    assert len(pairs) == len(set(pairs))  # one writer
    assert ("2", "train/loss") in {(str(s), k) for s, k in pairs}
    val = results[0]["a_val"]
    assert val == results[1]["a_val"]
    one = port_eval.main(port_eval.get_eval_opts(
        ["--dataset_path", str(ds), "--exp_name", str(work / "eval_1p"), *MODEL_ARGS,
         "--device", "cpu", "--ckpt_path", str(work / "exp_a" / "0" / "models" / "2.pt")]))
    assert set(one) == set(val)
    for k in one:
        assert abs(one[k] - val[k]) <= 1e-6, (k, one[k], val[k])


@pytest.mark.parametrize("mode,per_rank", [("d_stream", True), ("d_shared", False)])
def test_chunk_store_feeding_modes(two, mode, per_rank):
    _, _, results = two
    got = results[0][mode]
    assert got == results[1][mode]
    assert got["per_rank"] == per_rank
    for counts in got["counts"]:
        assert counts[0] == counts[1] > 0
    assert got["overlaps"] == [0, 0, 0]


def test_resume_cut_at_2_is_bit_equal(two):
    work, _, results = two
    for r in results:
        assert r["e_resumed_hash"] == r["e_hash"]
    assert results[0]["e_hash"] == results[1]["e_hash"]
    cut = torch.load(work / "exp_e" / "0" / "models" / "2.pt", weights_only=False)
    states = cut["generator_states"]
    assert len(states) == 2 and not torch.equal(states[0], states[1])
    assert torch.equal(cut["generator_state"], states[0])
    full = torch.load(work / "exp_e" / "0" / "models" / "4.pt", weights_only=False)
    resumed = torch.load(work / "exp_e" / "1" / "models" / "4.pt", weights_only=False)
    for key in ("model_state_dict", "bg_model_state_dict"):
        for name, v in full[key].items():
            assert torch.equal(v, resumed[key][name]), (key, name)
    for a, b in zip(full["generator_states"], resumed["generator_states"]):
        assert torch.equal(a, b)
    assert full["dataset_state"] == resumed["dataset_state"]


def test_cluster_masks_over_two_ranks(two, tmp_path):
    work, ds, _ = two
    ccm.main(ccm.get_mask_opts(["--dataset_path", str(ds), "--output",
                                str(tmp_path / "masks"), *MASK_ARGS]))
    two_p, one_p = work / "masks", tmp_path / "masks"
    a, b = load_pt(two_p / "params.pt"), load_pt(one_p / "params.pt")
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    files = sorted(p.relative_to(one_p) for p in one_p.glob("*/*.pt"))
    assert files == sorted(p.relative_to(two_p) for p in two_p.glob("*/*.pt"))
    assert len(files) == 3 * 5
    for rel in files:
        with zipfile.ZipFile(two_p / rel) as za, zipfile.ZipFile(one_p / rel) as zb:
            assert za.read(rel.name) == zb.read(rel.name), rel


def test_render_images_over_two_ranks(two, tmp_path):
    work, ds, _ = two
    render_images.main(render_images.get_render_opts(
        ["--dataset_path", str(ds), *MODEL_ARGS, "--device", "cpu",
         "--ckpt_path", str(work / "exp_e" / "0" / "models" / "4.pt"),
         "--centroids_path", str(work / "masks" / "params.pt"),
         "--input", str(work / "poses"), "--output", str(tmp_path / "frames")]))
    for sub in ("rgbs", "depths", "cells"):
        names = sorted(p.name for p in (tmp_path / "frames" / sub).iterdir())
        assert names == [f"{i:06d}.jpg" for i in range(FRAMES)]
        assert names == sorted(p.name for p in (work / "frames" / sub).iterdir())
        for name in names:
            assert (work / "frames" / sub / name).read_bytes() == \
                (tmp_path / "frames" / sub / name).read_bytes(), (sub, name)
    assert "FileExistsError" not in (work / "log_1.txt").read_text()
