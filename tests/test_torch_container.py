"""Merged containers between the port and the JAX package, on the CPU.

- Containers the JAX package writes (native and TorchScript) load in the
  port to bit-equal weights, and the port's load in the JAX package the
  same way; the container's need_viewdir / need_appearance_embedding win
  over the command line's defaults.
- The port's `merge_submodules` and the JAX script, on the same `{iter}.pt`
  files written by the port's trainer, give the same container; the port's
  `convert_to_container` wraps one checkpoint.
- `eval.main --container_path` in both packages on `tests/synthetic.py`
  data: PSNR within 0.01 dB; a container without bg submodules gets no bg
  model; `render_images` writes a flythrough's frames from a container.
"""

import jax
import numpy as np
import pytest
import torch

from mega_nerf_tpu.data.torch_io import save_pt
from mega_nerf_tpu.models.container import ContainerData as JContainerData
from mega_nerf_tpu.models.container import container_to_bundles as j_to_bundles
from mega_nerf_tpu.models.container import load_container as j_load_container
from mega_nerf_tpu.models.container import save_native_container as j_save_native
from mega_nerf_tpu.models.container import save_torchscript_container as j_save_ts
from mega_nerf_tpu.models.torch_interop import flax_params_from_torch_state
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch import eval as port_eval
from mega_nerf_tpu_torch.models import init_weights, make_bg_nerf
from mega_nerf_tpu_torch.models import make_nerf as t_make_nerf
from mega_nerf_tpu_torch.models.container import (
    ContainerData,
    container_to_bundles,
    load_container,
    save_native_container,
    save_torchscript_container,
)
from mega_nerf_tpu_torch.runtime import checkpoints
from mega_nerf_tpu_torch.runtime.runner import Runner as TRunner
from mega_nerf_tpu_torch.scripts import convert_to_container, merge_submodules, render_images
from tests.synthetic import make_synthetic_dataset
from tests.test_torch_eval import _args, _j_hparams, _metric
from tests.test_torch_mega import CENTROIDS, container_data, mixture_hparams

WRITERS = {
    ("jax", "native"): lambda path, data, hp: j_save_native(path, data),
    ("jax", "torchscript"): j_save_ts,
    ("port", "native"): lambda path, data, hp: save_native_container(path, data),
    ("port", "torchscript"): save_torchscript_container,
}


def _write(tmp_path, writer, fmt, hp, **kw):
    cls = JContainerData if writer == "jax" else ContainerData
    data = container_data(hp, cls=cls, **kw)
    path = tmp_path / f"{writer}.{fmt}"
    WRITERS[(writer, fmt)](path, data, hp)
    return path, data


def _assert_port_holds(bundle, states):
    assert len(bundle.module) == len(states)
    for sub, state in zip(bundle.module, states):
        own = sub.state_dict()
        assert own
        for key, value in own.items():
            np.testing.assert_array_equal(value.numpy(), np.asarray(state[key]), err_msg=key)


@pytest.mark.parametrize("fmt", ["native", "torchscript"])
def test_jax_written_container_loads_in_port(tmp_path, fmt):
    hp = mixture_hparams()
    path, data = _write(tmp_path, "jax", fmt, hp)
    loaded = load_container(path)
    np.testing.assert_array_equal(loaded.centroids, data.centroids)
    assert tuple(loaded.grid_dim) == tuple(data.grid_dim)
    assert (loaded.need_viewdir, loaded.need_appearance_embedding, loaded.cluster_2d) == \
        (True, True, False)
    fg, bg = container_to_bundles(loaded, hp)
    _assert_port_holds(fg, data.fg_states)
    _assert_port_holds(bg, data.bg_states)
    assert bg.xyz_real and not fg.xyz_real and fg.config.appearance_count == 5


@pytest.mark.parametrize("fmt", ["native", "torchscript"])
def test_port_written_container_loads_in_jax(tmp_path, fmt):
    hp = mixture_hparams()
    path, data = _write(tmp_path, "port", fmt, hp)
    jfg, jbg = j_to_bundles(j_load_container(path), hp)
    for jb, states in ((jfg, data.fg_states), (jbg, data.bg_states)):
        for k, state in enumerate(states):
            want = flax_params_from_torch_state(jb.config, state)
            got = jax.tree.map(lambda x: np.asarray(x)[k], jb.pretrained_params)
            for (pa, a), (pb, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                        jax.tree_util.tree_leaves_with_path(want)):
                assert pa == pb
                np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(jfg.centroids), data.centroids)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_container_flags_override_the_command_line(tmp_path, writer):
    """A container trained without view directions or appearance loads with
    the command line left at its defaults (dirs and appearance on)."""
    bare = mixture_hparams(pos_dir_dim=0, appearance_dim=0)
    path, data = _write(tmp_path, writer, "native", bare, bg=False)
    cli = mixture_hparams(pos_dir_dim=2, appearance_dim=4)
    fg, bg = container_to_bundles(load_container(path), cli)
    jfg, _ = j_to_bundles(j_load_container(path), cli)
    assert bg is None
    assert (fg.config.pos_dir_dim, fg.config.appearance_dim) == (0, 0)
    assert (jfg.config.pos_dir_dim, jfg.config.appearance_dim) == (0, 0)
    _assert_port_holds(fg, data.fg_states)


def _write_submodule_runs(root, hp, k, iteration):
    """K port-trainer `{iter}.pt` files under `{root}/sub{i}/{version}/models`
    (an older, incomplete version beside each) and a params.pt."""
    for i in range(k):
        fg, bg = t_make_nerf(hp, 5), make_bg_nerf(hp, 5)
        gen = torch.Generator().manual_seed(i)
        init_weights(fg.module, gen)
        init_weights(bg.module, gen)
        (root / f"sub{i}" / "0" / "models").mkdir(parents=True)
        checkpoints.save_checkpoint(root / f"sub{i}" / "1" / "models" / f"{iteration}.pt",
                                    fg.module, bg.module, {}, iteration,
                                    {"epoch": 0, "batch_index": 0}, gen.get_state())
    save_pt({"centroids": CENTROIDS[:k], "grid_dim": np.array([k, 1]),
             "min_position": CENTROIDS[:k].min(0), "max_position": CENTROIDS[:k].max(0),
             "cluster_2d": False}, root / "params.pt")


def test_merge_matches_the_jax_script(tmp_path):
    import scripts.merge_submodules as j_merge

    args = _args(tmp_path, tmp_path / "unused", True) + ["--train_iterations", "60"]
    _write_submodule_runs(tmp_path, _j_hparams(args), 3, 60)
    outputs = {}
    for name in ("jax", "port"):
        out = tmp_path / f"{name}.pt"
        extra = ["--ckpt_prefix", str(tmp_path / "sub"), "--centroid_path",
                 str(tmp_path / "params.pt"), "--output", str(out), "--torchscript"]
        if name == "jax":
            j_hp = _j_hparams(args)
            j_hp.ckpt_prefix, j_hp.centroid_path = extra[1], extra[3]
            j_hp.output, j_hp.torchscript = str(out), True
            j_merge.main(j_hp)
        else:
            merge_submodules.main(merge_submodules.get_merge_opts(
                args + ["--exp_name", "x", "--dataset_path", "x"] + extra))
        outputs[name] = out
    want = load_container(outputs["jax"])
    for path in (outputs["port"], f"{outputs['port']}.ts", f"{outputs['jax']}.ts"):
        got = load_container(path)
        for field in ("centroids", "grid_dim", "min_position", "max_position",
                      "need_viewdir", "need_appearance_embedding", "cluster_2d"):
            np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                          np.asarray(getattr(want, field)), err_msg=field)
        hp = mixture_hparams(pos_xyz_dim=6, layers=4, skip_layers=[2], layer_dim=32,
                             bg_layer_dim=32)
        for side in (0, 1):
            _assert_port_holds(container_to_bundles(got, hp)[side],
                               (want.fg_states, want.bg_states)[side])


def test_convert_to_container_wraps_one_checkpoint(tmp_path):
    args = _args(tmp_path, tmp_path / "unused", True) + ["--train_iterations", "60"]
    _write_submodule_runs(tmp_path, _j_hparams(args), 1, 60)
    ckpt = tmp_path / "sub0" / "1" / "models" / "60.pt"
    out = tmp_path / "single.pt"
    convert_to_container.main(convert_to_container.get_convert_opts(
        args + ["--ckpt_path", str(ckpt), "--output", str(out)]))
    data = load_container(out)
    saved = checkpoints.load_checkpoint(ckpt)
    assert data.centroids.shape == (1, 3) and len(data.bg_states) == 1
    for key, value in saved["model_state_dict"].items():
        np.testing.assert_array_equal(np.asarray(data.fg_states[0][key]), value.numpy())


@pytest.mark.parametrize("writer,fmt", [("jax", "native"), ("port", "torchscript")])
def test_eval_container_matches_jax(tmp_path, writer, fmt):
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))
    args = _args(ds, tmp_path / "unused", True)
    path, _ = _write(tmp_path, writer, fmt, _j_hparams(args), count=4)
    container = ["--container_path", str(path)]
    JRunner(_j_hparams(_args(ds, tmp_path / "jexp", True) + container)).eval()
    t_hp = port_eval.get_eval_opts(_args(ds, tmp_path / "texp", True) + container
                                   + ["--device", "cpu"])
    metrics = port_eval.main(t_hp)
    assert abs(_metric(tmp_path / "jexp", "val/psnr") - metrics["val/psnr"]) < 0.01
    assert abs(_metric(tmp_path / "jexp", "val/ssim") - metrics["val/ssim"]) < 1e-3
    runner = TRunner(t_hp, set_experiment_path=False)
    assert runner.fg.is_mega and runner.bg.is_mega and len(runner.fg.module) == 3
    assert "_container_bundles" not in (tmp_path / "texp" / "0" / "hparams.txt").read_text()


def test_container_without_bg_and_render_images(tmp_path):
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=3, n_val=1, hw=(16, 16))
    args = _args(ds, tmp_path / "unused", True)
    path, _ = _write(tmp_path, "port", "native", _j_hparams(args), count=4, bg=False)
    save_pt({"centroids": CENTROIDS}, tmp_path / "params.pt")
    poses = tmp_path / "poses"
    poses.mkdir()
    meta = torch.load(ds / "val" / "metadata" / "000003.pt", weights_only=False)
    c2w = " ".join(str(float(v)) for v in np.asarray(meta["c2w"]).reshape(-1))
    fx, fy, cx, cy = (float(v) for v in np.asarray(meta["intrinsics"]))
    (poses / "poses.txt").write_text(f"{c2w}\n{c2w}\n")
    (poses / "intrinsics.txt").write_text(f"16 16 {fx} {fy} {cx} {cy}\n" * 2)
    (poses / "embeddings.txt").write_text("0\n3\n")
    out = tmp_path / "frames"
    hp = render_images.get_render_opts(
        args + ["--container_path", str(path), "--device", "cpu", "--input", str(poses),
                "--output", str(out), "--centroids_path", str(tmp_path / "params.pt"),
                "--save_depth_npz"])
    render_images.main(hp)
    runner = TRunner(hp, set_experiment_path=False)
    assert runner.fg.is_mega and runner.bg is None
    for sub in ("rgbs", "depths", "cells"):
        assert sorted(p.name for p in (out / sub).iterdir()) == ["000000.jpg", "000001.jpg"]
    depth = np.load(out / "depths_npz" / "000000.npy")
    assert depth.shape == (16, 16) and np.isfinite(depth).all()
    with pytest.raises(FileExistsError):  # an existing output needs --resume
        render_images.main(hp)
    hp.resume = True
    render_images.main(hp)  # every frame's overlay reads back: all skipped
