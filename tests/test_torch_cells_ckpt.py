"""The JAX package's `.ckpt` cells in the port's merge, on the CPU.

A tiny 2-cell grid (fg + bg, appearance) trained for two steps by the JAX
`CellRunner` at `--cell_axis 2`, as its own tests run it, writes one
`{iter}.ckpt` per cell:
- the port's reader (`runtime/checkpoints.py::read_jax_checkpoint`, its own
  msgpack decoder) gives flax's `msgpack_restore` tree leaf for leaf, and
  the same aux; it runs in an interpreter without jax, flax or msgpack;
- the port's `merge_submodules` and the JAX script merge the two cells into
  containers holding bit-equal weights, centroids and metadata;
- training resumes from cell 0's `.ckpt`: `train` one model, `train_cells`
  every cell of the grid, each restored to its own cell's weights and Adam
  moments exactly;
- the decoder against the `msgpack` package on every type flax writes for
  a train state, and flax's chunked arrays.
"""

import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import flax.serialization
import jax
import msgpack
import numpy as np
import pytest
import torch

import mega_nerf_tpu.runtime.cell_runner as j_cell_runner_mod
import scripts.create_cluster_masks as j_ccm
import scripts.merge_submodules as j_merge
from mega_nerf_tpu.opts import get_opts_base as j_opts
from mega_nerf_tpu.parallel.cell_parallel import make_cell_train_state as j_make_cell_state
from mega_nerf_tpu.opts import parse_opts as j_parse
from mega_nerf_tpu.runtime import checkpoints as j_ckpt
from mega_nerf_tpu.runtime.cell_runner import CellRunner as JCellRunner
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch import train_cells
from mega_nerf_tpu_torch.models import flax_params_from_state
from mega_nerf_tpu_torch.models.container import load_container
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.runtime.checkpoints import msgpack_decode, read_jax_checkpoint
from mega_nerf_tpu_torch.scripts import merge_submodules
from tests.synthetic import make_synthetic_dataset

REPO = Path(__file__).resolve().parent.parent
STEPS = 2
MODEL = ["--near", "0.5", "--far", "3.5", "--ray_altitude_range", "-10", "10",
         "--coarse_samples", "8", "--fine_samples", "8", "--pos_xyz_dim", "4",
         "--pos_dir_dim", "2", "--layers", "3", "--skip_layers", "1",
         "--layer_dim", "16", "--bg_layer_dim", "16", "--appearance_dim", "4",
         "--compute_dtype", "float32", "--train_iterations", str(STEPS)]


def _j_hparams(args):
    parser = j_opts()
    parser.add_argument("--exp_name", type=str)
    parser.add_argument("--dataset_path", type=str)
    return j_parse(parser, args)


def _jit_cell_state(fg, bg, optimizer, key, num_cells):
    """The JAX `make_cell_train_state` as one compiled program: run eagerly,
    its vmapped flax init compiles each op on its own (~20 s on the CPU)."""
    return jax.jit(lambda k: j_make_cell_state(fg, bg, optimizer, k, num_cells))(key)


@pytest.fixture(scope="module")
def jax_grid(tmp_path_factory):
    root = tmp_path_factory.mktemp("jax_grid")
    ds = make_synthetic_dataset(root / "ds", n_train=3, n_val=1, hw=(12, 12))
    j_ccm.main(Namespace(
        dataset_path=str(ds), segmentation_path=None, output=str(root / "masks"),
        grid_dim=[2, 1], ray_samples=16, ray_chunk_size=48 * 1024, resume=False,
        ray_altitude_range=[-10.0, 10.0], near=0.5, far=3.5, center_pixels=True,
        cluster_2d=False, boundary_margin=1.15))
    args = ["--dataset_path", str(ds), "--exp_name", str(root / "sub"),
            "--cluster_mask_path", str(root / "masks"), "--dataset_type", "memory",
            "--batch_size", "64", "--lr", "5e-3", "--ckpt_interval", "100",
            "--cell_axis", "2", *MODEL]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_cell_runner_mod, "make_cell_train_state", _jit_cell_state)
        JCellRunner(_j_hparams(args)).train()
    return root, ds


def _ckpt(root, cell):
    return root / f"sub{cell}" / "0" / "models" / f"{STEPS}.ckpt"


def _assert_same_tree(got, want, path="root"):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path, strict=True)
    else:
        assert got == want and type(got) is type(want), path


@pytest.mark.parametrize("cell", [0, 1])
def test_reader_gives_flax_restore_tree_and_aux(jax_grid, cell):
    root, _ = jax_grid
    arrays, aux = read_jax_checkpoint(_ckpt(root, cell))
    want_arrays, want_aux = j_ckpt.load_checkpoint_raw(_ckpt(root, cell))
    _assert_same_tree(arrays, want_arrays)
    assert aux["cell_index"] == want_aux["cell_index"] == cell
    assert aux["num_cells"] == 2 and aux["iteration"] == STEPS
    assert aux["dataset_state"] == want_aux["dataset_state"]


def test_port_merge_of_jax_cells_matches_the_jax_merge(jax_grid):
    root, ds = jax_grid
    common = ["--dataset_path", str(ds), "--exp_name", "unused", *MODEL,
              "--ckpt_prefix", str(root / "sub"), "--centroid_path",
              str(root / "masks" / "params.pt")]
    merge_submodules.main(merge_submodules.get_merge_opts(
        common + ["--output", str(root / "port.pt")]))
    j_hp = _j_hparams(["--dataset_path", str(ds), "--exp_name", "unused", *MODEL])
    j_hp.ckpt_prefix, j_hp.centroid_path = common[-3], common[-1]
    j_hp.output, j_hp.torchscript = str(root / "jax.pt"), False
    j_merge.main(j_hp)
    got, want = load_container(root / "port.pt"), load_container(root / "jax.pt")
    for field in ("centroids", "grid_dim", "min_position", "max_position",
                  "need_viewdir", "need_appearance_embedding", "cluster_2d"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)), err_msg=field)
    for side in ("fg_states", "bg_states"):
        g, w = getattr(got, side), getattr(want, side)
        assert len(g) == len(w) == 2, side
        for sg, sw in zip(g, w):
            assert set(sg) == set(sw)
            for key in sw:
                a, b = np.asarray(sg[key]), np.asarray(sw[key])
                assert a.dtype == b.dtype and a.shape == b.shape, key
                np.testing.assert_array_equal(a, b, err_msg=f"{side} {key}")
    # The two cells were trained, not left at one init.
    assert not np.array_equal(got.fg_states[0]["sigma.weight"],
                              got.fg_states[1]["sigma.weight"])


def test_reader_needs_no_jax_flax_or_msgpack(jax_grid):
    root, _ = jax_grid
    code = (
        "import sys\n"
        "for name in ('jax', 'flax', 'msgpack'):\n"
        "    sys.modules[name] = None  # any import of them fails\n"
        "from mega_nerf_tpu_torch.runtime.checkpoints import read_jax_checkpoint\n"
        f"arrays, aux = read_jax_checkpoint({str(_ckpt(root, 1))!r})\n"
        "assert aux['cell_index'] == 1, aux\n"
        "print('read', sorted(arrays))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "fg_params" in out.stdout and "bg_params" in out.stdout


@pytest.mark.parametrize("entry", ["train", "train_cells"])
def test_training_resumes_from_a_jax_ckpt(jax_grid, tmp_path, entry):
    """`--ckpt_path` to cell 0's `.ckpt`: `train` resumes one model from it,
    `train_cells` every cell of the grid (the siblings found through the
    aux's `exp_prefix`). Right after the restore each model's weights, Adam
    moments and counts equal its cell's `.ckpt` exactly; the run goes on to
    step STEPS + 1."""
    root, ds = jax_grid
    exp = tmp_path / "exp"
    args = ["--dataset_path", str(ds), "--exp_name", str(exp),
            "--dataset_type", "memory", "--batch_size", "64", "--device", "cpu",
            "--ckpt_path", str(_ckpt(root, 0)), *MODEL,
            "--train_iterations", str(STEPS + 1)]
    if entry == "train":
        hp, main = port_train.get_train_opts(args), port_train.main
        written = [exp / "0" / "models" / f"{STEPS + 1}.pt"]
    else:
        hp = train_cells.get_train_cells_opts(
            args + ["--cluster_mask_path", str(root / "masks")])
        main = train_cells.main
        written = [Path(f"{exp}{cell}") / "0" / "models" / f"{STEPS + 1}.pt"
                   for cell in range(2)]
    restored = []
    load = TrainStep.load_optimizer_states

    def snapshot(self, states):
        load(self, states)
        sides = {}
        for side, bundle, opt in (("fg", self.fg, self.fg_opt), ("bg", self.bg, self.bg_opt)):
            named = list(bundle.module.named_parameters())
            sides[side] = {  # copies: training goes on in place
                "params": flax_params_from_state(bundle.config, {
                    n: p.detach().clone() for n, p in named}),
                # torch holds no state before a first step; optax zeros.
                **{m: flax_params_from_state(bundle.config, {
                    n: opt.state[p].get(key, torch.zeros_like(p)).clone() for n, p in named})
                   for m, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq"))},
                "count": {int(opt.state[p].get("step", 0)) for _, p in named}}
        restored.append(sides)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TrainStep, "load_optimizer_states", snapshot)
        main(hp)
    assert len(restored) == len(written)
    for cell, sides in enumerate(restored):
        arrays, _ = read_jax_checkpoint(_ckpt(root, cell))
        for side, got in sides.items():
            adam = arrays[f"{side}_opt"]["0"]
            _assert_same_tree(got["params"], arrays[f"{side}_params"], f"cell {cell} {side}")
            _assert_same_tree(got["mu"], adam["mu"], f"cell {cell} {side} mu")
            _assert_same_tree(got["nu"], adam["nu"], f"cell {cell} {side} nu")
            assert got["count"] == {int(adam["count"])}
    for path in written:
        assert torch.load(path, weights_only=False)["iteration"] == STEPS + 1


# ------------------------------------------------------------------ msgpack

@pytest.mark.parametrize("obj", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.5, -1e300, None, True, False, "", "abc", "é" * 20, "x" * 300, "y" * 70000,
    b"", b"\x00\x01", b"z" * 300, b"w" * 70000,
    [], [1, "a", None], list(range(20)), list(range(70000)),
    {}, {"a": 1, "b": [1, 2]}, {str(i): i for i in range(20)},
    {str(i): [i] for i in range(70000)},
])
def test_decoder_matches_msgpack(obj):
    data = msgpack.packb(obj, use_bin_type=True)
    assert msgpack_decode(data) == msgpack.unpackb(data, raw=False)


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16, 3, 300, 70000])
def test_decoder_ext_types(size):
    ext = msgpack.ExtType(5, b"e" * size)
    data = msgpack.packb([ext, 7], use_bin_type=True)
    assert msgpack_decode(data) == [(5, b"e" * size), 7]
    assert msgpack_decode(data, ext_hook=lambda c, p: (c, len(p))) == [(5, size), 7]


def test_decoder_reads_flax_arrays_scalars_and_chunks(tmp_path, monkeypatch):
    tree = {
        "f32": np.arange(12, dtype=np.float32).reshape(3, 4),
        "i32": np.arange(5, dtype=np.int32),
        "bool": np.array([True, False]),
        "scalar": np.float32(2.5),
        "nested": {"u8": np.arange(3, dtype=np.uint8), "none": None, "n": 3},
        "big": np.arange(1000, dtype=np.float32).reshape(10, 100),
    }
    # Arrays past the chunk size are split; a small limit exercises that path.
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 1024)
    path = tmp_path / "x.ckpt"
    j_ckpt.save_checkpoint(path, tree, {"iteration": 3})
    arrays, aux = read_jax_checkpoint(path)
    want, want_aux = j_ckpt.load_checkpoint_raw(path)
    assert aux == want_aux
    assert isinstance(arrays["big"], np.ndarray) and arrays["big"].shape == (10, 100)
    assert arrays["scalar"] == want["scalar"] == np.float32(2.5)
    assert arrays["scalar"].dtype == np.float32
    del arrays["scalar"], want["scalar"]
    _assert_same_tree(arrays, want)
    other = tmp_path / "other.pt"
    other.write_bytes(b"PK\x03\x04 not ours")
    with pytest.raises(ValueError, match="not a JAX package checkpoint"):
        read_jax_checkpoint(other)
