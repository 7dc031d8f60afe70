"""The port's multi-process Mega-NeRF grid over four real processes (gloo,
CPU).

One start of four ranks (`tests/torch_multiprocess_worker.py cells`) on a
16x16 synthetic scene (4 train + 2 val views), masks of a 1 x 3 grid made
over the four ranks (K = 3), drives every check here:

- `train_cells --cell_axis 2 --data_axis 2` from the memory dataset, no
  perturbation or sigma noise, 4 steps: ranks 0-1 hold cells 0 and 1,
  ranks 2-3 cell 2 and padding cell 3; the two ranks of a group hold
  bit-equal cells, each real cell equals the one-process port's
  `train_cells` within 1e-5 (its first Adam moments within a relative 1e-5
  per tensor, which a gradient mean over the wrong group fails), the
  per-cell validation at step 2 is the same on every rank, only the 3 real cells are checkpointed (with the group's
  two generator states and the stream state), a resume from step 2 is
  bit-equal in every real cell (a padding cell starts afresh, as in the JAX
  package), and the port's merge reads the written cells;
- `--cell_axis 4 --data_axis 1` from process-private filesystem stores:
  rank 3 holds only padding cell 3, writes no store and takes every step
  (its batch has the shape the real ranks' have);
- a filesystem store with `--data_axis 2`, and a world size that is not
  C x D, raise on every rank.
"""

import sys

import numpy as np
import pytest
import torch

from mega_nerf_tpu_torch import train_cells
from mega_nerf_tpu_torch.models.container import load_container
from tests.synthetic import make_synthetic_dataset
from tests.torch_multiprocess_worker import cell_args, no_sigma_noise, spawn


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    work = tmp_path_factory.mktemp("mp4")
    ds = make_synthetic_dataset(work / "ds", n_train=4, n_val=2, hw=(16, 16))
    return work, ds, spawn("cells", work, 4)


def _ckpt(work, run, cell, version, it):
    return torch.load(work / run / f"sub{cell}" / str(version) / "models" / f"{it}.pt",
                      weights_only=False)


def test_group_ranks_hold_bit_equal_cells(grid):
    _, _, results = grid
    assert [r["grid_group"] for r in results] == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert [r["grid_cells"] for r in results] == [[0, 1], [0, 1], [2, 3], [2, 3]]
    assert results[0]["grid_hashes"] == results[1]["grid_hashes"]
    assert results[2]["grid_hashes"] == results[3]["grid_hashes"]
    assert len(set(results[0]["grid_hashes"] + results[2]["grid_hashes"])) == 4


def test_cells_match_one_process_train_cells(grid, tmp_path, monkeypatch):
    work, ds, _ = grid
    # metrics.jsonl only: TensorBoard's import would pull TensorFlow in.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    restore = no_sigma_noise()
    try:
        train_cells.main(train_cells.get_train_cells_opts(
            cell_args(ds, work / "masks", tmp_path / "sub", 4)))
    finally:
        restore()
    for cell in range(3):
        one = torch.load(tmp_path / f"sub{cell}" / "0" / "models" / "4.pt",
                         weights_only=False)
        got = _ckpt(work, "grid", cell, 0, 4)
        for key in ("model_state_dict", "bg_model_state_dict"):
            for name, want in one[key].items():
                np.testing.assert_allclose(got[key][name].numpy(), want.numpy(),
                                           atol=1e-5, err_msg=f"cell {cell} {name}")
        # Adam's update hides the gradient's scale; its first moments do not.
        for name, slots in one["optimizers"].items():
            for j, slot in slots["state"].items():
                a = got["optimizers"][name]["state"][j]["exp_avg"].numpy()
                b = slot["exp_avg"].numpy()
                assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), (cell, name, j)
        assert got["dataset_state"] == one["dataset_state"]


def test_per_cell_validation_same_on_every_rank(grid):
    _, _, results = grid
    calls = results[0]["val_calls"]
    assert [c[0] for c in calls] == ["val/cell0", "val/cell1", "val/cell2"]
    assert all(np.isfinite(c[1][f"{c[0]}/psnr"]) for c in calls)
    assert all(r["val_calls"] == calls for r in results)


def test_only_real_cells_checkpointed_with_gathered_states(grid):
    work, _, _ = grid
    assert sorted(p.name for p in (work / "grid").iterdir()) == ["sub0", "sub1", "sub2"]
    for cell in range(3):
        for it in (2, 4):
            ck = _ckpt(work, "grid", cell, 0, it)
            assert ck["cell_index"] == cell and ck["num_cells"] == 3
            assert ck["iteration"] == it
            assert set(ck["dataset_state"]) == {"epoch", "batch_index"}
            gens = ck["generator_states"]
            assert len(gens) == 2 and not torch.equal(gens[0], gens[1])
            assert torch.equal(ck["generator_state"], gens[0])


def test_grid_resume_is_bit_equal(grid):
    work, _, results = grid
    for r in results:  # padding cell 3 starts afresh on a resume
        real = [c < 3 for c in r["grid_cells"]]
        assert [h for h, keep in zip(r["grid_resumed_hashes"], real) if keep] == \
            [h for h, keep in zip(r["grid_hashes"], real) if keep]
    for cell in range(3):
        full, resumed = _ckpt(work, "grid", cell, 0, 4), _ckpt(work, "grid", cell, 1, 4)
        assert full["dataset_state"] == resumed["dataset_state"]
        for key in ("model_state_dict", "bg_model_state_dict"):
            for name, v in full[key].items():
                assert torch.equal(v, resumed[key][name]), (cell, key, name)


def test_merge_of_the_written_cells(grid):
    work, _, _ = grid
    data = load_container(work / "merged.pt")
    assert len(data.fg_states) == len(data.bg_states) == 3
    assert data.centroids.shape == (3, 3)
    for cell in range(3):
        ck = _ckpt(work, "grid", cell, 1, 4)
        for name, v in ck["model_state_dict"].items():
            np.testing.assert_array_equal(data.fg_states[cell][name], v.numpy())


def test_rank_with_only_padding_steps_beside_private_stores(grid):
    work, _, results = grid
    assert [r["fs_cells"] for r in results] == [[0], [1], [2], [3]]
    assert [r["fs_stores"] for r in results] == [["cell0"], ["cell1"], ["cell2"], []]
    assert all(r["fs_finite"] for r in results)
    assert sorted(p.name for p in (work / "fs").iterdir()) == ["sub0", "sub1", "sub2"]
    for cell in range(3):
        assert _ckpt(work, "fs", cell, 0, 2)["iteration"] == 2


def test_filesystem_store_with_data_axis_2_raises(grid):
    _, _, results = grid
    for r in results:
        message = r["raised"]["fs_data_axis"]
        assert message is not None and "--data_axis 2" in message
        assert "a cell group must sit in one process" in message


def test_world_size_not_cell_times_data_raises(grid):
    _, _, results = grid
    for r in results:
        assert r["raised"]["world"] == (
            "--cell_axis 3 x --data_axis 1 = 3 ranks, but the world has 4 (WORLD_SIZE): "
            "C x D must equal it")
