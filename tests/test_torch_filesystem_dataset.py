"""The port's FilesystemDataset against the JAX package's, on the CPU.

The seven cases of `tests/test_filesystem_dataset.py` run against the port
(write and schema, rays equal to the memory dataset's to 1e-5, shuffled
chunks, cycle and `set_position`, stamp reuse and the stale-stamp
assertion, `batches`, differing intrinsics), then the two packages
against each other: a store written by one reads back in the other with
the same `batches()` stream for the same rng (`img_indices` and `rgbs` bit
for bit, rays to 1e-5), and two stores written from the same seed hold the
same columns. `get_rays_flat` is held against the JAX function to 1e-5.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from mega_nerf_tpu.data import FilesystemDataset as JFilesystemDataset
from mega_nerf_tpu.data import ImageMetadata as JImageMetadata
from mega_nerf_tpu.ops.rays import get_rays_flat as j_get_rays_flat
from mega_nerf_tpu_torch.data.filesystem_dataset import FilesystemDataset
from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata
from mega_nerf_tpu_torch.data.memory_dataset import MemoryDataset
from mega_nerf_tpu_torch.data.torch_io import load_pt
from mega_nerf_tpu_torch.ops.rays import get_rays_flat
from tests.synthetic import make_synthetic_dataset

HW = 16


def _items(dataset: Path, n: int, cls=ImageMetadata) -> list:
    items = []
    for i in range(n):
        meta = load_pt(dataset / "train" / "metadata" / f"{i:06d}.pt")
        items.append(cls(
            dataset / "train" / "rgbs" / f"{i:06d}.png", meta["c2w"], HW, HW,
            meta["intrinsics"], i, None, False,
        ))
    return items


@pytest.fixture(scope="module")
def ds_root(tmp_path_factory):
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("fsds"), n_train=4, n_val=0, hw=(HW, HW))


def _args(items, chunks, **kw):
    args = dict(
        metadata_items=items, near=0.5, far=3.5, ray_altitude_range=None,
        center_pixels=True, chunk_paths=[chunks], num_chunks=4,
        scale_factor=1, disk_flush_size=500, rng=np.random.default_rng(0),
    )
    args.update(kw)
    return args


def _make(ds_root, tmp_path, **kw):
    items = _items(ds_root, 4)
    ds = FilesystemDataset(**_args(items, tmp_path / "chunks", **kw))
    return ds, items


def test_write_and_schema(ds_root, tmp_path):
    ds, _ = _make(ds_root, tmp_path)
    files = sorted((tmp_path / "chunks").glob("*.parquet"))
    assert [f.name for f in files] == [f"{i:06d}.parquet" for i in range(4)]
    table = pq.read_table(files[0])
    # Shared intrinsics -> pixel_indices schema, u16 image indices.
    assert table.column_names == [
        "img_indices", "rgbs_0", "rgbs_1", "rgbs_2", "pixel_indices"]
    assert str(table.schema.field("img_indices").type) == "uint16"
    assert pq.ParquetFile(files[0]).metadata.row_group(0).column(0) \
        .compression == "BROTLI"
    stamp = load_pt(tmp_path / "chunks" / "metadata.pt")
    assert stamp["images"] == 4 and stamp["scale_factor"] == 1
    rows = {f.name: pq.read_table(f).num_rows for f in files}
    assert stamp["chunk_rows"] == rows == ds._chunk_rows
    # Every ray present across the chunks exactly once.
    assert sum(rows.values()) == 4 * HW * HW
    keys = np.concatenate([
        pq.read_table(f)["img_indices"].to_numpy().astype(np.int64) * HW * HW
        + pq.read_table(f)["pixel_indices"].to_numpy() for f in files])
    np.testing.assert_array_equal(np.sort(keys), np.arange(4 * HW * HW))
    ds.close()


def test_rays_match_memory_dataset(ds_root, tmp_path):
    """Regenerated rays (pixel_indices path) == directly generated rays."""
    ds, items = _make(ds_root, tmp_path)
    mem = MemoryDataset(items, 0.5, 3.5, None, True)
    chunk = ds.load_chunk()
    table = pq.read_table(sorted((tmp_path / "chunks").glob("*.parquet"))[0])
    pix = table["pixel_indices"].to_numpy()
    img = table["img_indices"].to_numpy().astype(np.int64)
    np.testing.assert_allclose(
        chunk["rays"], mem.rays.reshape(4, HW * HW, 8)[img, pix], atol=1e-5)
    assert chunk["rays"].dtype == np.float32
    np.testing.assert_array_equal(
        chunk["rgbs"], mem.rgbs.reshape(4, HW * HW, 3)[img, pix])
    ds.close()


def test_chunks_shuffled(ds_root, tmp_path):
    ds, _ = _make(ds_root, tmp_path)
    chunk = ds.load_chunk()
    assert len(np.unique(chunk["img_indices"][:64])) > 1
    ds.close()


def test_cycle_and_resume(ds_root, tmp_path):
    ds, _ = _make(ds_root, tmp_path)
    ds.load_chunk()
    c1 = ds.load_chunk()
    assert ds.position == 2
    for _ in range(2):
        ds.load_chunk()
    # Position 4 wraps around to chunk 0.
    c4 = ds.load_chunk()
    ds.close()
    ds2, _ = _make(ds_root, tmp_path / "x", chunk_paths=[tmp_path / "chunks"])
    c0 = ds2.load_chunk()
    np.testing.assert_array_equal(c0["img_indices"], c4["img_indices"])
    ds2.set_position(1)
    c1b = ds2.load_chunk()
    assert ds2.position == 2
    np.testing.assert_array_equal(c1["img_indices"], c1b["img_indices"])
    np.testing.assert_array_equal(c1["rays"], c1b["rays"])
    ds2.close()


def test_reuse_validates_stamp(ds_root, tmp_path):
    _make(ds_root, tmp_path)[0].close()
    written = {f: f.stat().st_mtime_ns for f in (tmp_path / "chunks").iterdir()}
    ds2, _ = _make(ds_root, tmp_path)  # the same config: reused, not rewritten
    assert len(ds2._parquet_paths) == 4
    assert {f: f.stat().st_mtime_ns for f in (tmp_path / "chunks").iterdir()} == written
    ds2.close()
    with pytest.raises(AssertionError, match="images"):  # wrong image count
        FilesystemDataset(**_args(_items(ds_root, 3), tmp_path / "chunks"))
    with pytest.raises(AssertionError, match="scale factor"):
        FilesystemDataset(**_args(_items(ds_root, 4), tmp_path / "chunks",
                                  scale_factor=2))
    (tmp_path / "chunks" / "metadata.pt").unlink()  # an incomplete write
    with pytest.raises(AssertionError, match="no metadata.pt"):
        FilesystemDataset(**_args(_items(ds_root, 4), tmp_path / "chunks"))


def test_batches_interface(ds_root, tmp_path):
    ds, _ = _make(ds_root, tmp_path)
    batches = list(ds.batches(64, np.random.default_rng(1)))
    assert len(batches) == (4 * HW * HW // 4) // 64
    b = batches[0]
    assert b["rays"].shape == (64, 8) and b["rays"].dtype == np.float32
    assert b["rgbs"].shape == (64, 3) and b["rgbs"].dtype == np.float32
    assert b["rgbs"].max() <= 1.0
    assert b["img_indices"].dtype == np.int32
    # A chunk smaller than one batch fails loudly.
    with pytest.raises(ValueError, match="rays < batch_size"):
        next(ds.batches(4 * HW * HW, np.random.default_rng(1)))
    ds.close()


def test_differing_intrinsics_materializes_rays(ds_root, tmp_path):
    items = _items(ds_root, 4)
    items[2].intrinsics = items[2].intrinsics * 1.1
    ds = FilesystemDataset(**_args(items, tmp_path / "chunks", num_chunks=2,
                                   disk_flush_size=10**9))
    files = sorted((tmp_path / "chunks").glob("*.parquet"))
    cols = pq.read_table(files[0]).column_names
    assert cols == ["img_indices", "rgbs_0", "rgbs_1", "rgbs_2"] + [
        f"rays_{i}" for i in range(8)]
    stamp = load_pt(tmp_path / "chunks" / "metadata.pt")
    assert stamp["near"] == 0.5 and stamp["far"] == 3.5
    assert stamp["center_pixels"] is True and stamp["ray_altitude_range"] is None
    chunk = ds.load_chunk()
    assert np.isfinite(chunk["rays"]).all()
    ds.close()
    with pytest.raises(AssertionError, match="far differs"):
        FilesystemDataset(**_args(items, tmp_path / "chunks", far=4.0))


@pytest.mark.parametrize("altitude", [None, (-0.3, 0.4)])
def test_get_rays_flat_matches_jax(altitude):
    rng = np.random.default_rng(7)
    n = 512
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    c2ws = np.concatenate([q, rng.uniform(-1, 1, size=(n, 3, 1))], -1).astype(np.float32)
    want = np.asarray(j_get_rays_flat(jnp.asarray(d), jnp.asarray(c2ws), 0.1, 2.5, altitude))
    got = get_rays_flat(torch.from_numpy(d), torch.from_numpy(c2ws), 0.1, 2.5, altitude)
    assert got.dtype == torch.float32 and got.shape == (n, 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if altitude is not None:  # the altitude planes moved some bounds
        assert (want[:, 6] > 0.1).any() and (want[:, 7] < 2.5).any()


def _stream(ds, seed=1, epochs=3):
    """The batches of `epochs` chunks, each shuffled as the runner does."""
    return [b for e in range(epochs)
            for b in ds.batches(64, np.random.default_rng((seed, e)))]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_written_by_one_package_reads_back_in_the_other(ds_root, tmp_path, writer):
    kw = dict(ray_altitude_range=[-0.5, 0.5], num_chunks=3)

    def make_jax():
        return JFilesystemDataset(**_args(_items(ds_root, 4, JImageMetadata),
                                          tmp_path / "chunks", **kw))

    def make_port():
        return FilesystemDataset(**_args(_items(ds_root, 4), tmp_path / "chunks", **kw))

    # The first one made writes the store; the second reuses it.
    if writer == "jax":
        j_ds, t_ds = make_jax(), make_port()
    else:
        t_ds = make_port()
        j_ds = make_jax()
    want, got = _stream(j_ds), _stream(t_ds)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["img_indices"], w["img_indices"])
        np.testing.assert_array_equal(g["rgbs"], w["rgbs"])
        np.testing.assert_allclose(g["rays"], w["rays"], atol=1e-5)
    t_ds.close()


@pytest.mark.parametrize("materialized", [False, True])
def test_same_seed_stores_hold_the_same_columns(ds_root, tmp_path, materialized):
    j_items, t_items = _items(ds_root, 4, JImageMetadata), _items(ds_root, 4)
    if materialized:  # differing intrinsics -> rays_0..7
        j_items[1].intrinsics = j_items[1].intrinsics * 1.1
        t_items[1].intrinsics = t_items[1].intrinsics * 1.1
    kw = dict(ray_altitude_range=[-0.5, 0.5], num_chunks=3, disk_flush_size=300)
    JFilesystemDataset(**_args(j_items, tmp_path / "j", **kw))
    FilesystemDataset(**_args(t_items, tmp_path / "t", **kw)).close()
    j_files = sorted((tmp_path / "j").glob("*.parquet"))
    t_files = sorted((tmp_path / "t").glob("*.parquet"))
    assert [f.name for f in t_files] == [f.name for f in j_files]
    for jf, tf in zip(j_files, t_files):
        jt, tt = pq.read_table(jf), pq.read_table(tf)
        assert tt.schema == jt.schema
        for name in jt.column_names:
            if name.startswith("rays_"):
                np.testing.assert_allclose(tt[name].to_numpy(), jt[name].to_numpy(),
                                           atol=1e-5, err_msg=name)
            else:
                np.testing.assert_array_equal(tt[name].to_numpy(),
                                              jt[name].to_numpy(), err_msg=name)
    j_stamp, t_stamp = load_pt(tmp_path / "j" / "metadata.pt"), load_pt(tmp_path / "t" / "metadata.pt")
    assert set(t_stamp) == set(j_stamp)
    assert t_stamp["chunk_rows"] == j_stamp["chunk_rows"]
