"""The port's LPIPS against the JAX package's, on the CPU.

Random weights of `expected_keys(net)`'s shapes (no pretrained weights are
in the repo), saved as one `.npz` per net, go through the JAX
`LPIPS.from_npz` and the port's for vgg, alex and squeeze; the distances
(about 0.03 with these weights) agree to 1e-5.
The key/shape contract and the tap widths are the JAX package's.
`metrics.lpips` returns {} without a weight file, and a training run's
validation reports `val/lpips/{net}` for each net that has one.
"""

import json

import numpy as np
import pytest
import torch

from mega_nerf_tpu.ops import lpips as j_lpips
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.ops import lpips as t_lpips
from mega_nerf_tpu_torch.ops.metrics import lpips as lpips_metric
from tests.synthetic import make_synthetic_dataset
from tests.test_torch_eval import _args

NETS = ["vgg", "alex", "squeeze"]


def random_weights(net: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, shape in j_lpips.expected_keys(net).items():
        w = rng.normal(0, 0.2, size=shape).astype(np.float32)
        out[k] = np.abs(w) if k.startswith("lin.") else w  # heads are >= 0
    return out


def _images(seed=7, hw=64):
    rng = np.random.default_rng(seed)
    img0 = rng.uniform(0, 1, (2, hw, hw, 3)).astype(np.float32)
    img1 = np.clip(img0 + rng.normal(0, 0.1, img0.shape), 0, 1).astype(np.float32)
    return img0, img1


@pytest.mark.parametrize("net", NETS)
def test_lpips_matches_jax(net, tmp_path):
    path = tmp_path / f"{net}.npz"
    np.savez(path, **random_weights(net))
    img0, img1 = _images()
    want = np.asarray(j_lpips.LPIPS.from_npz(net, path)(img0, img1))
    port = t_lpips.LPIPS.from_npz(net, path)
    got = port(torch.from_numpy(img0), torch.from_numpy(img1))
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # One image (H, W, 3) -> a scalar; identical images -> zero.
    one = port(torch.from_numpy(img0[0]), torch.from_numpy(img1[0]))
    np.testing.assert_allclose(float(one), want[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        port(torch.from_numpy(img0), torch.from_numpy(img0)).numpy(), 0.0, atol=1e-6)


@pytest.mark.parametrize("net", NETS)
def test_weight_contract_and_taps_match_jax(net):
    assert t_lpips.expected_keys(net) == j_lpips.expected_keys(net)
    weights = {k: torch.from_numpy(v) for k, v in random_weights(net).items()}
    taps = t_lpips._features(net, weights, torch.zeros((1, 3, 64, 64)))
    assert [t.shape[1] for t in taps] == t_lpips.TAP_CHANNELS[net] \
        == j_lpips.TAP_CHANNELS[net]
    del weights["lin.0.weight"]
    with pytest.raises(ValueError, match="missing keys"):
        t_lpips.LPIPS(net, weights)


def test_metrics_lpips_reads_the_weights_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("MEGA_NERF_TPU_LPIPS_WEIGHTS", str(tmp_path))
    a = torch.from_numpy(_images(3, 48)[0][0])
    b = torch.from_numpy(_images(4, 48)[0][0])
    assert lpips_metric(a, b) == {}  # no weight file: no LPIPS
    np.savez(tmp_path / "alex.npz", **random_weights("alex"))
    (tmp_path / "vgg.npz").write_bytes(b"not an npz")  # unusable: skipped
    with pytest.warns(UserWarning, match="lpips-vgg weights unusable"):
        out = lpips_metric(a, b)
    assert list(out) == ["alex"] and out["alex"] > 0
    want = float(j_lpips.LPIPS.from_npz("alex", tmp_path / "alex.npz")(
        a.numpy(), b.numpy()))
    np.testing.assert_allclose(out["alex"], want, rtol=1e-5)


def test_validation_reports_lpips(tmp_path, monkeypatch):
    weights = tmp_path / "weights"
    weights.mkdir()
    np.savez(weights / "alex.npz", **random_weights("alex"))
    monkeypatch.setenv("MEGA_NERF_TPU_LPIPS_WEIGHTS", str(weights))
    ds = make_synthetic_dataset(tmp_path / "ds", n_train=2, n_val=1, hw=(64, 64))
    hp = port_train.get_train_opts(_args(ds, tmp_path / "exp", True) + [
        "--dataset_type", "memory", "--batch_size", "64",
        "--train_iterations", "1", "--device", "cpu"])
    metrics = port_train.main(hp)
    assert set(metrics) == {"val/psnr", "val/ssim", "val/lpips/alex"}
    assert np.isfinite(metrics["val/lpips/alex"]) and metrics["val/lpips/alex"] > 0
    text = (tmp_path / "exp" / "0" / "metrics.txt").read_text()
    assert f"Average val/lpips/alex: {metrics['val/lpips/alex']}" in text
    lines = [json.loads(x) for x in
             (tmp_path / "exp" / "0" / "tb" / "metrics.jsonl").read_text().splitlines()]
    assert [x["val/lpips/alex/0"] for x in lines if "val/lpips/alex/0" in x] \
        == [metrics["val/lpips/alex"]]
