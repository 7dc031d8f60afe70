"""Mid-epoch resume of the port's trainer, its metrics log and profiler
window, on the CPU (`--device cpu`), for both dataset types.

One uninterrupted run of 20 steps per dataset type (a checkpoint every
step, validation at 10 and 20, `--profile_steps 2`) is the reference:
- resumed from its checkpoint at 10 (mid-epoch) or 14 (the last batch of
  an epoch), a run to 20 takes the same batches as steps 11-20 (14-20) of
  the uninterrupted one, and ends with the same parameters and Adam
  moments (1e-6) and sample-generator state;
- with `--no_resume_ckpt_state` the resumed run restarts the stream at
  epoch 0, batch 0, and the generator at the seed;
- the port's resumed stream equals the JAX `Runner.train` stream resumed
  at the same (epoch, batch_index) (its step stubbed out: only the
  stream is compared);
- `<exp>/tb/metrics.jsonl` holds `train/rays_per_sec` and the per-image
  validation scalars, and `<exp>/profile/trace.json.gz` is a Chrome trace.
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mega_nerf_tpu.runtime.runner as j_runner_mod
from mega_nerf_tpu.parallel.train_step import make_optimizer as j_make_optimizer
from mega_nerf_tpu.parallel.train_step import make_train_state as j_make_state
from mega_nerf_tpu.runtime import checkpoints as j_ckpt
from mega_nerf_tpu.runtime.runner import Runner as JRunner
from mega_nerf_tpu_torch import train as port_train
from mega_nerf_tpu_torch.parallel.train_step import TrainStep
from mega_nerf_tpu_torch.runtime.logging import MetricsWriter
from tests.synthetic import make_synthetic_dataset
from tests.test_torch_eval import _args, _j_hparams

STEPS = 20
# 3 train views + the val view's left half at 16x16 = 896 rays: 14 batches
# of 64 an epoch in memory, 7 a chunk (one epoch) in a 2-chunk store.
EPOCH_END = 14  # memory: epoch 0's last batch; filesystem: epoch 1's
EXPECTED_STATE = {  # (dataset_type, checkpoint) -> dataset_state
    ("memory", 10): {"epoch": 0, "batch_index": 9},
    ("memory", 14): {"epoch": 0, "batch_index": 13},
    ("filesystem", 10): {"epoch": 1, "batch_index": 2},
    ("filesystem", 14): {"epoch": 1, "batch_index": 6},
}


def _port_args(ds, exp, dataset_type, chunks, steps, extra=()):
    args = _args(ds, exp, True) + [
        "--dataset_type", dataset_type, "--batch_size", "64",
        "--train_iterations", str(steps), "--lr", "5e-3",
        "--ckpt_interval", "1", "--val_interval", "10", *extra]
    if dataset_type == "filesystem":
        args += ["--chunk_paths", str(chunks), "--num_chunks", "2"]
    return args


def _train_recording(args):
    """port train.main on the CPU -> the host batches of its steps."""
    batches = []
    call = TrainStep.__call__

    def recording(self, batch, generator=None):
        batches.append({k: v.numpy().copy() for k, v in batch.items()})
        return call(self, batch, generator)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TrainStep, "__call__", recording)
        port_train.main(port_train.get_train_opts(args + ["--device", "cpu"]))
    return batches


@pytest.fixture(scope="module", params=["memory", "filesystem"])
def uninterrupted(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"resume_{request.param}")
    ds = make_synthetic_dataset(tmp / "ds", n_train=3, n_val=1, hw=(16, 16))
    chunks = tmp / "chunks"
    batches = _train_recording(_port_args(
        ds, tmp / "exp", request.param, chunks, STEPS, ["--profile_steps", "2"]))
    return {"type": request.param, "ds": ds, "chunks": chunks, "tmp": tmp,
            "exp": tmp / "exp" / "0", "batches": batches}


def _ckpt(exp, it):
    return torch.load(exp / "models" / f"{it}.pt", weights_only=False)


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("rays", "rgbs", "img_indices"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"batch {i} {k}")


def _assert_same_state(got, want, atol):
    for key in ("model_state_dict", "bg_model_state_dict"):
        assert got[key].keys() == want[key].keys()
        for name, value in want[key].items():
            np.testing.assert_allclose(got[key][name].numpy(), value.numpy(),
                                       atol=atol, rtol=0, err_msg=f"{key} {name}")
    for side in ("nerf", "bg_nerf"):
        g_state = got["optimizers"][side]["state"]
        w_state = want["optimizers"][side]["state"]
        assert g_state.keys() == w_state.keys()
        for i, w in w_state.items():
            for moment in ("exp_avg", "exp_avg_sq"):
                np.testing.assert_allclose(
                    g_state[i][moment].numpy(), w[moment].numpy(), atol=atol,
                    rtol=0, err_msg=f"{side} {i} {moment}")
            assert float(g_state[i]["step"]) == float(w["step"])


@pytest.mark.parametrize("at", [10, EPOCH_END], ids=["mid_epoch", "epoch_end"])
def test_resumed_run_equals_uninterrupted(uninterrupted, at):
    run = uninterrupted
    ckpt = _ckpt(run["exp"], at)
    assert ckpt["iteration"] == at
    assert ckpt["dataset_state"] == EXPECTED_STATE[(run["type"], at)]
    resumed = _train_recording(_port_args(
        run["ds"], run["tmp"] / f"resumed_{at}", run["type"], run["chunks"], STEPS,
        ["--ckpt_path", str(run["exp"] / "models" / f"{at}.pt")]))
    # The epoch-end checkpoint skips the rest of no epoch: the resumed run
    # starts the next epoch at its first batch.
    _assert_same_batches(resumed, run["batches"][at:])
    got = _ckpt(run["tmp"] / f"resumed_{at}" / "0", STEPS)
    want = _ckpt(run["exp"], STEPS)
    _assert_same_state(got, want, atol=1e-6)
    assert torch.equal(got["generator_state"], want["generator_state"])
    assert got["dataset_state"] == want["dataset_state"]


def test_no_resume_ckpt_state_restarts_the_stream(uninterrupted):
    run = uninterrupted
    exp = run["tmp"] / "fresh_stream"
    resumed = _train_recording(_port_args(
        run["ds"], exp, run["type"], run["chunks"], 14,
        ["--ckpt_path", str(run["exp"] / "models" / "10.pt"),
         "--no_resume_ckpt_state"]))
    _assert_same_batches(resumed, run["batches"][:4])
    got = _ckpt(exp / "0", 14)
    # The iteration count continues; the stream and generator start over.
    want = _ckpt(run["exp"], 4)
    assert got["iteration"] == 14
    assert got["dataset_state"] == want["dataset_state"]
    assert torch.equal(got["generator_state"], want["generator_state"])


def test_resumed_stream_equals_the_jax_runners(uninterrupted, tmp_path):
    """The JAX `Runner.train` resumed at the (epoch, batch_index) of the
    port's step-10 checkpoint takes the port's batches."""
    run = uninterrupted
    port = _train_recording(_port_args(
        run["ds"], tmp_path / "port", run["type"], run["chunks"], 13,
        ["--ckpt_path", str(run["exp"] / "models" / "10.pt")]))
    _assert_same_batches(port, run["batches"][10:13])

    j_args = _port_args(run["ds"], tmp_path / "jax", run["type"], run["chunks"], 13)
    j_args[j_args.index("--val_interval") + 1] = "100000"
    template = JRunner(_j_hparams(j_args), set_experiment_path=False)
    state = j_make_state(template.fg, template.bg, j_make_optimizer(5e-3, 0.1, 13),
                         jax.random.PRNGKey(0))
    ckpt = tmp_path / "10.ckpt"
    j_ckpt.save_checkpoint(ckpt, jax.device_get(state), {
        "iteration": 10, "dataset_state": _ckpt(run["exp"], 10)["dataset_state"]})

    j_batches = []

    def recording_shard(mesh, batch):
        j_batches.append({k: np.asarray(v) for k, v in batch.items()})
        return batch

    def stub_step(*args, **kwargs):  # the stream only: no training math
        return lambda state, batch: (state, {"loss": jnp.zeros(())})

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_runner_mod, "shard_batch", recording_shard)
        mp.setattr(j_runner_mod, "make_train_step", stub_step)
        mp.setattr(JRunner, "_run_validation", lambda self, *a, **k: {})
        JRunner(_j_hparams(j_args + ["--ckpt_path", str(ckpt)])).train()
    assert len(j_batches) == len(port) == 3
    for i, (g, w) in enumerate(zip(port, j_batches)):
        np.testing.assert_array_equal(g["img_indices"], w["img_indices"],
                                      err_msg=f"batch {i}")
        np.testing.assert_array_equal(g["rgbs"], w["rgbs"], err_msg=f"batch {i}")
        # Rays are made by each package's own ops: 1e-5, relative for the
        # far bounds (hundreds of units where the altitude plane cuts them).
        np.testing.assert_allclose(g["rays"], w["rays"], rtol=1e-5, atol=1e-5,
                                   err_msg=f"batch {i}")


def test_metrics_log_and_profiler_window(uninterrupted):
    lines = [json.loads(line) for line in
             (uninterrupted["exp"] / "tb" / "metrics.jsonl").read_text().splitlines()]
    by_key = {k: (line["step"], v) for line in lines for k, v in line.items()
              if k not in ("t", "step")}
    # The first metrics step has no throughput sample of its own; the
    # validation at 10 opened the window that step 20 reads.
    step, rate = by_key["train/rays_per_sec"]
    assert step == STEPS and rate > 0
    assert by_key["train/loss"][0] == STEPS and np.isfinite(by_key["train/loss"][1])
    assert {line["step"] for line in lines if "val/psnr/0" in line} == {10, 20}
    with gzip.open(uninterrupted["exp"] / "profile" / "trace.json.gz", "rt") as f:
        trace = json.load(f)
    assert trace["traceEvents"]


def test_metrics_writer_appends_json_lines(tmp_path):
    writer = MetricsWriter(tmp_path / "tb")
    writer.add_scalar("train/loss", 0.25, 3)
    writer.add_scalar("val/psnr/0", np.float32(21.5), 4)
    writer.add_image("val/0", np.zeros((4, 6, 3), np.uint8), 4)
    writer.flush()
    writer.close()
    writer = MetricsWriter(tmp_path / "tb")  # reopening appends
    writer.add_scalar("train/loss", 0.125, 5)
    writer.close()
    lines = [json.loads(x) for x in
             (tmp_path / "tb" / "metrics.jsonl").read_text().splitlines()]
    assert [(x["step"], {k: v for k, v in x.items() if k not in ("t", "step")})
            for x in lines] == [(3, {"train/loss": 0.25}), (4, {"val/psnr/0": 21.5}),
                                (5, {"train/loss": 0.125})]
    assert all(isinstance(x["t"], float) for x in lines)
