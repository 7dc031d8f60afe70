#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs every phase, in order:
1. build    - compile every CUDA kernel of the port for sm_90a from the
              sources in this checkout (one nvcc per source, all at once);
              prints ptxas registers and spills, and fails when ptxas
              serialises a wgmma pipeline (warnings C7515, C7520, ...).
2. compare  - each kernel against its plain PyTorch version on the same
              seeded inputs at the main paths' shapes (~1M points, paper fg
              and bg widths, bf16), plus narrower variants, variants without
              dirs / appearance, a 512-wide one, and M not a multiple of
              the 64- or 128-point tiles.
              Forward kernels (eval, train with sigma noise): rgb <= 1e-2
              absolute, sigma <= 1e-2 * (1 + |sigma|). Backward-data (from
              the forward kernel's saved rows) and weight-gradient (from the
              backward-data kernel's rows): relative norm <= 1e-2 per
              layer's gradient rows, d_app and every gradient tensor (bf16
              operands, another summation order); two weight-gradient
              launches on the same inputs give the same bits; at the fg and
              bg paper shapes the eval kernel's output equals the training
              forward's without noise bit for bit (the same layer chain).
2b. compare_wide - the wide route (layer_dim 513-2048, `csrc/eval_wide.cu`):
              the encode, layer GEMM and heads kernels against their plain
              versions at widths 640, 1024 and 2048 (every layer of the
              chain fed the plain chain's input: the skip layer, and dir_a
              with and without dirs and appearance), M not a multiple of the
              128-point tile, and the whole wide eval at the dense fg and bg
              shapes on 1,000,003 points. Encode and layers 1e-2 (1 + |y|)
              (the encode also 99.9% of its bf16 elements bit-equal, the
              rest one bf16 ulp away), rgb 1e-2 absolute, sigma 1e-2
              (1 + |sigma|).
2c. compare_f32 - compare's six configurations in f32 compute
              (`--compute_dtype float32`, TF32 off) through the f32 kernels
              (`csrc/eval_f32.cu`, `csrc/train_f32.cu`) against their plain
              versions: rgb <= 1e-4, sigma <= 1e-4 (1 + |sigma|), saved rows,
              gradient rows, d_app and every weight-gradient tensor <= 1e-4
              relative; at the paper shapes the eval kernel equals the
              training forward without noise bit for bit; two weight-gradient
              launches give the same bits; every launch an f32 kernel's.
              Then the weight gradient against f64 sums of its f32 rows, and
              the forward (3xTF32 on wgmma) against an f64 forward of the
              same f32 weights and inputs at the paper width: every saved
              layer, rgb and sigma <= 1e-5 relative (FWD_F64_TOL), beside
              the plain f32 forward's and one-pass TF32's errors; and the
              backward-data kernel (3xTF32 on wgmma over the transposed
              weights) against the plain version's f64 sums of the same
              f32 rows: every gradient-row segment, each heads column and
              d_app <= 1e-5 relative (BWD_F64_TOL), two launches bit-equal,
              beside the plain f32 and one-pass TF32 errors.
3. serve    - the serving path end to end: a small dataset in the reference
              layout (one 128x128 val view), a paper-config fg+bg
              checkpoint with seeded random weights, then
              `mega_nerf_tpu_torch.eval.main` on cuda. Checks finite
              PSNR/SSIM, that the fused kernel launched (4 launches per
              16,384-ray chunk) and the plain version never ran, and renders
              one chunk again through the plain version for comparison.
3a. serve_mega - a merged Mega-NeRF mixture at the paper width
              (`configs/mega-nerf/building.yaml`): K = 8 seeded-random fg
              and bg submodules written as `{iter}.pt` runs, centroids on
              a 2 x 4 grid over the cameras (the port's
              `create_cluster_masks.make_centroids`), merged by
              `mega_nerf_tpu_torch.scripts.merge_submodules` into the
              native and the TorchScript container (both load to bit-equal
              weights), then `eval.main --container_path` on the 128x128
              view: finite PSNR/SSIM, K x 4 eval launches a view, no plain
              or eager call, each submodule on its own packed weights; one
              2,048-ray chunk's fg and bg mixture outputs through the
              kernel and through the plain version (rgb 1e-2, sigma 1e-2
              (1 + |sigma|)); s/view, rays/s, peak memory, the view's
              device time by kernel.
3c. bake     - on serve_mega's container and dataset, the grid depth the
              only reduction (6 for the default 8): the val view culled
              and with `--no_cell_cull` (launches, largest rgb difference,
              pixels not bit-equal, s/view); `scripts.create_octree`
              (seconds per step, leaves, file size, `fused_nerf_eval`
              launches = K x probe calls, no plain or eager call);
              `scripts.render_octree` (finite PSNR); `scripts.bake_occupancy
              --res 128`; `eval.main --occupancy_path` (finite PSNR/SSIM,
              s/view, launches, peak memory); culled vs dense again with
              `--occupancy_mode both`; a 2,048-ray bounded chunk through
              the kernel and the plain version (rgb 1e-2, sigma 1e-2
              (1 + |sigma|)).
3d. serve_routed - routed serving of merged mixtures at the paper width:
              `serve_mega`'s K = 8 container, then a K = 25 mixture merged
              from 25 seeded-random submodules (`--grid_dim 5 5`), each on
              the val view and `bake`'s outward edge view under
              `--mega_routing dense`, `routed` (per point, top M = 4 at
              margin 1.15, and M = K), `ray` (per ray, behind the 0.45 cost
              gate) and `ray` with the gate open: `fused_nerf_eval` launches a view
              and no other kernel, plain or eager call; s/view against
              dense; the ray path's decision and plan cost; peak memory;
              against dense the largest rgb difference and the pixels not
              bit-equal, at most 1e-4 on every pixel for ray routing and,
              for per-point routing, on every pixel none of whose points
              holds more than M nonzero weights (those are counted); each
              M = 4 per-point routed view rendered again through the
              plain version (rgb 1e-2 on every pixel). Every kernel's counter is
              set to 0 before the phase and read after it.
3b. serve_dense - the same at the `configs/mega-nerf-dense` width (fg and
              bg 8x2048, seeded random weights): `eval.main` on cuda through
              the wide kernels. Checks finite PSNR/SSIM, launches of each
              wide kernel, no narrow eval launch, no eager-module or plain
              call, peak device memory, and 1,024 rays rendered again
              through the wide plain version (rgb <= 1e-2).
4. train    - the training path end to end: `mega_nerf_tpu_torch.train.main`
              on cuda at the paper config (1024-ray batches, fg + bg 8x256,
              256 + 512 samples, Adam with per-step decay), 120 steps on a
              generated 128x128 dataset with a smooth pattern. Checks finite
              metrics, a falling loss (mean of the last 10 steps below the
              first 10), 4 launches per step of each training kernel and no
              plain call, and a finite-PSNR `eval.main` on the final
              `{iter}.pt`; then one step from the same weights and batch
              through the kernels and through the plain versions.
4b. train_fs - the training path fed from the parquet chunk store, cut and
              resumed: a 4-chunk store of a generated 128x128 dataset, run
              A = 40 paper-config steps of `train.main --dataset_type
              filesystem` (a checkpoint and a validation every 20,
              `--profile_steps 5`), run B = A's step-20 checkpoint (mid-
              epoch) resumed to 40 in a fresh experiment. Checks finite
              metrics, 4 launches a step of each narrow training kernel in
              both runs and no plain or eager-module call, the same batches
              bit for bit in A's steps 21-40 and B's, the final weights
              within 1e-3 relative, `train/rays_per_sec` in A's
              `metrics.jsonl`, A's profiler trace, a finite-PSNR `eval.main`
              on A's last checkpoint. Records: a one-chunk store of 16 + 1
              views at 512x512 (its write, the chunk's read and regenerate
              ms and rays/s), `load_chunk`'s waits on the prefetch in run A,
              and ms per step over 20 chained steps fed from that store
              beside fed from memory (turns memory, store, store, memory).
4c. train_cells - the README's grid workflow at the paper width
              (`configs/mega-nerf/building.yaml`, `--grid_dim 2 4`: K = 8)
              on 17 generated views of 128x128: `scripts.create_cluster_masks`
              on cuda (1000 samples; one view's ratios against the same pass
              on the CPU, 1e-5 relative, the masks equal off the 1e-5 band),
              `train_cells.main` for 20 grid steps (640 launches of each
              narrow training kernel, no plain or eager call, finite losses,
              the mean over the cells falling from step 1 to 20; ms per grid
              step and per cell step over 10 chained steps, peak memory), a
              run resumed from cell 3's step-10 checkpoint bit-equal to the
              uninterrupted one in every cell, `scripts.merge_submodules` of
              the 8 cells and `eval.main --container_path` on the val view
              (32 `eval_fwd` launches, finite PSNR, s/view).
4f. converge - the port's `scripts.convergence_run` at the paper config on
              the analytic ring scene (`data/synthetic.py`: 28 train and 2
              val views of 128x128, masks on a 2x1 grid, the chunk store),
              cell 0 for 2,500 steps, val PSNR at 1,250 and 2,500: 4
              launches a step of each narrow training kernel, eval launches
              in the validations only, no other kernel, plain or eager call;
              every val PSNR finite, the curve rising, the last >= 20 dB;
              the curve beside the JAX package's 28.32 dB at 2,500 (its TPU
              run's quality), median rays/s, each stage's seconds.
4g. converge_cells - `scripts.cell_convergence_run --grid 2 1 --steps 1250
              --bake` on the same scene, then `scripts.cell_diagnostics
              --synthetic` on its `merged.pt`: per stage (scene, masks,
              training, merge, merged eval, octree, flythrough, diagnostics)
              seconds and launches; 4 x K training launches a grid step; a
              merged PSNR >= 20 dB beside `converge`'s at 1,250; K eval
              launches a probe call of the depth-6 octree, its leaves and
              bytes; two frames; K launches and finite rows in the
              diagnostics, its floater and missing voxels.
4e. multiproc - 2 ranks on the one card through torchrun and gloo (this
              script again, `--multiproc_worker`): the first global batch's
              gradients averaged over the ranks against one process's
              kernel step (1e-2 relative per tensor); `train.main`
              data-parallel at the paper config, 20 steps of 512 rays a
              rank (80 launches of each training kernel on each rank, both
              ranks' weights bit-equal, a falling loss; ms a step over 20
              chained steps beside the one-process step's); masks over both
              ranks, `train_cells --cell_axis 2` on K = 3 cells (a padding
              cell on rank 1) from each rank's filesystem stores, a resume
              bit-equal in every real cell, the merge and a view; then
              `render_images` over both ranks, frames byte-equal to one
              process's. Sets `launches_multiproc`: both ranks' counts
              from just before `train.main` to just after `render_images`
              (the gradient check and the chained timing left out).
4d. train_mega - joint Mega-NeRF training: `train.main --train_mega_nerf`
              with `serve_mega`'s K = 8 centroids on `train`'s dataset at
              the paper config, 20 steps (finite metrics, a falling loss,
              each training kernel's launches a step equal and at most
              4 x K, no plain or eager call, each pass's points per
              submodule summing to the pass), ms a step over 20 chained
              steps beside `train`'s single-model step, peak memory, a
              profile of the joint step (device busy ms, the training
              kernels' part), `eval.main --train_mega_nerf --ckpt_path`
              (finite PSNR), every kernel's counter set to 0 before
              `train.main` and read after `eval.main`; then one joint step
              at the paper width: its loss against the plain step's, each
              MLP call's kernels against their plain versions on the
              call's own inputs (outputs, rows, d_app, every gradient),
              the step's gradients against its calls' sums (each relative
              1e-2); its gradients against a plain and an f64 step
              printed.
5. time     - eval kernel ms per launch and its persistent grid at the
              serving path's four shapes (fg 16,384 x 256 and x 512, bg
              16,384 x 128 and x 256 points), its TFLOP/s, plain ms and bound
              at fg fine; training kernels ms per launch at each of the
              step's four shapes (fg-fine: 1024 x 512 points); the plain
              versions' ms and the bounds at the fg-fine shapes (each
              kernel's FLOP - forward, dX or dW products - at 989 TFLOP/s
              against the training function's boundary bytes at 3.35 TB/s;
              the saved rows the kernels pass each other are printed
              beside it as the design's own cost, with the weight-gradient
              kernel's achieved rate over them); the weight gradient's
              library time (cuBLAS through torch.mm of the same bf16 column
              views, one call per job); the serving
              path's s/view and rays/s; train step ms and rays/s over 20
              chained steps; the card's name and power limit beside them.
6b. time_dense - the wide kernels at the dense width on one 524,288-point
              sub-chunk (the layer GEMM at a 2048 x 2048 trunk layer, with
              TFLOP/s, bound, plain ms and cuBLAS's F.linear on the same
              bf16 operands; the encode at the fg and the bg shape, each
              with its byte bound and its agreement with plain: the share
              of bit-equal bf16 elements, at least 99.9%, and the largest
              difference in bf16 ulps, at most 1); the whole wide eval at the fg-fine shape of one
              chunk (8,388,608 points) against its bound, its plain version
              and the cuBLAS chain over the same layers; the dense view's
              s/view, rays/s and peak device memory, and a torch.profiler
              window over one view: device time of each wide kernel and of
              the rest (the renderer), and the card's busy share.
7. eager_dense - a record, not a check: `eval.main --no_pallas` on the
              dense checkpoint, i.e. the eager module, the route the port
              took for this model before the wide kernels; prints its
              s/view or its out-of-memory error (the phase fails only on
              another error or non-finite metrics).
The wide training route (fg and bg 8x1024) adds, in the order of `main`:
compare_train_wide (each wide training kernel against its plain version,
also at the four pass sizes of a step, where a trunk layer's dW and db from
the kernel and from the plain f32 matmul are each held against f64 sums of
the same bf16 operands), train_wide (20 steps of `train.main`, launches per
step, an eval of the written checkpoint), time_train_wide (ms per step,
peak memory, a profile by kernel with the step's dW device time beside its
FLOP and bound; each kernel per launch at the fg-fine shape with its bound
and plain time, dX and dW beside cuBLAS, the forward's layer GEMM beside
`F.linear` on its operands and bias, each GEMM's ratio to its library call;
the layer GEMM's ratio at 2048 is time_dense's; dW and torch.mm at a trunk
job at each pass size, each timed right after the same ten layer GEMMs,
beside the SM clock and the cycles) and eager_train_wide (a record of the
eager module's step).
The cascade families and the SH head add, after time_train_wide:
serve_cascade (`eval.main` with `configs/npp/building.yaml`: coarse and fine
NeRFs, fg and bg 8x2048, seeded random weights, the 128x128 view; the wide
eval kernels' launches for each of the four levels, each on its own packed
weights, no narrow, eager or plain call; the levels' MLPs differ on the
same points; 1,024 rays again through the wide plain version, fine and
coarse rgb <= 1e-2; s/view, rays/s, peak memory, device time by kernel),
train_cascade (20 steps of `train.main` with
`configs/mega-nerf-embed-only/building.yaml` at `--layer_dim 1024`: finite
metrics with `coarse_loss`, a falling loss, each level's wide training
launches per step, its pass sizes 262,144 and 786,432 held against the plain
versions in compare_train_wide, no narrow, plain or eager call; `eval.main`
on its `{iter}.pt`; ms/step and peak memory) and train_sh (10 steps of
`train.main` and an eval with `configs/mega-nerf-sh-3/building.yaml`, the
eager module named by the log for every pass, no kernel launch). Last,
remat: eager_train_wide's steps again, from the same weights, with
`--remat` (every eager MLP pass checkpointed): peak memory and ms a step
beside the run without it; fails unless the peak is lower and the loss
after the steps agrees within 1e-5.
Then resume_jax: a run moved from the JAX package's `.ckpt`. `train.main`
at the paper config on `train`'s scene, 20 steps with a checkpoint at 10;
the step-10 state written as the JAX package's `10.ckpt` by this script's
own writer (`write_jax_checkpoint`: the `MNTPU001` header, a hand-written
msgpack encoder of the flax tree with ext 1 ndarrays, the pickled aux; the
card's machine has no jax, flax or msgpack) and as a `10.pt` whose generator
state is a fresh run's; each resumed to 20 by `train.main` and evaluated by
`eval.main`. Checks: the two `20.pt` files bit-equal (weights, Adam states,
stream position), iteration 20, each schedule at its Adam step; 40 launches
of each narrow training kernel in the resumed run, `eval_fwd` launches in
its validation and again in `eval.main` (every counter set to 0 before the
`.ckpt` resume and read after its eval: `launches_resume_jax`), no plain
call; the two evals' PSNR within 1e-6; the phase's seconds and the resumed
ms a step beside the card's name and power limit.

Last, train_f32: `train.main --compute_dtype float32` at the paper config on
`train`'s scene, 20 steps, then `eval.main` on its `{iter}.pt`, every counter
set to 0 just before `train.main` and read just after `eval.main`: 4 launches
a step of each f32 training kernel, 4 `eval_f32` launches a chunk of every
view, no other kernel's launch, no plain or eager-module call, a falling loss
(mean of the last 5 steps below the first 5), a finite PSNR; then ms a step
over 20 chained steps and s/view through the f32 kernels and through the
eager module (`--no_pallas`), in turns (eager, kernels, kernels, eager), and
each f32 kernel per launch at the main path's shapes (eval at the four passes
of a 16,384-ray chunk, the plain version at fg fine in 1,048,576-point
pieces; the training kernels at the four passes of a 1024-ray step, plain and
bound at fg fine, the weight gradient beside torch.mm in f32 with TF32 off;
every f32 kernel's bound at 3xTF32 (three products a multiply-add at 495
TFLOP/s) with FFMA's beside).

Then f32 compute at widths 513-1024 (`csrc/wide_f32.cu` and the f32 weight
gradient of `csrc/train_f32.cu`), TF32 off:
- compare_wide_f32: compare_train_wide's cases and compare_wide's eval
  cases (the dense ones at 1024, the f32 gate's limit) through the f32 wide
  kernels against their plain versions: rgb <= 1e-4, sigma and the
  pre-activations <= 1e-4 (1 + |x|), every layer output <= 1e-4 (1 + |y|),
  every backward tensor, d_app and dW <= 1e-4 relative; dX and dW repeat
  bit for bit; the eval heads equal the training heads without noise bit
  for bit; every launch an f32 wide kernel's. Then the weight gradient and
  the GEMM (3xTF32 on the tensor cores) against f64 sums of their f32 rows
  at the fg-fine pass, <= 1e-5 relative: a 1024 x 1024 layer's dW step,
  the layer (bias, ReLU) and its masked dX job, each beside the plain
  version's error and one-pass TF32's.
- train_wide_f32: `train.main --compute_dtype float32` at fg and bg 8x1024
  on `train`'s scene, 10 steps, then `eval.main` on its `{iter}.pt`, every
  counter set to 0 just before `train.main` and read just after
  `eval.main`: each f32 wide kernel's launches a step as the wide plan says,
  no other kernel's launch, no plain or eager-module call, a falling loss
  (mean of the last 3 steps below the first 3), a finite PSNR; then ms a
  step and peak memory over 3 chained steps, the f32 wide kernels' share of
  a profiled step, s/view of `eval.main`'s val view, each kernel per launch
  at the fg-fine pass (the encode also at the bg shape, each with the share
  of its byte bound; plain, bound, F.linear / torch.mm in f32; the GEMM's
  and the dW's bound at 3xTF32 with FFMA's beside), and, a
  record and not a check, the f32 eager module (`--no_pallas`, and with
  `--remat`) for a step after a warm-up one: ms and memory, or its
  out-of-memory error.

Prints `{"serving": ...}`, `{"serving_mega": ...}`, `{"serving_dense": ...}`,
`{"training": ...}`, `{"training_fs": ...}`, `{"training_wide": ...}`,
`{"serving_cascade": ...}`, `{"training_cascade": ...}`, `{"training_sh": ...}`,
`{"remat": ...}`, `{"training_cells": ...}`, `{"converge": ...}`,
`{"converge_cells": ...}`, `{"baking": ...}`,
`{"serving_routed": ...}`, `{"training_mega": ...}`, `{"multiproc": ...}`,
`{"resume_jax": ...}`, `{"training_f32": ...}`, `{"training_wide_f32": ...}`,
`{"dw_f64": ...}`, `{"fwd_f64": ...}`, `{"bwd_f64": ...}` and `{"gemm_f64": ...}`
lines, a `{"kernels": [...]}` line (with each kernel's
launches in serve_routed, in train_mega's `train.main` and `eval.main`, over
both ranks of multiproc, in resume_jax's resumed run and its eval, in
train_wide_f32's `train.main` and `eval.main`, and in converge and
converge_cells), the
nvidia-smi name/power-limit line,
and as its last line `{"ok": true, "device": {...}}`. Exits non-zero, with
no result line, when a phase fails, when CUDA is unavailable, or when the
port is not beside this script.
"""

from __future__ import annotations

import json
import os
import signal
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_HBM_BYTES = 3.35e12  # H100 SXM HBM3
TOL = 1e-2
F32_TOL = 1e-4  # the f32 kernels against their plain versions (TF32 off)
DW_F64_TOL = 1e-5  # the f32 weight gradient against f64 sums of its f32 rows
GEMM_F64_TOL = 1e-5  # the f32 wide GEMM against f64 sums of its f32 rows
FWD_F64_TOL = 1e-5  # the f32 forward against an f64 forward of its f32 inputs
BWD_F64_TOL = 1e-5  # the f32 backward-data against f64 sums of its f32 rows
F32 = ["--compute_dtype", "float32"]
# (name, source, the TPU kernel it replaces)
KERNELS = (
    ("fused_nerf_eval", "mega_nerf_tpu_torch/render/csrc/eval_fwd.cu",
     "mega_nerf_tpu/render/pallas_mlp.py:401"),
    ("fused_nerf_train_fwd", "mega_nerf_tpu_torch/render/csrc/train_fwd.cu",
     "mega_nerf_tpu/render/pallas_train.py:138"),
    ("train_bwd_data", "mega_nerf_tpu_torch/render/csrc/train_bwd.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
    ("weight_grad", "mega_nerf_tpu_torch/render/csrc/weight_grad.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
    # The wide route (layer_dim 513-2048): the same TPU kernel at those widths.
    ("eval_wide_encode", "mega_nerf_tpu_torch/render/csrc/eval_wide.cu",
     "mega_nerf_tpu/render/pallas_mlp.py:401"),
    ("eval_wide_layer", "mega_nerf_tpu_torch/render/csrc/eval_wide.cu",
     "mega_nerf_tpu/render/pallas_mlp.py:401"),
    ("eval_wide_heads", "mega_nerf_tpu_torch/render/csrc/eval_wide.cu",
     "mega_nerf_tpu/render/pallas_mlp.py:401"),
    # The wide training route (layer_dim 513-1024): the forward's layers are
    # eval_wide_layer; these replace the training kernels at those widths.
    ("train_wide_heads_fwd", "mega_nerf_tpu_torch/render/csrc/train_wide.cu",
     "mega_nerf_tpu/render/pallas_train.py:138"),
    ("train_wide_heads_bwd", "mega_nerf_tpu_torch/render/csrc/train_wide.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
    ("train_wide_dx", "mega_nerf_tpu_torch/render/csrc/train_wide.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
    ("train_wide_dw", "mega_nerf_tpu_torch/render/csrc/train_wide.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
    # f32 compute (--compute_dtype float32) to width 512: the three TPU
    # kernels' f32 range, in f32 (f32 sums; every layer product as 3xTF32
    # split products on the tensor cores).
    ("fused_nerf_eval_f32", "mega_nerf_tpu_torch/render/csrc/eval_f32.cu",
     "mega_nerf_tpu/render/pallas_mlp.py:401"),
    ("fused_nerf_train_fwd_f32", "mega_nerf_tpu_torch/render/csrc/train_f32.cu",
     "mega_nerf_tpu/render/pallas_train.py:138"),
    ("train_bwd_data_f32", "mega_nerf_tpu_torch/render/csrc/train_f32.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
    ("weight_grad_f32", "mega_nerf_tpu_torch/render/csrc/train_f32.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
    # f32 compute at widths 513-1024: the three TPU kernels' last range. The
    # GEMM (3xTF32 on wgmma) is every forward layer and every dX job; the
    # weight gradient is weight_grad_f32's kernel pair, per-job operands.
    ("wide_f32_encode", "mega_nerf_tpu_torch/render/csrc/wide_f32.cu",
     "mega_nerf_tpu/render/pallas_mlp.py:401"),
    ("wide_f32_gemm", "mega_nerf_tpu_torch/render/csrc/wide_f32.cu",
     "mega_nerf_tpu/render/pallas_mlp.py:401"),
    ("wide_f32_heads_fwd", "mega_nerf_tpu_torch/render/csrc/wide_f32.cu",
     "mega_nerf_tpu/render/pallas_train.py:138"),
    ("wide_f32_heads_bwd", "mega_nerf_tpu_torch/render/csrc/wide_f32.cu",
     "mega_nerf_tpu/render/pallas_train.py:171"),
)
F32_KERNELS = ("fused_nerf_eval_f32", "fused_nerf_train_fwd_f32", "train_bwd_data_f32",
               "weight_grad_f32")
WIDE_F32_KERNELS = ("wide_f32_encode", "wide_f32_gemm", "wide_f32_heads_fwd",
                    "wide_f32_heads_bwd")
WIDE_KERNELS = ("eval_wide_encode", "eval_wide_layer", "eval_wide_heads")
TRAIN_WIDE_KERNELS = ("train_wide_heads_fwd", "train_wide_heads_bwd", "train_wide_dx",
                      "train_wide_dw")
DENSE = ["--layer_dim", "2048", "--bg_layer_dim", "2048"]  # configs/mega-nerf-dense
WIDE_TRAIN = ["--layer_dim", "1024", "--bg_layer_dim", "1024"]  # the JAX training gate's widest


def log(msg: str) -> None:
    print(msg, flush=True)


def paper_hparams(extra=()):
    from mega_nerf_tpu_torch.eval import get_eval_opts

    return get_eval_opts([
        "--exp_name", "unused", "--dataset_path", "unused",
        "--pos_xyz_dim", "12", "--pos_dir_dim", "4", "--layers", "8",
        "--skip_layers", "4", "--layer_dim", "256", "--bg_layer_dim", "256",
        "--appearance_dim", "48", "--compute_dtype", "bfloat16",
        "--coarse_samples", "256", "--fine_samples", "512", *extra,
    ])


def seeded_bundle(hp, appearance_count: int, bg: bool, seed: int, device):
    import torch

    from mega_nerf_tpu_torch.models import init_weights, make_bg_nerf, make_nerf

    bundle = (make_bg_nerf if bg else make_nerf)(hp, appearance_count)
    gen = torch.Generator().manual_seed(seed)
    init_weights(bundle.module, gen)
    with torch.no_grad():  # small random biases so no layer starts dead
        for name, p in bundle.module.named_parameters():
            if name.endswith("bias"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    bundle.module.to(device).eval()
    return bundle


def mlp_inputs(cfg, m: int, seed: int, device):
    """Seeded points in the ranges the renderer feeds: fg xyz inside the
    unit ellipsoid, bg = unit-sphere point + inverse depth; unit dirs."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    if cfg.xyz_dim == 3:
        xyz = 1.5 * (2 * torch.rand((m, 3), generator=gen) - 1)
    else:
        p = torch.randn((m, 3), generator=gen)
        xyz = torch.cat([p / p.norm(dim=-1, keepdim=True),
                         torch.rand((m, 1), generator=gen)], -1)
    d = torch.randn((m, 3), generator=gen)
    dirs = d / d.norm(dim=-1, keepdim=True) if cfg.pos_dir_dim else None
    idx = torch.randint(0, max(cfg.appearance_count, 1), (m,), generator=gen)
    to = lambda t: None if t is None else t.to(device).contiguous()  # noqa: E731
    return to(xyz), to(dirs), to(idx)


def phase_build(device, report):
    from mega_nerf_tpu_torch.render import _build

    logs = _build.build_all()
    ok = True
    for name, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "Function properties for" in line or "serialized" in line):
                log(f"  {name}: {line.strip()}")
            if "wgmma" in line and "serialized" in line:  # C7515, C7520, ...
                ok = False
    return ok


def compare_case(name, hp, bg, m, seed, device, against_train=False, tol=TOL):
    """Kernel vs plain on one configuration -> (max_abs_err, ok). With
    `against_train`, the eval kernel must also equal the training forward
    without noise bit for bit."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    bundle = seeded_bundle(hp, 16, bg, seed, device)
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = mlp_inputs(bundle.config, m, seed + 1, device)
    app = (bundle.module.appearance(idx).contiguous()
           if bundle.config.appearance_dim else None)
    with torch.no_grad():
        got = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
        torch.cuda.synchronize()
        want = fused_mlp.fused_nerf_eval_plain(packed, xyz, dirs, app)
    err = (got - want).abs()
    rgb_err = err[:, :3].max().item()
    sig_ratio = (err[:, 3] / (1 + want[:, 3].abs())).max().item()
    finite = bool(torch.isfinite(got).all())
    ok = finite and rgb_err <= tol and sig_ratio <= tol
    same = ""
    if against_train:
        counters = (ft.fused_nerf_train_fwd, fused_f32.fused_nerf_train_fwd_f32)
        launches = [f.launches for f in counters]
        with torch.no_grad():
            train_out, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, None)
            torch.cuda.synchronize()
        for f, n in zip(counters, launches):  # not main-path launches
            f.launches = n
        bits = torch.equal(got, train_out)
        ok = ok and bits
        same = f" equals the training forward without noise bit for bit={bits}"
        del train_out, act
        torch.cuda.empty_cache()
    log(f"  {name}: M={m} rgb max|err|={rgb_err:.3e} "
        f"sigma max|err|/(1+|s|)={sig_ratio:.3e} sigma range "
        f"[{want[:, 3].min().item():.3g}, {want[:, 3].max().item():.3g}] "
        f"finite={finite}{same} -> {'ok' if ok else 'FAIL'}")
    return err.max().item(), ok


def rel_err(a, b) -> float:
    """||a - b|| / ||b||."""
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def compare_train_case(name, hp, bg, m, seed, device, tol=TOL, suffix=""):
    """Training kernels vs their plain versions on one configuration ->
    ({kernel + suffix: max_abs_err}, ok)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    bundle = seeded_bundle(hp, 16, bg, seed, device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = mlp_inputs(cfg, m, seed + 1, device)
    app = bundle.module.appearance(idx).float() if cfg.appearance_dim else None
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    noise = torch.rand((m,), generator=gen, device=device)
    noise = noise.to(cfg.dtype).float()
    g = torch.randn((m, 4), generator=gen, device=device)
    with torch.no_grad():
        out, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        want, p_act = ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise)
        torch.cuda.synchronize()
        err = (out - want).abs()
        fwd_rgb = err[:, :3].max().item()
        fwd_sig = (err[:, 3] / (1 + want[:, 3].abs())).max().item()
        act_rel = rel_err(act, p_act)
        fwd_err = err.max().item()
        del p_act
        grad, d_app = ft.train_bwd_data(packed, act, g, noise)
        p_grad, p_d_app = ft.train_bwd_data_plain(packed, act, g, noise)
        torch.cuda.synchronize()
        d = cfg.layer_dim
        rows_rel = max(rel_err(grad[:, i * d:(i + 1) * d], p_grad[:, i * d:(i + 1) * d])
                       for i in range(cfg.layers))
        rows_rel = max(rows_rel, rel_err(grad, p_grad))
        if p_d_app is not None:
            rows_rel = max(rows_rel, rel_err(d_app, p_d_app))
        bwd_err = (grad.float() - p_grad.float()).abs().max().item()
        del p_grad
        flat = ft.weight_grad(packed, act, grad)
        again = ft.weight_grad(packed, act, grad)
        p_flat = ft.weight_grad_plain(packed, act, grad)
        torch.cuda.synchronize()
        same_bits = torch.equal(flat, again)
        del again
        offs = ft._offsets(ft.packed_shapes(packed))
        w_rel = max(rel_err(flat[offs[i]:offs[i + 1]], p_flat[offs[i]:offs[i + 1]])
                    for i in range(len(offs) - 1))
        wg_err = (flat - p_flat).abs().max().item()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(flat).all())
    ok = (finite and fwd_rgb <= tol and fwd_sig <= tol and act_rel <= tol
          and rows_rel <= tol and w_rel <= tol and same_bits)
    log(f"  train {name}: M={m} fwd rgb max|err|={fwd_rgb:.3e} sigma "
        f"max|err|/(1+|s|)={fwd_sig:.3e} rows rel={act_rel:.3e}; bwd-data "
        f"worst rel={rows_rel:.3e}; weight-grad worst rel={w_rel:.3e}, two "
        f"launches bitwise equal={same_bits}; finite={finite} -> "
        f"{'ok' if ok else 'FAIL'}")
    del act, grad, flat, p_flat
    torch.cuda.empty_cache()
    return {"fused_nerf_train_fwd" + suffix: fwd_err, "train_bwd_data" + suffix: bwd_err,
            "weight_grad" + suffix: wg_err}, ok


def compare_cases(extra=()):
    """phase_compare's configurations, each with the flags `extra`."""
    def hp(flags=()):
        return paper_hparams([*flags, *extra])

    return [
        ("fg paper", hp(), False, 1_000_003),
        ("bg paper", hp(), True, 1_000_003),
        ("fg 64-wide, dirs, no appearance",
         hp(["--layer_dim", "64", "--appearance_dim", "0"]), False, 4_097),
        ("fg 48-wide, no dirs, no appearance",
         hp(["--layer_dim", "48", "--appearance_dim", "0", "--pos_dir_dim", "0",
             "--layers", "6", "--skip_layers", "3"]), False, 1_000),
        ("bg 128-wide, appearance, dirs", hp(["--bg_layer_dim", "128"]), True, 70_001),
        ("fg 512-wide, appearance, dirs", hp(["--layer_dim", "512"]), False, 50_001),
    ]


def phase_compare(device, report):
    cases = compare_cases()
    kernels = report["kernels"]
    worst = 0.0
    all_ok = True
    for i, (name, hp, bg, m) in enumerate(cases):
        err, ok = compare_case(name, hp, bg, m, 100 + i, device,
                               against_train=name in ("fg paper", "bg paper"))
        worst = max(worst, err)
        all_ok &= ok
    kernels["fused_nerf_eval"]["max_abs_err"] = worst
    for i, (name, hp, bg, m) in enumerate(cases):
        errs, ok = compare_train_case(name, hp, bg, m, 200 + i, device)
        for k, v in errs.items():
            kernels[k]["max_abs_err"] = max(kernels[k].get("max_abs_err", 0.0), v)
        all_ok &= ok
    return all_ok


def f32_launches():
    """{f32 kernel: launches so far}."""
    from mega_nerf_tpu_torch.render import fused_f32

    return {k: getattr(fused_f32, k).launches for k in F32_KERNELS}


def phase_compare_f32(device, report):
    """phase_compare's six configurations in f32 compute through the f32
    kernels against their plain versions, TF32 off: rgb <= 1e-4, sigma <=
    1e-4 (1 + |sigma|), rows, gradient rows, d_app and weight gradients
    <= 1e-4 relative; at the paper shapes the eval kernel equals the
    training forward without noise bit for bit; the weight gradient
    repeats bit for bit. Every launch is an f32 kernel's."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = report["kernels"]
    before, bf16_before = f32_launches(), sum(kernel_launches().values())
    worst, all_ok = 0.0, True
    cases = compare_cases(F32)
    for i, (name, hp, bg, m) in enumerate(cases):
        err, ok = compare_case(f"f32 {name}", hp, bg, m, 300 + i, device,
                               against_train=name in ("fg paper", "bg paper"),
                               tol=F32_TOL)
        worst = max(worst, err)
        all_ok &= ok
    kernels["fused_nerf_eval_f32"]["max_abs_err"] = worst
    for i, (name, hp, bg, m) in enumerate(cases):
        errs, ok = compare_train_case(f"f32 {name}", hp, bg, m, 400 + i, device,
                                      tol=F32_TOL, suffix="_f32")
        for k, v in errs.items():
            kernels[k]["max_abs_err"] = max(kernels[k].get("max_abs_err", 0.0), v)
        all_ok &= ok
    errs = narrow_dw_against_f64(device)
    report["dw_f64"] = {"narrow": errs}
    dw_ok = errs["kernel"] <= DW_F64_TOL
    log(f"  weight_grad_f32 against f64 sums of its f32 rows at the fg-fine pass (524,288 "
        f"points, paper width; relative over dW and db): kernel (3xTF32) "
        f"{errs['kernel']:.3e}, plain f32 (TF32 off) {errs['plain']:.3e}, one-pass TF32 "
        f"{errs['tf32']:.3e} -> {'ok' if dw_ok else 'FAIL'} (kernel <= {DW_F64_TOL})")
    all_ok &= dw_ok
    fwd = forward_against_f64(device)
    report["fwd_f64"] = fwd
    fwd_ok = max(fwd["kernel"].values()) <= FWD_F64_TOL
    for name in ("kernel", "plain", "tf32"):
        log(f"  f32 forward against an f64 forward of its f32 inputs (paper width fg, "
            f"{FWD_F64_POINTS} points; relative per saved layer, rgb, sigma), {name}: "
            + ", ".join(f"{k} {v:.3e}" for k, v in fwd[name].items()))
    log(f"  f32 forward (3xTF32 on wgmma) worst {max(fwd['kernel'].values()):.3e}, plain f32 "
        f"(TF32 off) {max(fwd['plain'].values()):.3e}, one-pass TF32 "
        f"{max(fwd['tf32'].values()):.3e} -> {'ok' if fwd_ok else 'FAIL'} (kernel <= "
        f"{FWD_F64_TOL} at every layer)")
    all_ok &= fwd_ok
    bwd = backward_against_f64(device)
    report["bwd_f64"] = bwd
    bwd_ok = max(bwd["kernel"].values()) <= BWD_F64_TOL and bwd["repeats_bitwise"]
    for name in ("kernel", "plain", "tf32"):
        log(f"  f32 backward-data against f64 sums of its f32 rows (paper width fg, "
            f"{FWD_F64_POINTS} points; relative per gradient-row segment, heads column, "
            f"d_app), {name}: " + ", ".join(f"{k} {v:.3e}" for k, v in bwd[name].items()))
    log(f"  f32 backward-data (3xTF32 on wgmma) worst {max(bwd['kernel'].values()):.3e}, "
        f"plain f32 (TF32 off) {max(bwd['plain'].values()):.3e}, one-pass TF32 "
        f"{max(bwd['tf32'].values()):.3e}; two launches bitwise equal "
        f"{bwd['repeats_bitwise']} -> {'ok' if bwd_ok else 'FAIL'} (kernel <= {BWD_F64_TOL} "
        f"at every segment)")
    all_ok &= bwd_ok
    after = f32_launches()
    f32_new = {k: after[k] - before[k] for k in F32_KERNELS}
    bf16_new = sum(kernel_launches().values()) - bf16_before - sum(f32_new.values())
    log(f"  f32 kernel launches in this phase {f32_new}; other kernels' {bf16_new}")
    return bool(all_ok and all(v > 0 for v in f32_new.values()) and bf16_new == 0)


FWD_F64_POINTS = 131_072


def forward_against_f64(device):
    """Relative errors (Frobenius) of every saved layer (h0 .. h7, final,
    branch), rgb and sigma of the paper model's f32 forward against an f64
    forward of the same f32 weights, encode and appearance rows
    (`fused_mlp.forward_trace(acc=torch.float64)`), FWD_F64_POINTS seeded fg
    points: the kernels (the training forward's rows without noise, the eval
    kernel's output), the plain f32 forward with TF32 off and with TF32 on
    (one-pass TF32 products) -> {"kernel": {...}, "plain": {...}, "tf32":
    {...}}."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    bundle = seeded_bundle(paper_hparams(F32), 16, False, 34, device)
    packed = fused_mlp.pack_params(bundle.module)
    d, lay = packed.config.layer_dim, ft.act_layout(packed)
    xyz, dirs, idx = mlp_inputs(bundle.config, FWD_F64_POINTS, 35, device)
    counters = (fused_f32.fused_nerf_eval_f32, fused_f32.fused_nerf_train_fwd_f32)
    launches = [f.launches for f in counters]

    def parts(out, act):
        got = {f"h{i}": act[:, lay["h0"] + i * d:lay["h0"] + (i + 1) * d]
               for i in range(packed.config.layers)}
        got["final"] = act[:, lay["final"]:lay["final"] + d]
        got["branch"] = act[:, lay["branch"]:lay["width"]]
        got["rgb"], got["sigma"] = out[:, :3], out[:, 3]
        return got

    allow = torch.backends.cuda.matmul.allow_tf32
    errs = {}
    with torch.no_grad():
        app = bundle.module.appearance(idx).float().contiguous()
        ref = fused_mlp.forward_trace(packed, xyz, dirs, app, acc=torch.float64)
        out64 = ref.output(packed.config.shifted_softplus)
        want = {f"h{i}": h for i, h in enumerate(ref.hs)}
        want["final"] = ref.branch_in[:, :d]
        want["branch"] = ref.branch
        want["rgb"], want["sigma"] = out64[:, :3], out64[:, 3]
        del ref, out64
        try:
            for name, tf32 in (("kernel", False), ("plain", False), ("tf32", True)):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                if name == "kernel":
                    out = fused_mlp.fused_nerf_eval(packed, xyz, dirs, app)
                    _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, None)
                else:
                    out, act = ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, None)
                torch.cuda.synchronize()
                got = parts(out, act)
                errs[name] = {k: (got[k].double() - want[k]).norm().item()
                              / want[k].norm().item() for k in want}
                del out, act, got
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
    for f, n in zip(counters, launches):  # checks, not main-path launches
        f.launches = n
    del want, xyz, dirs, app
    torch.cuda.empty_cache()
    return errs


def bwd_parts(packed, grad, d_app):
    """The gradient rows cut into their segments (`fused_train.grad_layout`:
    d_pre_0 .. d_pre_{L-1}, d_final, d_a, each heads column g_sigma, g_r,
    g_g, g_b) and d_app."""
    from mega_nerf_tpu_torch.render import fused_train as ft

    cfg, gl = packed.config, ft.grad_layout(packed)
    d = cfg.layer_dim
    got = {f"d_pre{i}": grad[:, i * d:(i + 1) * d] for i in range(cfg.layers)}
    if packed.has_branch:
        got["d_final"] = grad[:, gl["dfinal"]:gl["dfinal"] + d]
        got["d_a"] = grad[:, gl["da"]:gl["heads"]]
    for i, name in enumerate(("g_sigma", "g_r", "g_g", "g_b")):
        got[name] = grad[:, gl["heads"] + i]
    if d_app is not None:
        got["d_app"] = d_app
    return got


def backward_against_f64(device):
    """Relative errors (Frobenius) of every gradient-row segment, heads
    column and d_app of the paper model's f32 backward-data against the
    plain version's f64 sums of the same f32 saved rows (the f32 training
    forward's, with sigma noise), weights and cotangent
    (`fused_train.train_bwd_data_plain(acc=torch.float64)`), FWD_F64_POINTS
    seeded fg points: the kernel, the plain version with TF32 off and with
    TF32 on (one-pass TF32 products) -> {"kernel": {...}, "plain": {...},
    "tf32": {...}, "repeats_bitwise": two kernel launches equal}."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    bundle = seeded_bundle(paper_hparams(F32), 16, False, 36, device)
    packed = fused_mlp.pack_params(bundle.module)
    m = FWD_F64_POINTS
    xyz, dirs, idx = mlp_inputs(bundle.config, m, 37, device)
    gen = torch.Generator(device=device).manual_seed(38)
    noise = torch.rand((m,), generator=gen, device=device)
    g = torch.randn((m, 4), generator=gen, device=device)
    counters = (fused_f32.fused_nerf_train_fwd_f32, fused_f32.train_bwd_data_f32)
    launches = [f.launches for f in counters]
    allow = torch.backends.cuda.matmul.allow_tf32
    errs = {}
    with torch.no_grad():
        app = bundle.module.appearance(idx).float().contiguous()
        _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        del xyz, dirs, app
        want = bwd_parts(packed, *ft.train_bwd_data_plain(packed, act, g, noise,
                                                          acc=torch.float64))
        try:
            for name, tf32 in (("kernel", False), ("plain", False), ("tf32", True)):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                if name == "kernel":
                    grad, d_app = ft.train_bwd_data(packed, act, g, noise)
                    again, _ = ft.train_bwd_data(packed, act, g, noise)
                    torch.cuda.synchronize()
                    errs["repeats_bitwise"] = torch.equal(grad, again)
                    del again
                else:
                    grad, d_app = ft.train_bwd_data_plain(packed, act, g, noise)
                got = bwd_parts(packed, grad, d_app)
                errs[name] = {k: ((got[k].double() - w).norm() / w.norm()).item()
                              for k, w in want.items()}
                del grad, d_app, got
        finally:
            torch.backends.cuda.matmul.allow_tf32 = allow
    for f, n in zip(counters, launches):  # checks, not main-path launches
        f.launches = n
    del want, act, g, noise
    torch.cuda.empty_cache()
    return errs


def dw_f64_errors(jobs, n_out, kernel, plain):
    """Relative errors, over every dW and db element `jobs` (fused_f32.WgJob)
    write, against the f64 sums of the same f32 rows: of `kernel()`'s flat
    output (the f32 weight gradient, 3xTF32), of `plain()`'s (the plain
    version) with TF32 off, and of `plain()`'s with TF32 on (one-pass TF32
    products) -> {"kernel": e, "plain": e, "tf32": e}."""
    import torch

    device = jobs[0].d.device
    ref = torch.zeros(n_out, dtype=torch.float64, device=device)
    live = torch.zeros(n_out, dtype=torch.bool, device=device)
    for j in jobs:
        dd = j.d[:, j.d_col:j.d_col + j.n].double()
        rows = slice(j.out_off, j.out_off + j.n * j.stride)
        ref[rows].view(j.n, j.stride)[:, :j.k] = dd.T @ j.x[:, j.x_col:j.x_col + j.k].double()
        live[rows].view(j.n, j.stride)[:, :j.k] = True
        if j.bias_off >= 0:
            ref[j.bias_off:j.bias_off + j.n] = dd.sum(0)
            live[j.bias_off:j.bias_off + j.n] = True
        del dd
    return f64_errors(ref[live], lambda: kernel()[live], lambda: plain()[live])


def narrow_dw_against_f64(device):
    """`dw_f64_errors` of the f32 weight gradient at the paper model's
    fg-fine pass (524,288 points), on the saved and gradient rows of the
    f32 training kernels from seeded inputs."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    bundle = seeded_bundle(paper_hparams(F32), 16, False, 31, device)
    packed = fused_mlp.pack_params(bundle.module)
    m = 1024 * 512
    xyz, dirs, idx = mlp_inputs(bundle.config, m, 32, device)
    gen = torch.Generator(device=device).manual_seed(33)
    noise = torch.rand((m,), generator=gen, device=device)
    g = torch.randn((m, 4), generator=gen, device=device)
    with torch.no_grad():
        app = bundle.module.appearance(idx).float()
        _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
        grad, _ = ft.train_bwd_data(packed, act, g, noise)
        del xyz, dirs, app
        jobs = [fused_f32.WgJob(grad, act, *job) for job in ft.weight_grad_jobs(packed)]
        errs = dw_f64_errors(jobs, ft._offsets(ft.packed_shapes(packed))[-1],
                             lambda: ft.weight_grad(packed, act, grad),
                             lambda: ft.weight_grad_plain(packed, act, grad))
    del act, grad, jobs
    torch.cuda.empty_cache()
    return errs


def wide_dw_against_f64(device):
    """`dw_f64_errors` of the f32 weight gradient on one 1024 x 1024 layer's
    dW step of the wide route (trunk layer 2, its bias too) at the fg-fine
    pass (524,288 points): h1 from the f32 wide forward, d_pre2 seeded
    normal rows (scale 1e-2) under h2's ReLU mask."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    bundle = seeded_bundle(paper_hparams([*WIDE_TRAIN, *F32]), 16, False, 65, device)
    packed = fused_mlp.pack_params(bundle.module)
    plan = ftw.check_plan(packed)
    xyz, dirs, idx = mlp_inputs(bundle.config, 1024 * 512, 66, device)
    gen = torch.Generator(device=device).manual_seed(67)
    with torch.no_grad():
        app = bundle.module.appearance(idx).float()
        _, saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, None)
        del xyz, dirs, app
        h1, h2 = saved["h1"], saved["h2"]
        del saved
        gp = torch.randn(h2.shape, generator=gen, device=device) * 1e-2 * (h2 > 0)
        del h2
        job = next(job for kind, job in plan.steps if kind == "dw" and job[0].d == "g_pre2")
        tensors = {"g_pre2": gp, "h1": h1}
        wjobs = [fused_f32.WgJob(gp, h1, j.d_col, j.n, 0, j.k, j.out_off, j.out_stride,
                                 j.bias_off) for j in job]
        errs = dw_f64_errors(
            wjobs, plan.total,
            lambda: ftw.train_wide_dw(job, tensors, torch.zeros(plan.total, device=device)),
            lambda: ftw.train_wide_dw_plain(job, tensors,
                                            torch.zeros(plan.total, device=device)))
    del gp, h1, tensors, wjobs
    torch.cuda.empty_cache()
    return errs


def f64_errors(ref, kernel, plain):
    """Relative errors (Frobenius, over every element) against `ref` (f64
    sums of the same f32 rows) of `kernel()`'s output (an f32 kernel with
    3xTF32 products), of `plain()`'s with TF32 off and of `plain()`'s with
    TF32 on (one-pass TF32 products) -> {"kernel": e, "plain": e, "tf32":
    e}."""
    import torch

    norm = ref.norm().item()
    allow = torch.backends.cuda.matmul.allow_tf32
    errs = {}
    try:
        for name, fn, tf32 in (("kernel", kernel, False), ("plain", plain, False),
                               ("tf32", plain, True)):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            errs[name] = (fn().double() - ref).norm().item() / norm
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow
    return errs


def wide_gemm_against_f64(device):
    """`f64_errors` of the f32 wide GEMM at the fg-fine pass (524,288
    points, 8x1024): as trunk layer 2 (h1 -> h2, bias and ReLU; h1 from the
    f32 wide forward) and as that layer's masked dX job (d_pre2, seeded
    normal rows (scale 1e-2) under h2's ReLU mask, against the transposed
    weights, masked by h1) -> {"layer": errs, "dx": errs}."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import fused_wide as fw
    from mega_nerf_tpu_torch.render.fused_train import transposed_weights

    bundle = seeded_bundle(paper_hparams([*WIDE_TRAIN, *F32]), 16, False, 68, device)
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = mlp_inputs(bundle.config, 1024 * 512, 69, device)
    gen = torch.Generator(device=device).manual_seed(70)
    out = {}
    with torch.no_grad():
        app = bundle.module.appearance(idx).float()
        _, saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, None)
        del xyz, dirs, app
        h1, h2 = saved["h1"], saved["h2"]
        del saved
        w2, b2 = packed.mats[2], packed.biases[2]
        ref = (h1.double() @ w2.double().T + b2.double()).clamp_min(0)
        out["layer"] = f64_errors(
            ref, lambda: fw.eval_wide_layer([h1], w2, b2, True),
            lambda: fw.eval_wide_layer_plain([h1], w2, b2, True))
        del ref
        gp = torch.randn(h2.shape, generator=gen, device=device) * 1e-2 * (h2 > 0)
        del h2
        wt = transposed_weights(packed)[2]
        ref = (gp.double() @ wt.double().T) * (h1 > 0)
        args = (gp, wt, 0, wt.shape[0], ftw.DX_MASK, h1)
        out["dx"] = f64_errors(ref, lambda: ftw.train_wide_dx(*args),
                                    lambda: ftw.train_wide_dx_plain(*args))
    del gp, h1, ref, args
    torch.cuda.empty_cache()
    return out


def write_dataset(root: Path, hw: int, n_train: int, seed: int,
                  smooth: bool = False):
    """Reference dataset layout: coordinates.pt, {train,val}/metadata/*.pt,
    {train,val}/rgbs/*.png. Cameras sit on a lattice above a ground plane
    (DRB: x down), looking obliquely down; images are seeded noise, or with
    `smooth` a low-frequency colour pattern a model can fit."""
    import numpy as np
    import torch
    from PIL import Image

    rng = np.random.default_rng(seed)
    focal = 0.9 * hw
    intrinsics = torch.tensor([focal, focal, hw / 2, hw / 2], dtype=torch.float32)
    positions = [(-1.0, y, z) for y in (-0.6, 0.0, 0.6) for z in (-0.4, 0.4)]
    if n_train + 1 > len(positions):  # up to 17 train views on a 6 x 3 lattice
        positions = [(-1.0, y, z) for y in np.linspace(-0.6, 0.6, 6)
                     for z in (-0.4, 0.0, 0.4)]
    for i, pos in enumerate(positions[: n_train + 1]):
        split = "val" if i == 2 else "train"
        (root / split / "metadata").mkdir(parents=True, exist_ok=True)
        (root / split / "rgbs").mkdir(parents=True, exist_ok=True)
        pos = np.asarray(pos, np.float64)
        fwd = np.array([0.5, 0.5 * pos[1], 0.5 * pos[2]]) - pos
        fwd /= np.linalg.norm(fwd)
        z_axis = -fwd
        x_axis = np.cross(np.array([-1.0, 0.0, 0.0]), z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        c2w = np.stack([x_axis, y_axis, z_axis, pos], 1).astype(np.float32)
        torch.save({"W": hw, "H": hw, "intrinsics": intrinsics,
                    "c2w": torch.from_numpy(c2w)},
                   root / split / "metadata" / f"{i:06d}.pt")
        img = rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8)
        if smooth:
            yy, xx = np.mgrid[0:hw, 0:hw] / hw
            img = np.stack([0.5 + 0.35 * np.sin(2 * np.pi * (xx + 0.1 * i)),
                            0.5 + 0.35 * np.cos(3 * np.pi * yy),
                            0.5 + 0.3 * np.sin(2 * np.pi * (xx + yy))], -1)
            img = (img * 255).astype(np.uint8)
        Image.fromarray(img).save(root / split / "rgbs" / f"{i:06d}.png")
    torch.save({"origin_drb": torch.zeros(3, dtype=torch.float64),
                "pose_scale_factor": 1.0}, root / "coordinates.pt")


def phase_serve(device, report, tmp: Path):
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch.render import fused_mlp, rendering
    from mega_nerf_tpu_torch.runtime.runner import Runner

    ds = tmp / "dataset"
    write_dataset(ds, hw=128, n_train=4, seed=7)
    n_items = 5
    extra = ["--dataset_path", str(ds), "--exp_name", str(tmp / "exp"),
             "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
             "--val_scale_factor", "1", "--device", "cuda"]
    hp = paper_hparams(extra)
    fg = seeded_bundle(hp, n_items, False, 1, "cpu")
    bg = seeded_bundle(hp, n_items, True, 2, "cpu")
    ckpt = tmp / "0.pt"
    torch.save({"model_state_dict": fg.module.state_dict(),
                "bg_model_state_dict": bg.module.state_dict(),
                "iteration": 0}, ckpt)
    hp.ckpt_path = str(ckpt)

    fused_mlp.fused_nerf_eval.launches = 0
    fused_mlp.fused_nerf_eval_plain.calls = 0
    t0 = time.perf_counter()
    metrics = port_eval.main(hp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_mlp.fused_nerf_eval.launches
    plain_calls = fused_mlp.fused_nerf_eval_plain.calls
    log(f"  eval.main: {metrics} in {wall:.2f} s; kernel launches {launches}, "
        f"plain calls {plain_calls}")
    report["kernels"]["fused_nerf_eval"]["launches"] = launches
    ok = (all(np.isfinite(v) for v in metrics.values())
          and {"val/psnr", "val/ssim"} <= set(metrics)
          and launches >= 4 and launches % 4 == 0 and plain_calls == 0)

    # One chunk again, kernel vs plain MLP path, same weights and rays.
    hp.exp_name = str(tmp / "exp_cmp")
    runner = Runner(hp, set_experiment_path=False)
    runner.make_eval_state()
    meta = runner.val_items[0]
    from mega_nerf_tpu_torch.ops.rays import generate_image_rays

    rays = generate_image_rays(meta, runner.near, runner.far,
                               runner.ray_altitude_range, True,
                               device=device)[:4096]
    idx = torch.full((rays.shape[0],), meta.image_index, device=device)
    settings = runner.render_settings()
    args = (runner.fg, runner.bg, rays, idx, settings,
            runner.sphere_center, runner.sphere_radius)
    with torch.no_grad():
        kern, _ = rendering.render_rays(*args)
        saved = rendering.fused_nerf_eval
        rendering.fused_nerf_eval = fused_mlp.fused_nerf_eval_plain
        try:
            plain, _ = rendering.render_rays(*args)
        finally:
            rendering.fused_nerf_eval = saved
    diff = (kern["rgb_fine"] - plain["rgb_fine"]).abs().max().item()
    dd = ((kern["depth_fine"] - plain["depth_fine"]).abs()
          / (1 + plain["depth_fine"].abs())).max().item()
    log(f"  one 4096-ray chunk, kernel vs plain MLP path: rgb_fine max|diff|="
        f"{diff:.3e}, depth_fine max|diff|/(1+|d|)={dd:.3e}")
    report["render_rgb_diff"] = diff
    ok = ok and diff <= TOL and bool(torch.isfinite(kern["rgb_fine"]).all())
    report["runner"] = runner
    return ok


MEGA_CONFIG = "mega-nerf/building.yaml"  # the paper model: fg and bg 8x256, 48-d appearance
MEGA_GRID = (2, 4)  # the README's --grid_dim 2 4: K = 8 submodules
MEGA_ITER = 1000  # the `{iter}.pt` the merge reads
MEGA_CMP_RAYS = 2048


def camera_extent(ds: Path):
    """(min, max) camera position over the dataset's views, float32."""
    import numpy as np
    import torch

    pos = np.stack([torch.load(p, weights_only=False)["c2w"][:, 3].numpy()
                    for p in sorted(ds.glob("*/metadata/*.pt"))])
    return pos.min(0).astype(np.float32), pos.max(0).astype(np.float32)


def phase_serve_mega(device, report, tmp: Path):
    """The slice's serving path for a merged Mega-NeRF mixture at the paper
    width (`configs/mega-nerf/building.yaml`: fg and bg 8x256, 48-d
    appearance, bf16): K = 8 seeded-random fg and bg submodules written as
    `{iter}.pt` runs, centroids on a 2 x 4 grid over the dataset's camera
    extent (`create_cluster_masks.make_centroids`), merged by `mega_nerf_tpu_torch.scripts.merge_submodules` into
    the native and (`--torchscript`) the viewer's container, both loading to
    bit-equal weights; then `eval.main --container_path` on the serve
    phase's 128x128 view. Checks finite PSNR/SSIM, `fused_nerf_eval`
    launches per view = K x the single model's at the same chunking, each
    submodule on its own packed weights, no plain or eager call; one
    2,048-ray chunk's fg and bg mixture outputs through the kernels and
    through the plain version: rgb <= 1e-2, sigma <= 1e-2 (1 + |sigma|).
    Prints s/view, rays/s and peak device memory."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch.models.container import load_container
    from mega_nerf_tpu_torch.models.weights import state_keys
    from mega_nerf_tpu_torch.ops.geometry import depth2pts_outside, intersect_sphere
    from mega_nerf_tpu_torch.ops.rays import generate_image_rays
    from mega_nerf_tpu_torch.render import fused_mlp, rendering
    from mega_nerf_tpu_torch.runtime.runner import Runner, _eval_chunk_cap
    from mega_nerf_tpu_torch.scripts import merge_submodules
    from mega_nerf_tpu_torch.scripts.create_cluster_masks import make_centroids

    ds = tmp / "dataset"
    if not (ds / "coordinates.pt").exists():
        write_dataset(ds, hw=128, n_train=4, seed=7)
    lo, hi = camera_extent(ds)
    centroids = make_centroids(MEGA_GRID, lo, hi)
    k = len(centroids)
    root = tmp / "mega"
    hp_sub = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, tmp / "unused")
    for i in range(k):
        fg = seeded_bundle(hp_sub, 5, False, 100 + i, "cpu")
        bg = seeded_bundle(hp_sub, 5, True, 200 + i, "cpu")
        models = root / f"submodule_{i}" / "0" / "models"
        models.mkdir(parents=True)
        torch.save({"model_state_dict": fg.module.state_dict(),
                    "bg_model_state_dict": bg.module.state_dict(),
                    "iteration": MEGA_ITER}, models / f"{MEGA_ITER}.pt")
    torch.save({"centroids": torch.from_numpy(centroids), "grid_dim": list(MEGA_GRID),
                "min_position": torch.from_numpy(lo), "max_position": torch.from_numpy(hi),
                "cluster_2d": False}, root / "params.pt")
    merged = root / "merged.pt"
    t0 = time.perf_counter()
    merge_submodules.main(merge_submodules.get_merge_opts([
        "--config_file", str(ROOT / "configs" / MEGA_CONFIG), "--exp_name", "unused",
        "--dataset_path", str(ds), "--ckpt_prefix", str(root / "submodule_"),
        "--centroid_path", str(root / "params.pt"), "--output", str(merged),
        "--train_iterations", str(MEGA_ITER), "--torchscript"]))
    merge_s = time.perf_counter() - t0
    native, script = load_container(merged), load_container(f"{merged}.ts")
    formats_equal = all(
        len(a) == len(b) == k and all(np.array_equal(np.asarray(sa[key]), np.asarray(sb[key]))
                                      for sa, sb in zip(a, b) for key in sa)
        for a, b in ((native.fg_states, script.fg_states),
                     (native.bg_states, script.bg_states)))
    formats_equal &= bool(np.array_equal(native.centroids, script.centroids))
    log(f"  merged {k} fg + {k} bg submodules (native and TorchScript) in {merge_s:.2f} s; "
        f"the two formats load to bit-equal weights: {formats_equal}")

    hp = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, tmp / "exp_mega",
                        ["--container_path", str(merged)])
    n_rays = 128 * 128
    chunks = -(-n_rays // min(hp.image_pixel_batch_size, n_rays, _eval_chunk_cap(hp)))
    predicted = k * 4 * chunks  # K x the single model's 4 passes a chunk
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fused_mlp.fused_nerf_eval.launches = 0
    fused_mlp.fused_nerf_eval_plain.calls = 0
    t0 = time.perf_counter()
    with EagerCalls() as eager_calls:
        metrics = port_eval.main(hp)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_mlp.fused_nerf_eval.launches
    plain = fused_mlp.fused_nerf_eval_plain.calls
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  eval.main --container_path ({MEGA_CONFIG}, K = {k}, margin "
        f"{hp.boundary_margin}): {metrics} in {wall:.2f} s; peak device memory allocated "
        f"{peak:.2f} GB; fused_nerf_eval launches {launches} (predicted {predicted} = "
        f"{k} x 4 passes x {chunks} chunk(s)), plain calls {plain}, eager module calls "
        f"{eager_calls.count}")
    ok = (formats_equal and all(np.isfinite(v) for v in metrics.values())
          and {"val/psnr", "val/ssim"} <= set(metrics) and launches == predicted
          and plain == 0 and eager_calls.count == 0)

    runner = Runner(hp, set_experiment_path=False)
    runner.make_eval_state()
    meta = runner.val_items[0]
    runner.render_image(meta)  # warm: packs every submodule's weights
    own_packs = all(set(b.packed) == {("sub", i) for i in range(k)}
                    for b in (runner.fg, runner.bg))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.render_image(meta)
    torch.cuda.synchronize()
    s_view = (time.perf_counter() - t0) / reps
    view_peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  mixture serving path: {meta.W}x{meta.H} view, {s_view:.4f} s/view, "
        f"{n_rays / s_view:.1f} rays/s; peak device memory allocated {view_peak:.2f} GB; "
        f"each submodule on its own packed weights: {own_packs}")
    rows, busy, wall_ms = kernel_times(lambda: runner.render_image(meta), 1)
    profile = None
    if rows:
        kern_ms = sum(ms for ms, _, name in rows if "eval_fwd_kernel" in name)
        kern_n = sum(n for _, n, name in rows if "eval_fwd_kernel" in name)
        profile = {"busy_ms": busy, "wall_ms": wall_ms, "eval_fwd_ms": kern_ms,
                   "eval_fwd_launches": kern_n, "other_ms": busy - kern_ms}
        log(f"  mixture view profile: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall "
            f"({100 * busy / wall_ms:.1f}%); eval_fwd {kern_ms:.1f} ms "
            f"({100 * kern_ms / busy:.1f}%, x{kern_n}), the rest {busy - kern_ms:.1f} ms:")
        for ms, count, name in [r for r in rows if "eval_fwd_kernel" not in r[2]][:6]:
            log(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("  profiler: no device time recorded (mixture breakdown not measured)")
    report["serving_mega"] = {
        "config": MEGA_CONFIG, "submodules": k, "grid_dim": list(MEGA_GRID),
        "boundary_margin": hp.boundary_margin, "merge_s": merge_s,
        "eval_main_s": wall, "metrics": metrics, "peak_mem_gb": peak,
        "launches_per_view": launches, "predicted_launches": predicted,
        "plain_calls": plain, "eager_calls": eager_calls.count,
        "s_per_view": s_view, "rays_per_s": n_rays / s_view, "view_peak_mem_gb": view_peak,
        "profile": profile}

    # One chunk's fg and bg mixture outputs, kernels vs the plain version.
    rays = generate_image_rays(meta, runner.near, runner.far, runner.ray_altitude_range,
                               True, device=device)[:MEGA_CMP_RAYS]
    rays_o, rays_d = rays[:, None, 0:3], rays[:, None, 3:6]
    idx = torch.full((rays.shape[0],), meta.image_index, device=device)
    center, radius = runner.sphere_center, runner.sphere_radius
    fg_far = intersect_sphere(rays[:, 0:3], rays[:, 3:6], center, radius)
    t = torch.linspace(0, 1, hp.fine_samples, device=device)
    fg_pts = rays_o + rays_d * (rays[:, 6:7] + (fg_far[:, None] - rays[:, 6:7]) * t)[..., None]
    bg_z = torch.linspace(0, 1, hp.fine_samples // 2, device=device).expand(rays.shape[0], -1)
    bg_pts, _ = depth2pts_outside(rays_o, rays_d, bg_z, center, radius, True, False)
    settings = runner.render_settings()
    errs = {}
    with torch.no_grad():
        for name, bundle, pts in (("fg", runner.fg, fg_pts), ("bg", runner.bg, bg_pts)):
            kern = rendering._model_eval(bundle, "fine", settings, pts, rays_d, idx, False, None)
            saved = rendering.fused_nerf_eval
            rendering.fused_nerf_eval = fused_mlp.fused_nerf_eval_plain
            try:
                plain_out = rendering._model_eval(bundle, "fine", settings, pts, rays_d, idx,
                                                  False, None)
            finally:
                rendering.fused_nerf_eval = saved
            finite = all(bool(torch.isfinite(x).all()) for x in kern)
            errs[name] = ((kern[0] - plain_out[0]).abs().max().item(),
                          close_ratio(kern[1], plain_out[1]), finite)
    log(f"  {MEGA_CMP_RAYS}-ray chunk, mixture through the kernels vs the plain version "
        f"({hp.fine_samples} fg / {hp.fine_samples // 2} bg points a ray): "
        + "; ".join(f"{n} rgb max|diff|={e[0]:.3e}, sigma max|diff|/(1+|s|)={e[1]:.3e}"
                    for n, e in errs.items()))
    report["serving_mega"]["mixture_vs_plain"] = {n: e[:2] for n, e in errs.items()}
    return bool(ok and own_packs and all(e[0] <= TOL and e[1] <= TOL and e[2]
                                         for e in errs.values()))


BAKE_DEPTH = 6  # --init_grid_depth: a 64^3 auto-scale probe, a 128^3 grid (8 is the default)
BAKE_OCC_RES = 128  # bake_occupancy --res
BAKE_CMP_RAYS = 2048


def eval_launches():
    """(eval kernel launches, plain calls) so far."""
    from mega_nerf_tpu_torch.render import fused_mlp

    return fused_mlp.fused_nerf_eval.launches, fused_mlp.fused_nerf_eval_plain.calls


def zero_eval_counts() -> None:
    from mega_nerf_tpu_torch.render import fused_mlp

    fused_mlp.fused_nerf_eval.launches = 0
    fused_mlp.fused_nerf_eval_plain.calls = 0


def timed_view(runner, meta):
    """(results, s, eval launches, view_stats) of one synchronised view."""
    import torch

    before = eval_launches()[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = runner.render_image(meta)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, secs, eval_launches()[0] - before, dict(runner.view_stats)


def log_culled_vs_dense(label: str, cmp) -> None:
    log(f"  culled vs dense ({label}): launches {cmp['culled_launches']} vs "
        f"{cmp['dense_launches']}; max |rgb diff| {cmp['max_rgb_diff']:.3e}, "
        f"{cmp['pixels_not_bit_equal']} pixel(s) not bit-equal; s/view culled "
        f"{cmp['culled_s']}, dense {cmp['dense_s']}; culled view {cmp['culled_view']}")


def culled_vs_dense(runner, meta):
    """The view with culling on and with --no_cell_cull, in turns (culled,
    dense, dense, culled) -> the record: launches each way, the largest rgb
    difference, the pixels whose rgb is not bit-equal, s/view each way and
    the culled view's decisions."""
    import numpy as np

    views = {}
    for cull in (True, False, False, True):
        runner.hparams.cell_cull = cull
        out, secs, launches, stats = timed_view(runner, meta)
        entry = views.setdefault(cull, {"s": [], "launches": launches, "stats": stats})
        entry["s"].append(secs)
        entry["rgb"] = out["rgb_fine"]
    runner.hparams.cell_cull = True
    culled, dense = views[True]["rgb"], views[False]["rgb"]
    return {"culled_launches": views[True]["launches"],
            "dense_launches": views[False]["launches"],
            "max_rgb_diff": float(np.abs(culled - dense).max()),
            "pixels_not_bit_equal": int((culled != dense).any(-1).sum()),
            "culled_s": views[True]["s"], "dense_s": views[False]["s"],
            "culled_view": views[True]["stats"], "finite": bool(np.isfinite(culled).all())}


def edge_view(meta):
    """A view a flythrough may hold: from near the ground at the edge of the
    lattice of cells (`serve_mega`'s centroids at altitude 0, y +-0.3, z
    -0.3 .. 0.3), looking outward along +z, so its fg samples, which end at
    the ellipsoid's exit, reach only the cells of the z = 0.3 row."""
    import numpy as np

    from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata

    pos, fwd = np.array([0.3, 0.0, 0.75]), np.array([0.0, 0.0, 1.0])
    z_axis = -fwd
    x_axis = np.cross(np.array([-1.0, 0.0, 0.0]), z_axis)
    x_axis /= np.linalg.norm(x_axis)
    c2w = np.stack([x_axis, np.cross(z_axis, x_axis), z_axis, pos], 1).astype(np.float32)
    return ImageMetadata(Path(""), c2w, meta.W, meta.H, meta.intrinsics, meta.image_index,
                         None, False)


def phase_bake(device, report, tmp: Path):
    """The bake-and-bounded-serving path on `serve_mega`'s K = 8 paper-width
    container and 128x128 dataset (`configs/mega-nerf/building.yaml`: fg
    and bg 8x256, 48-d appearance, bf16); the grid depth is the only
    reduction (`--init_grid_depth` 6 for the default 8).
    a. The val view with culling on (the default) and with `--no_cell_cull`,
       in turns (culled, dense, dense, culled): `fused_nerf_eval` launches
       each way (culled <= dense), the largest rgb difference and the count
       of pixels whose rgb is not bit-equal (must be 0: culling drops only
       zero-weight terms), s/view each way; the same for an outward
       view at the edge of the cells' lattice (`edge_view`), where the
       culled path must engage (fewer launches); again in part c with the
       occupancy grid in `--occupancy_mode both`.
    b. `scripts.create_octree` from the container (`--masking_mode weight`,
       the dataset's cameras at 128x128): seconds of each step (scale, step
       1, grid weight, step 2), leaves, file size, and `fused_nerf_eval`
       launches = K x the probe calls (`_point_chunk` points a call), with
       no plain or eager call.
    c. `scripts.render_octree` of the tree (finite PSNR on the val view);
       `scripts.bake_occupancy --res 128` (its occupied share); `eval.main
       --container_path ... --occupancy_path ...` (finite PSNR/SSIM, s/view,
       launches, whether the support-sorted culled path engaged, peak
       memory); one 2,048-ray chunk with the occupancy bounds through the
       kernel and through the plain version: the fg mixture's outputs on
       the bounded samples (rgb <= 1e-2, sigma <= 1e-2 (1 + |sigma|)) and
       the chunk's rendered rgb (<= 1e-2).
    Prints the `{"baking": ...}` record."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch.octree import N3Tree
    from mega_nerf_tpu_torch.ops.geometry import intersect_sphere
    from mega_nerf_tpu_torch.ops.rays import generate_image_rays
    from mega_nerf_tpu_torch.render import fused_mlp, rendering
    from mega_nerf_tpu_torch.runtime.runner import Runner
    from mega_nerf_tpu_torch.scripts import bake_occupancy, create_octree, render_octree

    ds, merged = tmp / "dataset", tmp / "mega" / "merged.pt"
    k = MEGA_GRID[0] * MEGA_GRID[1]
    container = ["--container_path", str(merged)]
    record = {"config": MEGA_CONFIG, "submodules": k, "init_grid_depth": BAKE_DEPTH}
    ok = True

    # a. Culled against dense on the val view.
    hp = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, tmp / "exp_bake", container)
    runner = Runner(hp, set_experiment_path=False)
    runner.make_eval_state()
    meta = runner.val_items[0]
    runner.render_image(meta)  # warm: packs every submodule's weights
    cmp = record["culled_vs_dense"] = culled_vs_dense(runner, meta)
    log_culled_vs_dense(f"{meta.W}x{meta.H} val view, K = {k}", cmp)
    ok &= (cmp["culled_launches"] <= cmp["dense_launches"] and cmp["finite"]
           and cmp["pixels_not_bit_equal"] == 0)
    dense_launches = cmp["dense_launches"]
    edge = edge_view(meta)
    cmp = record["culled_vs_dense_edge"] = culled_vs_dense(runner, edge)
    log_culled_vs_dense("an outward view at the lattice's edge", cmp)
    ok &= (cmp["culled_launches"] < cmp["dense_launches"] and cmp["culled_view"]["cull"]
           and cmp["finite"] and cmp["pixels_not_bit_equal"] == 0)

    # b. The bake.
    focal = int(round(float(meta.intrinsics[0])))
    tree_path = tmp / "bake" / "tree.npz"
    bake_hp = create_octree._get_extraction_opts(
        ["--config_file", str(ROOT / "configs" / MEGA_CONFIG), "--dataset_path", str(ds),
         "--device", device.type, "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
         *container, "--output", str(tree_path), "--init_grid_depth", str(BAKE_DEPTH),
         "--masking_mode", "weight", "--camera_params", str(meta.W), str(meta.H),
         str(focal), str(focal), str(meta.W // 2), str(meta.H // 2)])
    times, calls = {}, []
    probe = create_octree._probe

    def counting_probe(bundle, settings, points, *args, **kwargs):
        calls.append(points.shape[0])
        return probe(bundle, settings, points, *args, **kwargs)

    create_octree._probe = counting_probe
    zero_eval_counts()
    try:
        with EagerCalls() as eager_calls:
            tree = create_octree.main(bake_hp, times)
            torch.cuda.synchronize()
    finally:
        create_octree._probe = probe
    launches, plain = eval_launches()
    chunk = create_octree._point_chunk(bake_hp, runner.fg)
    leaves = int(tree.n_leaves)
    record["bake"] = {
        "times_s": times, "leaves": leaves, "nodes": int(tree.n_internal),
        "file_bytes": tree_path.stat().st_size, "probe_calls": len(calls),
        "points_per_call": chunk, "probed_points": int(sum(calls)),
        "launches": launches, "predicted_launches": k * len(calls),
        "plain_calls": plain, "eager_calls": eager_calls.count}
    saved_tree = N3Tree.load(tree_path)
    data = saved_tree.get_leaf_data(saved_tree.leaf_indices())
    log(f"  create_octree (depth {BAKE_DEPTH}): {times}; {tree!r}, {leaves} leaves, "
        f"{tree_path.stat().st_size} bytes; {len(calls)} probe calls of <= {chunk} points "
        f"({sum(calls)} points), fused_nerf_eval launches {launches} (predicted "
        f"{k * len(calls)} = {k} x calls), plain calls {plain}, eager module calls "
        f"{eager_calls.count}")
    ok &= (launches == k * len(calls) and plain == 0 and eager_calls.count == 0
           and max(calls) <= chunk and leaves > 8 and bool(np.isfinite(data).all()))

    # c. Preview, occupancy and bounded serving.
    summary = render_octree.main(render_octree.get_render_octree_opts(
        ["--tree", str(tree_path), "--dataset_path", str(ds), "--near", "0.05",
         "--device", device.type]))
    record["render_octree"] = summary
    ok &= bool(np.isfinite(summary.get("mean_psnr", np.nan)))
    occ_path = tmp / "bake" / "occupancy.npz"
    t0 = time.perf_counter()
    zero_eval_counts()
    share = bake_occupancy.main(bake_occupancy.get_bake_opts(
        ["--config_file", str(ROOT / "configs" / MEGA_CONFIG), "--dataset_path", str(ds),
         "--device", device.type, "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
         "--val_scale_factor", "1", *container, "--output", str(occ_path),
         "--res", str(BAKE_OCC_RES)]))
    torch.cuda.synchronize()
    record["bake_occupancy"] = {"res": BAKE_OCC_RES, "occupied_share": share,
                                "s": time.perf_counter() - t0,
                                "launches": eval_launches()[0]}
    log(f"  bake_occupancy --res {BAKE_OCC_RES}: {100 * share:.2f}% occupied in "
        f"{record['bake_occupancy']['s']:.2f} s ({eval_launches()[0]} launches)")

    bounded = ["--occupancy_path", str(occ_path)]
    hp_b = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, tmp / "exp_bounded",
                          container + bounded)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_eval_counts()
    t0 = time.perf_counter()
    with EagerCalls() as eager_calls:
        metrics = port_eval.main(hp_b)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = eval_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    runner_b = Runner(hp_b, set_experiment_path=False)
    runner_b.make_eval_state()
    runner_b.render_image(meta)
    s_views = [timed_view(runner_b, meta)[1] for _ in range(2)]
    stats = dict(runner_b.view_stats)
    record["bounded_view"] = {
        "metrics": metrics, "eval_main_s": wall, "launches": launches, "plain_calls": plain,
        "eager_calls": eager_calls.count, "peak_mem_gb": peak, "s_per_view": s_views,
        "view": stats}
    log(f"  eval.main --occupancy_path: {metrics} in {wall:.2f} s; launches {launches}, "
        f"plain {plain}, eager {eager_calls.count}; peak {peak:.2f} GB; s/view {s_views}; "
        f"{stats}")
    ok &= (all(np.isfinite(v) for v in metrics.values()) and {"val/psnr", "val/ssim"}
           <= set(metrics) and 0 < launches <= dense_launches and plain == 0
           and eager_calls.count == 0 and stats["bounded"])

    # Culled against dense again under `--occupancy_mode both`: empty rays
    # collapse and far ends tighten, so per-ray support sets shrink and the
    # support-sorted culled path can engage.
    hp_both = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, tmp / "exp_both",
                             container + bounded + ["--occupancy_mode", "both"])
    runner_both = Runner(hp_both, set_experiment_path=False)
    runner_both.make_eval_state()
    runner_both.render_image(meta)
    cmp = record["culled_vs_dense_both"] = culled_vs_dense(runner_both, meta)
    log_culled_vs_dense("--occupancy_mode both", cmp)
    ok &= (cmp["culled_launches"] <= cmp["dense_launches"] and cmp["finite"]
           and cmp["pixels_not_bit_equal"] == 0)

    # One bounded chunk through the kernel and through the plain version.
    rays = generate_image_rays(meta, runner_b.near, runner_b.far, runner_b.ray_altitude_range,
                               True, device=device)[:BAKE_CMP_RAYS]
    plan = runner_b._view_plan(meta, rays, BAKE_CMP_RAYS)
    bounds = torch.from_numpy(plan.tighten(rays.cpu().numpy())).to(device)
    idx = torch.full((rays.shape[0],), meta.image_index, device=device)
    settings = runner_b.render_settings()
    fg_far = torch.minimum(rays[:, 7], intersect_sphere(
        rays[:, :3], rays[:, 3:6], runner_b.sphere_center, runner_b.sphere_radius))
    lo = torch.maximum(rays[:, 6], bounds[:, 0])
    hi = torch.maximum(torch.minimum(fg_far, bounds[:, 1]), lo)
    t = torch.linspace(0, 1, hp_b.fine_samples, device=device)
    pts = rays[:, None, :3] + rays[:, None, 3:6] * (lo[:, None] + (hi - lo)[:, None] * t)[..., None]
    args = (runner_b.fg, runner_b.bg, rays, idx, settings, runner_b.sphere_center,
            runner_b.sphere_radius)
    with torch.no_grad():
        kern = rendering._model_eval(runner_b.fg, "fine", settings, pts, rays[:, None, 3:6],
                                     idx, False, None)
        kern_img, _ = rendering.render_rays(*args, fg_bounds=bounds)
        saved = rendering.fused_nerf_eval
        rendering.fused_nerf_eval = fused_mlp.fused_nerf_eval_plain
        try:
            plain_out = rendering._model_eval(runner_b.fg, "fine", settings, pts,
                                              rays[:, None, 3:6], idx, False, None)
            plain_img, _ = rendering.render_rays(*args, fg_bounds=bounds)
        finally:
            rendering.fused_nerf_eval = saved
    errs = {"rgb": (kern[0] - plain_out[0]).abs().max().item(),
            "sigma": close_ratio(kern[1], plain_out[1]),
            "rendered_rgb": (kern_img["rgb_fine"] - plain_img["rgb_fine"]).abs().max().item()}
    shrunk = float((bounds[:, 0] > rays[:, 6]).float().mean())
    record["bounded_chunk_vs_plain"] = {**errs, "rays": BAKE_CMP_RAYS, "shrunk_share": shrunk}
    log(f"  {BAKE_CMP_RAYS}-ray bounded chunk ({100 * shrunk:.1f}% of rays tightened), kernel "
        f"vs plain: fg rgb max|diff|={errs['rgb']:.3e}, sigma max|diff|/(1+|s|)="
        f"{errs['sigma']:.3e}, rendered rgb max|diff|={errs['rendered_rgb']:.3e}")
    ok &= all(v <= TOL for v in errs.values()) and all(
        bool(torch.isfinite(x).all()) for x in (*kern, kern_img["rgb_fine"]))
    report["baking"] = record
    return bool(ok)


ROUTED_TOL = 1e-4  # routed and ray-routed views against the dense view's rgb
MEGA25_GRID = (5, 5)  # --grid_dim 5 5: the reference's 25-submodule models
# (label, --mega_routing, extra flags): per point at M = 4 and at M = K
# (every nonzero weight: no truncation, the dense blend's terms), ray at its
# default gate (0.45) and with the gate open, so the ray-routed path runs
# whatever the plan costs (its cost can pass K: the plan pads).
ROUTED_MODES = (("dense", "dense", []), ("routed", "routed", []),
                ("routed_all", "routed", ["--routing_max_experts", "64"]),
                ("ray", "ray", []), ("ray_open", "ray", ["--ray_routing_gate", "1e6"]))


class PlainEval:
    """While open, the renderer's eval MLP calls go to `fused_nerf_eval`'s
    plain version (its calls count as plain, never as launches)."""

    def __enter__(self):
        from mega_nerf_tpu_torch.render import fused_mlp, rendering

        self._saved = rendering.fused_nerf_eval
        rendering.fused_nerf_eval = fused_mlp.fused_nerf_eval_plain
        return self

    def __exit__(self, *exc):
        from mega_nerf_tpu_torch.render import rendering

        rendering.fused_nerf_eval = self._saved


class Truncation:
    """While open: for each view the Runner renders, which of its rays (in
    render order) hold a point with more nonzero routing weights than the
    M that `mega_apply_routed` keeps, in any pass of the fg mixture
    (`fg`) or of either mixture (`any`)."""

    def __enter__(self):
        import torch

        from mega_nerf_tpu_torch.render import rendering
        from mega_nerf_tpu_torch.runtime import runner as runner_mod

        self.chunks = {"fg": [], "any": []}
        self._saved = (runner_mod.render_rays, rendering.query_points,
                       rendering.mega_apply_routed)
        render_rays, query_points, routed = self._saved
        side = {}

        def recording_render(fg, bg, rays, *args, **kwargs):
            for chunks in self.chunks.values():
                chunks.append(torch.zeros(rays.shape[0], dtype=torch.bool))
            return render_rays(fg, bg, rays, *args, **kwargs)

        def recording_query(bundle, *args, **kwargs):
            side["bg"] = bundle.xyz_real
            return query_points(bundle, *args, **kwargs)

        def recording_routed(apply_rows, weights, max_experts, out_dim, log=None):
            n = self.chunks["any"][-1].shape[0]
            over = ((weights > 0).sum(-1) > max_experts).reshape(n, -1).any(1).cpu()
            for key in ("any",) if side["bg"] else ("any", "fg"):
                self.chunks[key][-1] |= over
            return routed(apply_rows, weights, max_experts, out_dim, log=log)

        runner_mod.render_rays = recording_render
        rendering.query_points = recording_query
        rendering.mega_apply_routed = recording_routed
        return self

    def __exit__(self, *exc):
        from mega_nerf_tpu_torch.render import rendering
        from mega_nerf_tpu_torch.runtime import runner as runner_mod

        (runner_mod.render_rays, rendering.query_points,
         rendering.mega_apply_routed) = self._saved

    def rays(self, key: str):
        import torch

        return torch.cat(self.chunks[key]).numpy()


def write_mixture(root: Path, ds: Path, grid, seed: int) -> Path:
    """K = gy x gz seeded-random paper-width fg and bg submodules as
    `{iter}.pt` runs, centroids on the grid over the dataset's cameras,
    merged by `scripts.merge_submodules` into a native container."""
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch.scripts import merge_submodules
    from mega_nerf_tpu_torch.scripts.create_cluster_masks import make_centroids

    lo, hi = camera_extent(ds)
    centroids = make_centroids(grid, lo, hi)
    hp_sub = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, root / "unused")
    for i in range(len(centroids)):
        fg = seeded_bundle(hp_sub, 5, False, seed + i, "cpu")
        bg = seeded_bundle(hp_sub, 5, True, seed + 1000 + i, "cpu")
        models = root / f"submodule_{i}" / "0" / "models"
        models.mkdir(parents=True)
        torch.save({"model_state_dict": fg.module.state_dict(),
                    "bg_model_state_dict": bg.module.state_dict(),
                    "iteration": MEGA_ITER}, models / f"{MEGA_ITER}.pt")
    torch.save({"centroids": torch.from_numpy(centroids), "grid_dim": list(grid),
                "min_position": torch.from_numpy(lo), "max_position": torch.from_numpy(hi),
                "cluster_2d": False}, root / "params.pt")
    merged = root / "merged.pt"
    merge_submodules.main(merge_submodules.get_merge_opts([
        "--config_file", str(ROOT / "configs" / MEGA_CONFIG), "--exp_name", "unused",
        "--dataset_path", str(ds), "--ckpt_prefix", str(root / "submodule_"),
        "--centroid_path", str(root / "params.pt"), "--output", str(merged),
        "--train_iterations", str(MEGA_ITER)]))
    return merged


def routed_views(ds: Path, container: Path, tmp: Path, k: int, label: str):
    """Every view (the val view, `edge_view`) under every mode of
    `ROUTED_MODES` -> ({view: {mode: record}}, ok). Each record: eval
    launches a view, s/view (2 timed after a warm one), the view's
    decisions, peak memory; against dense: the largest rgb difference, the
    pixels not bit-equal, and for per-point routing the pixels with a
    truncated point and the largest difference off them."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch.runtime.runner import Runner

    out, rgbs, fg_rgbs, ok = {}, {}, {}, True
    for mode, routing, extra in ROUTED_MODES:
        hp = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, tmp / "unused",
                            ["--container_path", str(container), "--mega_routing", routing,
                             *extra])
        runner = Runner(hp, set_experiment_path=False)
        runner.make_eval_state()
        meta = runner.val_items[0]
        for view, m in (("val", meta), ("edge", edge_view(meta))):
            with Truncation() as trunc:
                runner.render_image(m)  # warm: packs every submodule's weights
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = wide_counters()
            with EagerCalls() as eager_calls:
                timed = [timed_view(runner, m) for _ in range(2)]
            counts = {n: c - before[n] for n, c in wide_counters().items()}
            rgb, _, launches, stats = timed[-1]
            rec = {"launches": launches, "s": [t[1] for t in timed],
                   "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                   "ray_routed": stats["ray_routed"], "ray_eff": stats["ray_eff"],
                   "routed": stats["routed"], "cull": stats["cull"],
                   "active_per_chunk": stats["active_per_chunk"]}
            only_eval = (counts["plain"] == 0 and eager_calls.count == 0
                         and all(counts[w] == 0 for w in WIDE_KERNELS)
                         and timed[0][2] == launches > 0)
            ok &= only_eval and bool(np.isfinite(rgb["rgb_fine"]).all())
            if mode == "dense":
                rgbs[view], fg_rgbs[view] = rgb["rgb_fine"], rgb["fg_rgb_fine"]
            else:
                diff = np.abs(rgb["rgb_fine"] - rgbs[view]).max(-1)
                rec.update(max_rgb_diff=float(diff.max()),
                           pixels_not_bit_equal=int((diff > 0).sum()))
                if routing == "routed":
                    truncated, fg_truncated = trunc.rays("any"), trunc.rays("fg")
                    fg_diff = np.abs(rgb["fg_rgb_fine"] - fg_rgbs[view]).max(-1)
                    rec.update(pixels_truncated=int(truncated.sum()),
                               max_rgb_diff_untruncated=float(diff[~truncated].max(
                                   initial=0.0)),
                               pixels_fg_truncated=int(fg_truncated.sum()),
                               max_fg_rgb_diff_fg_untruncated=float(
                                   fg_diff[~fg_truncated].max(initial=0.0)))
                    ok &= (rec["max_rgb_diff_untruncated"] <= ROUTED_TOL
                           and rec["max_fg_rgb_diff_fg_untruncated"] <= ROUTED_TOL)
                    if mode == "routed":
                        # The truncating route through the plain version, on
                        # every pixel (at M = K the plain version's f32
                        # activations of whole chunks do not fit beside it).
                        with PlainEval():
                            plain = runner.render_image(m)["rgb_fine"]
                        rec["max_rgb_diff_plain"] = float(
                            np.abs(rgb["rgb_fine"] - plain).max())
                        ok &= rec["max_rgb_diff_plain"] <= TOL
                else:
                    ok &= rec["max_rgb_diff"] <= ROUTED_TOL
            out.setdefault(view, {})[mode] = rec
            dense_s = out[view]["dense"]["s"]
            log(f"  {label} {view} view, {mode}: {launches} fused_nerf_eval launches, "
                f"s/view {rec['s']} (dense {dense_s}); ray path {rec['ray_routed']} "
                f"(eff {rec['ray_eff']} of K = {k}), routed {rec['routed']}, culled "
                f"{rec['cull']}; peak {rec['peak_mem_gb']:.2f} GB; only the eval kernel "
                f"{only_eval}"
                + ("" if mode == "dense" else
                   f"; vs dense max|rgb diff| {rec['max_rgb_diff']:.3e}, "
                   f"{rec['pixels_not_bit_equal']} pixel(s) not bit-equal")
                + ("" if routing != "routed" else
                   f", {rec['pixels_truncated']} pixel(s) with a truncated point, "
                   f"max|diff| off them {rec['max_rgb_diff_untruncated']:.3e}; "
                   f"{rec['pixels_fg_truncated']} with a truncated fg point, fg rgb "
                   f"max|diff| off them {rec['max_fg_rgb_diff_fg_untruncated']:.3e}")
                + ("" if mode != "routed" else
                   f"; vs the same route through the plain version max|rgb diff| "
                   f"{rec['max_rgb_diff_plain']:.3e} (limit {TOL})"))
        del runner
        torch.cuda.empty_cache()
    return out, ok


def phase_serve_routed(device, report, tmp: Path):
    """Routed serving of merged mixtures at the paper width
    (`configs/mega-nerf/building.yaml`: fg and bg 8x256, 48-d appearance,
    bf16), each view under `--mega_routing dense`, `routed` (per point: the
    top M = 4 weights at margin 1.15, and M = K: every nonzero weight, the
    dense blend's terms), `ray` (per ray, behind the JAX
    Runner's cost gate, 0.45) and `ray` with the gate open:
    a. `serve_mega`'s K = 8 container (`--grid_dim 2 4`) on the val view
       and on `bake`'s outward `edge_view`;
    b. a K = 25 mixture merged from 25 seeded-random submodules
       (`--grid_dim 5 5`) on the same two views.
    For each view and mode: `fused_nerf_eval` launches a view and no other
    kernel, plain or eager call; s/view against dense; the ray path's
    decision and plan cost; peak memory; against dense the largest rgb
    difference and the pixels not bit-equal: at most 1e-4 on every pixel
    for ray routing (supports are supersets) and, for per-point routing,
    on every pixel none of whose points holds more than M nonzero weights
    (printed with the count of those that do; far bg points hold all K at
    margin 1.15), and likewise the fg rgb where no fg point does; each
    per-point routed view against the same route through the plain
    version at M = 4, rgb 1e-2 on every pixel. Every kernel's counter is set to 0
    before the phase and read after it (`launches_serve_routed`: every
    view of every mode, warm views included). Prints the
    `{"serving_routed": ...}` record."""
    ds, merged = tmp / "dataset", tmp / "mega" / "merged.pt"
    k8 = MEGA_GRID[0] * MEGA_GRID[1]
    k25 = MEGA25_GRID[0] * MEGA25_GRID[1]
    record = {"config": MEGA_CONFIG}
    zero_all_counters()
    views8, ok8 = routed_views(ds, merged, tmp, k8, f"K = {k8}")
    t0 = time.perf_counter()
    merged25 = write_mixture(tmp / "mega25", ds, MEGA25_GRID, 500)
    record["merge25_s"] = time.perf_counter() - t0
    views25, ok25 = routed_views(ds, merged25, tmp, k25, f"K = {k25}")
    launches = kernel_launches()
    for name, count in launches.items():
        report["kernels"][name]["launches_serve_routed"] = count
    log(f"  launches in the phase: {launches}")
    record.update({f"k{k8}": views8, f"k{k25}": views25, "launches": launches})
    report["serving_routed"] = record
    return bool(ok8 and ok25)


def close_ratio(got, want) -> float:
    """max |got - want| / (1 + |want|) over all elements, in f32."""
    got, want = got.float(), want.float()
    return ((got - want).abs() / (1 + want.abs())).max().item()


def bf16_agreement(got, want):
    """-> (share of the bf16 elements that are bit-equal, the largest
    difference in bf16 ulps); +0 and -0 count as one value."""
    import torch

    def order(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)

    g, w = order(got), order(want)
    return (g == w).float().mean().item(), int((g - w).abs().max().item())


ENCODE_EQUAL_SHARE = 0.999  # the encode kernel's bf16 elements bit-equal to plain


def compare_wide_case(name, hp, bg, m, m_full, seed, device):
    """The wide kernels against their plain versions on one model's own
    operands -> ({kernel: max_abs_err}, ok). Each layer of the chain (the
    skip layer, trunk_final and dir_a where the model has the branch) is fed
    the plain chain's input, so errors do not compound; the heads kernel
    reads the plain chain's last trunk output and branch. With `m_full`, the
    whole wide eval on m_full points against its plain version too."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_wide as fw

    bundle = seeded_bundle(hp, 16, bg, seed, device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = mlp_inputs(cfg, m, seed + 1, device)
    app = (bundle.module.appearance(idx).contiguous()
           if cfg.appearance_dim else None)
    errs = {k: 0.0 for k in WIDE_KERNELS}
    worst = {k: 0.0 for k in WIDE_KERNELS}  # against each tolerance

    def hold(kernel, got, want):
        errs[kernel] = max(errs[kernel], (got.float() - want.float()).abs().max().item())
        worst[kernel] = max(worst[kernel], close_ratio(got, want))

    n_layers = cfg.layers + (2 if packed.has_branch else 0)
    with torch.no_grad():
        enc, dir_enc = fw.eval_wide_encode(packed, xyz, dirs)
        p_enc, p_dir = fw.eval_wide_encode_plain(packed, xyz, dirs)
        hold("eval_wide_encode", enc, p_enc)
        agree = [bf16_agreement(enc, p_enc)]
        if p_dir is not None:
            hold("eval_wide_encode", dir_enc, p_dir)
            agree.append(bf16_agreement(dir_enc, p_dir))
        enc_equal, enc_ulps = min(a for a, _ in agree), max(u for _, u in agree)
        h = p_enc
        for i in range(cfg.layers):
            xs = [p_enc, h] if i in cfg.skip_layers else [h]
            got = fw.eval_wide_layer(xs, packed.mats[i], packed.biases[i], True)
            h = fw.eval_wide_layer_plain(xs, packed.mats[i], packed.biases[i], True)
            hold("eval_wide_layer", got, h)
        branch = None
        if packed.has_branch:
            w, b = packed.mats[cfg.layers], packed.biases[cfg.layers]
            got = fw.eval_wide_layer([h], w, b, False)
            final = fw.eval_wide_layer_plain([h], w, b, False)
            hold("eval_wide_layer", got, final)
            xs = [final] + ([p_dir] if packed.dp else []) + ([app] if packed.ap else [])
            w, b = packed.mats[cfg.layers + 1], packed.biases[cfg.layers + 1]
            got = fw.eval_wide_layer(xs, w, b, True)
            branch = fw.eval_wide_layer_plain(xs, w, b, True)
            hold("eval_wide_layer", got, branch)
        got = fw.eval_wide_heads(packed, h, branch)
        want = fw.eval_wide_heads_plain(packed, h, branch)
        torch.cuda.synchronize()
        err = (got - want).abs()
        errs["eval_wide_heads"] = err.max().item()
        rgb_err = err[:, :3].max().item()
        sig_ratio = (err[:, 3] / (1 + want[:, 3].abs())).max().item()
        finite = bool(torch.isfinite(got).all())
    ok = (finite and worst["eval_wide_encode"] <= TOL and worst["eval_wide_layer"] <= TOL
          and rgb_err <= TOL and sig_ratio <= TOL and enc_equal >= ENCODE_EQUAL_SHARE
          and enc_ulps <= 1)
    log(f"  wide {name}: M={m}, {n_layers} layers; encode max|err|/(1+|x|)="
        f"{worst['eval_wide_encode']:.3e}, bf16 bit-equal {100 * enc_equal:.4f}% (limit "
        f"{100 * ENCODE_EQUAL_SHARE:.1f}%), largest difference {enc_ulps} bf16 ulp (limit 1); "
        f"layers worst max|err|/(1+|y|)="
        f"{worst['eval_wide_layer']:.3e}, heads rgb max|err|={rgb_err:.3e} sigma "
        f"max|err|/(1+|s|)={sig_ratio:.3e}; finite={finite} -> {'ok' if ok else 'FAIL'}")
    if m_full:
        xyz, dirs, idx = mlp_inputs(cfg, m_full, seed + 2, device)
        app = (bundle.module.appearance(idx).contiguous()
               if cfg.appearance_dim else None)
        with torch.no_grad():
            got = fw.fused_nerf_eval_wide(packed, xyz, dirs, app)
            torch.cuda.synchronize()
            want = fw.fused_nerf_eval_wide_plain(packed, xyz, dirs, app)
        err = (got - want).abs()
        rgb_err = err[:, :3].max().item()
        sig_ratio = (err[:, 3] / (1 + want[:, 3].abs())).max().item()
        finite = bool(torch.isfinite(got).all())
        full_ok = finite and rgb_err <= TOL and sig_ratio <= TOL
        log(f"  wide {name}, whole eval: M={m_full} ({-(-m_full // fw.wide_plan(cfg).sub_chunk)}"
            f" sub-chunks) rgb max|err|={rgb_err:.3e} sigma max|err|/(1+|s|)="
            f"{sig_ratio:.3e} sigma range [{want[:, 3].min().item():.3g}, "
            f"{want[:, 3].max().item():.3g}] finite={finite} -> "
            f"{'ok' if full_ok else 'FAIL'}")
        ok = ok and full_ok
        del got, want, err
    torch.cuda.empty_cache()
    return errs, ok


def phase_compare_wide(device, report):
    """The wide route (layer_dim 513-2048): its three kernels against their
    plain versions at widths 640, 1024 and 2048, the skip layer and dir_a
    with and without dirs and appearance, M not a multiple of the 128-point
    tile; the whole wide eval at the dense fg and bg shapes."""
    cases = [  # (name, hparams, bg, points per layer compare, whole-eval points)
        ("fg 2048-wide (dense), dirs, appearance", paper_hparams(DENSE), False,
         100_003, 1_000_003),
        ("bg 2048-wide (dense), dirs, appearance", paper_hparams(DENSE), True,
         100_003, 1_000_003),
        ("fg 640-wide, dirs, no appearance",
         paper_hparams(["--layer_dim", "640", "--appearance_dim", "0"]), False,
         20_011, 20_011),
        ("bg 1024-wide, appearance, no dirs",
         paper_hparams(["--bg_layer_dim", "1024", "--pos_dir_dim", "0"]), True,
         20_011, 20_011),
        ("fg 1024-wide, no dirs, no appearance (no branch)",
         paper_hparams(["--layer_dim", "1024", "--appearance_dim", "0",
                        "--pos_dir_dim", "0", "--layers", "6", "--skip_layers", "3"]),
         False, 4_097, 4_097),
    ]
    kernels = report["kernels"]
    all_ok = True
    for i, (name, hp, bg, m, m_full) in enumerate(cases):
        errs, ok = compare_wide_case(name, hp, bg, m, m_full, 300 + i, device)
        for k, v in errs.items():
            kernels[k]["max_abs_err"] = max(kernels[k].get("max_abs_err", 0.0), v)
        all_ok &= ok
    return all_ok


def wide_counters():
    """Launches of the eval kernels (wide and narrow) and calls of every
    plain eval version."""
    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_wide as fw

    out = {k: getattr(fw, k).launches for k in WIDE_KERNELS}
    out["fused_nerf_eval"] = fused_mlp.fused_nerf_eval.launches
    out["plain"] = (fused_mlp.fused_nerf_eval_plain.calls
                    + fw.fused_nerf_eval_wide_plain.calls
                    + fw.eval_wide_encode_plain.calls + fw.eval_wide_layer_plain.calls
                    + fw.eval_wide_heads_plain.calls)
    return out


def zero_wide_counters() -> None:
    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_wide as fw

    for k in WIDE_KERNELS:
        getattr(fw, k).launches = 0
    fused_mlp.fused_nerf_eval.launches = 0
    for fn in (fused_mlp.fused_nerf_eval_plain, fw.fused_nerf_eval_wide_plain,
               fw.eval_wide_encode_plain, fw.eval_wide_layer_plain,
               fw.eval_wide_heads_plain):
        fn.calls = 0


class EagerCalls:
    """Counts forward calls of the eager `NeRF` module while open."""

    def __enter__(self):
        import torch

        from mega_nerf_tpu_torch.models.nerf import NeRF

        self.count = 0

        def hook(module, args, output):
            if isinstance(module, NeRF):
                self.count += 1

        self._handle = torch.nn.modules.module.register_module_forward_hook(hook)
        return self

    def __exit__(self, *exc):
        self._handle.remove()


DENSE_CMP_RAYS = 1024


def phase_serve_dense(device, report, tmp: Path):
    """The serving path at the `mega-nerf-dense` width: `eval.main` on cuda
    with a 2048/2048 fg+bg checkpoint of seeded random weights on the
    generated 128x128 val view. Checks finite PSNR/SSIM, launches of every
    wide kernel, no launch of the narrow eval kernel, no call of the eager
    module or of any plain version; then renders 1,024 rays again through
    the wide plain version (rgb <= 1e-2 absolute)."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch.ops.rays import generate_image_rays
    from mega_nerf_tpu_torch.render import fused_wide as fw
    from mega_nerf_tpu_torch.render import rendering
    from mega_nerf_tpu_torch.runtime.runner import Runner

    ds = tmp / "dataset"
    if not (ds / "coordinates.pt").exists():
        write_dataset(ds, hw=128, n_train=4, seed=7)
    extra = ["--dataset_path", str(ds), "--exp_name", str(tmp / "exp_dense"),
             "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
             "--val_scale_factor", "1", "--device", "cuda", *DENSE]
    hp = paper_hparams(extra)
    fg = seeded_bundle(hp, 5, False, 31, "cpu")
    bg = seeded_bundle(hp, 5, True, 32, "cpu")
    ckpt = tmp / "dense.pt"
    torch.save({"model_state_dict": fg.module.state_dict(),
                "bg_model_state_dict": bg.module.state_dict(),
                "iteration": 0}, ckpt)
    hp.ckpt_path = str(ckpt)
    report["dense_hparams"] = hp
    del fg, bg

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_wide_counters()
    t0 = time.perf_counter()
    with EagerCalls() as eager_calls:
        metrics = port_eval.main(hp)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = wide_counters()
    log(f"  eval.main at 2048/2048: {metrics} in {wall:.2f} s; peak device "
        f"memory allocated {peak:.2f} GB; launches {counts}; eager module "
        f"calls {eager_calls.count}")
    finite = (all(np.isfinite(v) for v in metrics.values())
              and {"val/psnr", "val/ssim"} <= set(metrics))
    report["serving_dense"] = {"eval_main_s": wall, "peak_mem_gb": peak,
                               "metrics": metrics,
                               "launches": {k: counts[k] for k in WIDE_KERNELS},
                               "eager_calls": eager_calls.count}
    for k in WIDE_KERNELS:
        report["kernels"][k]["launches"] = counts[k]
    ok = (finite and all(counts[k] > 0 for k in WIDE_KERNELS)
          and counts["fused_nerf_eval"] == 0 and counts["plain"] == 0
          and eager_calls.count == 0)

    # Some rays again, wide kernels vs the wide plain version, same weights.
    hp.exp_name = str(tmp / "exp_dense_cmp")
    runner = Runner(hp, set_experiment_path=False)
    runner.make_eval_state()
    meta = runner.val_items[0]
    rays = generate_image_rays(meta, runner.near, runner.far,
                               runner.ray_altitude_range, True,
                               device=device)[:DENSE_CMP_RAYS]
    idx = torch.full((rays.shape[0],), meta.image_index, device=device)
    settings = runner.render_settings()
    args = (runner.fg, runner.bg, rays, idx, settings,
            runner.sphere_center, runner.sphere_radius)
    with torch.no_grad():
        kern, _ = rendering.render_rays(*args)
        saved = rendering.fused_nerf_eval_wide
        rendering.fused_nerf_eval_wide = fw.fused_nerf_eval_wide_plain
        try:
            plain, _ = rendering.render_rays(*args)
        finally:
            rendering.fused_nerf_eval_wide = saved
    diff = (kern["rgb_fine"] - plain["rgb_fine"]).abs().max().item()
    dd = ((kern["depth_fine"] - plain["depth_fine"]).abs()
          / (1 + plain["depth_fine"].abs())).max().item()
    log(f"  {DENSE_CMP_RAYS} rays at 2048/2048, wide kernels vs the wide plain "
        f"version: rgb_fine max|diff|={diff:.3e}, depth_fine max|diff|/(1+|d|)="
        f"{dd:.3e}")
    report["serving_dense"]["render_rgb_diff"] = diff
    ok = ok and diff <= TOL and bool(torch.isfinite(kern["rgb_fine"]).all())
    report["dense_runner"] = runner
    return bool(ok)


TRAIN_STEPS = 120


def train_counters():
    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    return {
        "fused_nerf_train_fwd": ft.fused_nerf_train_fwd.launches,
        "train_bwd_data": ft.train_bwd_data.launches,
        "weight_grad": ft.weight_grad.launches,
        "plain": (ft.fused_nerf_train_fwd_plain.calls
                  + ft.train_bwd_data_plain.calls + ft.weight_grad_plain.calls
                  + fused_mlp.fused_nerf_eval_plain.calls),
    }


def zero_train_counters() -> None:
    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    for fn in (ft.fused_nerf_train_fwd, ft.train_bwd_data, ft.weight_grad):
        fn.launches = 0
    for fn in (ft.fused_nerf_train_fwd_plain, ft.train_bwd_data_plain,
               ft.weight_grad_plain, fused_mlp.fused_nerf_eval_plain):
        fn.calls = 0


def train_hparams(ds: Path, exp: Path, extra=()):
    from mega_nerf_tpu_torch.train import get_train_opts

    return get_train_opts([
        "--dataset_path", str(ds), "--exp_name", str(exp),
        "--dataset_type", "memory", "--device", "cuda",
        "--pos_xyz_dim", "12", "--pos_dir_dim", "4", "--layers", "8",
        "--skip_layers", "4", "--layer_dim", "256", "--bg_layer_dim", "256",
        "--appearance_dim", "48", "--compute_dtype", "bfloat16",
        "--coarse_samples", "256", "--fine_samples", "512",
        "--batch_size", "1024", "--lr", "5e-4", "--lr_decay_factor", "0.1",
        "--train_iterations", str(TRAIN_STEPS), "--ckpt_interval", "100000",
        "--val_interval", "100000", "--ray_altitude_range", "-1.3", "0.6",
        "--near", "0.05", "--val_scale_factor", "1", *extra,
    ])


def phase_train(device, report, tmp: Path):
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner

    ds = tmp / "train_dataset"
    write_dataset(ds, hw=128, n_train=4, seed=11, smooth=True)
    hp = train_hparams(ds, tmp / "train_exp")

    losses = []
    step_call = TrainStep.__call__

    def recording_call(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        losses.append(metrics["loss"])
        return metrics

    TrainStep.__call__ = recording_call
    zero_train_counters()
    t0 = time.perf_counter()
    try:
        val = port_train.main(hp)
        torch.cuda.synchronize()
    finally:
        TrainStep.__call__ = step_call
    wall = time.perf_counter() - t0
    counts = train_counters()
    loss = torch.stack(losses).float().cpu().numpy()
    first, last = float(loss[:10].mean()), float(loss[-10:].mean())
    log(f"  train.main: {TRAIN_STEPS} steps + final validation in {wall:.2f} s; "
        f"loss first 10 {first:.5f} -> last 10 {last:.5f}; val {val}; "
        f"launches {counts}")
    for name in ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"):
        report["kernels"][name]["launches"] = counts[name]
    ok = (len(loss) == TRAIN_STEPS and np.isfinite(loss).all() and last < first
          and all(counts[k] == 4 * TRAIN_STEPS for k in
                  ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"))
          and counts["plain"] == 0
          and all(np.isfinite(v) for v in val.values()))
    ckpt = tmp / "train_exp" / "0" / "models" / f"{TRAIN_STEPS}.pt"
    e_hp = paper_hparams(["--dataset_path", str(ds), "--exp_name",
                          str(tmp / "train_eval"), "--ckpt_path", str(ckpt),
                          "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
                          "--val_scale_factor", "1", "--device", "cuda"])
    e_metrics = port_eval.main(e_hp)
    log(f"  eval.main on {ckpt.name}: {e_metrics}")
    ok = ok and ckpt.exists() and np.isfinite(e_metrics["val/psnr"])

    # One step from the trained weights and one batch, kernels vs plain.
    runner = Runner(train_hparams(ds, tmp / "unused"), set_experiment_path=False)
    runner._load_weights(ckpt)
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(runner.hparams),
                     5e-4, 0.1, TRAIN_STEPS, runner.sphere_center,
                     runner.sphere_radius)
    dataset = runner._make_dataset()
    batches = []
    for host in dataset.batches(1024, np.random.default_rng(3)):
        batches.append({
            "rgbs": torch.from_numpy(host["rgbs"]).to(device),
            "rays": torch.from_numpy(host["rays"]).to(device),
            "img_indices": torch.from_numpy(host["img_indices"]).long().to(device),
        })
        if len(batches) == 30:
            break

    def loss_and_grads():
        for o in (step.fg_opt, step.bg_opt):
            o.zero_grad(set_to_none=True)
        gen = torch.Generator(device=device).manual_seed(5)
        loss_t, _, _ = step.loss(batches[0], gen)
        loss_t.backward()
        grads = {f"{side}.{n}": q.grad.detach().clone()
                 for side, b in (("fg", runner.fg), ("bg", runner.bg))
                 for n, q in b.module.named_parameters() if q.grad is not None}
        return loss_t.item(), grads

    k_loss, k_grads = loss_and_grads()
    saved = (ft.fused_nerf_train_fwd, ft.train_bwd_data, ft.weight_grad)
    ft.fused_nerf_train_fwd = ft.fused_nerf_train_fwd_plain
    ft.train_bwd_data = ft.train_bwd_data_plain
    ft.weight_grad = ft.weight_grad_plain
    try:
        p_loss, p_grads = loss_and_grads()
    finally:
        ft.fused_nerf_train_fwd, ft.train_bwd_data, ft.weight_grad = saved
    worst_name, worst = max(((n, rel_err(k_grads[n], p_grads[n])) for n in p_grads),
                            key=lambda t: t[1])
    log(f"  one step, kernels vs plain: loss {k_loss:.6f} vs {p_loss:.6f} "
        f"(diff {abs(k_loss - p_loss):.3e}); worst relative grad diff "
        f"{worst:.3e} ({worst_name})")
    report["training"] = {"steps": TRAIN_STEPS, "loss_first10": first,
                          "loss_last10": last, "val_psnr": val.get("val/psnr"),
                          "step_loss_diff": abs(k_loss - p_loss),
                          "step_worst_rel_grad_diff": worst}
    report["train_step"] = step
    report["train_batches"] = batches
    return bool(ok)


TRAIN_FS_STEPS = 40
TRAIN_FS_RESUME = 20  # the checkpoint run B resumes from: mid-epoch
LOADER_HW, LOADER_VIEWS = 512, 16  # the loader record's one-chunk store
FED_STEPS, FED_WARM = 20, 5


def fed_step_ms(step, dataset, device, seed: int) -> float:
    """ms per step over FED_STEPS chained steps fed as the runner feeds them
    (host batch from `dataset.batches`, `batch_to_device`, the step), after
    FED_WARM steps that also take the chunk load of a filesystem dataset."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch.runtime.runner import batch_to_device

    gen = torch.Generator(device=device).manual_seed(seed)
    batches = dataset.batches(1024, np.random.default_rng(seed))
    for _ in range(FED_WARM):
        step(batch_to_device(next(batches), device), gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(FED_STEPS):
        step(batch_to_device(next(batches), device), gen)
    torch.cuda.synchronize()
    batches.close()
    return (time.perf_counter() - t0) / FED_STEPS * 1e3


def phase_train_fs(device, report, tmp: Path):
    """Training from the parquet chunk store, cut and resumed: a generated
    128x128 dataset (4 train views + the val view's left half) written as a
    4-chunk store, then run A, `train.main` on cuda at the paper config with
    `--dataset_type filesystem`, TRAIN_FS_STEPS steps, a checkpoint and a
    validation every 20 steps and `--profile_steps 5`; run B resumes from
    A's step-20 checkpoint (mid-epoch) in a fresh experiment and trains to
    the same end. Checks finite metrics, 4 launches a step of each narrow
    training kernel in both runs and no plain or eager-module call, the same
    batches bit for bit in A's steps 21-40 and B's, A's and B's final
    weights within 1e-3 relative (the worst tensor printed), A's
    `metrics.jsonl` holding `train/rays_per_sec`, A's profiler trace, and a
    finite PSNR from `eval.main` on A's last checkpoint. A record, not a
    check: a one-chunk store of 16 views at 512x512, its write, the ms to
    read and regenerate the chunk and the loader's rays/s, the ms
    `load_chunk` waited on the prefetch in run A, and ms per step fed from
    that store beside fed from memory (turns: memory, store, store,
    memory)."""
    import json

    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    import pyarrow.parquet as pq

    from mega_nerf_tpu_torch.data.filesystem_dataset import FilesystemDataset
    from mega_nerf_tpu_torch.models.nerf import init_weights
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner

    ds = tmp / "train_fs_dataset"
    write_dataset(ds, hw=128, n_train=4, seed=11, smooth=True)
    chunks = tmp / "train_fs_chunks"
    fs_args = ["--dataset_type", "filesystem", "--chunk_paths", str(chunks),
               "--num_chunks", "4", "--train_iterations", str(TRAIN_FS_STEPS),
               "--ckpt_interval", str(TRAIN_FS_RESUME),
               "--val_interval", str(TRAIN_FS_RESUME), "--profile_steps", "5"]

    t0 = time.perf_counter()
    store = Runner(train_hparams(ds, tmp / "unused", fs_args),
                   set_experiment_path=False)._make_dataset()
    store_write_s = time.perf_counter() - t0
    store.close()
    rows = sorted(store._chunk_rows.values())
    log(f"  store: {len(rows)} chunks of {rows} rays written in {store_write_s:.2f} s")

    def run(name, extra=()):
        record, waits = [], []
        step_call, load_chunk = TrainStep.__call__, FilesystemDataset.load_chunk

        def recording(self, batch, generator=None):  # a copy on the card, no sync
            record.append({k: v.clone() for k, v in batch.items()})
            return step_call(self, batch, generator)

        def timed_load(self):
            t = time.perf_counter()
            self._future.result()
            waits.append((time.perf_counter() - t) * 1e3)
            return load_chunk(self)

        TrainStep.__call__ = recording
        FilesystemDataset.load_chunk = timed_load
        zero_train_counters()
        try:
            with EagerCalls() as eager:
                val = port_train.main(train_hparams(ds, tmp / name, [*fs_args, *extra]))
            torch.cuda.synchronize()
        finally:
            TrainStep.__call__ = step_call
            FilesystemDataset.load_chunk = load_chunk
        counts = train_counters()
        log(f"  run {name}: {len(record)} steps, val {val}, launches {counts}, "
            f"eager calls {eager.count}, load_chunk waits (ms) "
            f"{[round(w, 3) for w in waits]}")
        return record, waits, val, counts, eager.count, tmp / name / "0"

    a_batches, a_waits, a_val, a_counts, a_eager, a_exp = run("train_fs_a")
    resume_ckpt = a_exp / "models" / f"{TRAIN_FS_RESUME}.pt"
    ds_state = torch.load(resume_ckpt, weights_only=False)["dataset_state"]
    b_batches, _, b_val, b_counts, b_eager, b_exp = run(
        "train_fs_b", ["--ckpt_path", str(resume_ckpt)])

    def launched(counts, steps):
        return (all(counts[k] == 4 * steps for k in
                    ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"))
                and counts["plain"] == 0)

    same = (len(b_batches) == TRAIN_FS_STEPS - TRAIN_FS_RESUME
            and all(torch.equal(a[k], b[k]) for a, b in
                    zip(a_batches[TRAIN_FS_RESUME:], b_batches) for k in a))
    final_a = torch.load(a_exp / "models" / f"{TRAIN_FS_STEPS}.pt", weights_only=False)
    final_b = torch.load(b_exp / "models" / f"{TRAIN_FS_STEPS}.pt", weights_only=False)
    diffs = {f"{key}.{n}": rel_err(final_b[key][n], t) for key in
             ("model_state_dict", "bg_model_state_dict")
             for n, t in final_a[key].items()}
    worst_name, worst = max(diffs.items(), key=lambda t: t[1])
    equal_share = sum(d == 0 for d in diffs.values()) / len(diffs)
    log(f"  runs A and B: steps {TRAIN_FS_RESUME + 1}-{TRAIN_FS_STEPS} took the same "
        f"batches: {same} (resumed at {ds_state}); final weights worst relative "
        f"diff {worst:.3e} ({worst_name}), {100 * equal_share:.1f}% of tensors "
        f"bit-equal")

    lines = [json.loads(x) for x in (a_exp / "tb" / "metrics.jsonl").read_text().splitlines()]
    rates = [x["train/rays_per_sec"] for x in lines if "train/rays_per_sec" in x]
    losses = [x["train/loss"] for x in lines if "train/loss" in x]
    traces = sorted((a_exp / "profile").glob("*.json.gz"))
    log(f"  metrics.jsonl: train/rays_per_sec {rates}, train/loss {losses}; "
        f"profiler trace {[p.name for p in traces]}")
    e_metrics = port_eval.main(paper_hparams([
        "--dataset_path", str(ds), "--exp_name", str(tmp / "train_fs_eval"),
        "--ckpt_path", str(a_exp / "models" / f"{TRAIN_FS_STEPS}.pt"),
        "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
        "--val_scale_factor", "1", "--device", "cuda"]))
    log(f"  eval.main on {TRAIN_FS_STEPS}.pt: {e_metrics}")

    ok = (launched(a_counts, TRAIN_FS_STEPS)
          and launched(b_counts, TRAIN_FS_STEPS - TRAIN_FS_RESUME)
          and a_eager == 0 and b_eager == 0 and same and worst <= 1e-3
          and 0 < ds_state["batch_index"]
          and all(np.isfinite(v) for v in [*a_val.values(), *b_val.values()])
          and bool(losses) and np.isfinite(losses).all()
          and bool(rates) and np.isfinite(rates).all()
          and bool(traces) and np.isfinite(e_metrics["val/psnr"]))

    # The loader at a realistic chunk: 16 views at 512x512 in one chunk.
    big = tmp / "loader_dataset"
    write_dataset(big, hw=LOADER_HW, n_train=LOADER_VIEWS, seed=13)
    runner = Runner(train_hparams(big, tmp / "unused", [
        "--dataset_type", "filesystem", "--chunk_paths", str(tmp / "loader_chunks"),
        "--num_chunks", "1"]), set_experiment_path=False)
    t0 = time.perf_counter()
    store = runner._make_dataset()
    big_write_s = time.perf_counter() - t0
    store._future.result()  # the prefetch of chunk 0, started by the constructor
    path = store._parquet_paths[0]
    read_ms, chunk_ms = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        pq.read_table(path)
        read_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        chunk = store._load_chunk_inner(0)
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
    n_rays = chunk["rays"].shape[0]
    loader = {"rays": n_rays, "views": LOADER_VIEWS + 1, "hw": LOADER_HW,
              "write_s": big_write_s, "read_ms": read_ms, "chunk_ms": chunk_ms,
              "rays_per_s": n_rays / (min(chunk_ms) / 1e3),
              "bytes_on_disk": path.stat().st_size}
    log(f"  loader: {n_rays} rays in one chunk ({path.stat().st_size / 1e6:.1f} MB), "
        f"written in {big_write_s:.2f} s; parquet read {min(read_ms):.1f} ms, read + "
        f"regenerate (_load_chunk_inner) {min(chunk_ms):.1f} ms (of {chunk_ms}) = "
        f"{loader['rays_per_s']:.4g} rays/s")

    init_weights(runner.fg.module, torch.Generator().manual_seed(1))
    init_weights(runner.bg.module, torch.Generator().manual_seed(2))
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(runner.hparams),
                     5e-4, 0.1, 1000, runner.sphere_center, runner.sphere_radius)
    runner.hparams.dataset_type = "memory"
    memory = runner._make_dataset()
    fed = {"memory": [], "filesystem": []}
    for turn, name in enumerate(("memory", "filesystem", "filesystem", "memory")):
        fed[name].append(fed_step_ms(step, memory if name == "memory" else store,
                                     device, 100 + turn))
    store.close()
    log(f"  ms per step over {FED_STEPS} chained steps (batch 1024, paper fg+bg), fed "
        f"from memory {fed['memory']}, from the store {fed['filesystem']}")

    report["training_fs"] = {
        "steps": TRAIN_FS_STEPS, "resumed_at": TRAIN_FS_RESUME,
        "resume_dataset_state": ds_state, "chunks": len(rows), "chunk_rows": rows,
        "store_write_s": store_write_s, "same_batches": same,
        "weights_worst_rel_diff": worst, "weights_worst_tensor": worst_name,
        "weights_bit_equal_share": equal_share,
        "launches_a": a_counts, "launches_b": b_counts,
        "eager_calls": a_eager + b_eager, "load_chunk_wait_ms": a_waits,
        "rays_per_sec_logged": rates, "val_psnr_a": a_val.get("val/psnr"),
        "val_psnr_b": b_val.get("val/psnr"), "eval_psnr": e_metrics["val/psnr"],
        "loader": loader, "fed_step_ms": fed,
    }
    return bool(ok)


CELLS_GRID = (2, 4)  # the README's --grid_dim 2 4: K = 8 cells
CELLS_STEPS = 20
CELLS_RESUME = 10  # the step-10 checkpoint the resumed run starts from
CELLS_RESUME_FROM = 3  # ... given as this cell's file
CELLS_TIMED = 10
CELLS_VIEWS = 16  # train views; with the val view 17 views of 128x128
MASK_TOL = 1e-5


def cell_states_equal(a: Path, b: Path) -> bool:
    """Two cell checkpoints hold bit-equal weights, Adam states, generator
    and stream position."""
    import torch

    ca, cb = (torch.load(p, weights_only=False) for p in (a, b))
    same = all(torch.equal(ca[key][n], cb[key][n])
               for key in ("model_state_dict", "bg_model_state_dict") for n in ca[key])
    for name in ("nerf", "bg_nerf"):
        sa, sb = ca["optimizers"][name]["state"], cb["optimizers"][name]["state"]
        same &= sa.keys() == sb.keys() and all(
            torch.equal(torch.as_tensor(sa[i][k]), torch.as_tensor(sb[i][k]))
            for i in sa for k in ("step", "exp_avg", "exp_avg_sq"))
    return bool(same and torch.equal(ca["generator_state"], cb["generator_state"])
                and ca["dataset_state"] == cb["dataset_state"])


def phase_train_cells(device, report, tmp: Path):
    """The README's grid workflow on the card at the paper width
    (`configs/mega-nerf/building.yaml`: fg and bg 8x256, 48-d appearance,
    bf16, 1024 rays a cell a step, 256 + 512 samples) on a generated
    dataset of 17 views of 128x128:
    (a) masks: `scripts.create_cluster_masks` on cuda, `--grid_dim 2 4`
        (K = 8), `--ray_samples 1000`; one view's ratios on the card held
        against the same pass on the CPU (1e-5 relative; masks equal
        wherever |ratio - margin| > 1e-5) and against its written masks;
        prints seconds, rays/s and the masked rays per cell;
    (b) training: `train_cells.main`, 20 grid steps (a checkpoint at 10
        and 20). Checks 4 x 8 x 20 = 640 launches of each narrow training
        kernel, no plain or eager-module call, every cell's loss finite,
        the mean loss over the cells at step 20 below step 1's. Prints ms
        per grid step and per cell step over 10 chained memory-fed steps
        (a sync at the end), the run's peak memory and one cell step's;
    (c) resume: `train_cells.main --ckpt_path` cell 3's step-10 file, run
        to 20: every cell's weights, Adam states, generator and stream
        position bit-equal to the uninterrupted run's;
    (d) merge and serve: `scripts.merge_submodules` of the 8 cells, then
        `eval.main --container_path` on the val view: finite PSNR, 4 x 8
        `fused_nerf_eval` launches a chunk, no plain or eager call; s/view.
    """
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train_cells
    from mega_nerf_tpu_torch.data.cell_dataset import CellDataset
    from mega_nerf_tpu_torch.data.torch_io import load_mask_zip, load_pt
    from mega_nerf_tpu_torch.parallel.cell_parallel import CellParallelTrainStep
    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.runtime.cell_runner import CellRunner
    from mega_nerf_tpu_torch.runtime.runner import Runner, _eval_chunk_cap, batch_to_device
    from mega_nerf_tpu_torch.scripts import create_cluster_masks as ccm
    from mega_nerf_tpu_torch.scripts import merge_submodules

    ds = tmp / "cells_dataset"
    write_dataset(ds, hw=128, n_train=CELLS_VIEWS, seed=17, smooth=True)
    masks = tmp / "cells_masks"
    grid = [str(x) for x in CELLS_GRID]
    k = CELLS_GRID[0] * CELLS_GRID[1]

    # (a) Masks on the card; one view again on the CPU.
    mask_hp = config_hparams(ccm.get_mask_opts, MEGA_CONFIG, ds, tmp / "unused", [
        "--output", str(masks), "--grid_dim", *grid, "--ray_samples", "1000"])
    t0 = time.perf_counter()
    ccm.main(mask_hp)
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    stems = sorted(p.stem for p in ds.glob("*/metadata/*.pt"))
    n_rays = len(stems) * 128 * 128
    masked = [int(sum(load_mask_zip(masks / str(c) / f"{s}.pt").sum() for s in stems))
              for c in range(k)]
    params = load_pt(masks / "params.pt")
    val_stem = next(ds.glob("val/metadata/*.pt")).stem
    meta = load_pt(ds / "val" / "metadata" / f"{val_stem}.pt")

    def view_ratios(where):
        rays = ccm.view_rays(meta, params["near"], params["far"],
                             params["ray_altitude_range"], True, where)
        return ccm.view_ratios(rays, torch.from_numpy(params["centroids"]).to(where),
                               1000, 0, mask_hp.ray_chunk_size)

    card, cpu = view_ratios(device), view_ratios(torch.device("cpu"))
    ratio_err = float((np.abs(card - cpu) / np.abs(cpu)).max())
    margin = mask_hp.boundary_margin
    off = np.abs(cpu - margin) > MASK_TOL
    masks_agree = bool(((card <= margin) == (cpu <= margin))[off].all())
    written = np.stack([load_mask_zip(masks / str(c) / f"{val_stem}.pt").reshape(-1)
                        for c in range(k)], -1)
    written_agree = bool(np.array_equal(written, card <= margin))
    log(f"  masks: {len(stems)} views, {n_rays} rays x 1000 samples x K = {k} in "
        f"{mask_s:.2f} s ({n_rays / mask_s:.4g} rays/s); masked rays per cell {masked}; "
        f"view {val_stem} card vs CPU ratios max relative diff {ratio_err:.3e}, masks "
        f"equal off the {MASK_TOL:g} band: {masks_agree} ({int((~off).sum())} ratios "
        f"in the band); the written masks are the card's: {written_agree}")

    # (b) Training: 20 grid steps.
    def hparams(exp, extra=()):
        return config_hparams(train_cells.get_train_cells_opts, MEGA_CONFIG, ds, exp, [
            *TRAIN_ARGS, "--cluster_mask_path", str(masks), "--train_iterations",
            str(CELLS_STEPS), "--ckpt_interval", str(CELLS_RESUME), *extra])

    def run(exp, extra=()):
        losses, runners = [], []
        step_call, cell_train = CellParallelTrainStep.__call__, CellRunner.train

        def recording(self, batch):
            metrics = step_call(self, batch)
            losses.append(metrics["loss"])
            return metrics

        def capturing(self):
            runners.append(self)
            return cell_train(self)

        CellParallelTrainStep.__call__, CellRunner.train = recording, capturing
        zero_train_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            with EagerCalls() as eager:
                train_cells.main(hparams(exp, extra))
            torch.cuda.synchronize()
        finally:
            CellParallelTrainStep.__call__, CellRunner.train = step_call, cell_train
        wall = time.perf_counter() - t0
        loss = torch.stack(losses).float().cpu().numpy()  # (steps, K)
        return runners[0], loss, train_counters(), eager.count, wall, \
            torch.cuda.max_memory_allocated() / 1e9

    runner, loss, counts, eager, wall, peak = run(tmp / "cells_exp" / "sub")
    per_step = loss.mean(1)
    expected = 4 * k * CELLS_STEPS
    log(f"  train_cells.main: {CELLS_STEPS} grid steps of K = {k} cells in {wall:.2f} s "
        f"(with the datasets and checkpoints); mean loss over the cells step 1 "
        f"{per_step[0]:.5f} -> step {CELLS_STEPS} {per_step[-1]:.5f}; per cell at step "
        f"{CELLS_STEPS} {np.round(loss[-1], 5).tolist()}; launches {counts} "
        f"(expected {expected} each), eager module calls {eager}; peak device memory "
        f"allocated {peak:.2f} GB")
    ok = (masks_agree and written_agree and ratio_err <= MASK_TOL
          and loss.shape == (CELLS_STEPS, k) and bool(np.isfinite(loss).all())
          and per_step[-1] < per_step[0] and counts["plain"] == 0 and eager == 0
          and all(counts[name] == expected for name in
                  ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad")))

    # ms per grid step over chained memory-fed steps, and one cell step's peak.
    hp = runner.hparams
    dataset = CellDataset(runner.cell_items, runner.near, runner.far,
                          runner.ray_altitude_range, hp.center_pixels, hp.random_seed + 1)
    step = CellParallelTrainStep(runner.cells)
    for _ in range(2):
        step(batch_to_device(dataset.next_batch(hp.batch_size), device))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CELLS_TIMED):
        step(batch_to_device(dataset.next_batch(hp.batch_size), device))
    torch.cuda.synchronize()
    grid_ms = (time.perf_counter() - t0) / CELLS_TIMED * 1e3
    cell = runner.cells[0]
    one = batch_to_device(dataset.next_batch(hp.batch_size), device)
    torch.cuda.reset_peak_memory_stats()
    cell.step({key: v[0] for key, v in one.items()}, cell.generator)
    torch.cuda.synchronize()
    cell_peak = torch.cuda.max_memory_allocated() / 1e9
    cell_rays = [len(stream._dataset) for stream in dataset._streams.values()]
    log(f"  grid step at the paper width: {grid_ms:.2f} ms ({grid_ms / k:.2f} ms a cell "
        f"step, {k * hp.batch_size / grid_ms * 1e3:.1f} rays/s) over {CELLS_TIMED} chained "
        f"memory-fed steps; one cell step's peak {cell_peak:.2f} GB with all {k} cells "
        f"resident; training rays per cell {cell_rays}")
    # Device time of a grid step by kernel, beside its unprofiled wall time.
    prepared = [batch_to_device(dataset.next_batch(hp.batch_size), device)
                for _ in range(2)]
    rows, busy, prof_wall = kernel_times(lambda: [step(b) for b in prepared], 2)
    busy_step = busy / 2
    train_kernel_ms = sum(ms for ms, _, name in rows if any(
        key in name for key in ("train_fwd", "train_bwd", "weight_grad")))
    if rows:
        log(f"  grid step profile: device busy {busy_step:.2f} ms a grid step "
            f"({100 * busy_step / grid_ms:.1f}% of the unprofiled {grid_ms:.2f} ms; "
            f"{100 * busy / prof_wall:.1f}% of the profiled wall), the training kernels "
            f"{train_kernel_ms:.2f} ms of it; by kernel:")
        for ms, count, name in rows[:8]:
            log(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("  profiler: no device time recorded (the grid step's busy share not measured)")

    # (c) Resume from cell 3's step-10 checkpoint.
    full = tmp / "cells_exp"
    resume_ckpt = full / f"sub{CELLS_RESUME_FROM}" / "0" / "models" / f"{CELLS_RESUME}.pt"
    resume_state = torch.load(resume_ckpt, weights_only=False)["dataset_state"]
    _, r_loss, r_counts, r_eager, _, _ = run(tmp / "cells_resumed" / "sub",
                                             ["--ckpt_path", str(resume_ckpt)])
    same = [cell_states_equal(full / f"sub{c}" / "0" / "models" / f"{CELLS_STEPS}.pt",
                              tmp / "cells_resumed" / f"sub{c}" / "0" / "models"
                              / f"{CELLS_STEPS}.pt") for c in range(k)]
    r_expected = 4 * k * (CELLS_STEPS - CELLS_RESUME)
    log(f"  resumed from {resume_ckpt.relative_to(tmp)} (cell {CELLS_RESUME_FROM}'s stream at "
        f"{resume_state}): steps {CELLS_RESUME + 1}-{CELLS_STEPS} launches {r_counts}; "
        f"each cell's weights, Adam states, generator and stream bit-equal to the "
        f"uninterrupted run: {same}")
    ok = ok and all(same) and r_eager == 0 and r_counts["plain"] == 0 and all(
        r_counts[name] == r_expected
        for name in ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"))

    # (d) Merge the 8 cells, serve the container.
    merged = tmp / "cells_merged.pt"
    merge_submodules.main(merge_submodules.get_merge_opts([
        "--config_file", str(ROOT / "configs" / MEGA_CONFIG), "--exp_name", "unused",
        "--dataset_path", str(ds), "--ckpt_prefix", str(full / "sub"),
        "--centroid_path", str(masks / "params.pt"), "--output", str(merged),
        "--train_iterations", str(CELLS_STEPS)]))
    e_hp = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, tmp / "cells_eval",
                          ["--container_path", str(merged)])
    view_rays = 128 * 128
    chunks = -(-view_rays // min(e_hp.image_pixel_batch_size, view_rays,
                                 _eval_chunk_cap(e_hp)))
    fused_mlp.fused_nerf_eval.launches = 0
    fused_mlp.fused_nerf_eval_plain.calls = 0
    with EagerCalls() as e_eager:
        metrics = port_eval.main(e_hp)
        torch.cuda.synchronize()
    launches = fused_mlp.fused_nerf_eval.launches
    plain = fused_mlp.fused_nerf_eval_plain.calls
    served = Runner(e_hp, set_experiment_path=False)
    served.make_eval_state()
    view = served.val_items[0]
    served.render_image(view)  # warm: packs every submodule's weights
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2):
        served.render_image(view)
    torch.cuda.synchronize()
    s_view = (time.perf_counter() - t0) / 2
    log(f"  merged {k} trained cells, eval.main --container_path: {metrics}; "
        f"fused_nerf_eval launches {launches} (expected {4 * k * chunks} = 4 x {k} x "
        f"{chunks} chunk(s)), plain {plain}, eager {e_eager.count}; {s_view:.4f} s/view")
    ok = ok and launches == 4 * k * chunks and plain == 0 and e_eager.count == 0 and \
        bool(np.isfinite(metrics["val/psnr"]))

    report["training_cells"] = {
        "config": MEGA_CONFIG, "grid_dim": list(CELLS_GRID), "cells": k,
        "views": len(stems), "mask_s": mask_s, "mask_rays_per_s": n_rays / mask_s,
        "masked_rays_per_cell": masked, "training_rays_per_cell": cell_rays,
        "mask_ratio_max_rel_diff": ratio_err, "masks_agree_off_band": masks_agree,
        "steps": CELLS_STEPS, "loss_mean_step1": float(per_step[0]),
        "loss_mean_last": float(per_step[-1]), "launches": counts,
        "grid_step_ms": grid_ms, "cell_step_ms": grid_ms / k,
        "grid_step_device_busy_ms": busy_step if rows else None,
        "grid_step_train_kernel_ms": train_kernel_ms if rows else None,
        "peak_mem_gb": peak, "cell_step_peak_gb": cell_peak,
        "resumed_from": str(resume_ckpt.relative_to(tmp)), "resume_bit_equal": same,
        "resume_launches": r_counts, "merged_eval": metrics,
        "merged_launches": launches, "merged_s_per_view": s_view}
    return bool(ok)


CONVERGE_STEPS = 2500  # cut from the JAX run's 20,000; the width is the paper's
CONVERGE_VAL = 1250  # --val_interval: val PSNR at 1,250 and 2,500
CONVERGE_CELL_STEPS = 1250  # cut from the JAX run's 8,000
CONVERGE_MIN_PSNR = 20.0  # a model whose gradients are broken stays near 10-12 dB
# The JAX package's val PSNR at step 2,500 of the same run on a TPU v5e
# (PERF_TPU_HISTORY.md:46): a quality yardstick, not a time.
JAX_PSNR_2500 = 28.32


class Stages:
    """Seconds and kernel launches of named stages: `wrap(owner, attr,
    label)` replaces a function or method with one that also records, for
    each call, its wall time (with a synchronize at its end), every
    kernel's launches during it, the eager module's calls (with an open
    `EagerCalls` given) and its return value; `restore()` puts the
    originals back."""

    def __init__(self, eager=None):
        self.rows = {}
        self._saved = []
        self._eager = eager

    def wrap(self, owner, attr: str, label: str) -> None:
        import torch

        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            before, t0 = kernel_launches(), time.perf_counter()
            eager0 = self._eager.count if self._eager else 0
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            row = self.rows.setdefault(label, {"seconds": 0.0, "launches": {}, "calls": 0,
                                               "eager": 0})
            row["seconds"] += time.perf_counter() - t0
            row["calls"] += 1
            row["eager"] += (self._eager.count if self._eager else 0) - eager0
            for name, n in kernel_launches().items():
                if n - before[name]:
                    row["launches"][name] = row["launches"].get(name, 0) + n - before[name]
            row["result"] = out
            return out

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self) -> None:
        while self._saved:
            owner, attr, fn = self._saved.pop()
            setattr(owner, attr, fn)

    def launches(self, label: str, name: str) -> int:
        return self.rows.get(label, {}).get("launches", {}).get(name, 0)

    def table(self):
        """{label: {"seconds", "calls", "launches", "eager"}}, without the
        results."""
        return {k: {key: v[key] for key in ("seconds", "calls", "launches", "eager")}
                for k, v in self.rows.items()}


def only_narrow_launches(counts) -> bool:
    """No kernel outside the narrow eval and training kernels launched."""
    return all(n == 0 for name, n in counts.items() if name not in NARROW_KERNELS)


def phase_converge(device, report, tmp: Path):
    """The port's `scripts.convergence_run` at the paper config (fg and bg
    8x256, 48-d appearance, 256 + 512 samples, 1024 rays a step, bf16) on
    the analytic ring scene of `data/synthetic.py`: 28 train and 2 val
    views of 128x128, masks on a 2x1 grid, the parquet chunk store, cell-0
    training for CONVERGE_STEPS steps with right-half val PSNR every
    CONVERGE_VAL. Every counter is set to 0 just before `main` and read
    just after it. Checks: 4 launches a step of each narrow training kernel,
    `fused_nerf_eval` launches in the validations only, no other kernel's
    launch, no plain or eager-module call; every val PSNR finite, the curve
    rising, the last at least CONVERGE_MIN_PSNR. Prints the curve beside the
    JAX package's 28.32 dB at step 2,500 (its TPU run's quality, not a
    time), the median rays/s and each stage's seconds with the card's name
    and power limit."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch.runtime.runner import Runner
    from mega_nerf_tpu_torch.scripts import convergence_run

    work = tmp / "converge"
    stages = Stages()
    stages.wrap(convergence_run, "build_scene", "scene")
    stages.wrap(convergence_run, "build_masks", "masks")
    stages.wrap(Runner, "train", "train")
    stages.wrap(Runner, "_run_validation", "validation")
    zero_all_counters()
    t0 = time.perf_counter()
    try:
        with EagerCalls() as eager:
            summary = convergence_run.main(
                ["--steps", str(CONVERGE_STEPS), "--val_interval", str(CONVERGE_VAL),
                 "--workdir", str(work)])
            torch.cuda.synchronize()
    finally:
        stages.restore()
    wall = time.perf_counter() - t0
    counts = kernel_launches()
    plain = train_counters()["plain"]
    for name in NARROW_KERNELS:
        report["kernels"][name]["launches_converge"] = counts[name]
    curve = summary["val_psnr_curve"]
    psnrs = [p for _, p in curve]
    val_launches = stages.launches("validation", "fused_nerf_eval")
    smi = report["device_line"]
    log(f"  convergence_run: {CONVERGE_STEPS} steps at the paper config in {wall:.1f} s "
        f"(Runner.train {summary['wall_seconds']} s with the chunk store and "
        f"validations); stages " + ", ".join(
            f"{k} {v['seconds']:.1f} s" for k, v in stages.table().items()))
    log(f"  val PSNR curve (right half of the 2 val views): {curve}; the JAX package's "
        f"run on a TPU v5e read {JAX_PSNR_2500} at step 2,500 (PERF_TPU_HISTORY.md:46)")
    log(f"  median train rays/s {summary['median_sustained_rays_per_sec']} on {smi}")
    log(f"  launches {counts} (expected {4 * CONVERGE_STEPS} of each training kernel; "
        f"fused_nerf_eval {counts['fused_nerf_eval']}, of which in validation "
        f"{val_launches}); plain calls {plain}, eager module calls {eager.count}")
    ok = (len(curve) == CONVERGE_STEPS // CONVERGE_VAL
          and [s for s, _ in curve] == list(range(CONVERGE_VAL, CONVERGE_STEPS + 1,
                                                  CONVERGE_VAL))
          and bool(np.isfinite(psnrs).all()) and psnrs[-1] > psnrs[0]
          and psnrs[-1] >= CONVERGE_MIN_PSNR
          and all(counts[name] == 4 * CONVERGE_STEPS for name in TRAIN_KERNELS)
          and counts["fused_nerf_eval"] > 0 and val_launches == counts["fused_nerf_eval"]
          and only_narrow_launches(counts) and plain == 0 and eager.count == 0)
    report["converge"] = {
        "steps": CONVERGE_STEPS, "val_interval": CONVERGE_VAL,
        "val_psnr_curve": curve, "jax_tpu_psnr_2500": JAX_PSNR_2500,
        "median_rays_per_s": summary["median_sustained_rays_per_sec"],
        "train_wall_s": summary["wall_seconds"], "wall_s": wall,
        "stages": stages.table(), "launches": counts, "device_line": smi}
    return bool(ok)


def phase_converge_cells(device, report, tmp: Path):
    """The port's `scripts.cell_convergence_run --grid 2 1 --steps
    CONVERGE_CELL_STEPS --bake` at the paper config on the same ring scene
    (the same builder and flags as `converge`), then
    `scripts.cell_diagnostics --synthetic` on its `merged.pt`. Every counter
    is set to 0 just before and read just after the two. Checks, by stage:
    training, 4 x K launches a grid step of each narrow training kernel and
    no eval launch; the merge, none; the merged eval, `fused_nerf_eval`
    launches and a finite PSNR of at least CONVERGE_MIN_PSNR; the octree
    (weight mode, depth 6), K launches a probe call, its leaves and file
    size; the flythrough, two frames and eval launches; the diagnostics, K
    launches (one a submodule) and finite rows. No other kernel's launch, no
    plain call, and no eager-module call but the merge's check on the CPU
    (one forward of ones through each of the 2K submodules). Prints the merged PSNR beside `converge`'s
    at step CONVERGE_CELL_STEPS, the floater and missing voxels, and each
    stage's seconds."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch.runtime.cell_runner import CellRunner
    from mega_nerf_tpu_torch.runtime.runner import Runner
    from mega_nerf_tpu_torch.scripts import cell_convergence_run as ccr
    from mega_nerf_tpu_torch.scripts import cell_diagnostics, create_octree
    from mega_nerf_tpu_torch.scripts import merge_submodules, render_images

    work = tmp / "converge_cells"
    k = 2
    probes = []
    probe = create_octree._probe

    def counting_probe(bundle, settings, points, *args, **kwargs):
        probes.append(points.shape[0])
        return probe(bundle, settings, points, *args, **kwargs)

    eager = EagerCalls()
    stages = Stages(eager)
    stages.wrap(ccr, "build_scene", "scene")
    stages.wrap(ccr, "build_masks", "masks")
    stages.wrap(CellRunner, "train", "train")
    stages.wrap(merge_submodules, "main", "merge")
    stages.wrap(Runner, "eval", "eval")
    stages.wrap(create_octree, "main", "octree")
    stages.wrap(render_images, "main", "flythrough")
    stages.wrap(cell_diagnostics, "main", "diagnostics")
    create_octree._probe = counting_probe
    zero_all_counters()
    t0 = time.perf_counter()
    try:
        with eager:
            summary = ccr.main(["--grid", "2", "1", "--steps", str(CONVERGE_CELL_STEPS),
                                "--bake", "--workdir", str(work)])
            diag = cell_diagnostics.main(["--workdir", str(work), "--synthetic"])
            torch.cuda.synchronize()
    finally:
        stages.restore()
        create_octree._probe = probe
    wall = time.perf_counter() - t0
    counts = kernel_launches()
    plain = train_counters()["plain"]
    for name in NARROW_KERNELS:
        report["kernels"][name]["launches_converge_cells"] = counts[name]
    table = stages.table()
    tree = stages.rows["octree"]["result"]
    octree = work / "octree.npz"
    leaves, octree_bytes = int(tree.n_leaves), octree.stat().st_size
    single = dict(report.get("converge", {}).get("val_psnr_curve", []))
    at_same = single.get(CONVERGE_CELL_STEPS)
    rows, dsum = diag["cells"], diag["summary"]
    launch = stages.launches
    log(f"  cell_convergence_run --grid 2 1: {summary}")
    log(f"  merged 2x1 val PSNR {summary['merged_val_psnr']} at step {CONVERGE_CELL_STEPS} "
        f"beside converge's single cell-0 run at the same step: {at_same} (on {report['device_line']})")
    log(f"  octree: {leaves} leaves, {octree_bytes} bytes, {len(probes)} probe calls; "
        f"diagnostics: floater voxels {dsum.get('total_floater_voxels')}, missing voxels "
        f"{dsum.get('total_missing_voxels')}, rows {rows}")
    log("  stages: " + "; ".join(
        f"{name} {row['seconds']:.1f} s, launches {row['launches']}"
        for name, row in table.items()))
    log(f"  launches {counts}; plain calls {plain}; eager module calls {eager.count}, "
        f"expected {2 * k}: the merge's forward of ones through the fg and bg mixtures on "
        f"the CPU; phase {wall:.1f} s")
    train_each = 4 * k * CONVERGE_CELL_STEPS
    ok = (summary["num_cells"] == k and np.isfinite(summary["merged_val_psnr"])
          and summary["merged_val_psnr"] >= CONVERGE_MIN_PSNR
          and all(launch("train", name) == counts[name] == train_each
                  for name in TRAIN_KERNELS)
          and launch("train", "fused_nerf_eval") == 0
          and not table["merge"]["launches"]
          and launch("eval", "fused_nerf_eval") > 0
          and launch("octree", "fused_nerf_eval") == k * len(probes) > 0
          and summary.get("flythrough_frames") == 2
          and launch("flythrough", "fused_nerf_eval") > 0
          and launch("diagnostics", "fused_nerf_eval") == k
          and counts["fused_nerf_eval"] == sum(
              launch(s, "fused_nerf_eval") for s in ("eval", "octree", "flythrough",
                                                     "diagnostics"))
          and leaves > 8 and octree_bytes > 0 and len(rows) == k
          and all(np.isfinite(v).all() for r in rows for v in r.values()
                  if isinstance(v, (int, float)))
          and only_narrow_launches(counts) and plain == 0
          and eager.count == table["merge"]["eager"] == 2 * k)
    report["converge_cells"] = {
        "grid": [2, 1], "steps": CONVERGE_CELL_STEPS, "summary": summary,
        "single_cell_psnr_same_step": at_same, "octree_leaves": leaves,
        "octree_bytes": octree_bytes, "probe_calls": len(probes),
        "diagnostics": diag, "stages": table, "launches": counts, "wall_s": wall,
        "device_line": report["device_line"]}
    return bool(ok)


MP_RANKS = 2  # ranks on the one card (gloo: NCCL refuses two ranks on one device)
MP_STEPS = 20  # data-parallel Runner.train steps, then as many chained
MP_GRID = (1, 3)  # K = 3 cells over --cell_axis 2: rank 1 holds cell 2 and a padding cell
MP_CELL_STEPS = 10
MP_CELL_RESUME = 5
MP_FRAMES = 4
MP_TIMEOUT = 900  # seconds for both ranks


def mp_hparams(get_opts, ds: Path, exp: Path, extra=()):
    return config_hparams(get_opts, MEGA_CONFIG, ds, exp, [*TRAIN_ARGS, *extra])


def multiproc_worker(tmp: Path) -> int:
    """One rank of the `multiproc` phase (started by torchrun with
    `--multiproc_worker <tmp>`): (a) the data-parallel `Runner.train`, (b)
    `train_cells --cell_axis 2` with a resume, the merge and a view, (c)
    `render_images`; writes `mp_result_{rank}.json` under `tmp`."""
    import hashlib

    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch import train_cells
    from mega_nerf_tpu_torch.data.memory_dataset import MemoryDataset
    from mega_nerf_tpu_torch.models import init_weights
    from mega_nerf_tpu_torch.parallel import distributed
    from mega_nerf_tpu_torch.parallel.cell_parallel import CellParallelTrainStep
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner, batch_to_device
    from mega_nerf_tpu_torch.scripts import create_cluster_masks as ccm
    from mega_nerf_tpu_torch.scripts import merge_submodules, render_images

    device = distributed.init_from_env("cuda")
    rank = distributed.rank()

    def say(msg: str) -> None:
        print(f"  [rank {rank}] {msg}", flush=True)

    def weights_hash(*bundles) -> str:
        h = hashlib.sha256()
        for b in bundles:
            for v in b.module.state_dict().values():
                h.update(v.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()

    out = {"backend": distributed.backend(), "device": str(device)}
    ds = tmp / "train_dataset"

    # (a0) The first global batch's averaged gradients against one process's.
    hp = mp_hparams(port_train.get_train_opts, ds, tmp / "unused",
                    ["--train_iterations", str(MP_STEPS)])
    runner = Runner(hp, set_experiment_path=False)
    init_weights(runner.fg.module, torch.Generator().manual_seed(hp.random_seed))
    init_weights(runner.bg.module, torch.Generator().manual_seed(hp.random_seed + 1))
    full = MemoryDataset(runner.train_items, runner.near, runner.far,
                         runner.ray_altitude_range, hp.center_pixels,
                         np.random.default_rng(hp.random_seed), process_scope="private")
    host = next(full.batches(hp.batch_size, np.random.default_rng((hp.random_seed, 0))))
    half = hp.batch_size // distributed.world_size()
    local = {k: v[rank * half:(rank + 1) * half] for k, v in host.items()}
    settings = RenderSettings.from_hparams(hp)

    def grads(step, batch):
        step.gradients(batch_to_device(batch, device), None)
        return {f"{side}.{n}": p.grad.detach().clone()
                for side, b in (("fg", runner.fg), ("bg", runner.bg))
                for n, p in b.module.named_parameters()}

    dp = grads(TrainStep(runner.fg, runner.bg, settings, hp.lr, hp.lr_decay_factor,
                         hp.train_iterations, runner.sphere_center, runner.sphere_radius,
                         group=distributed.world_group()), local)
    if rank == 0:
        one = grads(TrainStep(runner.fg, runner.bg, settings, hp.lr, hp.lr_decay_factor,
                              hp.train_iterations, runner.sphere_center,
                              runner.sphere_radius), host)
        out["grad_worst"] = max((rel_err(dp[n], one[n]), n) for n in one)
        say(f"first global batch: averaged gradients of {distributed.world_size()} ranks "
            f"vs one process's kernel step, worst relative error "
            f"{out['grad_worst'][0]:.3e} ({out['grad_worst'][1]})")
    del runner, dp
    distributed.barrier("grads_compared")

    # (a) The data-parallel Runner.train.
    losses, steps = [], []
    step_call = TrainStep.__call__

    def recording(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        losses.append(metrics["loss"])
        return metrics

    # The path's launches: counted from here to the end of (c).
    zero_all_counters()
    before = kernel_launches()
    TrainStep.__call__ = recording
    captured = []
    runner_init = Runner.__init__

    def capturing(self, *args, **kwargs):
        runner_init(self, *args, **kwargs)
        captured.append(self)

    Runner.__init__ = capturing
    t0 = time.perf_counter()
    try:
        with EagerCalls() as eager:
            val = port_train.main(mp_hparams(port_train.get_train_opts, ds,
                                             tmp / "mp_train",
                                             ["--train_iterations", str(MP_STEPS)]))
            torch.cuda.synchronize()
    finally:
        TrainStep.__call__, Runner.__init__ = step_call, runner_init
    wall = time.perf_counter() - t0
    after = kernel_launches()
    runner = captured[0]
    loss = torch.stack(losses).float().cpu().numpy()
    out["train"] = {
        "launches": {n: after[n] - before[n] for n in after},
        "loss_first5": float(loss[:5].mean()), "loss_last5": float(loss[-5:].mean()),
        "finite": bool(np.isfinite(loss).all()), "steps": len(loss), "val": val,
        "wall_s": wall, "hash": weights_hash(runner.fg, runner.bg), "eager": eager.count}
    say(f"train.main: {MP_STEPS} steps of {half} rays (global {hp.batch_size}) + final "
        f"validation in {wall:.2f} s; loss first 5 {out['train']['loss_first5']:.5f} -> "
        f"last 5 {out['train']['loss_last5']:.5f}; launches {out['train']['launches']}")
    torch.cuda.empty_cache()

    # (b) train_cells --cell_axis 2: masks over both ranks, 10 grid steps from
    # each rank's filesystem stores, a resume from step 5, the merge, a view.
    cds = tmp / "cells_dataset"
    masks = tmp / "mp_masks"
    ccm.main(config_hparams(ccm.get_mask_opts, MEGA_CONFIG, cds, tmp / "unused", [
        "--output", str(masks), "--grid_dim", *map(str, MP_GRID),
        "--ray_samples", "1000"]))

    def cells(exp, extra=()):
        grid_losses = []
        grid_call = CellParallelTrainStep.__call__

        def rec(self, batch):
            metrics = grid_call(self, batch)
            grid_losses.append(metrics["loss"])
            return metrics

        b = kernel_launches()
        CellParallelTrainStep.__call__ = rec
        try:
            with EagerCalls() as e:
                train_cells.main(mp_hparams(
                    train_cells.get_train_cells_opts, cds, exp,
                    ["--dataset_type", "filesystem", "--chunk_paths", str(tmp / "mp_chunks"),
                     "--cluster_mask_path", str(masks), "--train_iterations",
                     str(MP_CELL_STEPS), "--ckpt_interval", str(MP_CELL_RESUME),
                     "--cell_axis", "2", "--data_axis", "1", *extra]))
                torch.cuda.synchronize()
        finally:
            CellParallelTrainStep.__call__ = grid_call
        a = kernel_launches()
        gl = torch.stack(grid_losses).float().cpu().numpy()
        return {"launches": {n: a[n] - b[n] for n in a}, "eager": e.count,
                "loss_first": gl[0].tolist(), "loss_last": gl[-1].tolist(),
                "finite": bool(np.isfinite(gl).all()), "steps": len(gl)}

    out["cells"] = cells(tmp / "mp_cells" / "sub")
    resume_from = tmp / "mp_cells" / "sub2" / "0" / "models" / f"{MP_CELL_RESUME}.pt"
    out["cells_resumed"] = cells(tmp / "mp_cells_resumed" / "sub",
                                 ["--ckpt_path", str(resume_from)])
    say(f"train_cells --cell_axis 2: grid steps {out['cells']['steps']}, launches "
        f"{out['cells']['launches']}; resumed from cell 2's step {MP_CELL_RESUME}: "
        f"launches {out['cells_resumed']['launches']}")
    merged = tmp / "mp_merged.pt"
    if rank == 0:
        merge_submodules.main(merge_submodules.get_merge_opts([
            "--config_file", str(ROOT / "configs" / MEGA_CONFIG), "--exp_name", "unused",
            "--dataset_path", str(cds), "--ckpt_prefix", str(tmp / "mp_cells" / "sub"),
            "--centroid_path", str(masks / "params.pt"), "--output", str(merged),
            "--train_iterations", str(MP_CELL_STEPS)]))
    distributed.barrier("merged")
    b = kernel_launches()
    with EagerCalls() as e:
        metrics = port_eval.main(config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, cds,
                                                tmp / "mp_eval",
                                                ["--container_path", str(merged)]))
        torch.cuda.synchronize()
    a = kernel_launches()
    out["eval"] = {"metrics": metrics, "eager": e.count,
                   "launches": {n: a[n] - b[n] for n in a}}

    # (c) render_images over both ranks.
    b = kernel_launches()
    render_images.main(render_images.get_render_opts(
        mp_render_args(cds, merged, masks, tmp / "mp_poses", tmp / "mp_frames")))
    torch.cuda.synchronize()
    a = kernel_launches()
    out["render"] = {"launches": {n: a[n] - b[n] for n in a}}
    out["launches"] = kernel_launches()

    # Past the path: ms a data-parallel step, chained.
    dataset = runner._make_dataset()
    batches = [batch_to_device(b, device) for _, b in zip(
        range(25), dataset.batches(hp.batch_size, np.random.default_rng(3)))]
    out["train"]["chained_ms"] = chained_step_ms(runner.train_step, batches, MP_STEPS)
    say(f"chained data-parallel step {out['train']['chained_ms']:.2f} ms")
    (tmp / f"mp_result_{rank}.json").write_text(json.dumps(out))
    distributed.barrier("written")
    return 0


def mp_render_args(ds: Path, merged: Path, masks: Path, poses: Path, output: Path):
    return ["--config_file", str(ROOT / "configs" / MEGA_CONFIG), "--dataset_path",
            str(ds), "--container_path", str(merged), "--centroids_path",
            str(masks / "params.pt"), "--input", str(poses), "--output", str(output),
            "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
            "--val_scale_factor", "1", "--device", "cuda"]


def phase_multiproc(device, report, tmp: Path):
    """Two ranks on the one card (torchrun, gloo: NCCL refuses two ranks on
    one device), each its own process and CUDA context, every kernel on the
    card; `multiproc_worker` is each rank's program:
    (a) the first global batch's gradients averaged over both ranks against
        one process's kernel step on the whole batch (relative error per
        tensor <= 1e-2); `train.main` data-parallel at the paper config
        from the memory dataset, 20 steps of 512 rays a rank (global 1024):
        4 launches of each training kernel a step on each rank, no plain or
        eager call, both ranks' weights bit-equal, a falling loss; then ms a
        step over 20 chained steps on each rank, beside the one-process
        step's in this process (both ranks share the card: these times say
        nothing about scaling over cards);
    (b) `create_cluster_masks` over both ranks (`--grid_dim 1 3`), then
        `train_cells --cell_axis 2 --data_axis 1` at the paper width from
        each rank's filesystem stores, 10 grid steps (rank 0: cells 0 and 1,
        rank 1: cell 2 and a padding cell), a resume from cell 2's step-5
        file bit-equal in every real cell, the merge of the 3 written cells
        and `eval.main --container_path` over both ranks through the eval
        kernel;
    (c) `render_images` over both ranks on the merged grid: frames
        byte-equal to one process's (rendered here after the ranks exit).
    A rank that fails fails the phase. `launches_multiproc` is the sum of
    both ranks' counters, zeroed just before `train.main` and read just
    after `render_images`: the gradient check before it and the chained
    timing after it are not counted."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch.data.torch_io import load_pt
    from mega_nerf_tpu_torch.scripts import render_images

    single_ms = chained_step_ms(report["train_step"], report["train_batches"], MP_STEPS)
    poses = tmp / "mp_poses"
    poses.mkdir()
    metas = sorted((tmp / "cells_dataset").glob("train/metadata/*.pt"))[:MP_FRAMES]
    lines, intr = [], []
    for meta_path in metas:
        meta = load_pt(meta_path)
        lines.append(" ".join(str(float(v)) for v in np.asarray(meta["c2w"]).reshape(-1)))
        intr.append(f"{int(meta['W'])} {int(meta['H'])} "
                    + " ".join(str(float(v)) for v in np.asarray(meta["intrinsics"])))
    (poses / "poses.txt").write_text("\n".join(lines) + "\n")
    (poses / "intrinsics.txt").write_text("\n".join(intr) + "\n")
    (poses / "embeddings.txt").write_text("".join(f"{i}\n" for i in range(MP_FRAMES)))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(MP_RANKS), str(ROOT / "chip_smoke.py"),
           "--multiproc_worker", str(tmp)]
    log(f"  {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=str(ROOT), start_new_session=True)
    try:
        rc = proc.wait(timeout=MP_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        rc = None
    wall = time.perf_counter() - t0
    if rc != 0:
        log(f"  the ranks failed: exit code {rc} after {wall:.1f} s")
        return False
    results = [json.loads((tmp / f"mp_result_{r}.json").read_text())
               for r in range(MP_RANKS)]

    launches = {n: sum(r["launches"][n] for r in results) for n in results[0]["launches"]}
    for name, count in launches.items():
        report["kernels"][name]["launches_multiproc"] = count
    runs = {n: sum(r[k]["launches"][n] for r in results
                   for k in ("train", "cells", "cells_resumed", "eval", "render"))
            for n in launches}
    train = [r["train"] for r in results]
    worst, worst_name = results[0]["grad_worst"]
    bit_equal = train[0]["hash"] == train[1]["hash"]
    per_rank = 4 * MP_STEPS
    train_ok = all(t["steps"] == MP_STEPS and t["finite"] and t["eager"] == 0
                   and t["loss_last5"] < t["loss_first5"]
                   and all(t["launches"][n] == per_rank for n in TRAIN_KERNELS)
                   for t in train)
    smi = report.get("device_line", "")
    log(f"  backend {results[0]['backend']} ({MP_RANKS} ranks on {results[0]['device']}); "
        f"{wall:.1f} s for both ranks with their start")
    log(f"  (a) data parallel: averaged gradients vs one process, worst relative error "
        f"{worst:.3e} ({worst_name}); ranks' weights bit-equal {bit_equal}; loss "
        f"{[round(t['loss_first5'], 5) for t in train]} -> "
        f"{[round(t['loss_last5'], 5) for t in train]}; training launches by rank "
        f"{[{n: t['launches'][n] for n in TRAIN_KERNELS} for t in train]} (expected "
        f"{per_rank} each), eval launches by rank "
        f"{[t['launches']['fused_nerf_eval'] for t in train]}; val {train[0]['val']}")
    log(f"  (a) ms a step over {MP_STEPS} chained steps: rank 0 "
        f"{train[0]['chained_ms']:.2f}, rank 1 {train[1]['chained_ms']:.2f} (512 rays "
        f"each, both ranks on one card) vs one process {single_ms:.2f} (1024 rays) on "
        f"{smi}; two ranks share one card, so these times say nothing about scaling "
        "over cards")

    cell_steps = [r["cells"] for r in results]
    resumed = [r["cells_resumed"] for r in results]
    same = [cell_states_equal(
        tmp / "mp_cells" / f"sub{c}" / "0" / "models" / f"{MP_CELL_STEPS}.pt",
        tmp / "mp_cells_resumed" / f"sub{c}" / "0" / "models" / f"{MP_CELL_STEPS}.pt")
        for c in range(MP_GRID[0] * MP_GRID[1])]
    padding_written = (tmp / "mp_cells" / "sub3").exists()
    cells_ok = (all(c["steps"] == MP_CELL_STEPS and c["finite"] and c["eager"] == 0
                    and all(c["launches"][n] == 4 * 2 * MP_CELL_STEPS for n in TRAIN_KERNELS)
                    for c in cell_steps)
                and all(c["eager"] == 0 and all(
                    c["launches"][n] == 4 * 2 * (MP_CELL_STEPS - MP_CELL_RESUME)
                    for n in TRAIN_KERNELS) for c in resumed)
                and all(same) and not padding_written)
    evals = [r["eval"] for r in results]
    eval_ok = (np.isfinite(evals[0]["metrics"]["val/psnr"])
               and evals[0]["metrics"] == evals[1]["metrics"]
               and sum(e["launches"]["fused_nerf_eval"] for e in evals) > 0
               and all(e["eager"] == 0 for e in evals))
    log(f"  (b) train_cells --cell_axis 2, K = 3 at paper width: training launches by rank "
        f"{[{n: c['launches'][n] for n in TRAIN_KERNELS} for c in cell_steps]} (expected "
        f"{4 * 2 * MP_CELL_STEPS} each: two cells a rank); loss by cell, rank 0 "
        f"{cell_steps[0]['loss_first']} -> {cell_steps[0]['loss_last']}, rank 1 "
        f"{cell_steps[1]['loss_first']} -> {cell_steps[1]['loss_last']}; resumed from "
        f"step {MP_CELL_RESUME}: every real cell bit-equal {same}, launches by rank "
        f"{[{n: c['launches'][n] for n in TRAIN_KERNELS} for c in resumed]}; padding cell "
        f"written: {padding_written}; merged eval {evals[0]['metrics']}, eval launches by "
        f"rank {[e['launches']['fused_nerf_eval'] for e in evals]}")

    torch.cuda.empty_cache()
    one = tmp / "mp_frames_1p"
    render_images.main(render_images.get_render_opts(
        mp_render_args(tmp / "cells_dataset", tmp / "mp_merged.pt", tmp / "mp_masks",
                       poses, one)))
    names = [(sub, f"{i:06d}.jpg") for sub in ("rgbs", "depths", "cells")
             for i in range(MP_FRAMES)]
    frames_equal = all((tmp / "mp_frames" / s / n).read_bytes() == (one / s / n).read_bytes()
                       for s, n in names)
    renders = [r["render"]["launches"]["fused_nerf_eval"] for r in results]
    log(f"  (c) render_images over {MP_RANKS} ranks: {MP_FRAMES} frames, eval launches by "
        f"rank {renders}; every file byte-equal to one process's: {frames_equal}")
    log(f"  launches_multiproc (both ranks): {launches}; the sum of the five runs' "
        f"{runs}")

    report["multiproc"] = {
        "ranks": MP_RANKS, "backend": results[0]["backend"], "wall_s": wall,
        "grad_worst_rel_err": worst, "grad_worst_tensor": worst_name,
        "ranks_bit_equal": bit_equal, "chained_ms_by_rank": [t["chained_ms"] for t in train],
        "single_process_ms": single_ms,
        "train_launches_by_rank": [t["launches"] for t in train],
        "loss_first5": [t["loss_first5"] for t in train],
        "loss_last5": [t["loss_last5"] for t in train],
        "cells_launches_by_rank": [c["launches"] for c in cell_steps],
        "cells_resume_bit_equal": same, "merged_eval": evals[0]["metrics"],
        "frames_byte_equal": frames_equal, "render_launches_by_rank": renders}
    return bool(worst <= TOL and bit_equal and train_ok and cells_ok and eval_ok
                and frames_equal and all(r > 0 for r in renders))


MEGA_TRAIN_STEPS = 20
MEGA_TIMED_STEPS = 20
TRAIN_KERNELS = ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad")
NARROW_KERNELS = ("fused_nerf_eval",) + TRAIN_KERNELS


def chained_step_ms(step, batches, n: int) -> float:
    """ms per step over `n` chained steps after 5 warm ones (a sync at the
    end only)."""
    import torch

    if len(batches) < 5 + n:
        raise ValueError(f"{len(batches)} batches for 5 + {n} steps")
    for b in batches[:5]:
        step(b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches[5:5 + n]:
        step(b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def train_fwd_f64(packed, xyz, dirs, app, noise):
    """The training forward in f64 (`forward_trace(acc=torch.float64)`: the
    same weights, every product, sum and activation in f64, the saved rows
    unrounded) -> ((M, 4) f32, f64 rows)."""
    import torch

    from mega_nerf_tpu_torch.render.fused_mlp import forward_trace

    tr = forward_trace(packed, xyz, dirs, app, noise, acc=torch.float64)
    parts = [tr.enc, *tr.hs] + ([tr.branch_in, tr.branch] if packed.has_branch else [])
    return tr.output(packed.config.shifted_softplus).float(), torch.cat(parts, -1)


def train_bwd_f64(packed, act, g, noise):
    """The backward-data step in f64 (`train_bwd_data_plain(acc=torch.float64)`)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_train as ft

    rows, d_app = ft.train_bwd_data_plain(packed, act, g, noise, acc=torch.float64)
    return rows, None if d_app is None else d_app.float()


def weight_grad_f64(packed, act, grad):
    """`weight_grad_plain`'s sums in f64 -> flat f32 gradients."""
    import torch

    from mega_nerf_tpu_torch.render import fused_train as ft

    out = torch.zeros(ft._offsets(ft.packed_shapes(packed))[-1], dtype=torch.float64,
                      device=act.device)
    for d_col, n, x_col, k, out_off, stride, bias_off in ft.weight_grad_jobs(packed):
        dm = grad[:, d_col:d_col + n].double()
        out[out_off:out_off + n * stride].view(n, stride)[:, :k] = \
            dm.T @ act[:, x_col:x_col + k].double()
        if bias_off >= 0:
            out[bias_off:bias_off + n] = dm.sum(0)
    return out.float()


TRAIN_STEPS_FNS = ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad")


def train_chain(name: str):
    """The three training steps of a chain: "kernel", "plain" or "f64"."""
    from mega_nerf_tpu_torch.render import fused_train as ft

    return {"kernel": (ft.fused_nerf_train_fwd, ft.train_bwd_data, ft.weight_grad),
            "plain": (ft.fused_nerf_train_fwd_plain, ft.train_bwd_data_plain,
                      ft.weight_grad_plain),
            "f64": (train_fwd_f64, train_bwd_f64, weight_grad_f64)}[name]


def joint_step_through(step, batch, device, chain: str):
    """One joint step's loss and gradients through `chain`'s three training
    steps, on `batch` with the sigma noise and sample draws of generator
    seed 5 -> (loss, {side.name: gradient}, the MLP calls: each call's
    submodule, module, points, direction coordinates, appearance rows,
    noise and the cotangent that reached its output)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render import rendering

    keys = {id(m): f"{side}.{i}" for side, b in (("fg", step.fg), ("bg", step.bg))
            for i, m in enumerate(b.module)}
    calls = []
    apply = rendering.fused_nerf_train_apply

    def recording_apply(module, xyz, coords, app, nz):
        out = apply(module, xyz, coords, app, nz)
        rec = {"key": keys[id(module)], "module": module, "xyz": xyz.detach(),
               "coords": None if coords is None else coords.detach(),
               "app": None if app is None else app.detach(),
               "nz": None if nz is None else nz.detach()}
        calls.append(rec)
        out.register_hook(lambda g, rec=rec: rec.__setitem__("g", g.detach().clone()))
        return out

    saved = [getattr(ft, n) for n in TRAIN_STEPS_FNS]
    rendering.fused_nerf_train_apply = recording_apply
    try:
        for n, fn in zip(TRAIN_STEPS_FNS, train_chain(chain)):
            setattr(ft, n, fn)
        for opt in (step.fg_opt, step.bg_opt):
            opt.zero_grad(set_to_none=True)
        loss, _, _ = step.loss(batch, torch.Generator(device=device).manual_seed(5))
        loss.backward()
    finally:
        rendering.fused_nerf_train_apply = apply
        for n, fn in zip(TRAIN_STEPS_FNS, saved):
            setattr(ft, n, fn)
    grads = {f"{side}.{name}": p.grad.detach().clone()
             for side, b in (("fg", step.fg), ("bg", step.bg))
             for name, p in b.module.named_parameters() if p.grad is not None}
    for opt in (step.fg_opt, step.bg_opt):
        opt.zero_grad(set_to_none=True)
    return loss.item(), grads, calls


def joint_calls_vs_plain(calls):
    """Each MLP call of a joint step through the training kernels against
    their plain versions on that call's own inputs: the forward (outputs and
    saved rows), the backward-data step on the kernel's saved rows and the
    call's cotangent (gradient rows and d_app), the weight gradient on the
    kernel's rows (every parameter's gradient) -> ((worst relative norm
    difference, what), {side.sub.name: the kernel's gradient summed over the
    calls})."""
    import torch

    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render.fused_mlp import mlp_param_names, pack_tensors

    errs, sums = [], {}
    for i, rec in enumerate(calls):
        cfg = rec["module"].config
        names = mlp_param_names(cfg)
        named = dict(rec["module"].named_parameters())
        params = [named[n] for n in names]
        packed = pack_tensors(cfg, dict(zip(names, params)))
        args = (rec["xyz"], rec["coords"], rec["app"], rec["nz"])
        g = rec["g"].float().contiguous()
        where = f"call {i} ({rec['key']}, {rec['xyz'].shape[0]} points)"
        with torch.no_grad():
            out_k, act_k = ft.fused_nerf_train_fwd(packed, *args)
            out_p, act_p = ft.fused_nerf_train_fwd_plain(packed, *args)
            rows_k, app_k = ft.train_bwd_data(packed, act_k, g, rec["nz"])
            rows_p, app_p = ft.train_bwd_data_plain(packed, act_k, g, rec["nz"])
            flat_k = ft.weight_grad(packed, act_k, rows_k)
            flat_p = ft.weight_grad_plain(packed, act_k, rows_k)
        pairs = [("forward outputs", out_k, out_p), ("saved rows", act_k, act_p),
                 ("backward-data rows", rows_k, rows_p)]
        if app_p is not None:
            pairs.append(("d_app", app_k, app_p))
        grads_k = ft.unpack_grads(cfg, ft.split_grads(packed, flat_k), params)
        grads_p = ft.unpack_grads(cfg, ft.split_grads(packed, flat_p), params)
        pairs += [(f"dW {n}", a, b) for n, a, b in zip(names, grads_k, grads_p)]
        errs += [(rel_err(a, b), f"{where}: {what}") for what, a, b in pairs]
        for n, gk in zip(names, grads_k):
            key = f"{rec['key']}.{n}"
            sums[key] = sums.get(key, 0) + gk.double()
    return max(errs, default=(float("inf"), "no call")), sums


def joint_step_vs_plain(step, batch, device):
    """One paper-width joint step (fg and bg mixtures) through the training
    kernels, held to their plain versions -> {"loss_rel": the loss against
    the plain step's, "stages": (worst, what) of `joint_calls_vs_plain` on
    every MLP call of the kernel step, "sums": (worst, tensor) of the kernel
    step's gradients against the sum of its calls' kernel gradients, "f64":
    each gradient of the kernel, plain and f64 steps against each other's
    (printed, not held)}.

    The step's gradients are not held to the plain step's tensor by tensor:
    a ReLU unit whose pre-activation sits within an f32 rounding of zero
    flips between two equally right sums, and at a point with a large
    cotangent that moves a small submodule's gradient by percents; both
    steps sit as far from the f64 step, and a ray origin moved by one f32
    ulp moves them as far (ROADMAP.md C.8). The plain calls are
    comparisons, not launches."""
    import torch

    k_loss, k_grads, calls = joint_step_through(step, batch, device, "kernel")
    p_loss, p_grads, _ = joint_step_through(step, batch, device, "plain")
    _, r_grads, _ = joint_step_through(step, batch, device, "f64")
    stages, sums = joint_calls_vs_plain(calls)
    comp = max(((rel_err(k_grads[n], s), n) for n, s in sums.items()),
               default=(float("inf"), "no gradient"))
    if set(sums) - set(k_grads):
        comp = (float("inf"), "a call's tensor has no gradient in the step")
    f64 = {}
    for pair, (a, b) in {"kernel_vs_plain": (k_grads, p_grads),
                         "kernel_vs_f64": (k_grads, r_grads),
                         "plain_vs_f64": (p_grads, r_grads)}.items():
        errs = [(rel_err(a[n], b[n]), n) for n in b]
        f64[pair] = {"worst": max(errs), "over_1e-2": sum(e > 1e-2 for e, _ in errs),
                     "tensors": len(errs)}
    del calls
    torch.cuda.empty_cache()
    return {"loss_rel": abs(k_loss - p_loss) / abs(p_loss), "stages": stages,
            "sums": comp, "f64": f64}


def phase_train_mega(device, report, tmp: Path):
    """Joint Mega-NeRF training on the card (`train.main --train_mega_nerf`):
    `configs/mega-nerf/building.yaml` (fg and bg 8x256, 48-d appearance,
    bf16, 1024 rays a step, 256 + 512 samples) with `serve_mega`'s K = 8
    centroids (`params.pt`, `--grid_dim 2 4`) on `train`'s smooth 128x128
    dataset: both mixtures under one Adam each, every submodule through the
    training kernels on the points assigned to it (hard assignment).
    `MEGA_TRAIN_STEPS` steps: finite metrics, the mean loss of the last 5
    steps below the first 5's, each training kernel's launches a step
    (equal for the three, at most 4 x K), no plain or eager-module call,
    each pass's points per submodule summing to the pass (fg 262,144 and
    524,288, bg 131,072 and 262,144); then ms a step over 20 chained steps
    from the written `{iter}.pt` beside `train`'s single-model step in the
    same phase, peak memory, and a profile of 3 steps (device busy ms a
    step, the training kernels' share, the largest kernels). After
    `train.main`, `eval.main --train_mega_nerf --ckpt_path` with a finite
    PSNR; every kernel's counter is set to 0 before `train.main` and read
    after `eval.main` (`launches_train_mega`: the 20 steps, the final
    validation and the eval). Last, one joint step at the paper width on
    one batch (`joint_step_vs_plain`): its loss against the plain step's,
    every MLP call's three kernels against their plain versions on the
    call's own inputs (outputs, rows, d_app, every gradient), and the step's
    gradients against its calls' sums, each relative 1e-2; the step's
    gradients against the plain and f64 steps' printed. Prints the
    `{"training_mega": ...}` record."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner, batch_to_device

    ds, params = tmp / "train_dataset", tmp / "mega" / "params.pt"
    k = MEGA_GRID[0] * MEGA_GRID[1]
    extra = TRAIN_ARGS + ["--train_iterations", str(MEGA_TRAIN_STEPS),
                          "--train_mega_nerf", str(params)]
    hp = config_hparams(port_train.get_train_opts, MEGA_CONFIG, ds, tmp / "mega_train",
                        extra)
    losses, per_step, steps = [], [], []
    step_call = TrainStep.__call__

    def recording_call(self, batch, generator=None):
        if not steps:
            steps.append(self)
            self.fg.route_log, self.bg.route_log = [], []
        before = train_counters()
        metrics = step_call(self, batch, generator)
        after = train_counters()
        per_step.append({n: after[n] - before[n] for n in TRAIN_KERNELS})
        losses.append(metrics["loss"])
        return metrics

    TrainStep.__call__ = recording_call
    zero_all_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with EagerCalls() as eager_calls:
            val = port_train.main(hp)
            torch.cuda.synchronize()
    finally:
        TrainStep.__call__ = step_call
    wall = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated() / 1e9
    counts = train_counters()
    ckpt = tmp / "mega_train" / "0" / "models" / f"{MEGA_TRAIN_STEPS}.pt"
    e_hp = config_hparams(port_eval.get_eval_opts, MEGA_CONFIG, ds, tmp / "mega_train_eval",
                          ["--train_mega_nerf", str(params), "--ckpt_path", str(ckpt)])
    with EagerCalls() as e_eager:
        e_metrics = port_eval.main(e_hp)
        torch.cuda.synchronize()
    launches = kernel_launches()
    plain_calls = train_wide_counters()["plain"]
    for name, count in launches.items():
        report["kernels"][name]["launches_train_mega"] = count
    log(f"  eval.main --train_mega_nerf --ckpt_path {ckpt.name}: {e_metrics}; eager module "
        f"calls {e_eager.count}; launches of train.main and eval.main {launches}, plain "
        f"calls {plain_calls}")
    loss = torch.stack(losses).float().cpu().numpy()
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    fg, bg = steps[0].fg, steps[0].bg
    sizes = {"fg": (1024 * hp.coarse_samples, 1024 * hp.fine_samples),
             "bg": (1024 * hp.coarse_samples // 2, 1024 * hp.fine_samples // 2)}
    passes_ok = all(
        len(b.route_log) == 2 * MEGA_TRAIN_STEPS and all(
            sum(c) == sizes[side][i % 2] and len(c) == k for i, c in enumerate(b.route_log))
        for side, b in (("fg", fg), ("bg", bg)))
    share = {side: (np.asarray(b.route_log[-1]) / sum(b.route_log[-1])).round(4).tolist()
             for side, b in (("fg", fg), ("bg", bg))}
    launches_ok = all(s[n] == s[TRAIN_KERNELS[0]] and 4 <= s[n] <= 4 * k
                      for s in per_step for n in TRAIN_KERNELS)
    log(f"  train.main --train_mega_nerf (K = {k}): {MEGA_TRAIN_STEPS} steps + final "
        f"validation in {wall:.2f} s, peak {run_peak:.2f} GB; loss first 5 {first:.5f} -> "
        f"last 5 {last:.5f}; val {val}; launches a step {per_step[0]} .. {per_step[-1]} "
        f"(at most {4 * k}); plain calls {counts['plain']}, eager module calls "
        f"{eager_calls.count}; each pass's points per submodule sum to the pass "
        f"{passes_ok}; the last step's fine-pass shares fg {share['fg']}, bg {share['bg']}")
    ok = (len(loss) == MEGA_TRAIN_STEPS and np.isfinite(loss).all() and last < first
          and launches_ok and passes_ok and plain_calls == 0
          and eager_calls.count == e_eager.count == 0
          and all(np.isfinite(v) for v in val.values())
          and bool(np.isfinite(e_metrics["val/psnr"])))

    # Chained steps from the written checkpoint, beside the single model's.
    runner = Runner(config_hparams(port_train.get_train_opts, MEGA_CONFIG, ds,
                                   tmp / "unused", extra), set_experiment_path=False)
    runner._load_weights(ckpt)
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(runner.hparams),
                     5e-4, 0.1, MEGA_TRAIN_STEPS, runner.sphere_center,
                     runner.sphere_radius)
    batches = [batch_to_device(b, device) for _, b in zip(
        range(5 + MEGA_TIMED_STEPS), runner._make_dataset().batches(
            1024, np.random.default_rng(3)))]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mega_ms = chained_step_ms(step, batches, MEGA_TIMED_STEPS)
    step_peak = torch.cuda.max_memory_allocated() / 1e9
    single_ms = chained_step_ms(report["train_step"], report["train_batches"],
                                MEGA_TIMED_STEPS)
    log(f"  joint step (K = {k}): {mega_ms:.2f} ms/step over {MEGA_TIMED_STEPS} chained "
        f"steps, peak {step_peak:.2f} GB; the single paper model's step in this phase "
        f"{single_ms:.2f} ms ({mega_ms / single_ms:.2f}x)")
    # Device time of a joint step by kernel, beside its unprofiled wall time.
    rows, busy, prof_wall = kernel_times(lambda: [step(b) for b in batches[:3]], 3)
    profile = None
    if rows:
        busy_step = busy / 3
        kernel_ms = sum(ms for ms, _, name in rows if any(
            key in name for key in ("train_fwd", "train_bwd", "weight_grad")))
        profile = {"busy_ms": busy_step, "train_kernels_ms": kernel_ms,
                   "busy_share": busy_step / mega_ms}
        log(f"  joint step profile: device busy {busy_step:.2f} ms a step "
            f"({100 * busy_step / mega_ms:.1f}% of the unprofiled {mega_ms:.2f} ms), the "
            f"training kernels {kernel_ms:.2f} ms of it; by kernel:")
        for ms, count, name in rows[:8]:
            log(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    else:
        log("  profiler: no device time recorded (the joint step's busy share not measured)")

    # One joint step: the loss against the plain step's, every MLP call's
    # kernels against their plain versions on the call's own inputs, the
    # step's gradients against its calls' sums; the gradients against the
    # plain and f64 steps' printed.
    vs = joint_step_vs_plain(step, batches[0], device)
    log(f"  joint step vs the plain versions (K = {k}, 1024 rays, limit {TOL}): loss "
        f"relative {vs['loss_rel']:.3e}; each call's kernels on its own inputs, worst "
        f"{vs['stages'][0]:.3e} ({vs['stages'][1]}); the step's gradients against its "
        f"calls' sums, worst {vs['sums'][0]:.3e} ({vs['sums'][1]})")
    for pair, e in vs["f64"].items():
        log(f"    step gradients {pair}: worst {e['worst'][0]:.3e} ({e['worst'][1]}), "
            f"{e['over_1e-2']} of {e['tensors']} tensors over 1e-2 (printed, not held)")
    ok = ok and vs["loss_rel"] <= TOL and vs["stages"][0] <= TOL and vs["sums"][0] <= TOL
    report["training_mega"] = {
        "config": MEGA_CONFIG, "submodules": k, "steps": MEGA_TRAIN_STEPS,
        "train_main_s": wall, "run_peak_mem_gb": run_peak, "loss_first5": first,
        "loss_last5": last, "val": val, "launches_per_step_first": per_step[0],
        "launches_per_step_last": per_step[-1], "plain_calls": plain_calls,
        "eager_calls": eager_calls.count + e_eager.count, "passes_sum_to_pass_size": passes_ok,
        "fine_pass_share_last_step": share, "step_ms": mega_ms,
        "single_model_step_ms": single_ms, "step_peak_mem_gb": step_peak,
        "profile": profile, "eval_metrics": e_metrics, "launches": launches,
        "vs_plain": vs}
    return bool(ok)


def weight_grad_boxes(plan, c: int) -> int:
    """64-column boxes one point row of cluster c brings in through TMA
    (weight_grad.cu's producer: a shared operand's boxes are loaded once for
    both CTAs)."""
    from mega_nerf_tpu_torch.render import fused_train as ft

    counts = []
    for j, n0, k0 in plan.tiles[2 * c:2 * c + 2]:
        if j < 0:
            counts.append((0, 0))
            continue
        d_col, n, _, k, *_ = plan.jobs[j]
        shift = (d_col + n0) % 8
        counts.append((-(-(shift + min(ft.WG_TILE_N, n - n0)) // 64),
                       -(-min(ft.WG_TILE_K, k - k0) // 64)))
    (a0, b0), (a1, b1) = counts
    if plan.share[c] == ft.WG_SHARE_X:
        return a0 + a1 + b0
    if plan.share[c] == ft.WG_SHARE_A:
        return a0 + b0 + b1
    return a0 + b0 + a1 + b1


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def dx_flops_per_point(cfg) -> int:
    """Multiply-adds x 2 of one point's data-gradient products at the live
    widths: through every trunk layer but the first (no gradient flows into
    the encodings, nor into a skip layer's encoding columns), trunk_final,
    the branch into the final features and d_app, and the heads."""
    d = cfg.layer_dim
    macs = (cfg.layers - 1) * d * d + d
    if cfg.uses_dir_branch:
        macs += d * d + (d + cfg.appearance_dim) * (d // 2) + (d // 2) * 3
    else:
        macs += d * 3
    return 2 * macs


def mm_f32(a, b):
    """torch.mm's keywords for f32 output where it takes out_dtype, tried on
    small slices of the bf16 operands a and b (else none: bf16 output) ->
    (keywords, output dtype name)."""
    import torch

    try:
        torch.mm(a[:8, :8], b[:8, :8], out_dtype=torch.float32)
        return {"out_dtype": torch.float32}, "float32"
    except (TypeError, RuntimeError):
        return {}, "bfloat16"


def library_weight_grad(packed, act, grad):
    """The weight gradient through cuBLAS: torch.mm of the same bf16 column
    views as the kernel's jobs, f32 output where torch.mm takes out_dtype
    (else bf16), bias sums left out -> (callable, output dtype name)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_train as ft

    jobs = ft.weight_grad_jobs(packed)
    kw, dtype = mm_f32(grad.T, act)

    def run():
        for d_col, n, x_col, k, *_ in jobs:
            torch.mm(grad[:, d_col:d_col + n].T, act[:, x_col:x_col + k], **kw)

    return run, dtype


def time_train_kernels(device, report):
    """Training kernels per launch at the step's four shapes; plain
    versions and bounds at the fg-fine shape."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    hp = paper_hparams()
    kernels = report["kernels"]
    saved = train_counters()
    per_step = 0.0
    shapes = [("fg coarse", False, 1024 * 256), ("fg fine", False, 1024 * 512),
              ("bg coarse", True, 1024 * 128), ("bg fine", True, 1024 * 256)]
    for name, bg, m in shapes:
        bundle = seeded_bundle(hp, 16, bg, 21, device)
        cfg = bundle.config
        packed = fused_mlp.pack_params(bundle.module)
        xyz, dirs, idx = mlp_inputs(cfg, m, 22, device)
        app = bundle.module.appearance(idx).float()
        noise = torch.rand((m,), device=device).to(torch.bfloat16).float()
        g = torch.randn((m, 4), device=device)
        with torch.no_grad():
            _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
            grad, _ = ft.train_bwd_data(packed, act, g, noise)
            t_fwd = cuda_ms(lambda: ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise), 5)
            t_bwd = cuda_ms(lambda: ft.train_bwd_data(packed, act, g, noise), 5)
            t_wg = cuda_ms(lambda: ft.weight_grad(packed, act, grad), 5)
        per_step += t_fwd + t_bwd + t_wg
        log(f"  train kernels, {name} ({m} points): fwd {t_fwd:.3f} ms, "
            f"bwd-data {t_bwd:.3f} ms, weight-grad {t_wg:.3f} ms")
        if name != "fg fine":
            continue
        flops = fused_mlp.flops_per_point(cfg) * m
        dx_flops = dx_flops_per_point(cfg) * m
        named = dict(bundle.module.named_parameters())
        n_params = sum(named[k].numel() for k in fused_mlp.mlp_param_names(cfg))
        # The function's boundary: xyz, dirs, app, noise in and (rgb, sigma)
        # out forward; the same points, noise and the output cotangent in,
        # d_app and the weight gradients out backward. The saved rows are
        # this design's own traffic, printed beside the bound, not in it.
        fwd_b = (fused_mlp.io_bytes_per_point(cfg) + 4) * m
        bwd_b = fwd_b + 4 * cfg.appearance_dim * m + 4 * n_params
        act_b, grad_b = act.numel() * 2, grad.numel() * 2
        # Backward-data reads the h columns of the rows for its masks (and
        # h_{L-1} once more for the heads with the branch), and writes the
        # gradient rows.
        bplan = ft.train_bwd_plan(cfg)
        heads_cols = cfg.layer_dim if cfg.uses_dir_branch else 0
        bwd_rows_b = (sum(w for _, w in bplan.mask_loads) + heads_cols) * 2 * m + grad_b
        lib_run, lib_dtype = library_weight_grad(packed, act, grad)
        with torch.no_grad():
            lib_wg = cuda_ms(lib_run, 5)
            kernels["weight_grad"]["library_ms"] = lib_wg
            log(f"  weight_grad library (torch.mm per job, {lib_dtype} out, no "
                f"bias sums) at fg fine: {lib_wg:.3f} ms")
            p_fwd = cuda_ms(lambda: ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app, noise), 2, 1)
            p_bwd = cuda_ms(lambda: ft.train_bwd_data_plain(packed, act, g, noise), 2, 1)
            p_wg = cuda_ms(lambda: ft.weight_grad_plain(packed, act, grad), 2, 1)
        rows = {  # name: (ms, plain ms, FLOP, bytes, saved-row bytes moved)
            "fused_nerf_train_fwd": (t_fwd, p_fwd, flops, fwd_b, act_b),
            "train_bwd_data": (t_bwd, p_bwd, dx_flops, bwd_b, bwd_rows_b),
            "weight_grad": (t_wg, p_wg, flops, bwd_b, act_b + grad_b),
        }
        for k, (ms, plain_ms, fl, nb, rows_b) in rows.items():
            bms, by = bound(fl, nb)
            kernels[k].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            log(f"  {k} at fg fine: {ms:.3f} ms/launch = {fl / ms / 1e9:.1f} "
                f"TFLOP/s; plain {plain_ms:.3f} ms; bound {bms:.3f} ms ({by}: "
                f"{fl:.4g} FLOP, {nb:.4g} B); saved rows moved {rows_b:.4g} B "
                f"= {rows_b / PEAK_HBM_BYTES * 1e3:.3f} ms at the memory rate "
                f"(achieved {rows_b / ms / 1e9:.3f} TB/s over them)")
        fplan = ft.train_fwd_plan(cfg)
        log(f"  fused_nerf_train_fwd at fg fine: {flops / t_fwd / 1e9:.1f} TFLOP/s "
            f"of {PEAK_BF16_FLOPS / 1e12:.0f}; row writes {act_b / t_fwd / 1e9:.3f} "
            f"TB/s ({act_b:.4g} B); tile {fplan.tm} points, {fplan.stages} ring "
            f"stages, {fplan.smem_bytes} B shared memory")
        log(f"  train_bwd_data at fg fine: {dx_flops / t_bwd / 1e9:.1f} TFLOP/s of "
            f"{PEAK_BF16_FLOPS / 1e12:.0f}; rows read and written "
            f"{bwd_rows_b / t_bwd / 1e9:.3f} TB/s ({bwd_rows_b:.4g} B); tile "
            f"{bplan.tm} points, {bplan.stages} ring stages, {bplan.smem_bytes} B "
            f"shared memory, {len(bplan.products)} products, "
            f"{len(bplan.weight_boxes)} weight boxes")
        plan = ft.weight_grad_plan(packed, m, ft._resident_ctas(ft._wg_library(), act.device))
        boxes = sum(weight_grad_boxes(plan, c) for c in range(len(plan.share)))
        log(f"  weight_grad plan at fg fine: {len(plan.tiles)} tiles in "
            f"{len(plan.share)} clusters of two (share {plan.share}), "
            f"{plan.splits} splits of {plan.split_len} points; TMA requests "
            f"{boxes * 128 * m:.4g} B ({boxes * 128} B per point against "
            f"{(act_b + grad_b) // m} B of rows)")
        report["training"]["fg_fine_saved_row_bytes"] = {"act": act_b, "grad": grad_b}
        del act, grad
        torch.cuda.empty_cache()
    report["train_kernel_ms_per_step"] = per_step
    # Timing launches are not main-path launches.
    for k in ("fused_nerf_train_fwd", "train_bwd_data", "weight_grad"):
        getattr(ft, k).launches = saved[k]


SERVING_SHAPES = (  # (name, bg, points, seed) of one 16,384-ray chunk
    ("fg coarse", False, 16384 * 256, 13), ("fg fine", False, 16384 * 512, 11),
    ("bg coarse", True, 16384 * 128, 15), ("bg fine", True, 16384 * 256, 17),
)


def phase_time(device, report):
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp

    hp = paper_hparams()
    saved = fused_mlp.fused_nerf_eval.launches
    per_shape = {}
    for name, bg, m, seed in SERVING_SHAPES:
        bundle = seeded_bundle(hp, 16, bg, seed, device)
        cfg = bundle.config
        packed = fused_mlp.pack_params(bundle.module)
        xyz, dirs, idx = mlp_inputs(cfg, m, seed + 1, device)
        app = bundle.module.appearance(idx).contiguous()
        grid = fused_mlp.launch_grid(packed, m, xyz.device)
        tm = fused_mlp.eval_plan(packed).tm
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_mlp.fused_nerf_eval(packed, xyz, dirs, app), 10)
        per_shape[name] = {"points": m, "ms": ms, "grid": grid, "tile": tm}
        log(f"  eval kernel, {name} ({m} points): {ms:.3f} ms/launch, grid "
            f"{grid} CTAs walking {-(-m // tm)} tiles of {tm} points")
        if name != "fg fine":
            continue
        with torch.no_grad():
            plain_ms = cuda_ms(
                lambda: fused_mlp.fused_nerf_eval_plain(packed, xyz, dirs, app), 3, 1)
        flops = fused_mlp.flops_per_point(cfg) * m
        nbytes = fused_mlp.io_bytes_per_point(cfg) * m
        bms, by = bound(flops, nbytes)
        report["kernels"]["fused_nerf_eval"].update(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        log(f"  fused eval kernel at {m} points (fg fine, 16384 x 512): "
            f"{ms:.3f} ms/launch = {flops / ms / 1e9:.1f} TFLOP/s; plain "
            f"{plain_ms:.3f} ms; bound {bms:.3f} ms ({by}: {flops:.4g} FLOP, "
            f"{nbytes:.4g} B)")
    fused_mlp.fused_nerf_eval.launches = saved  # timing launches
    chunk_ms = sum(v["ms"] for v in per_shape.values())
    report.update(eval_kernel=per_shape, eval_chunk_ms=chunk_ms)
    log(f"  eval kernel per 16,384-ray chunk (4 launches): {chunk_ms:.3f} ms")

    runner = report["runner"]
    meta = runner.val_items[0]
    runner.render_image(meta)  # warm
    torch.cuda.synchronize()
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.render_image(meta)
    torch.cuda.synchronize()
    s_view = (time.perf_counter() - t0) / reps
    rays = meta.W * meta.H
    report.update(s_per_view=s_view, rays_per_s=rays / s_view)
    log(f"  serving path: {meta.W}x{meta.H} view, {s_view:.4f} s/view, "
        f"{rays / s_view:.1f} rays/s (paper fg+bg, 256+512 samples)")

    time_train_kernels(device, report)
    step, batches = report["train_step"], report["train_batches"]
    for b in batches[:5]:  # warm-up
        step(b)
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for b in batches[5:5 + n]:
        step(b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    share = report["train_kernel_ms_per_step"] / step_ms
    report["training"].update(step_ms=step_ms, rays_per_s=1024 / step_ms * 1e3,
                               kernel_ms_per_step=report["train_kernel_ms_per_step"],
                               kernel_share=share,
                               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    log(f"  training path: {step_ms:.2f} ms/step over {n} chained steps = "
        f"{1024 / step_ms * 1e3:.1f} rays/s (paper fg+bg, batch 1024); "
        f"training kernels {report['train_kernel_ms_per_step']:.2f} ms/step "
        f"from per-launch times ({100 * share:.1f}% of the step)")
    profile_steps(step, batches[25:30], report)
    return True


PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM dense TF32 on the tensor cores


def phase_time_dense(device, report):
    """The wide route's times at the dense width (2048): each kernel per
    launch on one sub-chunk of the fg-fine pass (524,288 points; the layer
    kernel at a 2048 x 2048 trunk layer) with its plain version and bound,
    the layer's cuBLAS yardstick (F.linear on the same bf16 operands, f32
    accumulation); the whole wide eval at the fg-fine shape of one chunk
    (8,388,608 points) against its bound, its plain version and the cuBLAS
    chain over the same layers; the dense view's s/view, rays/s and peak
    device memory, and where its device time goes."""
    import torch
    import torch.nn.functional as F

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_wide as fw

    saved = wide_counters()
    kernels = report["kernels"]
    hp = paper_hparams(DENSE)
    bundle = seeded_bundle(hp, 16, False, 41, device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    plan = fw.wide_plan(cfg)
    sub, d = plan.sub_chunk, cfg.layer_dim
    xyz, dirs, idx = mlp_inputs(cfg, sub, 42, device)
    gen = torch.Generator(device=device).manual_seed(43)
    x = torch.rand((sub, d), generator=gen, device=device).to(torch.bfloat16)
    branch = torch.rand((sub, d // 2), generator=gen, device=device).to(torch.bfloat16)
    w, b = packed.mats[1], packed.biases[1]  # a 2048 x 2048 trunk layer
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    with torch.no_grad():
        layer = lambda: fw.eval_wide_layer([x], w, b, True)  # noqa: E731
        ms = cuda_ms(layer, 10)
        plain_ms = cuda_ms(lambda: fw.eval_wide_layer_plain([x], w, b, True), 3, 1)
        b16 = b.to(torch.bfloat16)  # F.linear takes the bias in the operands' type
        lib_ms = cuda_ms(lambda: F.linear(x, w, b16), 10)
        # The encode at the fg shape, then the bg shape (xyz_dim 4: 112 enc
        # columns), each into given outputs, as the wide eval's sub-chunks.
        bg_packed = fused_mlp.pack_params(seeded_bundle(hp, 16, True, 45, device).module)
        bg_xyz, bg_dirs, _ = mlp_inputs(bg_packed.config, sub, 46, device)
        encode_shapes = []
        for shape, pk, sx, sd in (("fg", packed, xyz, dirs), ("bg", bg_packed, bg_xyz, bg_dirs)):
            outs = fw.eval_wide_encode(pk, sx, sd)
            t = cuda_ms(lambda: fw.eval_wide_encode(pk, sx, sd, *outs), 20)
            tp = cuda_ms(lambda: fw.eval_wide_encode_plain(pk, sx, sd), 3, 1)
            encode_shapes.append((shape, pk, sx, sd, t, tp))
            del outs
        heads_ms = cuda_ms(lambda: fw.eval_wide_heads(packed, x, branch), 10)
        heads_plain = cuda_ms(lambda: fw.eval_wide_heads_plain(packed, x, branch), 3, 1)
    flops = 2.0 * sub * d * d
    nbytes = 2.0 * sub * d * 2 + w.numel() * 2 + b.numel() * 4
    bms, by = bound(flops, nbytes)
    kernels["eval_wide_layer"].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                      bound_by=by, library_ms=lib_ms)
    log(f"  eval_wide_layer, 2048 x 2048 trunk layer on {sub} points: {ms:.3f} "
        f"ms/launch = {flops / ms / 1e9:.1f} TFLOP/s; plain {plain_ms:.3f} ms; "
        f"cuBLAS (F.linear, bf16 operands and bias, f32 accumulation) {lib_ms:.3f} ms = "
        f"{flops / lib_ms / 1e9:.1f} TFLOP/s (the kernel takes {ms / lib_ms:.2f}x its "
        f"time); bound {bms:.3f} ms ({by}: {flops:.4g} FLOP, {nbytes:.4g} B)")
    def f32_bound(nb, ops):
        t_ops = ops / PEAK_F32_FLOPS * 1e3
        t_bytes = nb / PEAK_HBM_BYTES * 1e3
        return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")

    encode_ok = True
    for shape, pk, sx, sd, t, tp in encode_shapes:
        c = pk.config
        nb = sub * (4.0 * c.xyz_dim + 12 + 2 * (pk.ep + pk.dp))
        ops = 3.0 * (c.enc_in + c.dir_in) * sub  # scale, phase and sin per live column
        bms, by = f32_bound(nb, ops)
        with torch.no_grad():
            got = fw.eval_wide_encode(pk, sx, sd)
            want = fw.eval_wide_encode_plain(pk, sx, sd)
        agree = [bf16_agreement(g, w) for g, w in zip(got, want) if w is not None]
        equal, ulps = min(a for a, _ in agree), max(u for _, u in agree)
        worst = max(close_ratio(g, w) for g, w in zip(got, want) if w is not None)
        encode_ok &= equal >= ENCODE_EQUAL_SHARE and ulps <= 1 and worst <= TOL
        if shape == "fg":  # the kernel table's row
            kernels["eval_wide_encode"].update(ms=t, plain_ms=tp, bound_ms=bms, bound_by=by)
        log(f"  eval_wide_encode, {shape} shape (xyz_dim {c.xyz_dim}, {pk.ep} + {pk.dp} "
            f"columns) on {sub} points: {t:.4f} ms/launch ({nb / t / 1e9:.3f} TB/s, "
            f"{100 * bms / t:.1f}% of its bound); plain {tp:.3f} ms; bound {bms:.4f} ms "
            f"({by}: {nb:.4g} B, {ops:.4g} f32 operations); against plain max|err|/(1+|x|)="
            f"{worst:.3e}, bf16 bit-equal {100 * equal:.4f}%, largest difference {ulps} "
            f"bf16 ulp -> {'ok' if equal >= ENCODE_EQUAL_SHARE and ulps <= 1 else 'FAIL'}")
    heads_bytes = sub * (2.0 * d + d + 16) + 2 * (d + 3 * (d // 2))
    heads_ops = 2.0 * sub * (d + 3 * (d // 2))
    bms, by = f32_bound(heads_bytes, heads_ops)
    kernels["eval_wide_heads"].update(ms=heads_ms, plain_ms=heads_plain, bound_ms=bms,
                                      bound_by=by)
    log(f"  eval_wide_heads on {sub} points: {heads_ms:.3f} ms/launch "
        f"({heads_bytes / heads_ms / 1e9:.3f} TB/s); plain {heads_plain:.3f} ms; bound "
        f"{bms:.3f} ms ({by}: {heads_bytes:.4g} B, {heads_ops:.4g} f32 operations)")
    del x, branch, xyz, dirs, encode_shapes, bg_packed, bg_xyz, bg_dirs, got, want, pk, sx, sd

    # The whole wide eval at the fg-fine shape of one 16,384-ray chunk.
    m = 16384 * 512
    xyz, dirs, idx = mlp_inputs(cfg, m, 44, device)
    app = bundle.module.appearance(idx).contiguous()
    with torch.no_grad():
        whole = cuda_ms(lambda: fw.fused_nerf_eval_wide(packed, xyz, dirs, app), 2, 1)
        whole_plain = cuda_ms(
            lambda: fw.fused_nerf_eval_wide_plain(packed, xyz, dirs, app), 1, 0)
        # cuBLAS over the same chain: F.linear on each layer's (concatenated)
        # operand at the sub-chunk shape, once per sub-chunk.
        ops_in = [torch.rand((sub, k), generator=gen, device=device).to(torch.bfloat16)
                  for k in (mat.shape[1] for mat in packed.mats)]
        biases16 = [bias.to(torch.bfloat16) for bias in packed.biases]

        def chain():
            for _ in range(-(-m // sub)):
                for a, mat, bias in zip(ops_in, packed.mats, biases16):
                    F.linear(a, mat, bias)

        chain_ms = cuda_ms(chain, 1, 1)
    flops = fused_mlp.flops_per_point(cfg) * m
    nbytes = fused_mlp.io_bytes_per_point(cfg) * m
    bms, by = bound(flops, nbytes)
    per_chunk = len(fw.sub_chunks(m, sub))
    log(f"  wide eval at {m} points (fg fine, 16384 x 512; {per_chunk} sub-chunks "
        f"of {sub}, {per_chunk * (2 + cfg.layers + 2)} launches): {whole:.3f} ms = "
        f"{flops / whole / 1e9:.1f} TFLOP/s; plain {whole_plain:.3f} ms; cuBLAS "
        f"chain (F.linear per layer) {chain_ms:.3f} ms; bound {bms:.3f} ms ({by}: "
        f"{flops:.4g} FLOP, {nbytes:.4g} B)")
    report["serving_dense"].update(
        fg_fine_points=m, fg_fine_ms=whole, fg_fine_plain_ms=whole_plain,
        fg_fine_cublas_chain_ms=chain_ms, fg_fine_bound_ms=bms,
        fg_fine_launches=per_chunk * (2 + cfg.layers + 2))
    del xyz, dirs, app, ops_in
    torch.cuda.empty_cache()

    runner = report["dense_runner"]
    meta = runner.val_items[0]
    runner.render_image(meta)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.render_image(meta)
    torch.cuda.synchronize()
    s_view = (time.perf_counter() - t0) / reps
    peak = torch.cuda.max_memory_allocated() / 1e9
    rays = meta.W * meta.H
    report["serving_dense"].update(s_per_view=s_view, rays_per_s=rays / s_view,
                                   view_peak_mem_gb=peak)
    log(f"  dense serving path: {meta.W}x{meta.H} view, {s_view:.4f} s/view, "
        f"{rays / s_view:.1f} rays/s (2048/2048 fg+bg, 256+512 samples); peak "
        f"device memory allocated {peak:.2f} GB")
    profile_dense_view(runner, meta, report)
    for k in WIDE_KERNELS:  # timing launches are not main-path launches
        getattr(fw, k).launches = saved[k]
    return encode_ok


def phase_eager_dense(device, report, tmp: Path):
    """`eval.main --no_pallas` on serve_dense's checkpoint and view: the
    eager module, where the port sent this model before the wide kernels.
    Records its wall time and metrics, or its out-of-memory error; last of
    the phases, so the error cannot affect another."""
    import copy

    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval

    hp = copy.copy(report["dense_hparams"])
    hp.use_fused_kernel = False
    hp.exp_name = str(tmp / "exp_dense_eager")
    report.pop("dense_runner", None)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with EagerCalls() as eager_calls:
        try:
            metrics = port_eval.main(hp)
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            first = str(e).splitlines()[0] if str(e) else repr(e)
            log(f"  eval.main --no_pallas (eager module) at 2048/2048: out of "
                f"device memory after {wall:.2f} s, {eager_calls.count} module "
                f"calls (peak allocated {peak:.2f} GB): {first}")
            report["serving_dense"]["eager"] = {"error": first, "seconds": wall,
                                                "peak_mem_gb": peak}
            return True
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  eval.main --no_pallas (eager module) at 2048/2048: {metrics} in "
        f"{wall:.2f} s, {eager_calls.count} module calls, peak allocated "
        f"{peak:.2f} GB")
    report["serving_dense"]["eager"] = {"seconds": wall, "metrics": metrics,
                                        "peak_mem_gb": peak}
    return bool(all(np.isfinite(v) for v in metrics.values()))


# ------------------------------------------------- the wide training route


def zero_train_wide_counters() -> None:
    """Zero the launch counts of every kernel the wide training route can
    reach (its four, the wide eval kernels, the narrow training kernels)
    and the calls of every plain version."""
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    zero_wide_counters()
    zero_train_counters()
    for k in TRAIN_WIDE_KERNELS:
        getattr(ftw, k).launches = 0
    for fn in train_wide_plains():
        fn.calls = 0


def zero_all_counters() -> None:
    """Zero every kernel's launch count and every plain version's calls."""
    from mega_nerf_tpu_torch.render import fused_f32
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    zero_train_wide_counters()
    for k in F32_KERNELS:
        getattr(fused_f32, k).launches = 0
    for k in WIDE_F32_KERNELS:
        getattr(fwf, k).launches = 0


def kernel_launches():
    """{kernel: launches so far} for every kernel of `KERNELS`."""
    from mega_nerf_tpu_torch.render import fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import fused_wide as fw
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    module = {"fused_nerf_eval": fused_mlp, **dict.fromkeys(TRAIN_KERNELS, ft),
              **dict.fromkeys(WIDE_KERNELS, fw), **dict.fromkeys(TRAIN_WIDE_KERNELS, ftw),
              **dict.fromkeys(F32_KERNELS, fused_f32),
              **dict.fromkeys(WIDE_F32_KERNELS, fwf)}
    return {name: getattr(module[name], name).launches for name, _, _ in KERNELS}


def train_wide_plains():
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    return (ftw.train_wide_heads_fwd_plain, ftw.train_wide_heads_bwd_plain,
            ftw.train_wide_dx_plain, ftw.train_wide_dw_plain,
            ftw.fused_nerf_train_wide_fwd_plain, ftw.fused_nerf_train_wide_bwd_plain)


def train_wide_counters():
    """Launches of the wide training route's kernels (its four and the wide
    eval kernels its forward runs), of the narrow training kernels, and the
    calls of every plain version."""
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    wide, narrow = wide_counters(), train_counters()
    out = {k: getattr(ftw, k).launches for k in TRAIN_WIDE_KERNELS}
    out.update({k: wide[k] for k in WIDE_KERNELS})
    out["narrow"] = sum(narrow[k] for k in ("fused_nerf_train_fwd", "train_bwd_data",
                                            "weight_grad")) + wide["fused_nerf_eval"]
    out["plain"] = (wide["plain"] + narrow["plain"]
                    + sum(fn.calls for fn in train_wide_plains()))
    return out


def wide_step_launches(pass_cfgs):
    """Launches of training passes through the wide route, one pass per
    config in `pass_cfgs` (a step's: fg and bg, coarse and fine): each an
    encode, a layer GEMM per matmul layer, the heads forward and backward
    and the plan's dX and dW steps."""
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    per = dict.fromkeys(TRAIN_WIDE_KERNELS + WIDE_KERNELS, 0)
    for cfg in pass_cfgs:
        steps = ftw.train_wide_plan(cfg).steps
        n_dx = sum(kind == "dx" for kind, _ in steps)
        per["eval_wide_encode"] += 1
        per["eval_wide_layer"] += cfg.layers + (2 if cfg.uses_dir_branch else 0)
        per["train_wide_heads_fwd"] += 1
        per["train_wide_heads_bwd"] += 1
        per["train_wide_dx"] += n_dx
        per["train_wide_dw"] += len(steps) - n_dx
    return per


def dw_against_f64(packed, saved, gen):
    """A trunk layer's weight gradient (layer 2: dW = d_pre2^T h1, db = sum
    d_pre2) from `train_wide_dw` and from `train_wide_dw_plain`, each held
    against the f64 sums of the same bf16 operands: h1 the saved layer
    output, d_pre2 seeded normal rows (scale 1e-2) under h2's ReLU mask ->
    (kernel's relative error, plain's), over the weights and bias together."""
    import torch

    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    plan = ftw.check_plan(packed)
    job = next(job for kind, job in plan.steps if kind == "dw" and job[0].d == "g_pre2")
    h1, h2 = saved["h1"], saved["h2"]
    d = (torch.randn(h2.shape, generator=gen, device=h2.device) * 1e-2
         * (h2 > 0)).to(torch.bfloat16)
    tensors = {"g_pre2": d, "h1": h1}
    j = job[0]
    rows = slice(j.out_off, j.out_off + j.n * j.out_stride)
    bias = slice(j.bias_off, j.bias_off + j.n)

    def flat(buf):
        return torch.cat([buf[rows].view(j.n, j.out_stride)[:, :j.k].reshape(-1),
                          buf[bias]]).double()

    got = flat(ftw.train_wide_dw(job, tensors, torch.zeros(plan.total, device=d.device)))
    plain = flat(ftw.train_wide_dw_plain(job, tensors,
                                         torch.zeros(plan.total, device=d.device)))
    dd = d.double()
    ref = torch.cat([(dd.T @ h1.double()).reshape(-1), dd.sum(0)])
    del dd
    norm = ref.norm().item()
    return (got - ref).norm().item() / norm, (plain - ref).norm().item() / norm


def compare_train_wide_case(name, hp, bg, m, seed, device, f64=False):
    """The wide training kernels against their plain versions on one
    model -> ({kernel: max_abs_err}, ok, with `f64` the relative errors of
    `dw_against_f64` (kernel, plain), else None). The heads forward reads the plain
    forward's last trunk output and branch; the backward kernels go through
    `walk_backward` (each fed the plain backward's tensors, so errors do not
    compound; every dW launch runs twice for the same bits). Then the
    composed forward and backward against the composed plain versions."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render.fused_train import split_grads

    bundle = seeded_bundle(hp, 16, bg, seed, device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    xyz, dirs, idx = mlp_inputs(cfg, m, seed + 1, device)
    app = bundle.module.appearance(idx).float() if cfg.appearance_dim else None
    gen = torch.Generator(device=device).manual_seed(seed + 2)
    noise = torch.rand((m,), generator=gen, device=device).to(torch.bfloat16).float()
    g = torch.randn((m, 4), generator=gen, device=device)
    errs = dict.fromkeys(TRAIN_WIDE_KERNELS, 0.0)  # max |kernel - plain|
    worst = dict.fromkeys(TRAIN_WIDE_KERNELS, 0.0)  # against each tolerance

    def hold(kernel, got, want, ratio):
        errs[kernel] = max(errs[kernel], (got.float() - want.float()).abs().max().item())
        worst[kernel] = max(worst[kernel], ratio)

    def forward_ratio(got, want):
        err = (got - want).abs()
        return max(err[:, :3].max().item(), (err[:, 3] / (1 + want[:, 3].abs())).max().item())

    with torch.no_grad():
        want, saved = ftw.fused_nerf_train_wide_fwd_plain(packed, xyz, dirs, app, noise)
        out, pre = ftw.train_wide_heads_fwd(packed, saved[f"h{cfg.layers - 1}"],
                                            saved.get("branch"), noise)
        hold("train_wide_heads_fwd", out, want, forward_ratio(out, want))
        hold("train_wide_heads_fwd", pre, saved["pre"], close_ratio(pre, saved["pre"]))
        same = True
        for kernel, got, ref in ftw.walk_backward(packed, saved, g):
            if kernel == ftw.DW_REPEAT:
                same = same and torch.equal(got, ref)
            else:
                hold(kernel, got, ref, rel_err(got, ref))
        del got, ref
        # C.3: the kernel and the plain f32 matmul against f64 sums.
        f64_errs = dw_against_f64(packed, saved, gen) if f64 else None
        # The composed route against the composed plain versions.
        got, k_saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
        del k_saved
        fwd_ratio = forward_ratio(got, want)
        flat, d_app = ftw.fused_nerf_train_wide_bwd(packed, saved, g)
        p_flat, p_d_app = ftw.fused_nerf_train_wide_bwd_plain(packed, saved, g)
        torch.cuda.synchronize()
        bwd_rel = max(rel_err(a, b) for a, b in zip(split_grads(packed, flat),
                                                    split_grads(packed, p_flat)))
        if d_app is not None:
            bwd_rel = max(bwd_rel, rel_err(d_app, p_d_app))
        finite = bool(torch.isfinite(got).all() and torch.isfinite(flat).all())
    ok = (finite and same and max(worst.values()) <= TOL and fwd_ratio <= TOL
          and bwd_rel <= TOL and (f64_errs is None or max(f64_errs) <= TOL))
    if f64_errs is not None:
        log(f"  train wide {name}: M={m}; a trunk layer's dW and db against f64 sums of "
            f"the same bf16 operands: train_wide_dw {f64_errs[0]:.3e}, train_wide_dw_plain "
            f"(f32 matmul) {f64_errs[1]:.3e} relative")
    log(f"  train wide {name}: M={m}; heads fwd worst {worst['train_wide_heads_fwd']:.3e}, "
        f"heads bwd rel {worst['train_wide_heads_bwd']:.3e}, dX worst rel "
        f"{worst['train_wide_dx']:.3e}, dW worst rel {worst['train_wide_dw']:.3e} (two "
        f"launches bitwise equal={same}); composed forward rgb / sigma ratio "
        f"{fwd_ratio:.3e}, backward worst rel {bwd_rel:.3e}; finite={finite} -> "
        f"{'ok' if ok else 'FAIL'}")
    del saved, flat, p_flat, got, want
    torch.cuda.empty_cache()
    return errs, ok, f64_errs


def phase_compare_train_wide(device, report):
    """The wide training route's four kernels against their plain versions
    at width 1024 (fg and bg, the paper's dirs and appearance): at an M not
    a multiple of the 128-point tile, and at each pass's M of a training
    step (batch 1024: fg 256 coarse and 512 fine samples a ray, bg 128 and
    256) and at the cascade's fine pass (256 + 512 a ray), whose launches
    have their own grids and dW splits; and at 640 with and without the
    branch."""
    wide = paper_hparams(WIDE_TRAIN)
    cases = [  # (name, hparams, bg, points)
        ("fg 1024-wide, dirs, appearance", wide, False, 100_003),
        ("bg 1024-wide, dirs, appearance", wide, True, 100_003),
        ("fg 640-wide, no dirs, no appearance (no branch)",
         paper_hparams(["--layer_dim", "640", "--appearance_dim", "0",
                        "--pos_dir_dim", "0"]), False, 20_011),
        ("bg 640-wide, appearance 5, no dirs",
         paper_hparams(["--bg_layer_dim", "640", "--appearance_dim", "5",
                        "--pos_dir_dim", "0"]), True, 20_011),
        ("fg 1024-wide, the fg fine pass", wide, False, 1024 * 512),
        ("fg 1024-wide, the fg coarse pass", wide, False, 1024 * 256),
        ("bg 1024-wide, the bg fine pass", wide, True, 1024 * 256),
        ("bg 1024-wide, the bg coarse pass", wide, True, 1024 * 128),
        # The cascade's fine pass: the coarse and fine depths, 256 + 512.
        ("fg 1024-wide, the cascade's fine pass", wide, False, 1024 * 768),
    ]
    kernels = report["kernels"]
    all_ok = True
    f64 = report.setdefault("training_wide", {}).setdefault("dw_rel_err_vs_f64", {})
    for i, (name, hp, bg, m) in enumerate(cases):
        errs, ok, f64_errs = compare_train_wide_case(name, hp, bg, m, 400 + i, device,
                                                     f64="pass" in name)
        for k, v in errs.items():
            kernels[k]["max_abs_err"] = max(kernels[k].get("max_abs_err", 0.0), v)
        if f64_errs is not None:
            f64[f"{'bg' if bg else 'fg'} {m}"] = {"kernel": f64_errs[0],
                                                  "plain": f64_errs[1]}
        all_ok &= ok
    # (bg, points) of each 1024-wide case: train_wide checks that its passes
    # are among them.
    report["train_wide_compared"] = {(bg, m) for _, hp, bg, m in cases if hp is wide}
    return all_ok


TRAIN_WIDE_STEPS = 20


def phase_train_wide(device, report, tmp: Path):
    """`train.main` at fg and bg 8x1024 for TRAIN_WIDE_STEPS steps on the
    train phase's dataset: finite metrics, the wide route named for every
    fg and bg pass, each kernel's launches per step as the plans say, no
    narrow-kernel launch, no plain call, no eager-module call; then
    `eval.main` on the written `{iter}.pt` through the wide eval route."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.models import nerf_config_from_hparams
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import rendering

    ds = tmp / "train_dataset"
    hp = train_hparams(ds, tmp / "train_wide_exp",
                       ["--train_iterations", str(TRAIN_WIDE_STEPS), *WIDE_TRAIN])
    fg_cfg = nerf_config_from_hparams(hp, 1, hp.layer_dim, 3)
    bg_cfg = nerf_config_from_hparams(hp, 1, hp.bg_layer_dim, 4)
    per_step = wide_step_launches((fg_cfg, fg_cfg, bg_cfg, bg_cfg))
    routes, snaps, passes = [], [], set()
    log_path, step_call = rendering._log_mlp_path, TrainStep.__call__
    forward = ftw._forward

    def recording_forward(packed, xyz, *args):
        passes.add((packed.config.xyz_dim == 4, xyz.shape[0]))
        return forward(packed, xyz, *args)

    def recording_log(message):
        routes.append(message)
        log_path(message)

    def recording_call(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        snaps.append((metrics["loss"], train_wide_counters()))
        return metrics

    rendering._log_mlp_path, TrainStep.__call__ = recording_log, recording_call
    ftw._forward = recording_forward
    zero_train_wide_counters()
    t0 = time.perf_counter()
    try:
        with EagerCalls() as eager_calls:
            val = port_train.main(hp)
            torch.cuda.synchronize()
    finally:
        rendering._log_mlp_path, TrainStep.__call__ = log_path, step_call
        ftw._forward = forward
    wall = time.perf_counter() - t0
    after = train_wide_counters()
    counts = snaps[-1][1]  # after the last step, before the final validation
    loss = torch.stack([s[0] for s in snaps]).float().cpu().numpy()
    train_routes = sorted({r for r in routes if "/train]" in r})
    log(f"  train.main at {hp.layer_dim}/{hp.bg_layer_dim}: {len(snaps)} steps + final validation in "
        f"{wall:.2f} s; loss first {loss[0]:.5f} -> last {loss[-1]:.5f}; val {val}; "
        f"launches after the steps {counts} (per step expected {per_step}); after "
        f"validation {after}; eager module calls {eager_calls.count}; (bg, points) of "
        f"the passes {sorted(passes)}, each held against the plain versions in "
        f"compare_train_wide: {passes <= report['train_wide_compared']}")
    for r in train_routes:
        log(f"    {r}")
    for k in TRAIN_WIDE_KERNELS:
        report["kernels"][k]["launches"] = counts[k]
    ok = (len(snaps) == TRAIN_WIDE_STEPS and np.isfinite(loss).all()
          and all(np.isfinite(v) for v in val.values())
          and len(train_routes) == 4
          and all("fused train (wide kernel)" in r for r in train_routes)
          and all(counts[k] == TRAIN_WIDE_STEPS * n for k, n in per_step.items())
          and passes <= report["train_wide_compared"]
          and counts["eval_wide_heads"] == 0 and after["narrow"] == 0
          and after["plain"] == 0 and eager_calls.count == 0)

    ckpt = tmp / "train_wide_exp" / "0" / "models" / f"{TRAIN_WIDE_STEPS}.pt"
    e_hp = paper_hparams(["--dataset_path", str(ds), "--exp_name",
                          str(tmp / "train_wide_eval"), "--ckpt_path", str(ckpt),
                          "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
                          "--val_scale_factor", "1", "--device", "cuda", *WIDE_TRAIN])
    zero_wide_counters()
    routes.clear()
    rendering._log_mlp_path = recording_log
    try:
        with EagerCalls() as eval_eager:
            e_metrics = port_eval.main(e_hp)
    finally:
        rendering._log_mlp_path = log_path
    e_counts = wide_counters()
    log(f"  eval.main on {ckpt.name} at {hp.layer_dim}/{hp.bg_layer_dim}: {e_metrics}; "
        f"launches {e_counts}")
    ok = (ok and ckpt.exists() and np.isfinite(e_metrics["val/psnr"])
          and all(e_counts[k] > 0 for k in WIDE_KERNELS) and e_counts["plain"] == 0
          and eval_eager.count == 0 and routes
          and all("fused eval (wide kernel)" in r for r in routes))
    report.setdefault("training_wide", {}).update({
        "steps": len(snaps), "loss_first": float(loss[0]), "loss_last": float(loss[-1]),
        "val_psnr": val.get("val/psnr"), "ckpt_eval_psnr": e_metrics["val/psnr"],
        "launches_per_step": per_step, "train_main_s": wall})
    report["wide_train_ckpt"] = ckpt
    return bool(ok)


def time_train_wide_kernels(device, report):
    """The wide training kernels per launch at the fg-fine shape (524,288
    points, 8x1024): the heads kernels on the pass's own tensors, dX and dW
    at a 1024 x 1024 trunk layer, with TFLOP/s, bounds, plain times and
    cuBLAS (F.linear for dX, torch.mm for dW, the same bf16 operands, f32
    accumulation; no mask, no bias sums); the forward's layer GEMM beside
    F.linear on its operands and bias; the composed forward and backward
    of the pass."""
    import torch
    import torch.nn.functional as F

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import fused_wide as fw

    kernels = report["kernels"]
    hp = paper_hparams(WIDE_TRAIN)
    bundle = seeded_bundle(hp, 16, False, 51, device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    m, d = 1024 * 512, cfg.layer_dim
    xyz, dirs, idx = mlp_inputs(cfg, m, 52, device)
    app = bundle.module.appearance(idx).float()
    gen = torch.Generator(device=device).manual_seed(53)
    noise = torch.rand((m,), generator=gen, device=device).to(torch.bfloat16).float()
    g = torch.randn((m, 4), generator=gen, device=device)
    plan = ftw.check_plan(packed)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    with torch.no_grad():
        _, saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
        h, branch = saved[f"h{cfg.layers - 1}"], saved["branch"]
        hf = lambda: ftw.train_wide_heads_fwd(packed, h, branch, noise)  # noqa: E731
        t_hf, p_hf = cuda_ms(hf, 10), cuda_ms(
            lambda: ftw.train_wide_heads_fwd_plain(packed, h, branch, noise), 3, 1)
        hb_args = (packed, g, saved["pre"], h, branch)
        t_hb, p_hb = cuda_ms(lambda: ftw.train_wide_heads_bwd(*hb_args), 10), cuda_ms(
            lambda: ftw.train_wide_heads_bwd_plain(*hb_args), 3, 1)
        # dX and dW at trunk layer 2 (no skip): d_pre_2 -> d_pre_1 masked by h1.
        gp = (torch.randn((m, d), generator=gen, device=device) * 1e-2).to(torch.bfloat16)
        wt = ft.transposed_weights(packed)[2]
        dx_args = (gp, wt, 0, d, ftw.DX_MASK, saved["h1"])
        t_dx = cuda_ms(lambda: ftw.train_wide_dx(*dx_args), 10)
        p_dx = cuda_ms(lambda: ftw.train_wide_dx_plain(*dx_args), 3, 1)
        lib_dx = cuda_ms(lambda: F.linear(gp, wt), 10)
        job = next(job for kind, job in plan.steps if kind == "dw" and job[0].d == "g_pre2")
        tensors, out = {"g_pre2": gp, "h1": saved["h1"]}, torch.empty(plan.total, device=device)
        t_dw = cuda_ms(lambda: ftw.train_wide_dw(job, tensors, out), 10)
        p_dw = cuda_ms(lambda: ftw.train_wide_dw_plain(job, tensors, out), 3, 1)
        kw, lib_dtype = mm_f32(gp.T, saved["h1"])
        lib_dw = cuda_ms(lambda: torch.mm(gp.T, saved["h1"], **kw), 10)
        t_layer = cuda_ms(lambda: fw.eval_wide_layer([saved["h1"]], packed.mats[2],
                                                     packed.biases[2], True), 10)
        b16 = packed.biases[2].to(torch.bfloat16)  # F.linear's bias in the operands' type
        lib_layer = cuda_ms(lambda: F.linear(saved["h1"], packed.mats[2], b16), 10)
        t_fwd = cuda_ms(lambda: ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise),
                        3, 1)
        t_bwd = cuda_ms(lambda: ftw.fused_nerf_train_wide_bwd(packed, saved, g), 3, 1)
    del saved, gp, tensors
    torch.cuda.empty_cache()
    gemm = 2.0 * m * d * d
    rows = {  # name: (ms, plain ms, library ms, FLOP, bytes, peak)
        "train_wide_heads_fwd": (t_hf, p_hf, None, 2.0 * m * (d + 3 * (d // 2)),
                                 m * (2.0 * d + d + 4 + 32), PEAK_F32_FLOPS),
        "train_wide_heads_bwd": (t_hb, p_hb, None, 8.0 * m * (d // 2),
                                 m * (32.0 + 2 * d + 32), PEAK_F32_FLOPS),
        "train_wide_dx": (t_dx, p_dx, lib_dx, gemm, 6.0 * m * d + 2 * d * d,
                          PEAK_BF16_FLOPS),
        "train_wide_dw": (t_dw, p_dw, lib_dw, gemm, 4.0 * m * d + 4 * (d * d + d),
                          PEAK_BF16_FLOPS),
    }
    for k, (ms, plain_ms, lib_ms, fl, nb, peak) in rows.items():
        t_ops, t_bytes = fl / peak * 1e3, nb / PEAK_HBM_BYTES * 1e3
        bms, by = max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
        kernels[k].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=lib_ms)
        rate = (f"{fl / ms / 1e9:.1f} TFLOP/s" if peak == PEAK_BF16_FLOPS
                else f"{nb / ms / 1e9:.3f} TB/s")
        lib = ("" if lib_ms is None else
               f"; cuBLAS {lib_ms:.3f} ms (the kernel takes {ms / lib_ms:.2f}x its time)")
        log(f"  {k} at fg fine ({m} points, width {d}): {ms:.3f} ms/launch = {rate}; "
            f"plain {plain_ms:.3f} ms; bound {bms:.3f} ms ({by}: {fl:.4g} FLOP, "
            f"{nb:.4g} B){lib}")
    log(f"  weight-gradient library: torch.mm, {lib_dtype} out, no bias sums; dX "
        f"library: F.linear, bf16 out, no mask")
    layer_bound, layer_by = bound(gemm, 4.0 * m * d + 2 * d * d + 4 * d)
    log(f"  eval_wide_layer (the forward's GEMM), 1024 x 1024 trunk layer at fg fine: "
        f"{t_layer:.3f} ms = {gemm / t_layer / 1e9:.1f} TFLOP/s; bound {layer_bound:.3f} "
        f"ms ({layer_by}); cuBLAS (F.linear, bf16 operands and bias, f32 accumulation) "
        f"{lib_layer:.3f} ms = {gemm / lib_layer / 1e9:.1f} TFLOP/s (the kernel takes "
        f"{t_layer / lib_layer:.2f}x its time)")
    flops = (2 * fused_mlp.flops_per_point(cfg) + dx_flops_per_point(cfg)) * m
    bms, by = bound(flops, (fused_mlp.io_bytes_per_point(cfg) + 4) * m)
    log(f"  the fg-fine pass through the wide route: forward {t_fwd:.3f} ms + backward "
        f"{t_bwd:.3f} ms = {t_fwd + t_bwd:.3f} ms, "
        f"{flops / (t_fwd + t_bwd) / 1e9:.1f} TFLOP/s; bound {bms:.3f} ms ({by}: "
        f"{flops:.4g} FLOP)")
    report["training_wide"].update(
        fg_fine_fwd_ms=t_fwd, fg_fine_bwd_ms=t_bwd, fg_fine_bound_ms=bms,
        layer_ms_fg_fine=t_layer, layer_library_ms_fg_fine=lib_layer,
        dx_ms_fg_fine=t_dx, dx_library_ms_fg_fine=lib_dx)


# A training step's passes: (label, points) of fg fine, fg coarse, bg fine
# and bg coarse at 1024 rays (256 + 512 fg samples, 128 + 256 bg).
WIDE_PASSES = (("fg fine", 1024 * 512), ("fg coarse", 1024 * 256),
               ("bg fine", 1024 * 256), ("bg coarse", 1024 * 128))
NEIGHBOUR_LAYERS = 10  # layer GEMMs before each timed dW, as in a step's forward


def step_dw_work(fg_cfg, bg_cfg):
    """A training step's dW work from the plans' jobs at the four passes ->
    (FLOP of the products and bias sums at the live widths, bound ms: per
    launch the larger of its FLOP at 989 TFLOP/s and its bytes, each input
    row read once and each output written once, at 3.35 TB/s)."""
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    flops = bound_ms = 0.0
    for cfg, passes in ((fg_cfg, (1024 * 512, 1024 * 256)),
                        (bg_cfg, (1024 * 256, 1024 * 128))):
        plan = ftw.train_wide_plan(cfg)
        widths = dict(plan.saved)
        for kind, jobs in plan.steps:
            if kind != "dw":
                continue
            names = {j.x: widths[j.x] for j in jobs}
            names.update({j.d: max(jj.d_col + jj.n for jj in jobs if jj.d == j.d)
                          for j in jobs})
            per_point = sum(2 * j.n * j.k + (j.n if j.bias_off >= 0 else 0) for j in jobs)
            out_bytes = 4 * sum(j.n * j.k + (j.n if j.bias_off >= 0 else 0) for j in jobs)
            for m in passes:
                flops += per_point * m
                bound_ms += bound(per_point * m, 2 * m * sum(names.values()) + out_bytes)[0]
    return flops, bound_ms


def time_dw_beside_layers(device, report):
    """`train_wide_dw` and its library call (torch.mm, f32 out where it
    takes out_dtype, no bias sums) at a 1024 x 1024 trunk job at each pass
    of a step, each timed alone right after the same neighbour:
    NEIGHBOUR_LAYERS launches of the forward's layer GEMM, as in a step.
    The SM clock is read just before each timed launch (torch.cuda._sleep
    of 400,000 cycles timed with CUDA events), and each time is printed
    beside it and its cycles (ms x GHz); medians of five turns, the two
    calls alternating. Nothing waits between the neighbour and the timed
    call, so the wrapper's host work runs while the card is busy with the
    neighbour and the card never idles before the timed launch."""
    import statistics

    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import fused_wide as fw

    bundle = seeded_bundle(paper_hparams(WIDE_TRAIN), 16, False, 61, device)
    packed = fused_mlp.pack_params(bundle.module)
    plan = ftw.check_plan(packed)
    job = next(job for kind, job in plan.steps if kind == "dw" and job[0].d == "g_pre2")
    d = packed.config.layer_dim
    gen = torch.Generator(device=device).manual_seed(62)
    out = torch.empty(plan.total, device=device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    rows = {}
    with torch.no_grad():
        for label, m in WIDE_PASSES:
            h1 = torch.relu(torch.randn((m, d), generator=gen, device=device)).to(torch.bfloat16)
            gp = (torch.randn((m, d), generator=gen, device=device) * 1e-2).to(torch.bfloat16)
            tensors = {"g_pre2": gp, "h1": h1}
            kw, _ = mm_f32(gp.T, h1)
            calls = {"train_wide_dw": lambda: ftw.train_wide_dw(job, tensors, out),
                     "torch.mm": lambda: torch.mm(gp.T, h1, **kw)}
            got = {k: [] for k in calls}
            for turn in range(10):
                name = list(calls)[turn % 2]
                for _ in range(NEIGHBOUR_LAYERS):
                    fw.eval_wide_layer([h1], packed.mats[2], packed.biases[2], True)
                ev[0].record()
                torch.cuda._sleep(400_000)
                ev[1].record()
                ev[2].record()
                calls[name]()
                ev[3].record()
                torch.cuda.synchronize()
                got[name].append((ev[2].elapsed_time(ev[3]),
                                  400_000 / (ev[0].elapsed_time(ev[1]) * 1e6)))
            row = {}
            for name, v in got.items():
                ms = statistics.median(t for t, _ in v)
                ghz = statistics.median(g for _, g in v)
                row[name] = {"ms": ms, "ghz": ghz, "mcycles": ms * ghz}
            rows[f"{label} {m}"] = row
            k, lib = row["train_wide_dw"], row["torch.mm"]
            log(f"  train_wide_dw after {NEIGHBOUR_LAYERS} layer GEMMs, 1024 x 1024 trunk "
                f"job, {label} ({m} points): {k['ms']:.3f} ms at {k['ghz']:.2f} GHz = "
                f"{k['mcycles']:.3f} M cycles; torch.mm (f32 out, no bias sums) in the same "
                f"position {lib['ms']:.3f} ms at {lib['ghz']:.2f} GHz = {lib['mcycles']:.3f} "
                f"M cycles (the kernel takes {k['ms'] / lib['ms']:.2f}x its time, "
                f"{k['mcycles'] / lib['mcycles']:.2f}x its cycles)")
            del h1, gp, tensors
    report["training_wide"]["dw_beside_layers"] = rows
    torch.cuda.empty_cache()


def phase_time_train_wide(device, report, tmp: Path):
    """ms per 1024-ray step and train rays/s at fg and bg 8x1024 over 20
    chained steps (from train_wide's checkpoint, on the train phase's
    batches), peak device memory, a 5-step torch.profiler breakdown by
    kernel, then each kernel per launch at the fg-fine shape."""
    import torch

    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner

    saved = train_wide_counters()
    runner = Runner(train_hparams(tmp / "train_dataset", tmp / "unused_wide", WIDE_TRAIN),
                    set_experiment_path=False)
    runner._load_weights(report["wide_train_ckpt"])
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(runner.hparams),
                     5e-4, 0.1, TRAIN_WIDE_STEPS, runner.sphere_center,
                     runner.sphere_radius)
    batches = report["train_batches"]
    for b in batches[:5]:  # warm-up
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 20
    t0 = time.perf_counter()
    for b in batches[5:5 + n]:
        step(b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    flops = sum((2 * fused_mlp.flops_per_point(c) + dx_flops_per_point(c)) * pts for c, pts in (
        (runner.fg.config, 1024 * 768), (runner.bg.config, 1024 * 384)))
    step_bound = flops / PEAK_BF16_FLOPS * 1e3
    report["training_wide"].update(step_ms=step_ms, rays_per_s=1024 / step_ms * 1e3,
                                   peak_mem_gb=peak, step_bound_ms=step_bound)
    log(f"  wide training path: {step_ms:.2f} ms/step over {n} chained steps = "
        f"{1024 / step_ms * 1e3:.1f} rays/s (fg + bg 8x1024, batch 1024, 256 + 512 "
        f"samples); peak device memory allocated {peak:.2f} GB; MLP bound "
        f"{step_bound:.2f} ms/step ({flops:.4g} FLOP)")
    rows, busy, wall_ms = kernel_times(lambda: [step(b) for b in batches[25:30]], 5)
    if rows:
        log(f"  profiler over 5 steps: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
            f"wall ({100 * busy / wall_ms:.1f}%); per step by kernel:")
        for ms, count, name in rows[:12]:
            log(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
        log(f"    {sum(r[0] for r in rows[12:]):8.3f} ms  in {len(rows) - 12} other kernels")
        report["training_wide"]["profiled_device_busy_share"] = busy / wall_ms
        dw_ms = sum(ms for ms, _, name in rows if "train_wide_dw_kernel" in name)
        dw_n = sum(count for _, count, name in rows if "train_wide_dw_kernel" in name)
        dw_flops, dw_bound = step_dw_work(runner.fg.config, runner.bg.config)
        log(f"  train_wide_dw per step (profile): {dw_ms:.3f} ms device time over {dw_n} "
            f"launches; the step's dW products {dw_flops:.4g} FLOP = "
            f"{dw_flops / dw_ms / 1e9:.1f} TFLOP/s; bound {dw_bound:.3f} ms (each launch "
            f"the larger of its FLOP at 989 TFLOP/s and its bytes at 3.35 TB/s)")
        report["training_wide"].update(dw_ms_per_step=dw_ms, dw_launches_per_step=dw_n,
                                       dw_flop_per_step=dw_flops,
                                       dw_bound_ms_per_step=dw_bound)
        enc_ms = sum(ms for ms, _, name in rows if "eval_wide_encode_kernel" in name)
        enc_n = sum(count for _, count, name in rows if "eval_wide_encode_kernel" in name)
        log(f"  eval_wide_encode per step (profile): {enc_ms:.3f} ms device time over "
            f"{enc_n} launches")
        report["training_wide"]["encode_ms_per_step"] = enc_ms
    else:
        log("  profiler: no device time recorded (device share not measured)")
    report["wide_runner"] = runner
    del step
    torch.cuda.empty_cache()
    time_train_wide_kernels(device, report)
    time_dw_beside_layers(device, report)
    # Timing launches are not main-path launches.
    for k in TRAIN_WIDE_KERNELS:
        getattr(ftw, k).launches = saved[k]
    return True


def phase_eager_train_wide(device, report, tmp: Path):
    """A record, not a check: training steps at fg and bg 8x1024 through the
    eager module (`--no_pallas`), the route the port took for this model
    before the wide training route: ms/step and peak device memory, or its
    out-of-memory error."""
    import copy

    import numpy as np
    import torch

    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    runner = report["wide_runner"]
    hp = copy.copy(runner.hparams)
    hp.use_fused_kernel = False
    # The weights these steps start from, for the same steps with --remat.
    report["eager_wide_start"] = [
        {k: v.to("cpu", copy=True) for k, v in b.module.state_dict().items()}
        for b in (runner.fg, runner.bg)]
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(hp), 5e-4, 0.1,
                     TRAIN_WIDE_STEPS, runner.sphere_center, runner.sphere_radius)
    batches = report["train_batches"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = []
    with EagerCalls() as eager_calls:
        try:
            for b in batches[:2]:  # warm-up
                losses.append(step(b)["loss"])
            torch.cuda.synchronize()
            n = 5
            t0 = time.perf_counter()
            for b in batches[2:2 + n]:
                losses.append(step(b)["loss"])
            torch.cuda.synchronize()
        except torch.cuda.OutOfMemoryError as e:
            wall = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            first = str(e).splitlines()[0] if str(e) else repr(e)
            log(f"  eager module (--no_pallas) training at {hp.layer_dim}/{hp.bg_layer_dim}: "
                f"out of device "
                f"memory after {len(losses)} steps, {eager_calls.count} module calls "
                f"(peak allocated {peak:.2f} GB): {first}")
            report["training_wide"]["eager"] = {"error": first, "peak_mem_gb": peak}
            return True
    step_ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss = torch.stack(losses).float().cpu().numpy()
    log(f"  eager module (--no_pallas) training at {hp.layer_dim}/{hp.bg_layer_dim}: "
        f"{step_ms:.2f} ms/step over "
        f"{n} chained steps = {1024 / step_ms * 1e3:.1f} rays/s; peak device memory "
        f"allocated {peak:.2f} GB; {eager_calls.count} module calls; loss {loss[-1]:.5f}")
    report["training_wide"]["eager"] = {"step_ms": step_ms, "peak_mem_gb": peak,
                                        "rays_per_s": 1024 / step_ms * 1e3,
                                        "steps": len(losses), "loss_last": float(loss[-1])}
    return bool(np.isfinite(loss).all() and eager_calls.count > 0)


def phase_remat(device, report, tmp: Path):
    """`--remat` on the eager module: eager_train_wide's steps (fg and bg
    8x1024, the same batches, from the same weights, a fresh Adam) again
    with `--remat`, which recomputes each eager MLP pass's activations in
    the backward pass (torch.utils.checkpoint). Prints peak device memory
    and ms a step beside the run without it; fails unless every MLP pass
    was checkpointed, no kernel launched, the peak is lower and the loss
    after the steps agrees within 1e-5."""
    import copy

    import numpy as np
    import torch
    import torch.utils.checkpoint

    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    runner = report.pop("wide_runner")
    base = report["training_wide"]["eager"]
    if "loss_last" not in base:
        log(f"  the run without --remat did not finish ({base}); nothing to compare")
        return False
    for bundle, state in zip((runner.fg, runner.bg), report.pop("eager_wide_start")):
        bundle.module.load_state_dict(state)
    hp = copy.copy(runner.hparams)
    hp.use_fused_kernel, hp.remat = False, True
    settings = RenderSettings.from_hparams(hp)
    step = TrainStep(runner.fg, runner.bg, settings, 5e-4, 0.1, TRAIN_WIDE_STEPS,
                     runner.sphere_center, runner.sphere_radius)
    batches = report["train_batches"]
    real, checkpoints = torch.utils.checkpoint.checkpoint, [0]

    def counting(*args, **kwargs):
        checkpoints[0] += 1
        return real(*args, **kwargs)

    torch.utils.checkpoint.checkpoint = counting
    before = all_launches()
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses = [step(b)["loss"] for b in batches[:2]]  # warm-up, as without
        torch.cuda.synchronize()
        n = base["steps"] - 2
        t0 = time.perf_counter()
        losses += [step(b)["loss"] for b in batches[2:2 + n]]
        torch.cuda.synchronize()
    finally:
        torch.utils.checkpoint.checkpoint = real
    step_ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    loss = float(losses[-1])
    diff = abs(loss - base["loss_last"])
    log(f"  eager module at {hp.layer_dim}/{hp.bg_layer_dim}, {len(losses)} steps: with "
        f"--remat {step_ms:.2f} ms/step, peak device memory allocated {peak:.2f} GB; "
        f"without {base['step_ms']:.2f} ms/step, {base['peak_mem_gb']:.2f} GB; loss after "
        f"the steps {loss:.7f} vs {base['loss_last']:.7f} (|diff| {diff:.3e}); "
        f"{checkpoints[0]} checkpointed MLP passes")
    report["remat"] = {"layer_dim": hp.layer_dim, "bg_layer_dim": hp.bg_layer_dim,
                       "steps": len(losses), "step_ms": step_ms, "peak_mem_gb": peak,
                       "no_remat_step_ms": base["step_ms"],
                       "no_remat_peak_mem_gb": base["peak_mem_gb"], "loss_last": loss,
                       "loss_diff": diff, "checkpointed_passes": checkpoints[0]}
    return bool(np.isfinite(loss) and diff <= 1e-5 and peak < base["peak_mem_gb"]
                and checkpoints[0] == 4 * len(losses) and all_launches() == before)


CASCADE_SERVE = "npp/building.yaml"  # cascade, fg and bg 8x2048, no appearance
CASCADE_TRAIN = "mega-nerf-embed-only/building.yaml"  # cascade, appearance, no bg
SH_TRAIN = "mega-nerf-sh-3/building.yaml"  # SH degree 2, no view dirs, 8x256
LEVELS = ("fg coarse", "fg fine", "bg coarse", "bg fine")
CASCADE_TRAIN_STEPS = 20
SH_TRAIN_STEPS = 10
TRAIN_ARGS = ["--dataset_type", "memory", "--batch_size", "1024", "--lr", "5e-4",
              "--lr_decay_factor", "0.1", "--ckpt_interval", "100000",
              "--val_interval", "100000"]


def config_hparams(get_opts, config: str, ds: Path, exp: Path, extra=()):
    """The hparams of a file of `configs/` on a generated dataset, on cuda
    (the dataset's altitude range and near bound, val views at full size)."""
    return get_opts(["--config_file", str(ROOT / "configs" / config),
                     "--dataset_path", str(ds), "--exp_name", str(exp),
                     "--device", "cuda", "--ray_altitude_range", "-1.3", "0.6",
                     "--near", "0.05", "--val_scale_factor", "1", *extra])


def all_launches() -> int:
    """Launches of every kernel of the port so far."""
    counts = train_wide_counters()
    return (sum(counts[k] for k in TRAIN_WIDE_KERNELS + WIDE_KERNELS) + counts["narrow"]
            + sum(f32_launches().values()))


class LevelLaunches:
    """While open, the wide eval kernels' launches by level ("fg coarse",
    ...): each call of the renderer's wide eval wrapper is attributed to the
    level whose packed weights `rendering.packed_params` handed out; `packs`
    holds the identities of each level's packed weights."""

    def __enter__(self):
        from mega_nerf_tpu_torch.render import rendering

        self.counts, self.packs, owner = {}, {}, {}
        self._saved = packed_params, eval_wide = (rendering.packed_params,
                                                  rendering.fused_nerf_eval_wide)

        def recording_packed(bundle, typ, sub=None):
            packed = packed_params(bundle, typ, sub)
            level = f"{'bg' if bundle.config.xyz_dim == 4 else 'fg'} {typ}"
            owner[id(packed)] = level
            self.packs.setdefault(level, set()).add(id(packed))
            return packed

        def recording_eval_wide(packed, *args):
            before = wide_counters()
            out = eval_wide(packed, *args)
            after = wide_counters()
            level = self.counts.setdefault(owner[id(packed)], dict.fromkeys(WIDE_KERNELS, 0))
            for k in WIDE_KERNELS:
                level[k] += after[k] - before[k]
            return out

        rendering.packed_params = recording_packed
        rendering.fused_nerf_eval_wide = recording_eval_wide
        return self

    def __exit__(self, *exc):
        from mega_nerf_tpu_torch.render import rendering

        rendering.packed_params, rendering.fused_nerf_eval_wide = self._saved


def phase_serve_cascade(device, report, tmp: Path):
    """The serving path of a cascade family at its full width:
    `eval.main` on cuda with `configs/npp/building.yaml` (coarse and fine
    NeRFs, fg and bg 8x2048, no appearance, no ellipse bounds) and seeded
    random weights for every level, on the serve phase's 128x128 view.
    Checks finite PSNR/SSIM, launches of every wide eval kernel for each
    of the four levels (fg/bg, coarse/fine), each level on its own packed
    weights, no narrow eval launch, no eager-module or plain call; the two
    levels' MLPs give different outputs on the same points; 1,024 rays
    rendered again through the wide plain version agree on the fine and
    the coarse rgb (<= 1e-2). Prints s/view, rays/s, peak device memory
    and the view's device time by kernel."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch.ops.rays import generate_image_rays
    from mega_nerf_tpu_torch.render import fused_wide as fw
    from mega_nerf_tpu_torch.render import rendering
    from mega_nerf_tpu_torch.runtime.runner import Runner

    ds = tmp / "dataset"
    if not (ds / "coordinates.pt").exists():
        write_dataset(ds, hw=128, n_train=4, seed=7)
    hp = config_hparams(port_eval.get_eval_opts, CASCADE_SERVE, ds, tmp / "exp_cascade")
    fg = seeded_bundle(hp, 5, False, 51, "cpu")
    bg = seeded_bundle(hp, 5, True, 52, "cpu")
    ckpt = tmp / "cascade.pt"
    torch.save({"model_state_dict": fg.module.state_dict(),
                "bg_model_state_dict": bg.module.state_dict(),
                "iteration": 0}, ckpt)
    hp.ckpt_path = str(ckpt)
    del fg, bg

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_wide_counters()
    t0 = time.perf_counter()
    with EagerCalls() as eager_calls, LevelLaunches() as levels:
        metrics = port_eval.main(hp)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    counts = wide_counters()
    by_level = levels.counts
    log(f"  eval.main with {CASCADE_SERVE} (cascade, {hp.layer_dim}/{hp.bg_layer_dim}, "
        f"{hp.coarse_samples} + {hp.fine_samples} samples): {metrics} in {wall:.2f} s; "
        f"peak device memory allocated {peak:.2f} GB; launches {counts}; by level "
        f"{by_level}; eager module calls {eager_calls.count}")
    own_packs = all(levels.packs.get(f"{side} coarse", set()).isdisjoint(
        levels.packs.get(f"{side} fine", set())) for side in ("fg", "bg"))
    ok = (all(np.isfinite(v) for v in metrics.values())
          and {"val/psnr", "val/ssim"} <= set(metrics)
          and set(by_level) == set(LEVELS) and own_packs
          and all(by_level[lv][k] > 0 for lv in LEVELS for k in WIDE_KERNELS)
          and all(sum(by_level[lv][k] for lv in LEVELS) == counts[k] for k in WIDE_KERNELS)
          and counts["fused_nerf_eval"] == 0 and counts["plain"] == 0
          and eager_calls.count == 0)
    report["serving_cascade"] = {
        "config": CASCADE_SERVE, "eval_main_s": wall, "peak_mem_gb": peak,
        "metrics": metrics, "launches_by_level": by_level,
        "eager_calls": eager_calls.count}

    hp.exp_name = str(tmp / "exp_cascade_cmp")
    runner = Runner(hp, set_experiment_path=False)
    runner.make_eval_state()
    meta = runner.val_items[0]
    runner.render_image(meta)  # warm: packs both levels' weights
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        runner.render_image(meta)
    torch.cuda.synchronize()
    s_view = (time.perf_counter() - t0) / reps
    view_peak = torch.cuda.max_memory_allocated() / 1e9
    n_rays = meta.W * meta.H
    c, f = hp.coarse_samples, hp.fine_samples  # the fine level sees c + f a ray
    points = n_rays * ((c + c + f) + (c // 2 + c // 2 + f // 2))
    log(f"  cascade serving path: {meta.W}x{meta.H} view, {s_view:.4f} s/view, "
        f"{n_rays / s_view:.1f} rays/s, {points:,} MLP points a view; peak device "
        f"memory allocated {view_peak:.2f} GB")
    report["serving_cascade"].update(s_per_view=s_view, rays_per_s=n_rays / s_view,
                                     view_peak_mem_gb=view_peak, mlp_points=points)
    profile_dense_view(runner, meta, report, "serving_cascade", "cascade")

    # The levels' MLPs on the same points: different weights, other outputs.
    cfg = runner.fg.config
    xyz, dirs, _ = mlp_inputs(cfg, 65_536, 53, device)
    with torch.no_grad():
        outs = [fw.fused_nerf_eval_wide(rendering.packed_params(runner.fg, typ), xyz, dirs)
                for typ in ("coarse", "fine")]
    level_diff = close_ratio(outs[0], outs[1])

    # Some rays again, wide kernels vs the wide plain version.
    rays = generate_image_rays(meta, runner.near, runner.far, runner.ray_altitude_range,
                               True, device=device)[:DENSE_CMP_RAYS]
    args = (runner.fg, runner.bg, rays, None, runner.render_settings(),
            runner.sphere_center, runner.sphere_radius)
    with torch.no_grad():
        kern, _ = rendering.render_rays(*args)
        saved = rendering.fused_nerf_eval_wide
        rendering.fused_nerf_eval_wide = fw.fused_nerf_eval_wide_plain
        try:
            plain, _ = rendering.render_rays(*args)
        finally:
            rendering.fused_nerf_eval_wide = saved
    diffs = {key: (kern[key] - plain[key]).abs().max().item()
             for key in ("rgb_fine", "rgb_coarse")}
    log(f"  {DENSE_CMP_RAYS} rays, wide kernels vs the wide plain version: rgb_fine "
        f"max|diff|={diffs['rgb_fine']:.3e}, rgb_coarse max|diff|="
        f"{diffs['rgb_coarse']:.3e}; the fg levels' MLPs on 65,536 points: "
        f"max|coarse - fine|/(1+|fine|)={level_diff:.3e}")
    report["serving_cascade"].update(render_rgb_diff=diffs, level_rgb_diff=level_diff)
    ok = (ok and max(diffs.values()) <= TOL and level_diff > TOL
          and all(bool(torch.isfinite(kern[k]).all()) for k in diffs))
    report["cascade_runner"] = runner
    return bool(ok)


def phase_train_cascade(device, report, tmp: Path):
    """Training a cascade family through the wide training kernels:
    `train.main` on cuda with `configs/mega-nerf-embed-only/building.yaml`
    (coarse and fine 8x NeRFs with appearance, no bg) cut to `--layer_dim
    1024`, the widest the training gates take through kernels, for
    CASCADE_TRAIN_STEPS steps on the train phase's dataset. Checks finite
    metrics with a `coarse_loss`, a falling loss, the wide route named for
    both levels, each level's launches per step as its plan says (the
    coarse pass 262,144 points, the fine one 786,432), every pass size held
    against the plain versions in compare_train_wide, no narrow, plain or
    eager-module call; `eval.main` on the written `{iter}.pt`; then ms per
    step over chained steps and their peak device memory."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.models import nerf_config_from_hparams
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import rendering
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner

    ds = tmp / "train_dataset"
    width = ["--layer_dim", "1024"]
    hp = config_hparams(port_train.get_train_opts, CASCADE_TRAIN, ds,
                        tmp / "train_cascade_exp",
                        [*TRAIN_ARGS, "--train_iterations", str(CASCADE_TRAIN_STEPS), *width])
    cfg = nerf_config_from_hparams(hp, 1, hp.layer_dim, 3)
    per_level = wide_step_launches([cfg])
    level_points = {hp.batch_size * hp.coarse_samples: "coarse",
                    hp.batch_size * (hp.coarse_samples + hp.fine_samples): "fine"}
    by_level = {lv: dict.fromkeys(per_level, 0) for lv in level_points.values()}
    routes, snaps, passes = [], [], set()
    log_path, step_call = rendering._log_mlp_path, TrainStep.__call__
    wide_fwd, wide_bwd = ftw.fused_nerf_train_wide_fwd, ftw.fused_nerf_train_wide_bwd

    def counted(fn, m, *args):
        before = train_wide_counters()
        out = fn(*args)
        after = train_wide_counters()
        level = by_level.setdefault(level_points.get(m, f"{m} points"),
                                    dict.fromkeys(per_level, 0))
        for k in per_level:
            level[k] += after[k] - before[k]
        return out

    def recording_fwd(packed, xyz, *args):
        passes.add((packed.config.xyz_dim == 4, xyz.shape[0]))
        return counted(wide_fwd, xyz.shape[0], packed, xyz, *args)

    def recording_bwd(packed, saved, g):
        return counted(wide_bwd, g.shape[0], packed, saved, g)

    def recording_log(message):
        routes.append(message)
        log_path(message)

    def recording_call(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        snaps.append((metrics, train_wide_counters()))
        return metrics

    rendering._log_mlp_path, TrainStep.__call__ = recording_log, recording_call
    ftw.fused_nerf_train_wide_fwd, ftw.fused_nerf_train_wide_bwd = recording_fwd, recording_bwd
    zero_train_wide_counters()
    t0 = time.perf_counter()
    try:
        with EagerCalls() as eager_calls:
            val = port_train.main(hp)
            torch.cuda.synchronize()
    finally:
        rendering._log_mlp_path, TrainStep.__call__ = log_path, step_call
        ftw.fused_nerf_train_wide_fwd, ftw.fused_nerf_train_wide_bwd = wide_fwd, wide_bwd
    wall = time.perf_counter() - t0
    after = train_wide_counters()
    counts = snaps[-1][1]  # after the last step, before the final validation
    metrics = {k: torch.stack([m[k] for m, _ in snaps]).float().cpu().numpy()
               for k in snaps[0][0]}
    loss = metrics["loss"]
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    train_routes = sorted({r for r in routes if "/train]" in r})
    steps = len(snaps)
    log(f"  train.main with {CASCADE_TRAIN} at --layer_dim {hp.layer_dim}: {steps} steps "
        f"+ final validation in {wall:.2f} s; loss first 5 {first:.5f} -> last 5 "
        f"{last:.5f}, coarse_loss {metrics['coarse_loss'][0]:.5f} -> "
        f"{metrics['coarse_loss'][-1]:.5f}; val {val}; launches after the steps {counts}; "
        f"by level (fwd + bwd) {by_level} (per level and step expected {per_level}); "
        f"after validation {after}; eager module calls {eager_calls.count}; (bg, points) "
        f"of the passes {sorted(passes)}, each held against the plain versions in "
        f"compare_train_wide: {passes <= report['train_wide_compared']}")
    for r in train_routes:
        log(f"    {r}")
    ok = (steps == CASCADE_TRAIN_STEPS and "coarse_loss" in metrics
          and all(np.isfinite(v).all() for k, v in metrics.items() if k != "psnr")
          and last < first and all(np.isfinite(v) for v in val.values())
          and len(train_routes) == 2
          and all("fused train (wide kernel)" in r for r in train_routes)
          and set(by_level) == {"coarse", "fine"}
          and all(by_level[lv][k] == steps * n for lv in by_level
                  for k, n in per_level.items())
          and all(counts[k] == 2 * steps * n for k, n in per_level.items())
          and passes <= report["train_wide_compared"]
          and counts["eval_wide_heads"] == 0 and after["narrow"] == 0
          and after["plain"] == 0 and eager_calls.count == 0)

    ckpt = tmp / "train_cascade_exp" / "0" / "models" / f"{CASCADE_TRAIN_STEPS}.pt"
    e_hp = config_hparams(port_eval.get_eval_opts, CASCADE_TRAIN, ds,
                          tmp / "train_cascade_eval", [*width, "--ckpt_path", str(ckpt)])
    zero_wide_counters()
    with EagerCalls() as eval_eager:
        e_metrics = port_eval.main(e_hp)
    e_counts = wide_counters()
    log(f"  eval.main on {ckpt.name}: {e_metrics}; launches {e_counts}")
    ok = (ok and ckpt.exists() and np.isfinite(e_metrics["val/psnr"])
          and all(e_counts[k] > 0 for k in WIDE_KERNELS) and e_counts["plain"] == 0
          and eval_eager.count == 0)

    # ms per step over chained steps from the trained weights.
    runner = Runner(config_hparams(port_train.get_train_opts, CASCADE_TRAIN, ds,
                                   tmp / "unused", [*TRAIN_ARGS, *width]),
                    set_experiment_path=False)
    runner._load_weights(ckpt)
    step = TrainStep(runner.fg, None, RenderSettings.from_hparams(runner.hparams), 5e-4,
                     0.1, CASCADE_TRAIN_STEPS)
    batches = report["train_batches"]
    for b in batches[:2]:
        step(b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 10
    t0 = time.perf_counter()
    for b in batches[2:2 + n]:
        step(b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  cascade training step at {hp.layer_dim}: {step_ms:.2f} ms/step over {n} "
        f"chained steps = {hp.batch_size / step_ms * 1e3:.1f} rays/s; peak device memory "
        f"allocated {peak:.2f} GB")
    report["training_cascade"] = {
        "config": CASCADE_TRAIN, "layer_dim": hp.layer_dim, "steps": steps,
        "loss_first5": first, "loss_last5": last,
        "coarse_loss_last": float(metrics["coarse_loss"][-1]),
        "val_psnr": val.get("val/psnr"), "ckpt_eval_psnr": e_metrics["val/psnr"],
        "launches_per_level_step": per_level, "launches_by_level": by_level,
        "train_main_s": wall, "step_ms": step_ms, "rays_per_s": hp.batch_size / step_ms * 1e3,
        "peak_mem_gb": peak}
    del step, runner
    torch.cuda.empty_cache()
    return bool(ok)


def phase_train_sh(device, report, tmp: Path):
    """The SH head's family at its paper width: SH_TRAIN_STEPS steps of
    `train.main` on cuda with `configs/mega-nerf-sh-3/building.yaml` (SH
    degree 2, no view dirs, fg + bg 8x256) and `eval.main` on its
    `{iter}.pt`. The kernels have the rgb head only, so this is the eager
    module, which the log must name for every pass. Checks finite metrics
    and no kernel launch; ms per step from the steps after the first (each
    followed by a synchronize)."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import rendering

    ds = tmp / "train_dataset"
    hp = config_hparams(port_train.get_train_opts, SH_TRAIN, ds, tmp / "train_sh_exp",
                        [*TRAIN_ARGS, "--train_iterations", str(SH_TRAIN_STEPS)])
    routes, snaps, ends = [], [], []
    log_path, step_call = rendering._log_mlp_path, TrainStep.__call__

    def recording_log(message):
        routes.append(message)
        log_path(message)

    def recording_call(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        snaps.append(metrics)
        return metrics

    rendering._log_mlp_path, TrainStep.__call__ = recording_log, recording_call
    zero_train_wide_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with EagerCalls() as eager_calls:
            val = port_train.main(hp)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        ckpt = tmp / "train_sh_exp" / "0" / "models" / f"{SH_TRAIN_STEPS}.pt"
        e_hp = config_hparams(port_eval.get_eval_opts, SH_TRAIN, ds, tmp / "train_sh_eval",
                              ["--ckpt_path", str(ckpt)])
        e_metrics = port_eval.main(e_hp)
    finally:
        rendering._log_mlp_path, TrainStep.__call__ = log_path, step_call
    launches = all_launches()
    plain = train_wide_counters()["plain"]
    metrics = {k: torch.stack([m[k] for m in snaps]).float().cpu().numpy()
               for k in snaps[0]}
    kinds = sorted(set(routes))
    step_ms = (ends[-1] - ends[0]) / (len(ends) - 1) * 1e3
    log(f"  train.main with {SH_TRAIN} ({hp.layer_dim}/{hp.bg_layer_dim}, sh_deg "
        f"{hp.sh_deg}): {len(snaps)} steps + final validation in {wall:.2f} s, "
        f"{step_ms:.2f} ms/step after the first, peak device memory allocated "
        f"{peak:.2f} GB; loss {metrics['loss'][0]:.5f} -> "
        f"{metrics['loss'][-1]:.5f}; val {val}; eval.main on {ckpt.name}: {e_metrics}; "
        f"kernel launches {launches}, plain calls {plain}, eager module calls "
        f"{eager_calls.count}")
    for r in kinds:
        log(f"    {r}")
    report["training_sh"] = {
        "config": SH_TRAIN, "steps": len(snaps), "loss_first": float(metrics["loss"][0]),
        "loss_last": float(metrics["loss"][-1]), "val_psnr": val.get("val/psnr"),
        "ckpt_eval_psnr": e_metrics["val/psnr"], "train_main_s": wall,
        "step_ms": step_ms, "peak_mem_gb": peak, "eager_calls": eager_calls.count}
    return bool(len(snaps) == SH_TRAIN_STEPS
                and all(np.isfinite(v).all() for k, v in metrics.items() if k != "psnr")
                and all(np.isfinite(v) for v in val.values())
                and np.isfinite(e_metrics["val/psnr"])
                and len(kinds) == 8  # fg/bg x coarse/fine x train/eval
                and all("eager NeRF module (SH output head)" in r for r in kinds)
                and launches == 0 and plain == 0 and eager_calls.count > 0)


# ------------------------------------------------------------ resume_jax

RESUME_JAX_AT = 10  # the step the JAX-format checkpoint is written at
RESUME_JAX_STEPS = 20  # ... and the step both resumed runs end at
MAX_EXT_ARRAY = 1 << 30  # flax splits arrays past this many bytes into chunks


def msgpack_encode(obj) -> bytes:
    """msgpack of what a flax train state serialises to: maps with string
    keys, None, and numpy arrays as flax writes them (ext type 1: msgpack of
    (shape, dtype name, C-order bytes), so also lists, non-negative ints and
    bytes). A numpy scalar is written as a 0-d array, as flax writes a jax
    scalar."""
    import numpy as np

    out = bytearray()

    def length(n: int, small, tags) -> None:
        """A fix-format tag holding n (`small`: (bound, tag bits)), else
        the first of `tags` (bound, tag, struct format) that holds it."""
        if small is not None and n < small[0]:
            out.append(small[1] | n)
            return
        for limit, tag, fmt in tags:
            if n < limit:
                out.append(tag)
                out.extend(struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack: length {n} too large")

    def enc(x) -> None:
        if x is None:
            out.append(0xc0)
        elif isinstance(x, (np.ndarray, np.generic)):
            a = np.asarray(x)  # (ascontiguousarray would make a 0-d array 1-d)
            if a.nbytes >= MAX_EXT_ARRAY:
                raise ValueError(f"an array of {a.nbytes} bytes: flax would chunk it")
            payload = msgpack_encode([list(a.shape), a.dtype.name, a.tobytes("C")])
            n = len(payload)
            fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
            if n in fixext:
                out.append(fixext[n])
            else:
                length(n, None, ((1 << 8, 0xc7, ">B"), (1 << 16, 0xc8, ">H"),
                                 (1 << 32, 0xc9, ">I")))
            out.append(1)
            out.extend(payload)
        elif isinstance(x, int) and x >= 0:
            length(x, (128, 0x00), ((1 << 8, 0xcc, ">B"), (1 << 16, 0xcd, ">H"),
                                    (1 << 32, 0xce, ">I"), (1 << 64, 0xcf, ">Q")))
        elif isinstance(x, str):
            data = x.encode("utf-8")
            length(len(data), (32, 0xa0), ((1 << 8, 0xd9, ">B"), (1 << 16, 0xda, ">H"),
                                           (1 << 32, 0xdb, ">I")))
            out.extend(data)
        elif isinstance(x, (bytes, bytearray)):
            length(len(x), None, ((1 << 8, 0xc4, ">B"), (1 << 16, 0xc5, ">H"),
                                  (1 << 32, 0xc6, ">I")))
            out.extend(x)
        elif isinstance(x, (list, tuple)):
            length(len(x), (16, 0x90), ((1 << 16, 0xdc, ">H"), (1 << 32, 0xdd, ">I")))
            for item in x:
                enc(item)
        elif isinstance(x, dict):
            length(len(x), (16, 0x80), ((1 << 16, 0xde, ">H"), (1 << 32, 0xdf, ">I")))
            for k, v in x.items():
                enc(k)
                enc(v)
        else:
            raise TypeError(f"msgpack: cannot encode {type(x).__name__}")

    enc(obj)
    return bytes(out)


def write_jax_checkpoint(path: Path, tree: dict, aux: dict) -> Path:
    """The JAX package's `.ckpt` (`MNTPU001`, a `<QQ` header of the two
    payload lengths, the flax msgpack tree, the pickled aux), written
    without jax, flax or msgpack: the card's machine has none of them."""
    import pickle

    packed = msgpack_encode(tree)
    aux_bytes = pickle.dumps(aux)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"MNTPU001")
        f.write(struct.pack("<QQ", len(packed), len(aux_bytes)))
        f.write(packed)
        f.write(aux_bytes)
    return path


def jax_train_state_tree(loaded: dict, fg, bg, key) -> dict:
    """A port `{iter}.pt` (as loaded) of a single fg + bg model -> the
    JAX package's TrainState as flax serialises it: `step`, `key`, each
    side's params and its optax `adam(exponential_decay)` state
    `{"0": {count, mu, nu}, "1": {count}}`, the count its own Adam step.
    `fg` / `bg` give the configs and the parameter order of the saved
    Adam states."""
    import numpy as np

    from mega_nerf_tpu_torch.models.weights import flax_params_from_state

    tree = {"step": np.asarray(loaded["iteration"], np.int32),
            "key": np.asarray(key, np.uint32)}
    for side, bundle, state_key, opt_key in (
            ("fg", fg, "model_state_dict", "nerf"),
            ("bg", bg, "bg_model_state_dict", "bg_nerf")):
        names = [name for name, _ in bundle.module.named_parameters()]
        entries = loaded["optimizers"][opt_key]["state"]
        count = np.asarray(int(entries[0]["step"]) if entries else 0, np.int32)

        def moments(m, names=names, entries=entries, bundle=bundle):
            return flax_params_from_state(
                bundle.config, {n: entries[i][m] for i, n in enumerate(names)})

        tree[f"{side}_params"] = flax_params_from_state(bundle.config, loaded[state_key])
        tree[f"{side}_opt"] = {"0": {"count": count, "mu": moments("exp_avg"),
                                     "nu": moments("exp_avg_sq")},
                               "1": {"count": count}}
    return tree


def state_dicts_equal(a: dict, b: dict) -> bool:
    """Two `{iter}.pt` dicts hold bit-equal weights, Adam states (moments,
    steps, hyperparameters) and stream positions."""
    import torch

    def same(x, y) -> bool:
        if isinstance(x, torch.Tensor):
            return (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and torch.equal(x, y))
        if isinstance(x, dict):
            return (isinstance(y, dict) and x.keys() == y.keys()
                    and all(same(x[k], y[k]) for k in x))
        if isinstance(x, (list, tuple)):
            return (isinstance(y, (list, tuple)) and len(x) == len(y)
                    and all(same(p, q) for p, q in zip(x, y)))
        return x == y

    keys = ("model_state_dict", "bg_model_state_dict", "optimizers", "dataset_state",
            "iteration")
    return all(same(a[k], b[k]) for k in keys)


def phase_resume_jax(device, report, tmp: Path):
    """A paper-width run moved from the JAX package's `.ckpt`: `train.main`
    for 20 steps (a checkpoint at 10); its step-10 state written as the JAX
    package's `10.ckpt` (this script's own writer) and as a `10.pt` whose
    generator state is a fresh run's (a `.ckpt` holds no torch generator);
    each resumed to 20 by `train.main` and evaluated by `eval.main`."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.models import make_bg_nerf, make_nerf
    from mega_nerf_tpu_torch.parallel.distributed import rank_seed
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep, adam_steps
    from mega_nerf_tpu_torch.runtime.checkpoints import load_checkpoint

    t_phase = time.perf_counter()
    ds = tmp / "train_dataset"  # phase_train's scene
    if not ds.exists():
        write_dataset(ds, hw=128, n_train=4, seed=11, smooth=True)
    steps = ["--train_iterations", str(RESUME_JAX_STEPS)]
    hp = train_hparams(ds, tmp / "rj_first", steps + ["--ckpt_interval", str(RESUME_JAX_AT)])
    port_train.main(hp)
    loaded = load_checkpoint(tmp / "rj_first" / "0" / "models" / f"{RESUME_JAX_AT}.pt")
    count = int(loaded["model_state_dict"]["embedding_a.weight"].shape[0])
    with torch.device("meta"):
        fg, bg = make_nerf(hp, count), make_bg_nerf(hp, count)
    tree = jax_train_state_tree(loaded, fg, bg, key=[0, hp.random_seed])
    ckpt = write_jax_checkpoint(tmp / "rj_src" / f"{RESUME_JAX_AT}.ckpt", tree, {
        "iteration": RESUME_JAX_AT, "dataset_state": loaded["dataset_state"],
        "np_rng_state": np.random.default_rng(hp.random_seed).bit_generator.state})
    fresh = torch.Generator(device=device).manual_seed(rank_seed(hp.random_seed, 0))
    pt = tmp / "rj_src" / f"{RESUME_JAX_AT}.pt"
    torch.save({**loaded, "generator_state": fresh.get_state()}, pt)
    log(f"  wrote {ckpt.name} ({ckpt.stat().st_size} bytes) and {pt.name} at step "
        f"{RESUME_JAX_AT}; fg / bg Adam counts {int(tree['fg_opt']['0']['count'])} / "
        f"{int(tree['bg_opt']['0']['count'])}")

    steps_seen = []
    step_call = TrainStep.__call__

    def timed_call(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        steps_seen.append(self)
        if len(steps_seen) in (1, RESUME_JAX_STEPS - RESUME_JAX_AT):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
        return metrics

    def resume(src: Path, name: str):
        steps_seen.clear()
        stamps.clear()
        TrainStep.__call__ = timed_call
        try:
            port_train.main(train_hparams(ds, tmp / name, steps + ["--ckpt_path", str(src)]))
        finally:
            TrainStep.__call__ = step_call
        step = steps_seen[-1]
        scheds = [(step.fg_sched.last_epoch, adam_steps(step.fg_opt)),
                  (step.bg_sched.last_epoch, adam_steps(step.bg_opt))]
        ms = (stamps[1] - stamps[0]) / (len(steps_seen) - 1) * 1e3
        return (load_checkpoint(tmp / name / "0" / "models" / f"{RESUME_JAX_STEPS}.pt"),
                len(steps_seen), scheds, ms)

    def evaluate(src: Path, name: str):
        return port_eval.main(paper_hparams([
            "--dataset_path", str(ds), "--exp_name", str(tmp / name),
            "--ckpt_path", str(src), "--ray_altitude_range", "-1.3", "0.6",
            "--near", "0.05", "--val_scale_factor", "1", "--device", "cuda"]))

    stamps = []
    from_pt, _, pt_scheds, pt_ms = resume(pt, "rj_from_pt")
    e_pt = evaluate(pt, "rj_eval_pt")
    # The main path: the `.ckpt` resumed, then served.
    zero_all_counters()
    from_ckpt, n_steps, scheds, ms = resume(ckpt, "rj_from_ckpt")
    after_train = kernel_launches()
    e_ckpt = evaluate(ckpt, "rj_eval_ckpt")
    counts = kernel_launches()
    plain = train_counters()["plain"]
    for name, entry in report["kernels"].items():
        entry["launches_resume_jax"] = counts[name]
    val_eval = after_train["fused_nerf_eval"]
    eval_eval = counts["fused_nerf_eval"] - val_eval
    bit_equal = state_dicts_equal(from_ckpt, from_pt)
    psnr_diff = abs(e_ckpt["val/psnr"] - e_pt["val/psnr"])
    seconds = time.perf_counter() - t_phase
    resumed = RESUME_JAX_STEPS - RESUME_JAX_AT
    log(f"  resumed {n_steps} steps from {ckpt.name} and from {pt.name}: 20.pt bit-equal "
        f"(weights, Adam states, dataset_state) {bit_equal}; iteration "
        f"{from_ckpt['iteration']}; schedules (last_epoch, Adam step) fg / bg {scheds} "
        f"({pt_scheds} from the .pt)")
    log(f"  launches from {ckpt.name}: {counts} (eval_fwd {val_eval} in validation, "
        f"{eval_eval} in eval.main); plain calls {plain}")
    log(f"  eval.main PSNR {e_ckpt['val/psnr']:.6f} ({ckpt.name}) vs "
        f"{e_pt['val/psnr']:.6f} ({pt.name}), diff {psnr_diff:.3e}")
    log(f"  phase {seconds:.2f} s; resumed step {ms:.2f} ms from {ckpt.name}, "
        f"{pt_ms:.2f} ms from {pt.name} ({report['device_line']})")
    report["resume_jax"] = {
        "steps_resumed": n_steps, "bit_equal": bit_equal, "ms_per_step": ms,
        "ms_per_step_from_pt": pt_ms, "psnr": e_ckpt["val/psnr"], "psnr_diff": psnr_diff,
        "eval_launches_validation": val_eval, "eval_launches_eval": eval_eval,
        "seconds": seconds}
    return bool(
        bit_equal and n_steps == resumed and from_ckpt["iteration"] == RESUME_JAX_STEPS
        and all(last == adam for last, adam in scheds) and scheds[0][0] == RESUME_JAX_STEPS
        and all(counts[k] == 4 * resumed for k in TRAIN_KERNELS)
        and val_eval > 0 and eval_eval == val_eval and plain == 0
        and all(counts[k] == 0 for k in WIDE_KERNELS + TRAIN_WIDE_KERNELS)
        and np.isfinite(e_ckpt["val/psnr"]) and psnr_diff <= 1e-6)


TRAIN_F32_STEPS = 20
F32_PLAIN_PIECE = 1 << 20  # the eval plain version in pieces at 8,388,608 points


def views_and_chunks(record):
    """Wrap `Runner.render_image` so that each view appends its chunk count
    to `record` -> the original method (to restore)."""
    from mega_nerf_tpu_torch.runtime import runner as runner_mod

    original = runner_mod.Runner.render_image

    def counting(self, meta):
        n = meta.W * meta.H
        chunk = min(self.hparams.image_pixel_batch_size, n,
                    runner_mod._eval_chunk_cap(self.hparams))
        record.append(-(-n // chunk))
        return original(self, meta)

    runner_mod.Runner.render_image = counting
    return original


def phase_train_f32(device, report, tmp: Path):
    """`train.main --compute_dtype float32` at the paper config on train's
    scene for TRAIN_F32_STEPS steps, then `eval.main` on the written
    `{iter}.pt`, every counter zeroed just before `train.main` and read just
    after `eval.main`: 4 launches a step of each f32 training kernel, 4 f32
    eval launches a chunk of every view, no other kernel's launch, no plain
    or eager-module call, a falling loss, a finite PSNR. Then ms a step
    over 20 chained steps and s/view through the f32 kernels and through
    the eager module (`--no_pallas`), in turns, and each f32 kernel per
    launch at the main path's shapes."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.runtime import runner as runner_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    ds = tmp / "train_dataset"  # phase_train's scene
    hp = train_hparams(ds, tmp / "train_f32_exp",
                       ["--train_iterations", str(TRAIN_F32_STEPS), *F32])
    snaps, train_views, eval_views = [], [], []
    step_call = TrainStep.__call__

    def recording_call(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        snaps.append((metrics["loss"], kernel_launches()))
        return metrics

    TrainStep.__call__ = recording_call
    render_image = views_and_chunks(train_views)
    zero_all_counters()
    t0 = time.perf_counter()
    try:
        with EagerCalls() as eager_calls:
            val = port_train.main(hp)
            torch.cuda.synchronize()
            after_train = kernel_launches()
            ckpt = tmp / "train_f32_exp" / "0" / "models" / f"{TRAIN_F32_STEPS}.pt"
            e_hp = paper_hparams(["--dataset_path", str(ds), "--exp_name",
                                  str(tmp / "train_f32_eval"), "--ckpt_path", str(ckpt),
                                  "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
                                  "--val_scale_factor", "1", "--device", "cuda", *F32])
            runner_mod.Runner.render_image = render_image
            views_and_chunks(eval_views)
            e_metrics = port_eval.main(e_hp)
            torch.cuda.synchronize()
    finally:
        TrainStep.__call__ = step_call
        runner_mod.Runner.render_image = render_image
    wall = time.perf_counter() - t0
    counts = kernel_launches()
    plain = train_wide_counters()["plain"]
    loss = torch.stack([s_[0] for s_ in snaps]).float().cpu().numpy()
    first, last = float(loss[:5].mean()), float(loss[-5:].mean())
    steps = len(snaps)
    per_steps = snaps[-1][1]  # after the last step, before the final validation
    want = {k: 4 * steps for k in F32_KERNELS[1:]}
    want_eval_train = 4 * sum(train_views)
    want_eval = 4 * sum(eval_views)
    others = sum(v for k, v in counts.items() if k not in F32_KERNELS)
    log(f"  train.main --compute_dtype float32: {steps} steps + final validation, "
        f"eval.main on {ckpt.name}: {wall:.2f} s; loss first 5 {first:.5f} -> last 5 "
        f"{last:.5f}; val {val}; eval {e_metrics}; f32 launches after the steps "
        f"{ {k: per_steps[k] for k in F32_KERNELS} }, after train.main "
        f"{ {k: after_train[k] for k in F32_KERNELS} }, after eval.main "
        f"{ {k: counts[k] for k in F32_KERNELS} }; chunks of the views {train_views} "
        f"(train.main) {eval_views} (eval.main); other kernels' launches {others}; "
        f"plain calls {plain}; eager module calls {eager_calls.count}")
    ok = (steps == TRAIN_F32_STEPS and np.isfinite(loss).all() and last < first
          and all(per_steps[k] == n for k, n in want.items())
          and per_steps["fused_nerf_eval_f32"] == 0
          and after_train["fused_nerf_eval_f32"] == want_eval_train
          and counts["fused_nerf_eval_f32"] == want_eval_train + want_eval
          and all(counts[k] == n for k, n in want.items())
          and want_eval > 0 and others == 0 and plain == 0 and eager_calls.count == 0
          and all(np.isfinite(v) for v in val.values())
          and ckpt.exists() and np.isfinite(e_metrics["val/psnr"]))
    for k in F32_KERNELS:
        report["kernels"][k]["launches"] = counts[k]
    report["training_f32"] = {
        "steps": steps, "loss_first5": first, "loss_last5": last,
        "val_psnr": val.get("val/psnr"), "ckpt_eval_psnr": e_metrics["val/psnr"],
        "launches": {k: counts[k] for k in F32_KERNELS}, "phase_main_s": wall}

    saved = f32_launches()
    ok = f32_step_and_view(report, tmp, ckpt, e_hp) and ok
    time_f32_kernels(device, report)
    from mega_nerf_tpu_torch.render import fused_f32

    for k, n in saved.items():  # timing launches are not main-path launches
        getattr(fused_f32, k).launches = n
    report["training_f32"]["device_line"] = report["device_line"]
    return bool(ok)


def f32_step_and_view(report, tmp: Path, ckpt: Path, e_hp) -> bool:
    """ms a step over 20 chained steps (the train phase's batches) and
    s/view of the val view, from the f32 checkpoint, through the f32 kernels
    and through the eager module, in turns (eager, kernels, kernels, eager)."""
    import copy

    import numpy as np
    import torch

    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings
    from mega_nerf_tpu_torch.runtime.runner import Runner

    runner = Runner(train_hparams(tmp / "train_dataset", tmp / "unused_f32", F32),
                    set_experiment_path=False)
    runner._load_weights(ckpt)
    batches = report["train_batches"]
    steps, step_ms = {}, {"kernels": [], "eager": []}
    for route in ("eager", "kernels"):
        hp = copy.copy(runner.hparams)
        hp.use_fused_kernel = route == "kernels"
        steps[route] = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(hp),
                                 5e-4, 0.1, TRAIN_F32_STEPS, runner.sphere_center,
                                 runner.sphere_radius)
    with EagerCalls() as eager_calls:
        for route in ("eager", "kernels", "kernels", "eager"):
            before = eager_calls.count
            step_ms[route].append(chained_step_ms(steps[route], batches, 20))
            if (eager_calls.count > before) != (route == "eager"):
                log(f"  the {route} steps took the wrong route")
                return False
    del steps
    torch.cuda.empty_cache()
    view = Runner(copy.copy(e_hp), set_experiment_path=False)
    view.make_eval_state()
    meta = view.val_items[0]
    s_view = {"kernels": [], "eager": []}
    for route in ("eager", "kernels", "kernels", "eager"):
        view.hparams.use_fused_kernel = route == "kernels"
        view.render_image(meta)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            view.render_image(meta)
        torch.cuda.synchronize()
        s_view[route].append((time.perf_counter() - t0) / 2)
    k_ms, e_ms = float(np.mean(step_ms["kernels"])), float(np.mean(step_ms["eager"]))
    k_s, e_s = float(np.mean(s_view["kernels"])), float(np.mean(s_view["eager"]))
    log(f"  f32 training step, 20 chained steps (paper fg+bg, batch 1024), turns "
        f"eager/kernels/kernels/eager: kernels {step_ms['kernels']} ms, eager module "
        f"{step_ms['eager']} ms; mean {k_ms:.2f} vs {e_ms:.2f} ms/step "
        f"({e_ms / k_ms:.3f}x) [{report['device_line']}]")
    log(f"  f32 view {meta.W}x{meta.H}, turns eager/kernels/kernels/eager: kernels "
        f"{s_view['kernels']} s, eager module {s_view['eager']} s; mean {k_s:.4f} vs "
        f"{e_s:.4f} s/view ({e_s / k_s:.3f}x)")
    report["training_f32"].update(
        step_ms=k_ms, eager_step_ms=e_ms, step_ms_turns=step_ms, s_per_view=k_s,
        eager_s_per_view=e_s, s_per_view_turns=s_view, rays_per_s=1024 / k_ms * 1e3)
    return True


def time_f32_kernels(device, report):
    """Each f32 kernel per launch at the main path's shapes: eval at the four
    passes of a 16,384-ray chunk (plain, bound and TFLOP/s at fg fine, the
    plain version in pieces of F32_PLAIN_PIECE points: the whole pass's f32
    intermediates do not fit the card), the training kernels at the four
    passes of a 1024-ray step (plain, bound and the weight gradient's
    torch.mm in f32 with TF32 off at fg fine)."""
    import torch

    from mega_nerf_tpu_torch.render import fused_f32, fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft

    hp = paper_hparams(F32)
    kernels = report["kernels"]
    out = report["training_f32"]
    chunk_ms = 0.0
    for name, bg, m, seed in SERVING_SHAPES:
        bundle = seeded_bundle(hp, 16, bg, seed, device)
        cfg = bundle.config
        packed = fused_mlp.pack_params(bundle.module)
        xyz, dirs, idx = mlp_inputs(cfg, m, seed + 1, device)
        app = bundle.module.appearance(idx).contiguous()
        with torch.no_grad():
            ms = cuda_ms(lambda: fused_mlp.fused_nerf_eval(packed, xyz, dirs, app), 3, 1)
        chunk_ms += ms
        log(f"  f32 eval kernel, {name} ({m} points): {ms:.3f} ms/launch")
        if name != "fg fine":
            continue
        pieces = [(i, min(m, i + F32_PLAIN_PIECE)) for i in range(0, m, F32_PLAIN_PIECE)]

        def plain():
            for a, b in pieces:
                fused_mlp.fused_nerf_eval_plain(packed, xyz[a:b], dirs[a:b], app[a:b])

        with torch.no_grad():
            plain_ms = cuda_ms(plain, 1, 1)
        flops = fused_mlp.flops_per_point(cfg) * m
        nbytes = fused_mlp.io_bytes_per_point(cfg) * m
        # Three TF32 tensor-core products a multiply-add (the kernel's);
        # FFMA's bound beside.
        bms, by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
        ffma_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
        kernels["fused_nerf_eval_f32"].update(ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                              bound_by=by)
        plan = fused_f32.f32_fwd_plan(cfg)
        log(f"  fused_nerf_eval_f32 at fg fine: {ms:.3f} ms/launch = "
            f"{3 * flops / ms / 1e9:.1f} TFLOP/s of TF32 products ({flops / ms / 1e9:.1f} "
            f"f32); plain {plain_ms:.3f} ms ({len(pieces)} pieces); bound {bms:.3f} ms "
            f"({by}: {3 * flops:.4g} FLOP at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s of TF32, "
            f"{nbytes:.4g} B; FFMA {ffma_ms:.3f} ms); tile {plan.tm} points, ring "
            f"{plan.stages} stages, {plan.smem_bytes} B shared memory")
        del xyz, dirs, app
        torch.cuda.empty_cache()
    out["eval_chunk_ms"] = chunk_ms
    log(f"  f32 eval kernel per 16,384-ray chunk (4 launches): {chunk_ms:.3f} ms")

    per_step = 0.0
    shapes = [("fg coarse", False, 1024 * 256), ("fg fine", False, 1024 * 512),
              ("bg coarse", True, 1024 * 128), ("bg fine", True, 1024 * 256)]
    for name, bg, m in shapes:
        bundle = seeded_bundle(hp, 16, bg, 21, device)
        cfg = bundle.config
        packed = fused_mlp.pack_params(bundle.module)
        xyz, dirs, idx = mlp_inputs(cfg, m, 22, device)
        app = bundle.module.appearance(idx).float()
        noise = torch.rand((m,), device=device)
        g = torch.randn((m, 4), device=device)
        with torch.no_grad():
            _, act = ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise)
            grad, _ = ft.train_bwd_data(packed, act, g, noise)
            t_fwd = cuda_ms(lambda: ft.fused_nerf_train_fwd(packed, xyz, dirs, app, noise), 3)
            t_bwd = cuda_ms(lambda: ft.train_bwd_data(packed, act, g, noise), 3)
            t_wg = cuda_ms(lambda: ft.weight_grad(packed, act, grad), 3)
        per_step += t_fwd + t_bwd + t_wg
        log(f"  f32 train kernels, {name} ({m} points): fwd {t_fwd:.3f} ms, bwd-data "
            f"{t_bwd:.3f} ms, weight-grad {t_wg:.3f} ms")
        if name != "fg fine":
            del act, grad
            continue
        flops = fused_mlp.flops_per_point(cfg) * m
        dx_flops = dx_flops_per_point(cfg) * m
        named = dict(bundle.module.named_parameters())
        n_params = sum(named[k].numel() for k in fused_mlp.mlp_param_names(cfg))
        fwd_b = (fused_mlp.io_bytes_per_point(cfg) + 4) * m
        bwd_b = fwd_b + 4 * cfg.appearance_dim * m + 4 * n_params
        jobs = ft.weight_grad_jobs(packed)

        def library():
            for d_col, n, x_col, k, *_ in jobs:
                torch.mm(grad[:, d_col:d_col + n].T, act[:, x_col:x_col + k])

        with torch.no_grad():
            lib_ms = cuda_ms(library, 3)
            p_fwd = cuda_ms(lambda: ft.fused_nerf_train_fwd_plain(packed, xyz, dirs, app,
                                                                  noise), 1, 1)
            p_bwd = cuda_ms(lambda: ft.train_bwd_data_plain(packed, act, g, noise), 1, 1)
            p_wg = cuda_ms(lambda: ft.weight_grad_plain(packed, act, grad), 1, 1)
        kernels["weight_grad_f32"]["library_ms"] = lib_ms
        log(f"  weight_grad_f32 library (torch.mm per job, f32, TF32 off, no bias sums) "
            f"at fg fine: {lib_ms:.3f} ms")
        # The weight gradient reads the saved and gradient rows once and
        # writes the flat gradients: FFMA bound and, the row's, 3xTF32 bound
        # (three tensor-core products a multiply-add).
        wg_b = 4.0 * (act.numel() + grad.numel() + n_params)
        rows = {"fused_nerf_train_fwd_f32": (t_fwd, p_fwd, flops, fwd_b),
                "train_bwd_data_f32": (t_bwd, p_bwd, dx_flops, bwd_b),
                "weight_grad_f32": (t_wg, p_wg, flops, wg_b)}
        ffma = bound(flops, wg_b, PEAK_F32_FLOPS)
        tf32 = bound(3 * flops, wg_b, PEAK_TF32_FLOPS)
        log(f"  weight_grad_f32 bounds at fg fine: FFMA {ffma[0]:.3f} ms ({ffma[1]}), 3xTF32 "
            f"{tf32[0]:.3f} ms ({tf32[1]}: {3 * flops:.4g} FLOP at "
            f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s, {wg_b:.4g} B); the row takes 3xTF32's")
        fwd_tf32 = bound(3 * flops, fwd_b, PEAK_TF32_FLOPS)
        log(f"  fused_nerf_train_fwd_f32 bounds at fg fine: FFMA "
            f"{bound(flops, fwd_b, PEAK_F32_FLOPS)[0]:.3f} ms, 3xTF32 {fwd_tf32[0]:.3f} ms "
            f"({fwd_tf32[1]}); the row takes 3xTF32's")
        bwd_tf32 = bound(3 * dx_flops, bwd_b, PEAK_TF32_FLOPS)
        log(f"  train_bwd_data_f32 bounds at fg fine: FFMA "
            f"{bound(dx_flops, bwd_b, PEAK_F32_FLOPS)[0]:.3f} ms, 3xTF32 {bwd_tf32[0]:.3f} ms "
            f"({bwd_tf32[1]}: {3 * dx_flops:.4g} FLOP at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s); "
            f"the row takes 3xTF32's")
        for k, (ms, plain_ms, fl, nb) in rows.items():
            bms, by = {"weight_grad_f32": tf32, "fused_nerf_train_fwd_f32": fwd_tf32,
                       "train_bwd_data_f32": bwd_tf32}[k]
            kernels[k].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            log(f"  {k} at fg fine: {ms:.3f} ms/launch = {fl / ms / 1e9:.1f} TFLOP/s; "
                f"plain {plain_ms:.3f} ms; bound {bms:.3f} ms ({by}: {fl:.4g} FLOP, "
                f"{nb:.4g} B); saved rows {act.numel() * 4:.4g} B, gradient rows "
                f"{grad.numel() * 4:.4g} B")
        wplan = fused_f32.f32_wg_plan(packed, m)
        bplan = fused_f32.f32_bwd_plan(cfg)
        log(f"  f32 plans at fg fine: forward tile {fused_f32.f32_fwd_plan(cfg).tm}, "
            f"backward tile {bplan.tm} points, ring {bplan.stages} stages, "
            f"{bplan.smem_bytes} B; weight gradient "
            f"{len(wplan.tiles)} tiles x {wplan.splits} splits of {wplan.split_len} points")
        del act, grad
        torch.cuda.empty_cache()
    out["train_kernel_ms_per_step"] = per_step
    log(f"  f32 training kernels per step (12 launches): {per_step:.3f} ms")


# ------------------------------------------- f32 compute at widths 513-1024


def wide_f32_counters():
    """Launches of the four f32 wide kernels and of the f32 weight gradient,
    of every other kernel together ("others"), and the calls of every plain
    version."""
    counts = kernel_launches()
    out = {k: counts[k] for k in (*WIDE_F32_KERNELS, "weight_grad_f32")}
    out["others"] = sum(v for k, v in counts.items() if k not in out)
    out["plain"] = train_wide_counters()["plain"]
    return out


def wide_f32_step_launches(pass_cfgs):
    """Launches of training passes through the f32 wide route, one pass per
    config: an encode, a GEMM per matmul layer and per dX job, the heads
    forward and backward, a weight-gradient launch per dW step."""
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw

    per = dict.fromkeys((*WIDE_F32_KERNELS, "weight_grad_f32"), 0)
    for cfg in pass_cfgs:
        steps = ftw.train_wide_plan(cfg).steps
        n_dx = sum(kind == "dx" for kind, _ in steps)
        per["wide_f32_encode"] += 1
        per["wide_f32_gemm"] += cfg.layers + (2 if cfg.uses_dir_branch else 0) + n_dx
        per["wide_f32_heads_fwd"] += 1
        per["wide_f32_heads_bwd"] += 1
        per["weight_grad_f32"] += len(steps) - n_dx
    return per


def phase_compare_wide_f32(device, report):
    """The f32 wide route (`csrc/wide_f32.cu` and the f32 weight gradient)
    against its plain versions, TF32 off: compare_train_wide's cases (each
    backward kernel fed the plain backward's tensors, the composed route
    against the composed plain versions) and compare_wide's eval cases, the
    dense ones at 1024, the widest the f32 gate admits. rgb <= 1e-4, sigma
    and the pre-activations <= 1e-4 (1 + |x|), every layer output <= 1e-4
    (1 + |y|), every backward tensor, d_app and dW <= 1e-4 relative; dX and
    dW launches repeat bit for bit; the eval heads equal the training heads
    without noise bit for bit. Every launch is an f32 wide kernel's."""
    import torch

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import fused_wide as fw
    from mega_nerf_tpu_torch.render.fused_train import split_grads, transposed_weights

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = report["kernels"]
    errs = dict.fromkeys((*WIDE_F32_KERNELS, "weight_grad_f32"), 0.0)
    before = wide_f32_counters()
    all_ok = True

    def hold(kernel, got, want):
        errs[kernel] = max(errs[kernel], (got.float() - want.float()).abs().max().item())

    def fwd_ratio(got, want):
        err = (got - want).abs()
        return max(err[:, :3].max().item(), (err[:, 3] / (1 + want[:, 3].abs())).max().item())

    wide = paper_hparams([*WIDE_TRAIN, *F32])
    train_cases = [  # (name, hparams, bg, points): compare_train_wide's, in f32
        ("fg 1024-wide, dirs, appearance", wide, False, 100_003),
        ("bg 1024-wide, dirs, appearance", wide, True, 100_003),
        ("fg 640-wide, no dirs, no appearance (no branch)",
         paper_hparams(["--layer_dim", "640", "--appearance_dim", "0",
                        "--pos_dir_dim", "0", *F32]), False, 20_011),
        ("bg 640-wide, appearance 5, no dirs",
         paper_hparams(["--bg_layer_dim", "640", "--appearance_dim", "5",
                        "--pos_dir_dim", "0", *F32]), True, 20_011),
        ("fg 1024-wide, the fg fine pass", wide, False, 1024 * 512),
        ("fg 1024-wide, the fg coarse pass", wide, False, 1024 * 256),
        ("bg 1024-wide, the bg fine pass", wide, True, 1024 * 256),
        ("bg 1024-wide, the bg coarse pass", wide, True, 1024 * 128),
        ("fg 1024-wide, the cascade's fine pass", wide, False, 1024 * 768),
    ]
    for i, (name, hp, bg, m) in enumerate(train_cases):
        bundle = seeded_bundle(hp, 16, bg, 700 + i, device)
        cfg = bundle.config
        packed = fused_mlp.pack_params(bundle.module)
        xyz, dirs, idx = mlp_inputs(cfg, m, 701 + i, device)
        m = xyz.shape[0]
        app = bundle.module.appearance(idx).float() if cfg.appearance_dim else None
        gen = torch.Generator(device=device).manual_seed(702 + i)
        noise = torch.rand((m,), generator=gen, device=device)
        g = torch.randn((m, 4), generator=gen, device=device)
        worst = dict.fromkeys(("heads_fwd", "heads_bwd", "dx", "dw"), 0.0)
        with torch.no_grad():
            want, saved = ftw.fused_nerf_train_wide_fwd_plain(packed, xyz, dirs, app, noise)
            h_last, branch = saved[f"h{cfg.layers - 1}"], saved.get("branch")
            out, pre = ftw.train_wide_heads_fwd(packed, h_last, branch, noise)
            hold("wide_f32_heads_fwd", out, want)
            worst["heads_fwd"] = max(fwd_ratio(out, want), close_ratio(pre, saved["pre"]))
            clean, _ = ftw.train_wide_heads_fwd(packed, h_last, branch, None)
            heads_bits = torch.equal(fw.eval_wide_heads(packed, h_last, branch), clean)
            del out, pre, clean
            same = True
            names = {"train_wide_heads_bwd": ("wide_f32_heads_bwd", "heads_bwd"),
                     "train_wide_dx": ("wide_f32_gemm", "dx"),
                     "train_wide_dw": ("weight_grad_f32", "dw")}
            for kernel, got, ref in ftw.walk_backward(packed, saved, g):
                if kernel == ftw.DW_REPEAT:
                    same = same and torch.equal(got, ref)
                    continue
                name_, key = names[kernel]
                hold(name_, got, ref)
                worst[key] = max(worst[key], rel_err(got, ref))
            del got, ref
            # Every dX job twice on the same inputs: the same bits.
            plan = ftw.check_plan(packed)
            wts = transposed_weights(packed)
            rows, first_g = ftw.train_wide_heads_bwd_plain(packed, g, saved["pre"], h_last,
                                                           branch)
            grads = {"g_heads": rows, plan.first: first_g}
            del first_g
            for (kind, job), frees in zip(plan.steps, plan.frees):
                if kind == "dx":
                    args = (grads[job.g], wts[job.mat], job.row0, job.k, job.mode,
                            saved.get(job.mask), grads.get("g_heads"), packed.sigma_w)
                    a = ftw.train_wide_dx(*args)
                    same = same and torch.equal(a, ftw.train_wide_dx(*args))
                    grads[job.out] = a
                    del args, a
                for nm in frees:
                    grads.pop(nm, None)
            del grads, rows
            got, k_saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
            del k_saved
            fwd = fwd_ratio(got, want)
            flat, d_app = ftw.fused_nerf_train_wide_bwd(packed, saved, g)
            p_flat, p_d_app = ftw.fused_nerf_train_wide_bwd_plain(packed, saved, g)
            torch.cuda.synchronize()
            bwd = max(rel_err(a, b) for a, b in zip(split_grads(packed, flat),
                                                    split_grads(packed, p_flat)))
            if d_app is not None:
                bwd = max(bwd, rel_err(d_app, p_d_app))
            finite = bool(torch.isfinite(got).all() and torch.isfinite(flat).all())
        ok = (finite and same and heads_bits and max(worst.values()) <= F32_TOL
              and fwd <= F32_TOL and bwd <= F32_TOL)
        log(f"  f32 train wide {name}: M={m}; heads fwd worst {worst['heads_fwd']:.3e}, "
            f"heads bwd rel {worst['heads_bwd']:.3e}, dX worst rel {worst['dx']:.3e}, "
            f"dW worst rel {worst['dw']:.3e}; dX and dW repeat bitwise={same}; eval heads = "
            f"training heads without noise bitwise={heads_bits}; composed forward "
            f"{fwd:.3e}, backward worst rel {bwd:.3e}; finite={finite} -> "
            f"{'ok' if ok else 'FAIL'}")
        all_ok &= ok
        del saved, flat, p_flat, got, want, xyz, dirs, app, noise, g, d_app, p_d_app
        torch.cuda.empty_cache()

    eval_cases = [  # compare_wide's, in f32; the dense ones at the f32 gate's 1024
        ("fg 1024-wide (dense, cut to the f32 limit), dirs, appearance",
         paper_hparams([*WIDE_TRAIN, *F32]), False, 100_003, 1_000_003),
        ("bg 1024-wide (dense, cut to the f32 limit), dirs, appearance",
         paper_hparams([*WIDE_TRAIN, *F32]), True, 100_003, 1_000_003),
        ("fg 640-wide, dirs, no appearance",
         paper_hparams(["--layer_dim", "640", "--appearance_dim", "0", *F32]), False,
         20_011, 20_011),
        ("bg 1024-wide, appearance, no dirs",
         paper_hparams(["--bg_layer_dim", "1024", "--pos_dir_dim", "0", *F32]), True,
         20_011, 20_011),
        ("fg 1024-wide, no dirs, no appearance (no branch)",
         paper_hparams(["--layer_dim", "1024", "--appearance_dim", "0",
                        "--pos_dir_dim", "0", "--layers", "6", "--skip_layers", "3", *F32]),
         False, 4_097, 4_097),
    ]
    for i, (name, hp, bg, m, m_full) in enumerate(eval_cases):
        bundle = seeded_bundle(hp, 16, bg, 720 + i, device)
        cfg = bundle.config
        packed = fused_mlp.pack_params(bundle.module)
        xyz, dirs, idx = mlp_inputs(cfg, m, 721 + i, device)
        app = bundle.module.appearance(idx).contiguous() if cfg.appearance_dim else None
        layer_worst = 0.0
        with torch.no_grad():
            enc, dir_enc = fw.eval_wide_encode(packed, xyz, dirs)
            p_enc, p_dir = fw.eval_wide_encode_plain(packed, xyz, dirs)
            hold("wide_f32_encode", enc, p_enc)
            enc_worst = close_ratio(enc, p_enc)
            if p_dir is not None:
                hold("wide_f32_encode", dir_enc, p_dir)
                enc_worst = max(enc_worst, close_ratio(dir_enc, p_dir))
            h = p_enc
            for li in range(cfg.layers):
                xs = [p_enc, h] if li in cfg.skip_layers else [h]
                got = fw.eval_wide_layer(xs, packed.mats[li], packed.biases[li], True)
                h = fw.eval_wide_layer_plain(xs, packed.mats[li], packed.biases[li], True)
                hold("wide_f32_gemm", got, h)
                layer_worst = max(layer_worst, close_ratio(got, h))
            branch = None
            if packed.has_branch:
                w, b = packed.mats[cfg.layers], packed.biases[cfg.layers]
                got = fw.eval_wide_layer([h], w, b, False)
                final = fw.eval_wide_layer_plain([h], w, b, False)
                hold("wide_f32_gemm", got, final)
                layer_worst = max(layer_worst, close_ratio(got, final))
                xs = [final] + ([p_dir] if packed.dp else []) + ([app] if packed.ap else [])
                w, b = packed.mats[cfg.layers + 1], packed.biases[cfg.layers + 1]
                got = fw.eval_wide_layer(xs, w, b, True)
                branch = fw.eval_wide_layer_plain(xs, w, b, True)
                hold("wide_f32_gemm", got, branch)
                layer_worst = max(layer_worst, close_ratio(got, branch))
            heads = fw.eval_wide_heads(packed, h, branch)
            p_heads = fw.eval_wide_heads_plain(packed, h, branch)
            hold("wide_f32_heads_fwd", heads, p_heads)
            heads_worst = fwd_ratio(heads, p_heads)
            xyz, dirs, idx = mlp_inputs(cfg, m_full, 722 + i, device)
            app = bundle.module.appearance(idx).contiguous() if cfg.appearance_dim else None
            got = fw.fused_nerf_eval_wide(packed, xyz, dirs, app)
            torch.cuda.synchronize()
            want = fw.fused_nerf_eval_wide_plain(packed, xyz, dirs, app)
            full = fwd_ratio(got, want)
            finite = bool(torch.isfinite(got).all() and torch.isfinite(heads).all())
        ok = (finite and enc_worst <= F32_TOL and layer_worst <= F32_TOL
              and heads_worst <= F32_TOL and full <= F32_TOL)
        log(f"  f32 wide {name}: M={m}; encode max|err|/(1+|x|)={enc_worst:.3e}, layers "
            f"worst {layer_worst:.3e}, heads {heads_worst:.3e}; whole eval M={m_full} "
            f"({-(-m_full // fw.wide_plan(cfg).sub_chunk)} sub-chunks) {full:.3e}; "
            f"finite={finite} -> {'ok' if ok else 'FAIL'}")
        all_ok &= ok
        del got, want, xyz, dirs, app
        torch.cuda.empty_cache()
    f64 = wide_dw_against_f64(device)
    report.setdefault("dw_f64", {})["wide"] = f64
    dw_ok = f64["kernel"] <= DW_F64_TOL
    log(f"  weight_grad_f32 against f64 sums of its f32 rows on a 1024 x 1024 layer's dW "
        f"step (524,288 points; relative over dW and db): kernel (3xTF32) "
        f"{f64['kernel']:.3e}, plain f32 (TF32 off) {f64['plain']:.3e}, one-pass TF32 "
        f"{f64['tf32']:.3e} -> {'ok' if dw_ok else 'FAIL'} (kernel <= {DW_F64_TOL})")
    all_ok &= dw_ok
    g64 = wide_gemm_against_f64(device)
    report["gemm_f64"] = g64
    for form, what in (("layer", "a 1024 x 1024 trunk layer (bias, ReLU)"),
                       ("dx", "that layer's masked dX job")):
        e = g64[form]
        ok = e["kernel"] <= GEMM_F64_TOL
        log(f"  wide_f32_gemm against f64 sums of its f32 rows at the fg-fine pass "
            f"(524,288 points), {what}, relative over every output: kernel (3xTF32) "
            f"{e['kernel']:.3e}, plain f32 (TF32 off) {e['plain']:.3e}, one-pass TF32 "
            f"{e['tf32']:.3e} -> {'ok' if ok else 'FAIL'} (kernel <= {GEMM_F64_TOL})")
        all_ok &= ok
    after = wide_f32_counters()
    new = {k: after[k] - before[k] for k in after}
    for k, v in errs.items():
        kernels[k]["max_abs_err"] = max(kernels[k].get("max_abs_err") or 0.0, v)
    log(f"  launches in this phase {new}")
    return bool(all_ok and all(new[k] > 0 for k in errs) and new["others"] == 0)


TRAIN_WIDE_F32_STEPS = 10
EAGER_WIDE_F32_STEPS = 2


def phase_train_wide_f32(device, report, tmp: Path):
    """`train.main --compute_dtype float32` with fg and bg 8x1024
    (WIDE_TRAIN) on train's scene for TRAIN_WIDE_F32_STEPS steps, then
    `eval.main` on the written `{iter}.pt`, every counter zeroed just
    before `train.main` and read just after `eval.main`: the f32 wide
    kernels' launches a step as the wide plan says, no other kernel's
    launch, no plain or eager-module call, a falling loss and a finite
    PSNR; s/view of `eval.main`'s val view. Then ms a step and peak memory
    over chained steps, the f32 wide kernels' share of a step from a
    profile, each kernel per launch at the fg-fine shape; and, a record and not a check,
    the f32 eager module (`--no_pallas`, and with `--remat`) for
    EAGER_WIDE_F32_STEPS steps: ms and memory or its out-of-memory error."""
    import numpy as np
    import torch

    from mega_nerf_tpu_torch import eval as port_eval
    from mega_nerf_tpu_torch import train as port_train
    from mega_nerf_tpu_torch.models import nerf_config_from_hparams
    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render import rendering
    from mega_nerf_tpu_torch.runtime import runner as runner_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ds = tmp / "train_dataset"
    flags = [*WIDE_TRAIN, *F32]
    hp = train_hparams(ds, tmp / "train_wide_f32_exp",
                       ["--train_iterations", str(TRAIN_WIDE_F32_STEPS), *flags])
    fg_cfg = nerf_config_from_hparams(hp, 1, hp.layer_dim, 3)
    bg_cfg = nerf_config_from_hparams(hp, 1, hp.bg_layer_dim, 4)
    per_step = wide_f32_step_launches((fg_cfg, fg_cfg, bg_cfg, bg_cfg))
    snaps, routes, train_views, eval_views = [], [], [], []
    step_call, log_path = TrainStep.__call__, rendering._log_mlp_path

    def recording_call(self, batch, generator=None):
        metrics = step_call(self, batch, generator)
        snaps.append((metrics["loss"], wide_f32_counters()))
        return metrics

    def recording_log(message):
        routes.append(message)
        log_path(message)

    TrainStep.__call__, rendering._log_mlp_path = recording_call, recording_log
    render_image = views_and_chunks(train_views)
    ckpt = tmp / "train_wide_f32_exp" / "0" / "models" / f"{TRAIN_WIDE_F32_STEPS}.pt"
    e_hp = paper_hparams(["--dataset_path", str(ds), "--exp_name",
                          str(tmp / "train_wide_f32_eval"), "--ckpt_path", str(ckpt),
                          "--ray_altitude_range", "-1.3", "0.6", "--near", "0.05",
                          "--val_scale_factor", "1", "--device", "cuda", *flags])
    zero_all_counters()
    t0 = time.perf_counter()
    try:
        with EagerCalls() as eager_calls:
            val = port_train.main(hp)
            torch.cuda.synchronize()
            after_train = wide_f32_counters()
            runner_mod.Runner.render_image = render_image
            views_and_chunks(eval_views)
            counted, view_s = runner_mod.Runner.render_image, []

            def timed(self, meta):  # the val view, warm from train.main's validation
                torch.cuda.synchronize()
                t_view = time.perf_counter()
                rendered = counted(self, meta)
                torch.cuda.synchronize()
                view_s.append(time.perf_counter() - t_view)
                return rendered

            runner_mod.Runner.render_image = timed
            torch.cuda.reset_peak_memory_stats()
            e_metrics = port_eval.main(e_hp)
            torch.cuda.synchronize()
            view_peak = torch.cuda.max_memory_allocated() / 1e9
    finally:
        TrainStep.__call__, rendering._log_mlp_path = step_call, log_path
        runner_mod.Runner.render_image = render_image
    wall = time.perf_counter() - t0
    counts = wide_f32_counters()
    loss = torch.stack([s_[0] for s_ in snaps]).float().cpu().numpy()
    first, last = float(loss[:3].mean()), float(loss[-3:].mean())
    steps_done = len(snaps)
    at_last = snaps[-1][1]  # after the last step, before the final validation
    views = len(train_views) + len(eval_views)
    eval_launches = {k: counts[k] - at_last[k] for k in WIDE_F32_KERNELS[:3]}
    train_routes = sorted({r for r in routes if "/train]" in r})
    eval_routes = sorted({r for r in routes if "/eval]" in r})
    log(f"  train.main --compute_dtype float32 at {hp.layer_dim}/{hp.bg_layer_dim}: "
        f"{steps_done} steps + final validation, eval.main on {ckpt.name}: {wall:.2f} s; "
        f"loss first 3 {first:.5f} -> last 3 {last:.5f}; val {val}; eval {e_metrics}; "
        f"launches after the steps {at_last} (a step as the plan says: {per_step}); after "
        f"train.main {after_train}; after eval.main {counts}; views {views} "
        f"(chunks {train_views} + {eval_views}), eval launches {eval_launches}; eager "
        f"module calls {eager_calls.count}")
    for r in train_routes + eval_routes:
        log(f"    {r}")
    ok = (steps_done == TRAIN_WIDE_F32_STEPS and np.isfinite(loss).all() and last < first
          and all(at_last[k] == n * steps_done for k, n in per_step.items())
          and all(eval_launches[k] > 0 for k in eval_launches)
          and counts["wide_f32_heads_bwd"] == at_last["wide_f32_heads_bwd"]
          and counts["weight_grad_f32"] == at_last["weight_grad_f32"]
          and counts["others"] == 0 and counts["plain"] == 0 and eager_calls.count == 0
          and len(train_routes) == 4
          and all("fused train (wide kernel)" in r for r in train_routes)
          and eval_routes and all("fused eval (wide kernel)" in r for r in eval_routes)
          and all(np.isfinite(v) for v in val.values())
          and ckpt.exists() and np.isfinite(e_metrics["val/psnr"]))
    for k in WIDE_F32_KERNELS:
        report["kernels"][k]["launches"] = counts[k]
    for k, n in kernel_launches().items():
        report["kernels"][k]["launches_train_wide_f32"] = n
    out = report["training_wide_f32"] = {
        "steps": steps_done, "loss_first3": first, "loss_last3": last,
        "val_psnr": val.get("val/psnr"), "ckpt_eval_psnr": e_metrics["val/psnr"],
        "launches_per_step": per_step, "launches": {k: counts[k] for k in per_step},
        "eval_launches_per_view": {k: v / max(views, 1) for k, v in eval_launches.items()},
        "s_per_view": view_s[-1], "view_peak_mem_gb": view_peak,
        "phase_main_s": wall, "device_line": report["device_line"]}
    log(f"  f32 view (eval.main, 128x128): {view_s[-1]:.4f} s, peak device memory "
        f"allocated {view_peak:.2f} GB [{report['device_line']}]")

    saved = {k: v for k, v in kernel_launches().items()}
    wide_f32_steps(report, tmp, ckpt)
    time_wide_f32_kernels(device, report)
    eager_wide_f32_steps(report, tmp, ckpt)
    eager = out.get("eager", {})
    if "step_ms" in eager and "step_ms" in out:
        log(f"  f32 wide step through the kernels {out['step_ms']:.2f} ms against the eager "
            f"module's {eager['step_ms']:.2f} ms in this call: "
            f"{eager['step_ms'] / out['step_ms']:.3f}x [{report['device_line']}]")
    from mega_nerf_tpu_torch.render import fused_f32
    from mega_nerf_tpu_torch.render import fused_wide_f32 as fwf

    for k in WIDE_F32_KERNELS:  # timing launches are not main-path launches
        getattr(fwf, k).launches = saved[k]
    fused_f32.weight_grad_f32.launches = saved["weight_grad_f32"]
    log(f"  {out}")
    return bool(ok)


def wide_f32_runner(tmp: Path, ckpt: Path):
    from mega_nerf_tpu_torch.runtime.runner import Runner

    runner = Runner(train_hparams(tmp / "train_dataset", tmp / "unused_wide_f32",
                                  [*WIDE_TRAIN, *F32]), set_experiment_path=False)
    runner._load_weights(ckpt)
    return runner


def wide_f32_steps(report, tmp: Path, ckpt: Path) -> None:
    """ms a step over 3 chained steps from the f32 checkpoint (the train
    phase's batches, after a warm-up step), the step's peak device memory,
    and the f32 wide kernels' share of a step's device time (torch.profiler
    over one step)."""
    import torch

    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    out = report["training_wide_f32"]
    runner = wide_f32_runner(tmp, ckpt)
    step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(runner.hparams),
                     5e-4, 0.1, TRAIN_WIDE_F32_STEPS, runner.sphere_center,
                     runner.sphere_radius)
    batches = report["train_batches"]
    step(batches[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    n = 3
    t0 = time.perf_counter()
    for b in batches[1:1 + n]:
        step(b)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / n * 1e3
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows, busy, wall_ms = kernel_times(lambda: step(batches[1 + n]), 1)
    share = {}
    if rows:
        names = {"wide_f32_encode": "wide_f32_encode_kernel",
                 "wide_f32_gemm": "wide_f32_gemm_",  # the GEMM and its W rests
                 "wide_f32_heads_fwd": "wide_f32_heads_fwd_kernel",
                 "wide_f32_heads_bwd": "wide_f32_heads_bwd_kernel",
                 "weight_grad_f32": "wg_"}
        share = {k: sum(ms for ms, _, nm in rows if key in nm) for k, key in names.items()}
        kern = sum(share.values())
        log(f"  profiler over one f32 step: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
            f"wall ({100 * busy / wall_ms:.1f}%); the f32 wide training kernels "
            f"{kern:.1f} ms ({100 * kern / busy:.1f}% of the busy time): "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in share.items()))
        for ms, count, name in rows[:8]:
            log(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
        out.update(profiled_device_busy_share=busy / wall_ms,
                   kernel_ms_per_step_profiled=kern, kernel_ms_by_name=share)
    else:
        log("  profiler: no device time recorded (the kernels' share not measured)")
    del step, runner
    torch.cuda.empty_cache()
    log(f"  f32 wide training step (fg + bg 8x1024, batch 1024, 256 + 512 samples): "
        f"{step_ms:.2f} ms/step over {n} chained steps = {1024 / step_ms * 1e3:.1f} rays/s; "
        f"peak device memory allocated {peak:.2f} GB [{report['device_line']}]")
    out.update(step_ms=step_ms, rays_per_s=1024 / step_ms * 1e3, peak_mem_gb=peak)


def time_wide_f32_kernels(device, report):
    """Each f32 wide kernel per launch at the main path's shapes: training
    at the fg-fine pass (524,288 points, 8x1024): the encode (at the fg and
    the bg shape, with the share of its byte bound), the GEMM as a
    1024 x 1024 trunk layer and as that layer's masked dX job, the heads
    forward and backward, the f32 weight gradient of that layer; with the
    plain versions, the bounds (67 TFLOP/s of f32 FFMA, 3.35 TB/s) and the
    library calls (F.linear and torch.mm in f32, TF32 off); and the eval
    route's encode and GEMM on one f32 sub-chunk."""
    import torch
    import torch.nn.functional as F

    from mega_nerf_tpu_torch.render import fused_mlp
    from mega_nerf_tpu_torch.render import fused_train as ft
    from mega_nerf_tpu_torch.render import fused_train_wide as ftw
    from mega_nerf_tpu_torch.render import fused_wide as fw

    torch.backends.cuda.matmul.allow_tf32 = False
    kernels, out = report["kernels"], report["training_wide_f32"]
    hp = paper_hparams([*WIDE_TRAIN, *F32])
    bundle = seeded_bundle(hp, 16, False, 61, device)
    cfg = bundle.config
    packed = fused_mlp.pack_params(bundle.module)
    m, d = WIDE_PASSES[0][1], cfg.layer_dim  # the fg fine pass
    xyz, dirs, idx = mlp_inputs(cfg, m, 62, device)
    m = xyz.shape[0]
    app = bundle.module.appearance(idx).float()
    gen = torch.Generator(device=device).manual_seed(63)
    noise = torch.rand((m,), generator=gen, device=device)
    g = torch.randn((m, 4), generator=gen, device=device)
    plan = ftw.check_plan(packed)
    with torch.no_grad():
        _, saved = ftw.fused_nerf_train_wide_fwd(packed, xyz, dirs, app, noise)
        h, branch, h1 = saved[f"h{cfg.layers - 1}"], saved["branch"], saved["h1"]
        # The encode at the fg shape, then the bg shape (xyz_dim 4: 112 enc
        # columns), each into given outputs, as the wide route's passes.
        bg_packed = fused_mlp.pack_params(seeded_bundle(hp, 16, True, 64, device).module)
        bg_xyz, bg_dirs, _ = mlp_inputs(bg_packed.config, m, 65, device)
        encode_times = {}
        for shape, pk, sx, sd in (("fg", packed, xyz, dirs), ("bg", bg_packed, bg_xyz, bg_dirs)):
            outs = fw.eval_wide_encode(pk, sx, sd)
            encode_times[shape] = (
                pk, sx.shape[0], cuda_ms(lambda: fw.eval_wide_encode(pk, sx, sd, *outs), 20),
                cuda_ms(lambda: fw.eval_wide_encode_plain(pk, sx, sd), 3, 1))
            del outs
        del bg_xyz, bg_dirs
        t_enc, p_enc = encode_times["fg"][2:]
        w2, b2 = packed.mats[2], packed.biases[2]
        layer_out = torch.empty((m, d), device=device)
        t_layer = cuda_ms(lambda: fw.eval_wide_layer([h1], w2, b2, True, layer_out), 5)
        p_layer = cuda_ms(lambda: fw.eval_wide_layer_plain([h1], w2, b2, True), 3, 1)
        lib_layer = cuda_ms(lambda: F.linear(h1, w2, b2), 5)
        del layer_out
        hf = lambda: ftw.train_wide_heads_fwd(packed, h, branch, noise)  # noqa: E731
        t_hf = cuda_ms(hf, 10)
        p_hf = cuda_ms(lambda: ftw.train_wide_heads_fwd_plain(packed, h, branch, noise), 3, 1)
        hb_args = (packed, g, saved["pre"], h, branch)
        t_hb = cuda_ms(lambda: ftw.train_wide_heads_bwd(*hb_args), 10)
        p_hb = cuda_ms(lambda: ftw.train_wide_heads_bwd_plain(*hb_args), 3, 1)
        # dX and dW at trunk layer 2 (no skip): d_pre_2 -> d_pre_1 masked by h1.
        gp = torch.randn((m, d), generator=gen, device=device) * 1e-2 * (saved["h2"] > 0)
        wt = ft.transposed_weights(packed)[2]
        dx_args = (gp, wt, 0, d, ftw.DX_MASK, h1)
        t_dx = cuda_ms(lambda: ftw.train_wide_dx(*dx_args), 5)
        p_dx = cuda_ms(lambda: ftw.train_wide_dx_plain(*dx_args), 3, 1)
        lib_dx = cuda_ms(lambda: F.linear(gp, wt), 5)
        job = next(job for kind, job in plan.steps if kind == "dw" and job[0].d == "g_pre2")
        tensors, flat = {"g_pre2": gp, "h1": h1}, torch.empty(plan.total, device=device)
        t_dw = cuda_ms(lambda: ftw.train_wide_dw(job, tensors, flat), 5)
        p_dw = cuda_ms(lambda: ftw.train_wide_dw_plain(job, tensors, flat), 3, 1)
        lib_dw = cuda_ms(lambda: torch.mm(gp.T, h1), 5)
    del saved, gp, tensors, h, branch, h1
    torch.cuda.empty_cache()
    gemm = 2.0 * m * d * d
    ep, dp = packed.ep, packed.dp
    rows = {  # name: (ms, plain ms, library ms, FLOP, bytes)
        "wide_f32_encode": (t_enc, p_enc, None,
                            2.0 * m * (cfg.xyz_dim * 2 * cfg.pos_xyz_dim
                                       + 3 * 2 * cfg.pos_dir_dim),
                            4.0 * m * (cfg.xyz_dim + 3 + ep + dp)),
        "wide_f32_gemm": (t_layer, p_layer, lib_layer, gemm,
                          4.0 * (2 * m * d + d * d + d)),
        "wide_f32_heads_fwd": (t_hf, p_hf, None, 2.0 * m * (d + 3 * (d // 2)),
                               4.0 * m * (d + d // 2 + 1 + 8) + 4.0 * (d + 3 * d // 2)),
        "wide_f32_heads_bwd": (t_hb, p_hb, None, 6.0 * m * (d // 2),
                               4.0 * m * (4 + 4 + d // 2 + 16 + d // 2)),
    }
    # The GEMM's products run as 3xTF32 on the tensor cores: its bound is
    # three TF32 products a multiply-add at 495 TFLOP/s (FFMA's beside).
    gemm_ffma = bound(gemm, rows["wide_f32_gemm"][4], PEAK_F32_FLOPS)
    gemm_tf32 = bound(3 * gemm, rows["wide_f32_gemm"][4], PEAK_TF32_FLOPS)
    for k, (ms, plain_ms, lib_ms, fl, nb) in rows.items():
        bms, by = gemm_tf32 if k == "wide_f32_gemm" else bound(fl, nb, PEAK_F32_FLOPS)
        kernels[k].update(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                          library_ms=lib_ms)
        lib = ("" if lib_ms is None else
               f"; library {lib_ms:.3f} ms (the kernel takes {ms / lib_ms:.2f}x its time)")
        log(f"  {k} at fg fine ({m} points, width {d}): {ms:.3f} ms/launch = "
            f"{fl / ms / 1e9:.2f} TFLOP/s, {nb / ms / 1e9:.3f} TB/s; plain {plain_ms:.3f} ms; "
            f"bound {bms:.3f} ms ({by}: {fl:.4g} FLOP, {nb:.4g} B){lib}")
    for shape, (pk, n, t, tp) in encode_times.items():
        c = pk.config
        nb = 4.0 * n * (c.xyz_dim + 3 + pk.ep + pk.dp)
        bms, by = bound(2.0 * n * (c.xyz_dim * 2 * c.pos_xyz_dim + 3 * 2 * c.pos_dir_dim), nb,
                        PEAK_F32_FLOPS)
        log(f"  wide_f32_encode, {shape} shape (xyz_dim {c.xyz_dim}, {pk.ep} + {pk.dp} columns) "
            f"on {n} points: {t:.4f} ms/launch ({nb / t / 1e9:.3f} TB/s, {100 * bms / t:.1f}% of "
            f"its bound); plain {tp:.3f} ms; bound {bms:.4f} ms ({by}: {nb:.4g} B)")
        out[f"encode_{shape}_ms"] = t
        out[f"encode_{shape}_bound_share"] = bms / t
    dx_bytes = 4.0 * (3 * m * d + d * d)
    dx_ffma = bound(gemm, dx_bytes, PEAK_F32_FLOPS)
    dx_bound = bound(3 * gemm, dx_bytes, PEAK_TF32_FLOPS)
    dw_ffma = bound(gemm + m * d, 4.0 * (2 * m * d + d * d + d), PEAK_F32_FLOPS)
    dw_bound = bound(3 * gemm, 4.0 * (2 * m * d + d * d + d), PEAK_TF32_FLOPS)
    log(f"  wide_f32_gemm bounds at fg fine: 3xTF32 {gemm_tf32[0]:.3f} ms ({gemm_tf32[1]}: "
        f"{3 * gemm:.4g} FLOP of TF32 products at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), FFMA "
        f"{gemm_ffma[0]:.3f} ms; the row takes 3xTF32's. As a layer the kernel runs its "
        f"products at {3 * gemm / t_layer / 1e9:.1f} TFLOP/s of TF32 and takes "
        f"{t_layer / lib_layer:.3f}x F.linear's time")
    log(f"  wide_f32_gemm as the masked dX job of that layer: {t_dx:.3f} ms = "
        f"{gemm / t_dx / 1e9:.1f} TFLOP/s ({3 * gemm / t_dx / 1e9:.1f} of TF32 products); "
        f"plain {p_dx:.3f} ms; bound {dx_bound[0]:.3f} ms ({dx_bound[1]}, 3xTF32; FFMA "
        f"{dx_ffma[0]:.3f} ms); library (F.linear, f32, no mask) {lib_dx:.3f} ms (the kernel "
        f"takes {t_dx / lib_dx:.3f}x its time)")
    log(f"  weight_grad_f32 on that layer's dW step (the wide route's jobs): {t_dw:.3f} ms = "
        f"{gemm / t_dw / 1e9:.1f} TFLOP/s; plain {p_dw:.3f} ms; bound {dw_bound[0]:.3f} ms "
        f"({dw_bound[1]}, 3xTF32 at {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s; FFMA "
        f"{dw_ffma[0]:.3f} ms); library (torch.mm, f32, no bias sums) {lib_dw:.3f} ms (the "
        f"kernel takes {t_dw / lib_dw:.2f}x its time)")
    out.update(gemm_bound_ms=gemm_tf32[0], gemm_ffma_bound_ms=gemm_ffma[0],
               dx_ffma_bound_ms=dx_ffma[0])
    out.update(dx_ms=t_dx, dx_plain_ms=p_dx, dx_library_ms=lib_dx, dx_bound_ms=dx_bound[0],
               dw_ms=t_dw, dw_plain_ms=p_dw, dw_library_ms=lib_dw, dw_bound_ms=dw_bound[0],
               dw_ffma_bound_ms=dw_ffma[0],
               layer_ms=t_layer, layer_library_ms=lib_layer)


def eager_wide_f32_steps(report, tmp: Path, ckpt: Path) -> None:
    """A record, not a check: EAGER_WIDE_F32_STEPS training steps in f32 at
    fg and bg 8x1024 through the eager module (`--no_pallas`), and with
    `--remat`, from the f32 checkpoint: ms a step after a warm-up step and
    peak device memory, or the out-of-memory error."""
    import copy

    import torch

    from mega_nerf_tpu_torch.parallel.train_step import TrainStep
    from mega_nerf_tpu_torch.render.rendering import RenderSettings

    out = report["training_wide_f32"]
    batches = report["train_batches"]
    for label, remat in (("--no_pallas", False), ("--no_pallas --remat", True)):
        runner = wide_f32_runner(tmp, ckpt)
        hp = copy.copy(runner.hparams)
        hp.use_fused_kernel, hp.remat = False, remat
        step = TrainStep(runner.fg, runner.bg, RenderSettings.from_hparams(hp), 5e-4, 0.1,
                         TRAIN_WIDE_F32_STEPS, runner.sphere_center, runner.sphere_radius)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        done, t0 = 0, time.perf_counter()
        try:
            with EagerCalls() as calls:
                step(batches[0])  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for b in batches[1:EAGER_WIDE_F32_STEPS]:
                    step(b)
                    done += 1
                torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) / max(done, 1) * 1e3
            peak = torch.cuda.max_memory_allocated() / 1e9
            log(f"  f32 eager module ({label}) at {hp.layer_dim}/{hp.bg_layer_dim}: "
                f"{step_ms:.2f} ms/step over "
                f"{done} steps after a warm-up, peak device memory allocated {peak:.2f} GB, "
                f"{calls.count} module calls")
            out[f"eager{'_remat' if remat else ''}"] = {"step_ms": step_ms,
                                                        "peak_mem_gb": peak}
        except torch.cuda.OutOfMemoryError as e:
            peak = torch.cuda.max_memory_allocated() / 1e9
            first = str(e).splitlines()[0] if str(e) else repr(e)
            log(f"  f32 eager module ({label}) at {hp.layer_dim}/{hp.bg_layer_dim}: out of "
                f"device memory "
                f"(peak allocated {peak:.2f} GB): {first}")
            out[f"eager{'_remat' if remat else ''}"] = {"error": first, "peak_mem_gb": peak}
        del step, runner
        torch.cuda.empty_cache()


def kernel_times(run, reps: int):
    """Device time by kernel over `run()`, which makes `reps` repetitions
    (torch.profiler) -> (rows [(ms per rep, launches per rep, name)],
    largest first; device busy ms; wall ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", 0.0) or 0.0
        if dev > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3 / reps, e.count // reps, e.key))
    rows.sort(reverse=True)
    return rows, sum(r[0] for r in rows) * reps, wall_ms


def profile_steps(step, batches, report) -> None:
    """Device time by kernel over a few chained steps (torch.profiler) and
    the device's busy share of the window."""
    rows, busy, wall_ms = kernel_times(lambda: [step(b) for b in batches],
                                       len(batches))
    if not rows:
        log("  profiler: no device time recorded (device share not measured)")
        return
    log(f"  profiler over {len(batches)} steps: device busy {busy:.1f} ms of "
        f"{wall_ms:.1f} ms wall ({100 * busy / wall_ms:.1f}%); per step by kernel:")
    for ms, count, name in rows[:15]:
        log(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    rest = sum(r[0] for r in rows[15:])
    log(f"    {rest:8.3f} ms  in {len(rows) - 15} other kernels")
    report["training"]["profiled_device_busy_share"] = busy / wall_ms


def profile_dense_view(runner, meta, report, section="serving_dense",
                       label="dense") -> None:
    """Where a wide view's device time goes (torch.profiler over one view):
    the wide kernels by name, the rest (the renderer's own work) together,
    and the device's busy share of the view -> report[section]["profile"]."""
    rows, busy, wall_ms = kernel_times(lambda: runner.render_image(meta), 1)
    if not rows:
        log(f"  profiler: no device time recorded ({label} breakdown not measured)")
        return
    parts = {k: [0.0, 0] for k in WIDE_KERNELS}
    parts["other"] = [0.0, 0]
    for ms, count, name in rows:
        key = next((k for k in WIDE_KERNELS if f"{k}_kernel" in name), "other")
        parts[key][0] += ms
        parts[key][1] += count
    log(f"  {label} view profile: device busy {busy:.1f} ms of {wall_ms:.1f} ms "
        f"wall ({100 * busy / wall_ms:.1f}%); "
        + ", ".join(f"{k} {ms:.1f} ms ({100 * ms / busy:.1f}%, x{n})"
                    for k, (ms, n) in parts.items()))
    for ms, count, name in [r for r in rows if not any(
            f"{k}_kernel" in r[2] for k in WIDE_KERNELS)][:5]:
        log(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    report[section]["profile"] = {
        "busy_ms": busy, "wall_ms": wall_ms,
        **{k: {"ms": ms, "launches": n} for k, (ms, n) in parts.items()}}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import mega_nerf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    if len(sys.argv) > 2 and sys.argv[1] == "--multiproc_worker":
        return multiproc_worker(Path(sys.argv[2]))
    device = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    log(f"device: {torch.cuda.get_device_name(0)} ({smi_line}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    report = {"kernels": {name: {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "library_ms": None, "launches_serve_routed": None, "launches_train_mega": None,
        "launches_multiproc": None, "launches_resume_jax": None,
        "launches_train_wide_f32": None, "launches_converge": None,
        "launches_converge_cells": None}
        for name, source, replaces in KERNELS}, "device_line": smi_line}
    ok = True
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        phases = (
            ("build", lambda: phase_build(device, report)),
            ("compare", lambda: phase_compare(device, report)),
            ("compare_wide", lambda: phase_compare_wide(device, report)),
            ("compare_train_wide", lambda: phase_compare_train_wide(device, report)),
            ("compare_f32", lambda: phase_compare_f32(device, report)),
            ("serve", lambda: phase_serve(device, report, Path(tmp))),
            ("serve_mega", lambda: phase_serve_mega(device, report, Path(tmp))),
            ("bake", lambda: phase_bake(device, report, Path(tmp))),
            ("serve_routed", lambda: phase_serve_routed(device, report, Path(tmp))),
            ("serve_dense", lambda: phase_serve_dense(device, report, Path(tmp))),
            ("train", lambda: phase_train(device, report, Path(tmp))),
            ("train_fs", lambda: phase_train_fs(device, report, Path(tmp))),
            ("train_cells", lambda: phase_train_cells(device, report, Path(tmp))),
            ("converge", lambda: phase_converge(device, report, Path(tmp))),
            ("converge_cells", lambda: phase_converge_cells(device, report, Path(tmp))),
            ("multiproc", lambda: phase_multiproc(device, report, Path(tmp))),
            ("train_mega", lambda: phase_train_mega(device, report, Path(tmp))),
            ("train_wide", lambda: phase_train_wide(device, report, Path(tmp))),
            ("time", lambda: phase_time(device, report)),
            ("time_dense", lambda: phase_time_dense(device, report)),
            ("time_train_wide", lambda: phase_time_train_wide(device, report, Path(tmp))),
            ("serve_cascade", lambda: phase_serve_cascade(device, report, Path(tmp))),
            ("train_cascade", lambda: phase_train_cascade(device, report, Path(tmp))),
            ("train_sh", lambda: phase_train_sh(device, report, Path(tmp))),
            ("eager_dense", lambda: phase_eager_dense(device, report, Path(tmp))),
            ("eager_train_wide", lambda: phase_eager_train_wide(device, report, Path(tmp))),
            ("remat", lambda: phase_remat(device, report, Path(tmp))),
            ("resume_jax", lambda: phase_resume_jax(device, report, Path(tmp))),
            ("train_f32", lambda: phase_train_f32(device, report, Path(tmp))),
            ("compare_wide_f32", lambda: phase_compare_wide_f32(device, report)),
            ("train_wide_f32", lambda: phase_train_wide_f32(device, report, Path(tmp))),
        )
        for phase, run in phases:
            log(f"[{phase}]")
            t0 = time.perf_counter()
            good = run()
            log(f"[{phase}] {'ok' if good else 'FAILED'} in "
                f"{time.perf_counter() - t0:.1f} s")
            ok &= good
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "launches_serve_routed", "launches_train_mega", "launches_multiproc",
            "launches_resume_jax", "launches_train_wide_f32", "launches_converge",
            "launches_converge_cells")
    kernels = [{k: entry[k] for k in keys} for entry in report["kernels"].values()]
    serving = {k: report[k] for k in ("s_per_view", "rays_per_s",
                                      "render_rgb_diff", "eval_chunk_ms",
                                      "eval_kernel")}
    log(json.dumps({"serving": serving}))
    log(json.dumps({"serving_mega": report["serving_mega"]}))
    log(json.dumps({"serving_dense": report["serving_dense"]}))
    log(json.dumps({"training": report["training"]}))
    log(json.dumps({"training_fs": report["training_fs"]}))
    log(json.dumps({"training_wide": report["training_wide"]}))
    log(json.dumps({"serving_cascade": report["serving_cascade"]}))
    log(json.dumps({"training_cascade": report["training_cascade"]}))
    log(json.dumps({"training_sh": report["training_sh"]}))
    log(json.dumps({"remat": report["remat"]}))
    log(json.dumps({"training_cells": report["training_cells"]}))
    log(json.dumps({"converge": report["converge"]}))
    log(json.dumps({"converge_cells": report["converge_cells"]}, default=str))
    log(json.dumps({"baking": report["baking"]}))
    log(json.dumps({"serving_routed": report["serving_routed"]}))
    log(json.dumps({"training_mega": report["training_mega"]}))
    log(json.dumps({"multiproc": report["multiproc"]}))
    log(json.dumps({"resume_jax": report["resume_jax"]}))
    log(json.dumps({"training_f32": report["training_f32"]}))
    log(json.dumps({"training_wide_f32": report["training_wide_f32"]}))
    log(json.dumps({"dw_f64": report["dw_f64"]}))
    log(json.dumps({"fwd_f64": report["fwd_f64"]}))
    log(json.dumps({"bwd_f64": report["bwd_f64"]}))
    log(json.dumps({"gemm_f64": report["gemm_f64"]}))
    log(json.dumps({"kernels": kernels}))
    log(smi_line)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
