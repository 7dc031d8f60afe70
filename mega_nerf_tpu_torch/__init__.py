"""mega_nerf_tpu_torch — the PyTorch/CUDA port of mega_nerf_tpu.

A second package beside the JAX one, with the same subpackage names:
`ops` (rays, sampling, compositing, metrics), `models` (the NeRF module,
factory, weight carry-over), `render` (the renderer, the fused eval MLP
kernel `render/csrc/eval_fwd.cu` and the fused training kernels
`render/csrc/train_fwd.cu`, `train_bwd.cu` and `weight_grad.cu`, all for
Hopper), `parallel` (the training
step and the grid step), `data`, `runtime`, `scripts`, and the `train`,
`train_cells` and `eval` entry points. It imports torch, never jax and
nothing of mega_nerf_tpu.
"""
