"""mega_nerf_tpu_torch — the PyTorch/CUDA port of mega_nerf_tpu.

A second package beside the JAX one, with the same subpackage names:
`ops` (rays, sampling, compositing, metrics), `models` (the NeRF module,
factory, weight carry-over), `render` (the renderer, the fused eval MLP
kernel `render/csrc/fused_mlp.cu` and the fused training kernels
`render/csrc/fused_train.cu`, all for Hopper), `parallel` (the training
step), `data`, `runtime`, and the `train` and `eval` entry points. It
imports torch, never jax and nothing of mega_nerf_tpu.
"""
