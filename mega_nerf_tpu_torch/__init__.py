"""mega_nerf_tpu_torch — the PyTorch/CUDA port of mega_nerf_tpu.

A second package beside the JAX one, with the same subpackage names:
`ops` (rays, sampling, compositing, metrics), `models` (the NeRF module,
factory, weight carry-over), `render` (the eval renderer and the fused
eval MLP kernel for Hopper, `render/csrc/fused_mlp.cu`), `data`, `runtime`
and the `eval` entry point. It imports torch, never jax and nothing of
mega_nerf_tpu.
"""
