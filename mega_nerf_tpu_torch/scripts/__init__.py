"""The grid workflows: `create_cluster_masks`, `merge_submodules`,
`convert_to_container`, `render_images` and `remat_steps`, each run as
`python -m mega_nerf_tpu_torch.scripts.<name>`."""
