"""The workflows around training: `colmap_to_mega_nerf` and `copy_images`
(dataset import), `create_cluster_masks`, `merge_submodules`,
`convert_to_container`, `render_images`, the bakes and `remat_steps`, each
run as `python -m mega_nerf_tpu_torch.scripts.<name>`."""
