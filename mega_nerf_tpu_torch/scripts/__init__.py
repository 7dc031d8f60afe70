"""The merged-model workflows: `merge_submodules`, `convert_to_container`
and `render_images`, each run as `python -m mega_nerf_tpu_torch.scripts.<name>`."""
