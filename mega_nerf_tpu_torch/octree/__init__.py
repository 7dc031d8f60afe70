"""Sparse voxel octree (PlenOctree-style) for baking merged models.

The port's counterpart of the JAX package's `octree/`: a host-side numpy
N3Tree (svox layout) and the torch visibility pass the bake culls voxels
with.
"""

from mega_nerf_tpu_torch.octree.grid_weight import grid_weight_render_max
from mega_nerf_tpu_torch.octree.n3tree import N3Tree

__all__ = ["N3Tree", "grid_weight_render_max"]
