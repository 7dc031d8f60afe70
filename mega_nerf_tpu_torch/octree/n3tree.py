"""N3Tree: an N^3-branching sparse voxel octree, svox-layout compatible.

A copy of the JAX package's `octree/n3tree.py` (numpy only; the port
keeps its own, since importing the JAX package's `octree` pulls in JAX).
It is the subset of the external `svox.N3Tree` container the octree baker
uses: point-indexed refinement, leaf sampling, leaf data assignment,
internal-node averaging, and `.npz` serialization in the svox array
layout, the same bytes as the JAX package's, so a tree saved by either
package loads in the other:

- `data`: (capacity, N, N, N, data_dim) float — leaf/internal payload;
- `child`: (capacity, N, N, N) int32 — RELATIVE pointer to the child node
  (child_node_index - this_node_index), 0 for leaves;
- `parent_depth`: (capacity, 2) int32 — packed parent cell index
  (node * N^3 + intra-node offset) and depth;
- `invradius3` / `offset`: world -> tree-coordinate transform
  t = x * invradius + offset, tree coords in [0, 1]^3.

Host-side numpy: tree construction is pointer-chasing, not tensor math;
the model probes and the visibility pass run on the device
(`scripts/create_octree.py`, `octree/grid_weight.py`). The serialized file
targets the layout the Mega-NeRF-Dynamic / PlenOctree viewers read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np


class N3Tree:
    def __init__(
        self,
        N: int = 2,
        data_dim: int = 4,
        depth_limit: int = 10,
        init_reserve: int = 1,
        radius: Sequence[float] | float = 0.5,
        center: Sequence[float] = (0.5, 0.5, 0.5),
        data_format: str = "RGBA",
    ):
        self.N = int(N)
        self.data_dim = int(data_dim)
        self.depth_limit = int(depth_limit)
        self.data_format = data_format
        self.geom_resize_fact = 1.0

        radius = np.broadcast_to(np.asarray(radius, np.float32), (3,)).copy()
        center = np.asarray(center, np.float32)
        self.invradius = 0.5 / radius
        self.offset = 0.5 * (1.0 - center / radius)

        cap = max(1, int(init_reserve))
        n = self.N
        self.data = np.zeros((cap, n, n, n, self.data_dim), np.float32)
        self.child = np.zeros((cap, n, n, n), np.int32)
        self.parent_depth = np.zeros((cap, 2), np.int32)
        # Node geometry caches (not serialized): corner in tree coords, depth.
        self._corner = np.zeros((cap, 3), np.float32)
        self._depth = np.zeros((cap,), np.int32)
        self.n_internal = 1  # number of allocated nodes (root included)

    # ------------------------------------------------------------- geometry

    def world_to_tree(self, xyz: np.ndarray) -> np.ndarray:
        return xyz * self.invradius + self.offset

    def tree_to_world(self, t: np.ndarray) -> np.ndarray:
        return (t - self.offset) / self.invradius

    # ---------------------------------------------------------- tree lookup

    def _locate(self, tree_coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """For each point in [0,1)^3 tree coords -> (node_index, cell_offset)
        of the containing LEAF cell. Points outside [0,1) are clamped."""
        n = self.N
        pts = np.clip(tree_coords, 0.0, np.nextafter(1.0, 0.0))
        m = pts.shape[0]
        node = np.zeros(m, np.int64)
        local = pts.copy()
        out_node = np.full(m, -1, np.int64)
        out_cell = np.zeros((m, 3), np.int64)
        active = np.arange(m)
        while active.size:
            idx = np.minimum((local[active] * n).astype(np.int64), n - 1)
            ptr = self.child[
                node[active], idx[:, 0], idx[:, 1], idx[:, 2]
            ].astype(np.int64)
            is_leaf = ptr == 0
            leaf_sel = active[is_leaf]
            out_node[leaf_sel] = node[leaf_sel]
            out_cell[leaf_sel] = idx[is_leaf]
            go = active[~is_leaf]
            node[go] = node[go] + ptr[~is_leaf]
            local[go] = local[go] * n - idx[~is_leaf]
            active = go
        return out_node, out_cell

    # ------------------------------------------------------------- refining

    def _ensure_capacity(self, needed: int) -> None:
        cap = self.data.shape[0]
        if needed <= cap:
            return
        new_cap = max(needed, int(cap * 1.5) + 1)
        n = self.N

        def grow(arr, shape_tail):
            out = np.zeros((new_cap, *shape_tail), arr.dtype)
            out[:cap] = arr
            return out

        self.data = grow(self.data, (n, n, n, self.data_dim))
        self.child = grow(self.child, (n, n, n))
        self.parent_depth = grow(self.parent_depth, (2,))
        self._corner = grow(self._corner, (3,))
        self._depth = grow(self._depth, ())

    def refine_at_points(self, world_points: np.ndarray) -> int:
        """Subdivide every leaf cell containing one of `world_points`
        (the `tree[grid].refine()` pattern, reference
        `create_octree.py:183-184`). Returns number of new nodes."""
        node, cell = self._locate(self.world_to_tree(world_points))
        packed = node * self.N**3 + (
            cell[:, 0] * self.N + cell[:, 1]
        ) * self.N + cell[:, 2]
        targets = np.unique(packed)
        # Respect the depth limit.
        depths = self._depth[targets // self.N**3]
        targets = targets[depths < self.depth_limit]
        if targets.size == 0:
            return 0

        n = self.N
        start = self.n_internal
        self._ensure_capacity(start + targets.size)
        for new_idx, t in enumerate(targets, start=start):
            pn = int(t // n**3)
            rem = int(t % n**3)
            ci, cj, ck = rem // (n * n), (rem // n) % n, rem % n
            self.child[pn, ci, cj, ck] = new_idx - pn
            self.parent_depth[new_idx] = (t, self._depth[pn] + 1)
            cell_side = float(n) ** -(self._depth[pn] + 1)
            self._corner[new_idx] = self._corner[pn] + (
                np.array([ci, cj, ck], np.float32) * cell_side
            )
            self._depth[new_idx] = self._depth[pn] + 1
            # Child node inherits the parent cell payload.
            self.data[new_idx] = self.data[pn, ci, cj, ck]
        self.n_internal = start + targets.size
        return targets.size

    # ----------------------------------------------------------- leaf views

    def leaf_mask(self) -> np.ndarray:
        return self.child[: self.n_internal] == 0

    def leaf_indices(self) -> np.ndarray:
        """(L, 4) [node, i, j, k] in C order — the canonical leaf ordering."""
        return np.argwhere(self.leaf_mask())

    @property
    def n_leaves(self) -> int:
        return int(self.leaf_mask().sum())

    def leaf_bounds(self, leaves: Optional[np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(corner, side) of each leaf cell in tree coords."""
        if leaves is None:
            leaves = self.leaf_indices()
        node = leaves[:, 0]
        side = (
            np.float32(self.N) ** -(self._depth[node] + 1)
        ).astype(np.float32)
        corner = self._corner[node] + leaves[:, 1:] * side[:, None]
        return corner, side

    def sample_leaves(
        self, leaves: np.ndarray, samples_per_cell: int,
        rng: np.random.Generator,
    ) -> np.ndarray:
        """(L, S, 3) random world points inside each leaf cell
        (the `tree[i:j].sample(n)` pattern, reference `create_octree.py:194`)."""
        corner, side = self.leaf_bounds(leaves)
        u = rng.random((leaves.shape[0], samples_per_cell, 3), np.float32)
        t = corner[:, None, :] + u * side[:, None, None]
        return self.tree_to_world(t)

    def set_leaf_data(self, leaves: np.ndarray, values: np.ndarray) -> None:
        self.data[leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3]] = values

    def get_leaf_data(self, leaves: np.ndarray) -> np.ndarray:
        return self.data[leaves[:, 0], leaves[:, 1], leaves[:, 2], leaves[:, 3]]

    # ------------------------------------------------- internal-node filling

    def fill_internal(self) -> None:
        """Average child-node payloads into their parent cells, deepest
        first — the effect of the reference's repeated merge()/restore dance
        (`create_octree.py:274-286`), done directly."""
        order = np.argsort(-self._depth[: self.n_internal])
        for node in order:
            if node == 0:
                continue
            t, _ = self.parent_depth[node]
            n = self.N
            pn, rem = int(t) // n**3, int(t) % n**3
            ci, cj, ck = rem // (n * n), (rem // n) % n, rem % n
            self.data[pn, ci, cj, ck] = self.data[node].reshape(
                -1, self.data_dim
            ).mean(axis=0)

    # ---------------------------------------------------------------- save

    def shrink_to_fit(self) -> None:
        used = self.n_internal
        self.data = self.data[:used].copy()
        self.child = self.child[:used].copy()
        self.parent_depth = self.parent_depth[:used].copy()
        self._corner = self._corner[:used].copy()
        self._depth = self._depth[:used].copy()

    def save(self, path, compress: bool = False) -> None:
        """svox-layout .npz (reference `create_octree.py:291`)."""
        payload = {
            "data_dim": self.data_dim,
            "child": self.child[: self.n_internal],
            "parent_depth": self.parent_depth[: self.n_internal],
            "n_internal": self.n_internal,
            "n_free": 0,
            "invradius3": self.invradius.astype(np.float32),
            "offset": self.offset.astype(np.float32),
            "depth_limit": self.depth_limit,
            "geom_resize_fact": self.geom_resize_fact,
            "data": self.data[: self.n_internal].astype(np.float16),
            "data_format": self.data_format,
        }
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        if compress:
            np.savez_compressed(path, **payload)
        else:
            np.savez(path, **payload)

    @classmethod
    def load(cls, path) -> "N3Tree":
        z = np.load(path, allow_pickle=True)
        child = z["child"]
        n = child.shape[1]
        tree = cls(N=n, data_dim=int(z["data_dim"]),
                   depth_limit=int(z["depth_limit"]),
                   data_format=str(z["data_format"]))
        tree.invradius = z["invradius3"].astype(np.float32)
        tree.offset = z["offset"].astype(np.float32)
        tree.n_internal = int(z["n_internal"])
        tree.child = child.astype(np.int32)
        tree.parent_depth = z["parent_depth"].astype(np.int32)
        tree.data = z["data"].astype(np.float32)
        # Rebuild geometry caches by walking parents in allocation order.
        cap = tree.n_internal
        tree._corner = np.zeros((cap, 3), np.float32)
        tree._depth = np.zeros((cap,), np.int32)
        for node in range(1, cap):
            t, d = tree.parent_depth[node]
            pn, rem = int(t) // n**3, int(t) % n**3
            ci, cj, ck = rem // (n * n), (rem // n) % n, rem % n
            tree._depth[node] = d
            side = np.float32(n) ** -np.float32(d)
            tree._corner[node] = tree._corner[pn] + np.array(
                [ci, cj, ck], np.float32
            ) * side
        return tree

    def __repr__(self) -> str:
        return (
            f"N3Tree(N={self.N}, data_dim={self.data_dim}, "
            f"nodes={self.n_internal}, leaves={self.n_leaves}, "
            f"format={self.data_format})"
        )
