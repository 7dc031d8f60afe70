"""Pixel extraction with cluster/dataset masks and the val-image protocol.

A copy of the JAX package's `data/dataset_utils.py`. Validation images also
contribute training pixels, but only their LEFT half; the right half is
held out for eval metrics. When a cluster mask would have selected
right-half pixels, the same number of random unselected left-half pixels
is added instead to keep the per-cell ray balance.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from mega_nerf_tpu_torch.data.image_metadata import ImageMetadata


def get_rgb_index_mask(
    metadata: ImageMetadata,
    rng: Optional[np.random.Generator] = None,
) -> Optional[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]]:
    """-> (rgbs (M, 3) u8, image_indices (M,) i32, keep_mask (H*W,) bool | None).

    The keep_mask (when present) marks which pixels of the flattened image
    were kept, so callers can subset per-pixel rays the same way.
    """
    if rng is None:
        rng = np.random.default_rng(metadata.image_index)

    rgbs = metadata.load_image().reshape(-1, 3)
    keep_mask = metadata.load_mask()

    if metadata.is_val:
        h, w = metadata.H, metadata.W
        if keep_mask is None:
            keep_mask = np.ones((h, w), dtype=bool)
        else:
            keep_mask = keep_mask.copy()
            # Count masked-in pixels about to be discarded on the right...
            discard_pos_count = int(keep_mask[:, w // 2:].sum())
            # ...and rebalance with random unmasked left-half pixels.
            candidates = np.arange(h * w).reshape(h, w)[:, : w // 2]
            candidates = candidates[~keep_mask[:, : w // 2]].reshape(-1)
            to_add = rng.permutation(candidates)[:discard_pos_count]
            flat = keep_mask.reshape(-1)
            flat[to_add] = True
            keep_mask = flat.reshape(h, w)
        keep_mask[:, metadata.W // 2:] = False

    if keep_mask is not None:
        if keep_mask.sum() == 0:
            return None
        keep_mask = keep_mask.reshape(-1)
        rgbs = rgbs[keep_mask]

    assert metadata.image_index <= np.iinfo(np.int32).max
    indices = np.full(rgbs.shape[0], metadata.image_index, dtype=np.int32)
    return rgbs, indices, keep_mask
