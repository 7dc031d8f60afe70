"""Per-image lazy metadata + pixel/mask IO.

A copy of the JAX package's `data/image_metadata.py`: images load with PIL
and are LANCZOS-downscaled to the pre-divided W/H; masks come from the
zip(torch) format and are nearest-resized if their resolution differs.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from mega_nerf_tpu_torch.data.torch_io import load_mask_zip


class ImageMetadata:
    def __init__(
        self,
        image_path: Path,
        c2w: np.ndarray,  # (3, 4) DRB
        w: int,
        h: int,
        intrinsics: np.ndarray,  # (4,) fx fy cx cy (already scale-divided)
        image_index: int,
        mask_path: Optional[Path],
        is_val: bool,
    ):
        self.image_path = Path(image_path)
        self.c2w = np.asarray(c2w, dtype=np.float32)
        self.W = int(w)
        self.H = int(h)
        self.intrinsics = np.asarray(intrinsics, dtype=np.float32)
        self.image_index = int(image_index)
        self._mask_path = Path(mask_path) if mask_path is not None else None
        self.is_val = bool(is_val)

    def load_image(self) -> np.ndarray:
        """(H, W, 3) uint8, LANCZOS-downscaled if needed."""
        from PIL import Image

        rgbs = Image.open(self.image_path).convert("RGB")
        if rgbs.size != (self.W, self.H):
            rgbs = rgbs.resize((self.W, self.H), Image.LANCZOS)
        return np.asarray(rgbs, dtype=np.uint8)

    def load_mask(self) -> Optional[np.ndarray]:
        """(H, W) bool keep-mask or None."""
        if self._mask_path is None:
            return None
        mask = load_mask_zip(self._mask_path)
        if mask.shape != (self.H, self.W):
            from PIL import Image

            img = Image.fromarray(mask.astype(np.uint8) * 255)
            mask = (
                np.asarray(img.resize((self.W, self.H), Image.NEAREST)) > 127
            )
        return mask
