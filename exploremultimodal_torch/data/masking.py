"""BEiT-style blockwise image mask generator (counterpart of
`exploremultimodal_tpu/data/masking.py` `MaskingGenerator`, the same draws
from the same numpy generator).

Random-aspect rectangular blocks of at least `min_num_patches` are placed
until `num_masking_patches` of the grid are masked, or no block fits.
"""

from __future__ import annotations

import math

import numpy as np


class MaskingGenerator:
    def __init__(self, input_size: int | tuple[int, int],
                 num_masking_patches: int, min_num_patches: int = 4,
                 max_num_patches: int | None = None, min_aspect: float = 0.3,
                 max_aspect: float | None = None):
        if not isinstance(input_size, tuple):
            input_size = (input_size, input_size)
        self.height, self.width = input_size
        self.num_masking_patches = num_masking_patches
        self.min_num_patches = min_num_patches
        self.max_num_patches = (num_masking_patches if max_num_patches is None
                                else max_num_patches)
        max_aspect = max_aspect or 1.0 / min_aspect
        self.log_aspect_ratio = (math.log(min_aspect), math.log(max_aspect))

    def _place_block(self, mask: np.ndarray, max_mask_patches: int,
                     rng: np.random.Generator) -> int:
        lo = min(self.min_num_patches, max_mask_patches)
        for _ in range(10):
            target_area = rng.uniform(lo, max_mask_patches)
            aspect = math.exp(rng.uniform(*self.log_aspect_ratio))
            h = int(round(math.sqrt(target_area * aspect)))
            w = int(round(math.sqrt(target_area / aspect)))
            if w < self.width and h < self.height:
                top = rng.integers(0, self.height - h + 1)
                left = rng.integers(0, self.width - w + 1)
                region = mask[top: top + h, left: left + w]
                newly = h * w - int(region.sum())
                if 0 < newly <= max_mask_patches:
                    region[:] = 1
                    return newly
        return 0

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        """(height, width) int32 mask, 1 at the masked patches."""
        mask = np.zeros((self.height, self.width), dtype=np.int32)
        count = 0
        while count < self.num_masking_patches:
            budget = min(self.num_masking_patches - count, self.max_num_patches)
            delta = self._place_block(mask, budget, rng)
            if delta == 0:
                break
            count += delta
        return mask
