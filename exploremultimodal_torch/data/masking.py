"""Image patch maskers (counterpart of `exploremultimodal_tpu/data/masking.py`:
`MaskingGenerator`, `RandomMaskingGenerator`, `RegionMaskingGenerator`, the
same draws from the same numpy generator).

`MaskingGenerator` (BEiT's blockwise masks) places random-aspect
rectangular blocks of at least `min_num_patches` until
`num_masking_patches` of the grid are masked, or no block fits.
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


class RandomMaskingGenerator:
    """`num_mask` patches of the grid drawn uniformly (one permutation of
    the patches), as a flat (num_patches,) int32 mask."""

    def __init__(self, input_size: int | tuple[int, int], num_mask: int):
        if not isinstance(input_size, tuple):
            input_size = (input_size, input_size)
        self.num_patches = input_size[0] * input_size[1]
        self.num_mask = num_mask

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        mask = np.zeros(self.num_patches, dtype=np.int32)
        mask[rng.permutation(self.num_patches)[: self.num_mask]] = 1
        return mask


class RegionMaskingGenerator:
    """One random rectangle of at most `num_masking_patches` patches
    (`data.mask_style=region`, the inpainting hole): a height drawn
    uniformly, the widest width that keeps the area within the budget,
    then a uniform position. The draw favours thin regions, so the masked
    area is skewed below the budget."""

    def __init__(self, input_size: int | tuple[int, int], num_masking_patches: int):
        if not isinstance(input_size, tuple):
            input_size = (input_size, input_size)
        self.height, self.width = input_size
        self.num_masking_patches = num_masking_patches

    def __call__(self, rng: np.random.Generator) -> np.ndarray:
        """(height, width) int32 mask, 1 inside the region."""
        mask = np.zeros((self.height, self.width), dtype=np.int32)
        target = max(1, self.num_masking_patches)
        h = int(rng.integers(1, min(self.height, target) + 1))
        w = min(self.width, max(1, target // h))
        top = int(rng.integers(0, self.height - h + 1))
        left = int(rng.integers(0, self.width - w + 1))
        mask[top: top + h, left: left + w] = 1
        return mask
