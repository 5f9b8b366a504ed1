"""AnyRes / UHD crop-grid selection (the port's copy of ``slime_tpu/data/anyres.py``).

Integer and float functions, no tensors, that decide how a high-resolution
image is cut into 336x336 crops, with the reference's behaviour:

- ``compute_slice_grid``: ``cal_num_of_slices`` (llava/process_image.py:70-101)
- ``select_best_resolution_uhd`` (llava/mm_utils.py:41-97)
- ``select_best_resolution``, the pinpoint-list variant (llava/mm_utils.py:12-39)
- ``resize_and_pad_geometry``: the geometry of ``resize_and_pad_image``
  (llava/mm_utils.py:99-131)
- ``get_anyres_image_grid_shape`` (llava/mm_utils.py:156-174)
- ``adapt_size`` (llava/process_image.py:48-68)
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

from ..constants import IMAGE_HEIGHT, IMAGE_WIDTH, MAX_PATCHES, PATCH_SIZE


def _factor_pairs(n: int) -> List[Tuple[float, int, int]]:
    """All (cols/rows ratio, cols, rows) factorizations of n, cols ascending."""
    return [(i / (n // i), i, n // i) for i in range(1, n + 1) if n % i == 0]


def _candidate_grids(scale: int) -> List[Tuple[float, int, int]]:
    """Candidate grids for an area scale: factorizations of {scale, scale+1}
    for scale <= 2, else of {scale-1, scale, scale+1} (at most 7 crops)."""
    ns = [scale, scale + 1] if scale <= 2 else [scale - 1, scale, scale + 1]
    return [c for n in ns for c in _factor_pairs(n)]


def area_scale(width: int, height: int, clamp_max: int = 6) -> int:
    """ceil(image area / 336^2), clamped to [1, clamp_max]."""
    scale = math.ceil(width * height / (IMAGE_WIDTH * IMAGE_HEIGHT))
    return max(1, min(scale, clamp_max))


def compute_slice_grid(width: int, height: int) -> Tuple[int, int]:
    """The (cols, rows) grid whose aspect ratio best matches the image (least
    |log(cols/rows) - log(w/h)|, the first best on ties)."""
    log_ratio = math.log(width / height)
    best, best_diff = (1, 1), float("inf")
    for r, cols, rows in _candidate_grids(area_scale(width, height)):
        d = abs(math.log(r) - log_ratio)
        if d < best_diff:
            best_diff, best = d, (cols, rows)
    return best


def _best_target(original_size, targets) -> Tuple[int, int]:
    """The target that maximizes the effective resolution, then minimizes the
    wasted area."""
    ow, oh = original_size
    best, max_eff, min_waste = None, 0, float("inf")
    for w, h in targets:
        s = min(w / ow, h / oh)
        eff = min(int(ow * s) * int(oh * s), ow * oh)
        waste = w * h - eff
        if eff > max_eff or (eff == max_eff and waste < min_waste):
            max_eff, min_waste, best = eff, waste, (w, h)
    return best


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """LLaVA-NeXT pinpoint selection."""
    return _best_target(original_size, possible_resolutions)


def select_best_resolution_uhd(original_size: Tuple[int, int],
                               tile: Tuple[int, int] = (IMAGE_WIDTH, IMAGE_HEIGHT)
                               ) -> Tuple[int, int]:
    """UHD rule: (cols*336, rows*336) targets from the area scale, picked by the
    pinpoint criterion. A scale of 1 is promoted to 2 (UHD always slices)."""
    tw, th = tile
    ow, oh = original_size
    scale = math.ceil(ow * oh / (tw * th))
    scale = 6 if scale > 6 else (2 if scale == 1 else scale)
    return _best_target(original_size, [(cols * tw, rows * th)
                                        for _, cols, rows in _candidate_grids(scale)])


def resize_and_pad_geometry(original_size: Tuple[int, int],
                            target_resolution: Tuple[int, int]
                            ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Aspect-preserving fit -> ((new_w, new_h), (paste_x, paste_y)) on a
    black canvas of the target size."""
    ow, oh = original_size
    tw, th = target_resolution
    if tw / ow < th / oh:
        nw, nh = tw, min(math.ceil(oh * (tw / ow)), th)
    else:
        nw, nh = min(math.ceil(ow * (th / oh)), tw), th
    return (nw, nh), ((tw - nw) // 2, (th - nh) // 2)


def get_anyres_image_grid_shape(image_size: Tuple[int, int],
                                tile: int = IMAGE_WIDTH) -> Tuple[int, int]:
    """(cols, rows) of the crop grid the UHD rule picks for ``image_size``."""
    w, h = select_best_resolution_uhd(image_size, (tile, tile))
    return w // tile, h // tile


def adapt_size(origin_height: int, origin_width: int,
               patch_height: int = PATCH_SIZE, patch_width: int = PATCH_SIZE,
               max_patches: int = MAX_PATCHES) -> Tuple[int, int, int, int]:
    """Pix2struct-style fit to at most ``max_patches`` patches, aspect kept ->
    (resized_h, resized_w, n_patches_h, n_patches_w)."""
    scale = math.sqrt(max_patches * (patch_height / origin_height)
                      * (patch_width / origin_width))
    nph = max(min(math.floor(scale * origin_height / patch_height), max_patches), 1)
    npw = max(min(math.floor(scale * origin_width / patch_width), max_patches), 1)
    return max(nph * PATCH_SIZE, 1), max(npw * PATCH_SIZE, 1), nph, npw


def get_patch_nums(origin_width: int, origin_height: int) -> Tuple[int, int, int, int]:
    """(slice_w_num, slice_h_num, abstract_w_num, abstract_h_num)."""
    cols, rows = compute_slice_grid(origin_width, origin_height)
    _, _, slice_h_num, slice_w_num = adapt_size(origin_height // rows,
                                                origin_width // cols)
    _, _, abstract_h_num, abstract_w_num = adapt_size(origin_height, origin_width)
    return slice_w_num, slice_h_num, abstract_w_num, abstract_h_num


def slice_boxes(width: int, height: int) -> List[Tuple[int, int, int, int]]:
    """Crop boxes (left, top, right, bottom), row-major
    (llava/process_image.py:119-139)."""
    cols, rows = compute_slice_grid(width, height)
    return [(i * width // cols, j * height // rows,
             (i + 1) * width // cols, (j + 1) * height // rows)
            for j in range(rows) for i in range(cols)]
