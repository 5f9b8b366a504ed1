"""Device-side anyres preprocessing (resize + pad + tile + CLIP normalize).

Port of ``slime_tpu/data/image_ops.py:make_device_anyres_fn`` (:209-262). The
crop grid is a static function of the source size (``slime_tpu.data.anyres``
decides it on the host); each resize is two matmuls with PIL-exact bicubic
weight matrices, so the whole pipeline runs on the device without gathers.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from slime_tpu.data import anyres

from ..config import CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, IMAGE_WIDTH, MAX_CROPS
from ..models.layers import pil_resize_matrix


def make_device_anyres_fn(src_hw: Tuple[int, int], *, tile: int = IMAGE_WIDTH,
                          max_crops: int = MAX_CROPS, device="cpu"
                          ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Build fn: uint8 image [H, W, 3] -> (crops [max_crops, 3, tile, tile]
    fp32, mask [max_crops] bool). crops[0] is the global view, then the local
    tiles row-major, then zero padding with mask False."""
    h, w = src_hw
    best = anyres.select_best_resolution_uhd((w, h), (tile, tile))
    (nw, nh), (px, py) = anyres.resize_and_pad_geometry((w, h), best)
    cols, rows = best[0] // tile, best[1] // tile
    n_local = cols * rows
    if 1 + n_local > max_crops:
        raise ValueError(f"grid {cols}x{rows} exceeds the crop budget {max_crops}")

    mat = lambda s, d: torch.from_numpy(pil_resize_matrix(s, d)).to(device)  # noqa: E731
    gy, gx = mat(h, tile), mat(w, tile)
    fy, fx = mat(h, nh), mat(w, nw)
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=device).reshape(3, 1, 1)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=device).reshape(3, 1, 1)
    mask = torch.arange(max_crops, device=device) < (1 + n_local)

    def _resize(x, wy, wx):
        t = torch.einsum("oh,hwc->owc", wy, x)
        return torch.einsum("pw,owc->opc", wx, t)

    def fn(img_hwc: torch.Tensor):
        x = img_hwc.to(torch.float32) / 255.0                  # [H, W, 3]
        g = _resize(x, gy, gx)
        canvas = torch.zeros((best[1], best[0], 3), dtype=torch.float32,
                             device=x.device)
        canvas[py:py + nh, px:px + nw] = _resize(x, fy, fx)
        tiles = canvas.reshape(rows, tile, cols, tile, 3).permute(0, 2, 1, 3, 4)
        tiles = tiles.reshape(n_local, tile, tile, 3)
        stack = torch.cat([g[None], tiles], dim=0).permute(0, 3, 1, 2)   # CHW
        stack = (torch.clamp(stack, 0.0, 1.0) - mean) / std
        pad = max_crops - (1 + n_local)
        stack = torch.cat([stack, stack.new_zeros((pad,) + stack.shape[1:])])
        return stack, mask

    return fn
