"""Image preprocessing: anyres slicing and CLIP normalization, on the host
and on the device.

The host path (PIL + numpy; ``slime_tpu/data/image_ops.py:37-120``) follows
the reference's ``process_anyres_image`` (llava/mm_utils.py:177-210) for data
loading. The device path (``make_device_anyres_fn``, ``image_ops.py:209-262``)
computes the same crops with PIL-exact bicubic weight matrices, each resize
two matmuls, so the whole pipeline runs on the card without gathers. The crop
grid is a static function of the source size (``data.anyres``).
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..constants import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, IMAGE_WIDTH,
                         MAX_CROPS)
from ..models.layers import pil_resize_matrix, resolve_device
from . import anyres

_MEAN = np.asarray(CLIP_IMAGE_MEAN, dtype=np.float32).reshape(3, 1, 1)
_STD = np.asarray(CLIP_IMAGE_STD, dtype=np.float32).reshape(3, 1, 1)


def clip_normalize(chw: np.ndarray) -> np.ndarray:
    """uint8/float [3, H, W] in [0, 255] -> CLIP-normalized float32."""
    return (chw.astype(np.float32) / 255.0 - _MEAN) / _STD


def _pil_to_chw(img) -> np.ndarray:
    return np.asarray(img.convert("RGB"), dtype=np.uint8).transpose(2, 0, 1)


def process_anyres_image_host(img, *, tile: int = IMAGE_WIDTH,
                              max_crops: int = MAX_CROPS, normalize: bool = True
                              ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """PIL image -> (crops [max_crops, 3, tile, tile], crop_mask [max_crops]
    bool, grid (cols, rows)). crops[0] is the global view (a square bicubic
    resize), then the local tiles of the resized-and-padded image row-major,
    then zeros with mask False. ``normalize=False`` keeps raw uint8 crops
    (``slime.encode_images`` normalizes those on the device)."""
    from PIL import Image

    img = img.convert("RGB")
    best = anyres.select_best_resolution_uhd(img.size, (tile, tile))
    (nw, nh), (px, py) = anyres.resize_and_pad_geometry(img.size, best)
    canvas = Image.new("RGB", best, (0, 0, 0))
    canvas.paste(img.resize((nw, nh), Image.BICUBIC), (px, py))
    cols, rows = best[0] // tile, best[1] // tile
    if 1 + cols * rows > max_crops:
        raise ValueError(f"grid {cols}x{rows} exceeds the crop budget {max_crops}")

    post = clip_normalize if normalize else (lambda x: x)
    out = np.zeros((max_crops, 3, tile, tile), dtype=np.float32 if normalize else np.uint8)
    mask = np.zeros((max_crops,), dtype=bool)
    out[0] = post(_pil_to_chw(img.resize((tile, tile), Image.BICUBIC)))
    mask[0] = True
    canvas_np = _pil_to_chw(canvas)
    k = 1
    for j in range(rows):
        for i in range(cols):
            out[k] = post(canvas_np[:, j * tile:(j + 1) * tile, i * tile:(i + 1) * tile])
            mask[k] = True
            k += 1
    return out, mask, (cols, rows)


def make_device_anyres_fn(src_hw: Tuple[int, int], *, tile: int = IMAGE_WIDTH,
                          max_crops: int = MAX_CROPS, device=None
                          ) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Build fn: uint8 image [H, W, 3] -> (crops [max_crops, 3, tile, tile]
    fp32, mask [max_crops] bool). crops[0] is the global view, then the local
    tiles row-major, then zero padding with mask False. ``device`` holds the
    resize matrices: the current CUDA device unless the caller names one."""
    device = resolve_device(device)
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
