"""Image preprocessing: anyres slicing and CLIP normalization, on the host
and on the device.

The host path (PIL + numpy; ``slime_tpu/data/image_ops.py:37-206``) follows
the reference's ``process_anyres_image`` (llava/mm_utils.py:177-210) for data
loading, with the 'pad', 'pad_then_devide' and square modes behind
``process_images_host``. Two host-computed token orders feed the model's
merges: ``spatial_local_perm`` (the 'spatial' merge of compressed local
tokens) and ``unpad_token_order`` (LLaVA-NeXT's 'unpad' merge of the identity
path, ``image_ops.py:265-314``). The device path (``make_device_anyres_fn``, ``image_ops.py:209-262``)
computes the same crops with PIL-exact bicubic weight matrices, each resize
two matmuls, so the whole pipeline runs on the card without gathers. The crop
grid is a static function of the source size (``data.anyres``).
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..constants import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD, IMAGE_HEIGHT,
                         IMAGE_WIDTH, MAX_CROPS)
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
                              max_crops: int = MAX_CROPS, use_native: bool = False,
                              normalize: bool = True
                              ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """PIL image -> (crops [max_crops, 3, tile, tile], crop_mask [max_crops]
    bool, grid (cols, rows)). crops[0] is the global view (a square bicubic
    resize), then the local tiles of the resized-and-padded image row-major,
    then zeros with mask False. ``normalize=False`` keeps raw uint8 crops
    (``slime.encode_images`` normalizes those on the device). ``use_native``
    takes the C++ library (``data.native``) where it is built, else PIL."""
    from PIL import Image

    if use_native:
        from . import native
        if native.available():
            arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
            return native.anyres_preprocess_native(arr, tile=tile, max_crops=max_crops,
                                                   normalize=normalize)
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


def expand2square_np(chw: np.ndarray, fill: Tuple[int, int, int]) -> np.ndarray:
    """Pad [3, H, W] to a centred square canvas of ``fill`` (the reference's
    expand2square, llava/mm_utils.py:217-228)."""
    c, h, w = chw.shape
    if h == w:
        return chw
    side = max(h, w)
    out = np.empty((c, side, side), dtype=chw.dtype)
    out[:] = np.asarray(fill, dtype=chw.dtype).reshape(3, 1, 1)
    y0, x0 = (side - h) // 2, (side - w) // 2
    out[:, y0:y0 + h, x0:x0 + w] = chw
    return out


def process_pad_image_host(img, *, tile: int = IMAGE_WIDTH) -> np.ndarray:
    """'pad' mode: square canvas of the CLIP mean, bicubic resize to
    ``tile``, CLIP-normalized [3, tile, tile] (llava/mm_utils.py:234-238)."""
    from PIL import Image

    fill = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
    sq = Image.fromarray(expand2square_np(_pil_to_chw(img), fill).transpose(1, 2, 0))
    return clip_normalize(_pil_to_chw(sq.resize((tile, tile), Image.BICUBIC)))


def process_naive_image_host(img, *, tile: int = IMAGE_WIDTH, stride: int = 308,
                             resize_width: int = 1024, max_crops: int = MAX_CROPS
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """'pad_then_devide' mode (the reference's process_image_naive): square
    canvas of the CLIP mean, resized to ``resize_width``, a tile-sized window
    slid by ``stride``; the square's global view first."""
    from PIL import Image

    fill = tuple(int(x * 255) for x in CLIP_IMAGE_MEAN)
    sq = Image.fromarray(expand2square_np(_pil_to_chw(img), fill).transpose(1, 2, 0))
    out = np.zeros((max_crops, 3, tile, tile), dtype=np.float32)
    mask = np.zeros((max_crops,), dtype=bool)
    out[0] = clip_normalize(_pil_to_chw(sq.resize((tile, tile), Image.BICUBIC)))
    mask[0] = True
    scale = resize_width / sq.size[0]
    arr = _pil_to_chw(sq.resize((resize_width, int(sq.size[1] * scale)), Image.BICUBIC))
    k = 1
    for y in range(0, arr.shape[1] - tile + 1, stride):
        for x in range(0, arr.shape[2] - tile + 1, stride):
            if k >= max_crops:
                break
            out[k] = clip_normalize(arr[:, y:y + tile, x:x + tile])
            mask[k] = True
            k += 1
    return out, mask


def spatial_local_perm(cols: int, rows: int, grid: int,
                       max_local_tokens: int) -> np.ndarray:
    """Permutation [max_local_tokens] int32 taking crop-major local tokens
    (each crop's grid x grid tokens in turn) to row-major spatial order over
    the rows x cols crop grid; the identity on the padded tail."""
    n = cols * rows * grid * grid
    idx = np.arange(n).reshape(rows, cols, grid, grid).transpose(0, 2, 1, 3).reshape(-1)
    out = np.arange(max_local_tokens, dtype=np.int32)
    out[:n] = idx
    return out


def process_images_host(images: List, mode: str = "anyres", *, max_crops: int = MAX_CROPS):
    """The reference's ``process_images`` over the modes -> (pixel_values,
    crop_masks or None, sizes): anyres and pad_then_devide give [B,
    max_crops, 3, 336, 336] and [B, max_crops]; pad and square [B, 3, 336,
    336] and None."""
    from PIL import Image

    sizes = [im.size for im in images]
    if mode == "pad_then_devide":
        pairs = [process_naive_image_host(im, max_crops=max_crops) for im in images]
        return np.stack([c for c, _ in pairs]), np.stack([m for _, m in pairs]), sizes
    if mode in ("anyres", "any_res"):
        trip = [process_anyres_image_host(im, max_crops=max_crops) for im in images]
        return np.stack([c for c, _, _ in trip]), np.stack([m for _, m, _ in trip]), sizes
    if mode == "pad":
        return np.stack([process_pad_image_host(im) for im in images]), None, sizes
    return np.stack([clip_normalize(_pil_to_chw(im.convert("RGB").resize(
        (IMAGE_WIDTH, IMAGE_HEIGHT), Image.BICUBIC))) for im in images]), None, sizes


def unpad_token_order(cols: int, rows: int, grid: int, original_size: Tuple[int, int],
                      budget: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 'unpad' merge's token order (LLaVA-NeXT, llava_arch.py:314-331):
    the local tokens laid out spatially, the rows or columns that came from
    the aspect-ratio padding dropped (centred fit), a newline slot after each
    kept row. -> (src [budget] int32: crop-major local token index, -1 for a
    newline; valid [budget] bool, False past the end)."""
    gw, gh = cols * grid, rows * grid
    ow, oh = original_size
    if ow / oh > gw / gh:
        pad = (gh - int(oh * (gw / ow))) // 2       # padded above and below
        keep_rows, keep_cols = range(pad, gh - pad), range(gw)
    else:
        pad = (gw - int(ow * (gh / oh))) // 2       # padded left and right
        keep_rows, keep_cols = range(gh), range(pad, gw - pad)

    def tok(r, c):
        return (((r // grid) * cols + c // grid) * grid + r % grid) * grid + c % grid

    src = np.full((budget,), -1, np.int32)
    valid = np.zeros((budget,), bool)
    k = 0
    for r in keep_rows:
        for c in keep_cols:
            if k >= budget:
                break
            src[k] = tok(r, c)
            valid[k] = True
            k += 1
        if k < budget:
            src[k] = -1
            valid[k] = True
            k += 1
    return src, valid


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
