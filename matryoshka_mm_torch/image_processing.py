"""CLIP image front-end (numpy / PIL only).

A standalone re-implementation of the preprocessing pipeline the reference
gets from HF ``CLIPImageProcessor`` plus the LLaVA pad / anyres modes
(reference: llava/mm_utils.py:12-182).  The port's own copy of
``matryoshka_mm_tpu/image_processing.py``: the PIL path only (the optional
C++ resize of the JAX package is not carried over yet, ROADMAP.md), and
without the on-device normalize helper.
"""

from __future__ import annotations

import ast
import math
from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

OPENAI_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass
class ClipImageProcessor:
    """Drop-in stand-in for HF ``CLIPImageProcessor`` (ViT-L/14-336 defaults).

    Resize shortest edge -> center crop -> rescale 1/255 -> normalize.
    Attribute names (``image_mean``, ``crop_size``, ``size``) mirror HF so the
    serving / eval layers written against the reference API keep working.
    """

    image_mean: Tuple[float, float, float] = OPENAI_CLIP_MEAN
    image_std: Tuple[float, float, float] = OPENAI_CLIP_STD
    size: dict = field(default_factory=lambda: {"shortest_edge": 336})
    crop_size: dict = field(default_factory=lambda: {"height": 336, "width": 336})

    def resize_shortest_edge(self, image):
        from PIL import Image

        target = self.size["shortest_edge"]
        w, h = image.size
        short, long = (w, h) if w <= h else (h, w)
        if short == target:
            return image
        scale = target / short
        new_short, new_long = target, int(long * scale)
        new_w, new_h = (new_short, new_long) if w <= h else (new_long, new_short)
        return image.resize((new_w, new_h), Image.BICUBIC)

    def center_crop(self, image):
        ch, cw = self.crop_size["height"], self.crop_size["width"]
        w, h = image.size
        left = (w - cw) // 2
        top = (h - ch) // 2
        return image.crop((left, top, left + cw, top + ch))

    def preprocess(self, image, return_tensors: str = "np"):
        """PIL image -> normalized CHW float32 array, shaped like HF
        output."""
        if not isinstance(image, (list, tuple)):
            images = [image]
        else:
            images = list(image)

        out = []
        for im in images:
            im = im.convert("RGB")
            im = self.resize_shortest_edge(im)
            im = self.center_crop(im)
            arr = np.asarray(im, dtype=np.float32) / 255.0  # HWC
            arr = (arr - np.asarray(self.image_mean, dtype=np.float32)) / np.asarray(
                self.image_std, dtype=np.float32
            )
            out.append(arr.transpose(2, 0, 1))  # CHW
        return {"pixel_values": np.stack(out, axis=0)}

    def __call__(self, images, return_tensors: str = "np"):
        if not isinstance(images, (list, tuple)):
            images = [images]
        return {"pixel_values": self.preprocess(images)["pixel_values"]}


def select_best_resolution(original_size: Tuple[int, int],
                           possible_resolutions: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Pick the anyres grid resolution that wastes the least area
    (reference: mm_utils.py:12-39)."""
    original_width, original_height = original_size
    best_fit = None
    max_effective_resolution = 0
    min_wasted_resolution = float("inf")

    for width, height in possible_resolutions:
        scale = min(width / original_width, height / original_height)
        downscaled_width = int(original_width * scale)
        downscaled_height = int(original_height * scale)
        effective_resolution = min(downscaled_width * downscaled_height,
                                   original_width * original_height)
        wasted_resolution = (width * height) - effective_resolution
        if effective_resolution > max_effective_resolution or (
            effective_resolution == max_effective_resolution
            and wasted_resolution < min_wasted_resolution
        ):
            max_effective_resolution = effective_resolution
            min_wasted_resolution = wasted_resolution
            best_fit = (width, height)

    return best_fit


def resize_and_pad_image(image, target_resolution: Tuple[int, int]):
    """Aspect-preserving resize centered on a black canvas
    (reference: mm_utils.py:42-74)."""
    from PIL import Image

    original_width, original_height = image.size
    target_width, target_height = target_resolution

    scale_w = target_width / original_width
    scale_h = target_height / original_height
    if scale_w < scale_h:
        new_width = target_width
        new_height = min(math.ceil(original_height * scale_w), target_height)
    else:
        new_height = target_height
        new_width = min(math.ceil(original_width * scale_h), target_width)

    resized = image.resize((new_width, new_height))
    canvas = Image.new("RGB", (target_width, target_height), (0, 0, 0))
    canvas.paste(resized, ((target_width - new_width) // 2, (target_height - new_height) // 2))
    return canvas


def divide_to_patches(image, patch_size: int) -> List:
    """Row-major tiling into patch_size squares (reference: mm_utils.py:77-96)."""
    patches = []
    width, height = image.size
    for i in range(0, height, patch_size):
        for j in range(0, width, patch_size):
            patches.append(image.crop((j, i, j + patch_size, i + patch_size)))
    return patches


def get_anyres_image_grid_shape(image_size, grid_pinpoints, patch_size: int):
    """(width, height) of the tile grid for an anyres image
    (reference: mm_utils.py:99-116)."""
    if isinstance(grid_pinpoints, list):
        possible_resolutions = grid_pinpoints
    else:
        possible_resolutions = ast.literal_eval(grid_pinpoints)
    width, height = select_best_resolution(image_size, possible_resolutions)
    return width // patch_size, height // patch_size


def process_anyres_image(image, processor: ClipImageProcessor, grid_pinpoints) -> np.ndarray:
    """Anyres tiling: base resize + grid tiles, each CLIP-preprocessed.

    Returns (1 + n_tiles, 3, H, W) float32 (reference: mm_utils.py:119-145).
    """
    if isinstance(grid_pinpoints, list):
        possible_resolutions = grid_pinpoints
    else:
        possible_resolutions = ast.literal_eval(grid_pinpoints)
    best_resolution = select_best_resolution(image.size, possible_resolutions)
    image_padded = resize_and_pad_image(image, best_resolution)

    patches = divide_to_patches(image_padded, processor.crop_size["height"])
    image_original_resize = image.resize(
        (processor.size["shortest_edge"], processor.size["shortest_edge"])
    )
    image_patches = [image_original_resize] + patches
    arrs = [processor.preprocess(p)["pixel_values"][0] for p in image_patches]
    return np.stack(arrs, axis=0)


def expand2square(pil_img, background_color):
    """Pad to square, content centered (reference: mm_utils.py:152-163)."""
    from PIL import Image

    width, height = pil_img.size
    if width == height:
        return pil_img
    elif width > height:
        result = Image.new(pil_img.mode, (width, width), background_color)
        result.paste(pil_img, (0, (width - height) // 2))
        return result
    else:
        result = Image.new(pil_img.mode, (height, height), background_color)
        result.paste(pil_img, ((height - width) // 2, 0))
        return result


def process_images(images, image_processor: ClipImageProcessor, model_cfg) -> np.ndarray:
    """Dispatch over image_aspect_ratio modes (reference: mm_utils.py:166-182).

    Returns (B, 3, H, W) float32, or a list of (T_i, 3, H, W) stacks when
    anyres tile counts differ across images.
    """
    image_aspect_ratio = getattr(model_cfg, "image_aspect_ratio", None)
    new_images = []
    if image_aspect_ratio == "pad":
        for image in images:
            image = expand2square(
                image, tuple(int(x * 255) for x in image_processor.image_mean)
            )
            new_images.append(image_processor.preprocess(image)["pixel_values"][0])
    elif image_aspect_ratio == "anyres":
        for image in images:
            new_images.append(
                process_anyres_image(image, image_processor, model_cfg.image_grid_pinpoints)
            )
    else:
        return image_processor(images)["pixel_values"]
    if all(x.shape == new_images[0].shape for x in new_images):
        new_images = np.stack(new_images, axis=0)
    return new_images
