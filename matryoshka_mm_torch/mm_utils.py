"""Multimodal tokenization utilities.

Host-side helpers that turn prompt strings with ``<image>`` markers into
input-id arrays carrying ``IMAGE_TOKEN_INDEX`` sentinels
(reference: llava/mm_utils.py:185-213).
"""

from __future__ import annotations

import base64
from io import BytesIO
from typing import List

import numpy as np

from .constants import IMAGE_TOKEN_INDEX

# Re-export the image front-end so callers can keep the reference's
# single-module import habit (``from ... import mm_utils``).
from .image_processing import (  # noqa: F401
    ClipImageProcessor,
    divide_to_patches,
    expand2square,
    get_anyres_image_grid_shape,
    process_anyres_image,
    process_images,
    resize_and_pad_image,
    select_best_resolution,
)


def load_image_from_base64(image: str):
    from PIL import Image

    return Image.open(BytesIO(base64.b64decode(image)))


def tokenizer_image_token(prompt: str, tokenizer,
                          image_token_index: int = IMAGE_TOKEN_INDEX,
                          return_tensors: str = None):
    """Tokenize ``prompt`` splicing an image sentinel at each ``<image>``.

    Exactly reproduces the reference's BOS bookkeeping: if every chunk is
    tokenized with a leading BOS, the BOS is kept once at the front and
    stripped from subsequent chunks (reference: mm_utils.py:185-204).
    """
    prompt_chunks: List[List[int]] = [tokenizer(chunk).input_ids for chunk in prompt.split("<image>")]

    def insert_separator(X, sep):
        return [ele for sublist in zip(X, [sep] * len(X)) for ele in sublist][:-1]

    input_ids: List[int] = []
    offset = 0
    if (
        len(prompt_chunks) > 0
        and len(prompt_chunks[0]) > 0
        and prompt_chunks[0][0] == tokenizer.bos_token_id
    ):
        offset = 1
        input_ids.append(prompt_chunks[0][0])

    for x in insert_separator(prompt_chunks, [image_token_index] * (offset + 1)):
        input_ids.extend(x[offset:])

    if return_tensors is not None:
        if return_tensors in ("np", "pt"):
            arr = np.asarray(input_ids, dtype=np.int32)
            if return_tensors == "pt":
                import torch

                return torch.from_numpy(arr)
            return arr
        raise ValueError(f"Unsupported tensor type: {return_tensors}")
    return input_ids


def get_model_name_from_path(model_path: str) -> str:
    model_path = model_path.strip("/")
    model_paths = model_path.split("/")
    if model_paths[-1].startswith("checkpoint-"):
        return model_paths[-2] + "_" + model_paths[-1]
    return model_paths[-1]


class KeywordsStoppingCriteria:
    """Host-side stop-string detector for the decode loop.

    The reference subclasses HF ``StoppingCriteria`` over token tensors
    (mm_utils.py:215-247); in the port's decode loop, stop handling happens on
    host between device steps, so this operates on generated id lists.
    """

    def __init__(self, keywords: List[str], tokenizer, input_len: int):
        self.keywords = keywords
        self.tokenizer = tokenizer
        self.keyword_ids: List[List[int]] = []
        self.max_keyword_len = 0
        for keyword in keywords:
            cur = tokenizer(keyword).input_ids
            if len(cur) > 1 and cur[0] == tokenizer.bos_token_id:
                cur = cur[1:]
            self.max_keyword_len = max(self.max_keyword_len, len(cur))
            self.keyword_ids.append(list(cur))
        self.start_len = input_len

    def __call__(self, output_ids: List[int]) -> bool:
        """True once any keyword appears at the end of the generated suffix."""
        gen = list(output_ids)
        for kw_ids in self.keyword_ids:
            if len(gen) >= len(kw_ids) and gen[-len(kw_ids):] == kw_ids:
                return True
        offset = min(len(gen) - self.start_len, self.max_keyword_len)
        if offset > 0:
            text = self.tokenizer.decode(gen[-offset:], skip_special_tokens=True)
            if any(kw in text for kw in self.keywords):
                return True
        return False
