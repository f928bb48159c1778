"""Supervised training data pipeline (the port's own copy of
``matryoshka_mm_tpu/train/data.py``, which is framework-free).

numpy-native port of the reference's dataset machinery (reference:
llava/train/train.py:281-820): conversation-template rendering, per-template
target masking (``preprocess_v1`` / ``_plain`` / ``_mpt`` / ``_llama_2`` /
legacy), the lazy JSON dataset with on-the-fly image loading, and the
pad-to-longest collator.  Host-side only — batches leave here as numpy
arrays ready for ``M3Batch`` (``train.py`` makes them tensors).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import conversation as conversation_lib
from ..constants import (
    DEFAULT_IM_END_TOKEN,
    DEFAULT_IM_START_TOKEN,
    DEFAULT_IMAGE_TOKEN,
    IGNORE_INDEX,
)
from ..mm_utils import tokenizer_image_token


@dataclasses.dataclass
class DataArguments:
    """reference: train.py:92-101."""

    data_path: str = None
    lazy_preprocess: bool = False
    is_multimodal: bool = False
    image_folder: Optional[str] = None
    image_aspect_ratio: str = "square"
    train_size: Optional[int] = None
    # attached at runtime like the reference (train.py:1044-1045):
    # image_processor, mm_use_im_start_end
    image_processor: object = None

    def __post_init__(self):
        self.mm_use_im_start_end = getattr(self, "mm_use_im_start_end", False)


def preprocess_multimodal(sources: Sequence, data_args: DataArguments):
    """Normalize <image> placement in the first turn (train.py:341-360)."""
    if not data_args.is_multimodal:
        return sources
    for source in sources:
        for sentence in source:
            if DEFAULT_IMAGE_TOKEN in sentence["value"]:
                sentence["value"] = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, "").strip()
                sentence["value"] = DEFAULT_IMAGE_TOKEN + "\n" + sentence["value"]
                sentence["value"] = sentence["value"].strip()
                if "mmtag" in conversation_lib.default_conversation.version:
                    sentence["value"] = sentence["value"].replace(
                        DEFAULT_IMAGE_TOKEN,
                        "<Image>" + DEFAULT_IMAGE_TOKEN + "</Image>")
            replace_token = DEFAULT_IMAGE_TOKEN
            if data_args.mm_use_im_start_end:
                replace_token = DEFAULT_IM_START_TOKEN + replace_token + DEFAULT_IM_END_TOKEN
            sentence["value"] = sentence["value"].replace(DEFAULT_IMAGE_TOKEN, replace_token)
    return sources


def _tokenize(tokenizer, text: str, has_image: bool) -> List[int]:
    if has_image:
        return tokenizer_image_token(text, tokenizer)
    return list(tokenizer(text).input_ids)


def _render_conversations(sources, conv) -> List[str]:
    roles = {"human": conv.roles[0], "gpt": conv.roles[1]}
    conversations = []
    for i, source in enumerate(sources):
        if roles[source[0]["from"]] != conv.roles[0]:
            source = source[1:]
        conv.messages = []
        for j, sentence in enumerate(source):
            role = roles[sentence["from"]]
            assert role == conv.roles[j % 2], f"{i}"
            conv.append_message(role, sentence["value"])
        conversations.append(conv.get_prompt())
    return conversations


def _truncate(ids: List[int], max_len: int) -> List[int]:
    return ids[:max_len]


def preprocess_v1(sources, tokenizer, has_image: bool = False) -> Dict:
    """Vicuna-v1 template tokenization + answer-only target masking
    (reference: train.py:446-530, including the modern-tokenizer round-length
    adjustment at :509-511)."""
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)

    input_ids = [np.asarray(_truncate(_tokenize(tokenizer, c, has_image),
                                      tokenizer.model_max_length), np.int32)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]

    assert conv.sep_style == conversation_lib.SeparatorStyle.TWO
    sep = conv.sep + conv.roles[1] + ": "
    legacy = getattr(tokenizer, "legacy", False)
    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum())
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(tokenizer, rou, has_image))
            instruction_len = len(_tokenize(tokenizer, parts[0], has_image)) - 2
            if i != 0 and not legacy:
                # modern (non-legacy) tokenizers drop the leading SPIECE
                # after </s> (train.py:509-511)
                round_len -= 1
                instruction_len -= 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")
    return dict(input_ids=input_ids, labels=targets)


def preprocess_llama_2(sources, tokenizer, has_image: bool = False) -> Dict:
    """reference: train.py:363-443."""
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    input_ids = [np.asarray(_truncate(_tokenize(tokenizer, c, has_image),
                                      tokenizer.model_max_length), np.int32)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]

    assert conv.sep_style == conversation_lib.SeparatorStyle.LLAMA_2
    sep = "[/INST] "
    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum())
        rounds = conversation.split(conv.sep2)
        cur_len = 1
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(tokenizer, rou, has_image))
            instruction_len = len(_tokenize(tokenizer, parts[0], has_image)) - 2
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")
    return dict(input_ids=input_ids, labels=targets)


def preprocess_mpt(sources, tokenizer, has_image: bool = False) -> Dict:
    """reference: train.py:533-618."""
    conv = conversation_lib.default_conversation.copy()
    conversations = _render_conversations(sources, conv)
    input_ids = [np.asarray(_truncate(_tokenize(tokenizer, c, has_image),
                                      tokenizer.model_max_length), np.int32)
                 for c in conversations]
    targets = [ids.copy() for ids in input_ids]

    assert conv.sep_style == conversation_lib.SeparatorStyle.MPT
    sep = conv.sep + conv.roles[1]
    legacy = getattr(tokenizer, "legacy", False)
    for conversation, target in zip(conversations, targets):
        total_len = int((target != tokenizer.pad_token_id).sum())
        rounds = conversation.split(conv.sep)
        re_rounds = [conv.sep.join(rounds[:3])]
        for conv_idx in range(3, len(rounds), 2):
            re_rounds.append(conv.sep.join(rounds[conv_idx:conv_idx + 2]))
        cur_len = 0
        target[:cur_len] = IGNORE_INDEX
        for i, rou in enumerate(re_rounds):
            if rou == "":
                break
            parts = rou.split(sep)
            if len(parts) != 2:
                break
            parts[0] += sep
            round_len = len(_tokenize(tokenizer, rou, has_image))
            instruction_len = len(_tokenize(tokenizer, parts[0], has_image)) - 1
            if i != 0 and legacy:
                round_len += 1
                instruction_len += 1
            target[cur_len:cur_len + instruction_len] = IGNORE_INDEX
            cur_len += round_len
        target[cur_len:] = IGNORE_INDEX
        if cur_len < tokenizer.model_max_length and cur_len != total_len:
            target[:] = IGNORE_INDEX
            print(f"WARNING: tokenization mismatch: {cur_len} vs. {total_len}. (ignored)")
    return dict(input_ids=input_ids, labels=targets)


def preprocess_plain(sources, tokenizer) -> Dict:
    """Pretraining: <image> + caption (reference: train.py:621-640)."""
    conversations = []
    for source in sources:
        assert len(source) == 2
        assert DEFAULT_IMAGE_TOKEN in source[0]["value"]
        source[0]["value"] = DEFAULT_IMAGE_TOKEN
        conversation = (source[0]["value"] + source[1]["value"]
                        + conversation_lib.default_conversation.sep)
        conversations.append(conversation)
    input_ids = [np.asarray(tokenizer_image_token(p, tokenizer), np.int32)
                 for p in conversations]
    targets = [ids.copy() for ids in input_ids]
    for target, source in zip(targets, sources):
        tokenized_len = len(tokenizer_image_token(source[0]["value"], tokenizer))
        target[:tokenized_len] = IGNORE_INDEX
    return dict(input_ids=input_ids, labels=targets)


def preprocess_add_speaker_and_signal(sources, tokenizer,
                                      has_image: bool = False) -> Dict:
    """v0-template fallback (reference: train.py:319-337
    ``_add_speaker_and_signal`` + train.py:662-687): every round is
    rendered as ``### <role>: <text>\\n`` after the system header, the
    whole conversation ends with a dangling ``### ``, and human rounds
    are masked (the ``### `` signal prefix of each round stays visible —
    the reference masks from offset +2 inside the round)."""
    BEGIN, END = "### ", "\n"
    conv = conversation_lib.default_conversation
    role_of = {"human": conv.roles[0], "gpt": conv.roles[1]}

    headers, rendered = [], []
    for source in sources:
        header = f"{conv.system}\n\n"
        rounds = [
            BEGIN + role_of.get(s["from"].lower(), "unknown") + ": "
            + s["value"] + END
            for s in source
        ]
        headers.append(header)
        rendered.append((header + "".join(rounds) + BEGIN, rounds))

    input_ids = [
        np.asarray(_truncate(_tokenize(tokenizer, text, has_image),
                             tokenizer.model_max_length), np.int32)
        for text, _ in rendered
    ]

    def piece_len(text: str, first: bool) -> int:
        # piece-wise tokenization adds a BOS per piece; only the header's
        # aligns with the concatenated conversation's single BOS, so later
        # pieces subtract it (the reference keeps the drift — its v0
        # masking is approximate; we mask exactly)
        ids = _tokenize(tokenizer, text, has_image)
        bos = getattr(tokenizer, "bos_token_id", None)
        if not first and bos is not None and ids and ids[0] == bos:
            return len(ids) - 1
        return len(ids)

    targets = [ids.copy() for ids in input_ids]
    for target, source, header, (_, rounds) in zip(targets, sources, headers,
                                                   rendered):
        lens = [piece_len(header, True)] + \
               [piece_len(r, False) for r in rounds]
        cur = lens[0]
        target[:cur] = IGNORE_INDEX
        for n, s in zip(lens[1:], source):
            if s["from"].lower() == "human":
                target[cur + 2: cur + n] = IGNORE_INDEX
            cur += n
    return dict(input_ids=input_ids, labels=targets)


def preprocess(sources, tokenizer, has_image: bool = False) -> Dict:
    """Template dispatch (reference: train.py:643-687); anything that is
    not plain/llama_2/v1/mpt falls back to the v0 speaker-and-signal
    format, matching the reference's default branch."""
    style = conversation_lib.default_conversation.sep_style
    if style == conversation_lib.SeparatorStyle.PLAIN:
        return preprocess_plain(sources, tokenizer)
    if style == conversation_lib.SeparatorStyle.LLAMA_2:
        return preprocess_llama_2(sources, tokenizer, has_image=has_image)
    if conversation_lib.default_conversation.version.startswith("v1"):
        return preprocess_v1(sources, tokenizer, has_image=has_image)
    if conversation_lib.default_conversation.version == "mpt":
        return preprocess_mpt(sources, tokenizer, has_image=has_image)
    return preprocess_add_speaker_and_signal(sources, tokenizer,
                                             has_image=has_image)


class LazySupervisedDataset:
    """Lazy JSON dataset (reference: train.py:690-780)."""

    def __init__(self, data_path: str, tokenizer, data_args: DataArguments):
        with open(data_path) as f:
            list_data_dict = json.load(f)
        if data_args.train_size is not None:
            list_data_dict = list_data_dict[: data_args.train_size]
        self.tokenizer = tokenizer
        self.list_data_dict = list_data_dict
        self.data_args = data_args

    def __len__(self):
        return len(self.list_data_dict)

    @property
    def lengths(self) -> List[int]:
        out = []
        for sample in self.list_data_dict:
            img_tokens = 128 if "image" in sample else 0
            out.append(sum(len(c["value"].split())
                           for c in sample["conversations"]) + img_tokens)
        return out

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for sample in self.list_data_dict:
            cur = sum(len(c["value"].split()) for c in sample["conversations"])
            out.append(cur if "image" in sample else -cur)
        return out

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        from PIL import Image

        from ..image_processing import expand2square

        sample = self.list_data_dict[i]
        sources = [sample]
        has_image = "image" in sample
        image = None
        if has_image:
            processor = self.data_args.image_processor
            image = Image.open(
                os.path.join(self.data_args.image_folder, sample["image"])
            ).convert("RGB")
            if self.data_args.image_aspect_ratio == "pad":
                image = expand2square(
                    image, tuple(int(x * 255) for x in processor.image_mean))
            image = processor.preprocess(image)["pixel_values"][0]
            sources = preprocess_multimodal(
                copy.deepcopy([e["conversations"] for e in sources]),
                self.data_args)
        else:
            sources = copy.deepcopy([e["conversations"] for e in sources])

        data_dict = preprocess(sources, self.tokenizer, has_image=has_image)
        out = dict(input_ids=data_dict["input_ids"][0],
                   labels=data_dict["labels"][0])
        if has_image:
            out["image"] = image
        elif self.data_args.is_multimodal:
            crop = self.data_args.image_processor.crop_size
            out["image"] = np.zeros((3, crop["height"], crop["width"]), np.float32)
        return out


class DataCollatorForSupervisedDataset:
    """Pad-to-longest collator (reference: train.py:783-811).

    Batches round the padded length up to a bucket multiple, so a run
    sees few distinct sequence lengths.
    """

    def __init__(self, tokenizer, length_bucket: int = 64):
        self.tokenizer = tokenizer
        self.length_bucket = length_bucket

    def __call__(self, instances: Sequence[Dict]) -> Dict[str, np.ndarray]:
        input_ids = [ins["input_ids"] for ins in instances]
        labels = [ins["labels"] for ins in instances]
        max_len = min(max(len(x) for x in input_ids),
                      self.tokenizer.model_max_length)
        if self.length_bucket:
            max_len = -(-max_len // self.length_bucket) * self.length_bucket
        B = len(input_ids)
        pad_id = self.tokenizer.pad_token_id or 0
        ids = np.full((B, max_len), pad_id, np.int32)
        labs = np.full((B, max_len), IGNORE_INDEX, np.int32)
        mask = np.zeros((B, max_len), bool)
        for b, (x, y) in enumerate(zip(input_ids, labels)):
            n = min(len(x), max_len)
            ids[b, :n] = x[:n]
            labs[b, :n] = y[:n]
            mask[b, :n] = True
        batch = dict(input_ids=ids, labels=labs, attention_mask=mask)
        if "image" in instances[0]:
            images = [ins["image"] for ins in instances]
            if all(x is not None and x.shape == images[0].shape for x in images):
                batch["images"] = np.stack(images).astype(np.float32)
            else:
                batch["images"] = images
        return batch


def make_supervised_data_module(tokenizer, data_args: DataArguments) -> Dict:
    """reference: train.py:814-820."""
    return dict(
        train_dataset=LazySupervisedDataset(
            data_path=data_args.data_path, tokenizer=tokenizer,
            data_args=data_args),
        eval_dataset=None,
        data_collator=DataCollatorForSupervisedDataset(tokenizer=tokenizer),
    )
