"""Batched VQA answer generation on the PyTorch port (port of
``matryoshka_mm_tpu/eval/model_vqa_loader.py``; reference:
llava/eval/model_vqa_loader.py).

Deterministic shuffled chunking for sharded eval (``--num-chunks`` /
``--chunk-idx``), greedy decoding, answers written as jsonl.  A producer
thread prepares the questions on the host (PIL decode, ``process_images``
to numpy, tokenising) while the main thread generates; it makes no CUDA
call, so it never meets the decode capture of ``generate`` (a device call
from another thread during a capture fails).  An error of the producer
(a missing image) is raised on the main thread.

    python -m matryoshka_mm_torch.eval.model_vqa_loader \\
        --model-path debug://7b --image-folder imgs \\
        --question-file q.jsonl --answers-file a.jsonl \\
        --batch-size 8 --matryoshka_vis_token_scale ver=v0_numtoks=144
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import random
import threading
import uuid
from queue import Empty, Queue

import numpy as np

from ..constants import (DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN,
                         DEFAULT_IMAGE_TOKEN)
from ..conversation import conv_templates
from ..mm_utils import (get_model_name_from_path, process_images,
                        tokenizer_image_token)
from ..models.builder import load_pretrained_model


def get_chunk(lst, n, k, seed=0):
    """Deterministically shuffle then split into n chunks, return chunk k
    (reference: model_vqa_loader.py:20-28).  Seeds the global ``random``
    state, as the reference does."""
    random.seed(seed)
    indices = list(range(len(lst)))
    random.shuffle(indices)
    chunk_size = math.ceil(len(lst) / n)
    chunks = [indices[i:i + chunk_size]
              for i in range(0, len(indices), chunk_size)]
    return [lst[idx] for idx in chunks[k]]


def with_image_token(qs: str, mm_use_im_start_end: bool) -> str:
    """``qs`` behind the image sentinel (and its start / end tokens)."""
    if mm_use_im_start_end:
        return (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
                + DEFAULT_IM_END_TOKEN + "\n" + qs)
    return DEFAULT_IMAGE_TOKEN + "\n" + qs


def conv_prompt(conv_mode: str, qs: str) -> str:
    """One user turn of ``conv_mode`` and the open assistant turn."""
    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def answer_line(question_id, prompt, text: str, model_id: str) -> str:
    """One answers-file line in the reference's layout."""
    return json.dumps({"question_id": question_id, "prompt": prompt,
                       "text": text, "answer_id": str(uuid.uuid4())[:8],
                       "model_id": model_id, "metadata": {}}) + "\n"


def _prepare(line, image_folder, tokenizer, image_processor, model_config,
             conv_mode, mm_use_im_start_end):
    """Host work of one question -> (ids (1, T) int32, pixels float32,
    image size, prompt); numpy only."""
    from PIL import Image

    prompt = conv_prompt(conv_mode,
                         with_image_token(line["text"], mm_use_im_start_end))
    image = Image.open(os.path.join(image_folder, line["image"])).convert(
        "RGB")
    pixels = process_images([image], image_processor, model_config)
    input_ids = np.asarray(tokenizer_image_token(prompt, tokenizer),
                           np.int32)[None, :]
    return input_ids, np.asarray(pixels, np.float32), image.size, prompt


class _Failed:
    """What the producer hands the consumer when preparing a row raised."""

    def __init__(self, error: BaseException):
        self.error = error


def _prefetch(questions, prepare, maxsize=2):
    """Yield ``(line, prepare(line))`` for every question, prepared on a
    host thread up to ``maxsize`` rows ahead.  The thread's error is raised
    here; when the caller stops early the thread is stopped and joined."""
    q: Queue = Queue(maxsize=maxsize)
    stop = threading.Event()

    def producer():
        try:
            for line in questions:
                if stop.is_set():
                    return
                q.put((line, prepare(line)))
        except BaseException as e:   # noqa: BLE001: re-raised by the consumer
            q.put(_Failed(e))
            return
        q.put(None)

    thread = threading.Thread(target=producer, daemon=True,
                              name="vqa-prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, _Failed):
                raise item.error
            yield item
    finally:
        stop.set()
        while thread.is_alive():       # unblock a producer waiting on put
            try:
                q.get(timeout=0.05)
            except Empty:
                pass
        thread.join()


def eval_model(args):
    model_name = get_model_name_from_path(args.model_path)
    tokenizer, model, image_processor, context_len = load_pretrained_model(
        args.model_path, args.model_base, model_name, device=args.device)

    with open(os.path.expanduser(args.question_file)) as f:
        questions = [json.loads(q) for q in f]
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)

    if ("plain" in model_name and "finetune" not in model_name.lower()
            and "mmtag" not in args.conv_mode):
        args.conv_mode = args.conv_mode + "_mmtag"
        print(f"It seems that this is a plain model, but it is not using a "
              f"mmtag prompt, auto switching to {args.conv_mode}.")

    mm_use_im_start_end = getattr(model.config, "mm_use_im_start_end", False)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0

    def prepare(line):
        return _prepare(line, args.image_folder, tokenizer, image_processor,
                        model.config, args.conv_mode, mm_use_im_start_end)

    def flush_batch(batch, ans_file):
        """Left-pad the batch to a shared length rounded up to 32, one
        generate call for all rows (greedy outputs equal batch-1's thanks
        to the attention mask)."""
        if not batch:
            return
        T = max(x[1][0].shape[1] for x in batch)
        T = -(-T // 32) * 32
        B = len(batch)
        ids = np.full((B, T), pad_id, np.int32)
        mask = np.zeros((B, T), bool)
        pixels = np.concatenate([x[1][1] for x in batch], axis=0)
        for b, (_, (row_ids, _, _, _)) in enumerate(batch):
            n = row_ids.shape[1]
            ids[b, T - n:] = row_ids[0]
            mask[b, T - n:] = True
        output_ids = model.generate(
            ids, images=pixels, attention_mask=mask,
            image_sizes=[x[1][2] for x in batch],
            matryoshka_vis_token_scale=args.matryoshka_vis_token_scale,
            do_sample=args.temperature > 0,
            temperature=args.temperature,
            top_p=args.top_p if args.top_p is not None else 1.0,
            max_new_tokens=args.max_new_tokens,
            eos_token_id=getattr(tokenizer, "eos_token_id", 2),
            pad_token_id=pad_id,
            num_beams=args.num_beams,
        )
        texts = tokenizer.batch_decode(output_ids, skip_special_tokens=True)
        for (line, _), text in zip(batch, texts):
            ans_file.write(answer_line(line["question_id"], line["text"],
                                       text.strip(), model_name))
        ans_file.flush()

    # beam search decodes batch-1; rows are not batched under --num_beams
    rows = 1 if args.num_beams > 1 else args.batch_size
    with open(answers_file, "w") as ans_file, \
            contextlib.closing(_prefetch(questions, prepare)) as items:
        batch = []
        for item in items:
            batch.append(item)
            if len(batch) >= rows:
                flush_batch(batch, ans_file)
                batch = []
        flush_batch(batch, ans_file)


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default="debug://tiny")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--image-folder", type=str, default="")
    parser.add_argument("--question-file", type=str,
                        default="tables/question.jsonl")
    parser.add_argument("--answers-file", type=str, default="answer.jsonl")
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=1,
                        help="rows a generate call (greedy outputs match "
                             "batch-1 exactly)")
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--max_new_tokens", type=int, default=128)
    parser.add_argument("--matryoshka_vis_token_scale", type=str, default=None)
    return parser


if __name__ == "__main__":
    eval_model(build_parser().parse_args())
