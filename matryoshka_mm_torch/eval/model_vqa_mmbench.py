"""MMBench answer generation on the PyTorch port (port of
``matryoshka_mm_tpu/eval/model_vqa_mmbench.py``; reference:
llava/eval/model_vqa_mmbench.py).

Reads the TSV with base64 images (pandas, imported when the generator
runs); ``--all-rounds`` runs every circular permutation of the options
(the benchmark's consistency protocol).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import uuid

import numpy as np

from ..mm_utils import (get_model_name_from_path, load_image_from_base64,
                        process_images, tokenizer_image_token)
from ..models.builder import load_pretrained_model
from .model_vqa_loader import conv_prompt, with_image_token
from .model_vqa_loader import get_chunk as loader_chunk

all_options = ["A", "B", "C", "D"]


def get_chunk(lst, n, k, seed=0):
    """``model_vqa_loader.get_chunk`` that also takes a DataFrame (its
    rows by position)."""
    import pandas as pd

    if isinstance(lst, pd.DataFrame):
        return lst.iloc[loader_chunk(list(range(len(lst))), n, k, seed)]
    return loader_chunk(lst, n, k, seed)


def is_none(value):
    if value is None:
        return True
    if isinstance(value, float) and math.isnan(value):
        return True
    if isinstance(value, str) and value.lower() in ("nan", "none"):
        return True
    return False


def get_options(row, options):
    parsed = []
    for option in options:
        if is_none(row[option]):
            break
        parsed.append(row[option])
    return parsed


def eval_model(args):
    import pandas as pd

    model_path = os.path.expanduser(args.model_path)
    model_name = get_model_name_from_path(model_path)
    tokenizer, model, image_processor, context_len = load_pretrained_model(
        model_path, args.model_base, model_name, device=args.device)

    questions = pd.read_table(os.path.expanduser(args.question_file))
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    use_se = getattr(model.config, "mm_use_im_start_end", False)

    with open(answers_file, "w") as ans_file:
        for index, row in questions.iterrows():
            options = get_options(row, all_options)
            cur_option_char = all_options[: len(options)]
            num_rounds = len(options) if args.all_rounds else 1

            for round_idx in range(num_rounds):
                idx = row["index"]
                question = row["question"]
                hint = row["hint"]
                image = load_image_from_base64(row["image"]).convert("RGB")
                if not is_none(hint):
                    question = hint + "\n" + question
                for option_char, option in zip(all_options[: len(options)],
                                               options):
                    question = question + "\n" + option_char + ". " + option
                cur_prompt = question
                qs = with_image_token(question, use_se)

                if args.single_pred_prompt:
                    if args.lang == "cn":
                        qs = qs + "\n" + "请直接回答选项字母。"
                    else:
                        qs = qs + "\n" + ("Answer with the option's letter "
                                          "from the given choices directly.")

                prompt = conv_prompt(args.conv_mode, qs)
                input_ids = np.asarray(
                    tokenizer_image_token(prompt, tokenizer),
                    np.int32)[None, :]
                pixels = np.asarray(process_images(
                    [image], image_processor, model.config), np.float32)

                output_ids = model.generate(
                    input_ids, images=pixels, image_sizes=[image.size],
                    matryoshka_vis_token_scale=args.matryoshka_vis_token_scale,
                    do_sample=args.temperature > 0,
                    temperature=args.temperature,
                    top_p=args.top_p if args.top_p is not None else 1.0,
                    max_new_tokens=128,
                    eos_token_id=getattr(tokenizer, "eos_token_id", 2),
                    num_beams=args.num_beams,
                    pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0)
                outputs = tokenizer.batch_decode(
                    output_ids, skip_special_tokens=True)[0].strip()

                ans_file.write(json.dumps({
                    "question_id": idx, "round_id": round_idx,
                    "prompt": cur_prompt, "text": outputs,
                    "options": options, "option_char": cur_option_char,
                    "answer_id": str(uuid.uuid4())[:8],
                    "model_id": model_name, "metadata": {}}) + "\n")
                ans_file.flush()

                # circular shift options for the next round
                options = options[1:] + options[:1]
                cur_option_char = cur_option_char[1:] + cur_option_char[:1]


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default="debug://tiny")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--question-file", type=str,
                        default="tables/question.tsv")
    parser.add_argument("--answers-file", type=str, default="answer.jsonl")
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--all-rounds", action="store_true")
    parser.add_argument("--single-pred-prompt", action="store_true")
    parser.add_argument("--lang", type=str, default="en")
    parser.add_argument("--matryoshka_vis_token_scale", type=str, default=None)
    return parser


if __name__ == "__main__":
    eval_model(build_parser().parse_args())
