"""ScienceQA answer generation on the PyTorch port (port of
``matryoshka_mm_tpu/eval/model_vqa_science.py``; reference:
llava/eval/model_vqa_science.py).

Problems without an ``image`` go through text-only ``generate``;
``--single-pred-prompt`` adds the option-letter instruction.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..mm_utils import (get_model_name_from_path, process_images,
                        tokenizer_image_token)
from ..models.builder import load_pretrained_model
from .model_vqa_loader import (answer_line, conv_prompt, get_chunk,
                               with_image_token)

SINGLE_PRED = "Answer with the option's letter from the given choices directly."


def eval_model(args):
    from PIL import Image

    model_path = os.path.expanduser(args.model_path)
    model_name = get_model_name_from_path(model_path)
    tokenizer, model, image_processor, context_len = load_pretrained_model(
        model_path, args.model_base, model_name, device=args.device)

    with open(os.path.expanduser(args.question_file)) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    answers_file = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(answers_file) or ".", exist_ok=True)
    use_se = getattr(model.config, "mm_use_im_start_end", False)

    with open(answers_file, "w") as ans_file:
        for line in questions:
            qs = line["conversations"][0]["value"].replace(
                "<image>", "").strip()
            cur_prompt = qs

            images = None
            image_sizes = None
            if "image" in line:
                image = Image.open(os.path.join(
                    args.image_folder, line["image"])).convert("RGB")
                images = np.asarray(process_images(
                    [image], image_processor, model.config), np.float32)
                image_sizes = [image.size]
                qs = with_image_token(qs, use_se)
                cur_prompt = "<image>" + "\n" + cur_prompt

            if args.single_pred_prompt:
                qs = qs + "\n" + SINGLE_PRED
                cur_prompt = cur_prompt + "\n" + SINGLE_PRED

            prompt = conv_prompt(args.conv_mode, qs)
            input_ids = np.asarray(tokenizer_image_token(prompt, tokenizer),
                                   np.int32)[None, :]

            output_ids = model.generate(
                input_ids, images=images, image_sizes=image_sizes,
                matryoshka_vis_token_scale=args.matryoshka_vis_token_scale,
                do_sample=args.temperature > 0, temperature=args.temperature,
                max_new_tokens=1024,
                eos_token_id=getattr(tokenizer, "eos_token_id", 2),
                num_beams=args.num_beams,
                pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0)
            outputs = tokenizer.batch_decode(
                output_ids, skip_special_tokens=True)[0].strip()
            ans_file.write(answer_line(line["id"], cur_prompt, outputs,
                                       model_name))
            ans_file.flush()


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default="debug://tiny")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--image-folder", type=str, default="")
    parser.add_argument("--question-file", type=str,
                        default="tables/question.json")
    parser.add_argument("--answers-file", type=str, default="answer.jsonl")
    parser.add_argument("--conv-mode", type=str, default="llava_v0")
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--answer-prompter", action="store_true")
    parser.add_argument("--single-pred-prompt", action="store_true")
    parser.add_argument("--matryoshka_vis_token_scale", type=str, default=None)
    return parser


if __name__ == "__main__":
    eval_model(build_parser().parse_args())
