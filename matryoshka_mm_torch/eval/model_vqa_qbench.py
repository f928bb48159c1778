"""Q-Bench answer generation on the PyTorch port (port of
``matryoshka_mm_tpu/eval/model_vqa_qbench.py``, which follows the upstream
LLaVA generator's llvisionqa contract: a JSON list of ``{img_path,
question, candidates, correct_ans?}`` records; each question is asked with
lettered options and the model's raw response is appended to the record).

Supports ``--lang en|cn`` (question framing language) and the standard
scale / chunking knobs.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..mm_utils import (get_model_name_from_path, process_images,
                        tokenizer_image_token)
from ..models.builder import load_pretrained_model
from .model_vqa_loader import conv_prompt, get_chunk, with_image_token

_PREFACES = {
    "en": ("Answer with the option's letter from the given choices "
           "directly.\n"),
    "cn": "请直接回答正确选项的字母。\n",
}


def _format_question(question: str, candidates, lang: str) -> str:
    letters = "ABCDEFGH"
    options = "\n".join(f"{letters[i]}. {c}" for i, c in enumerate(candidates))
    return f"{question}\n{options}\n{_PREFACES[lang]}"


def eval_model(args):
    from PIL import Image

    model_name = get_model_name_from_path(os.path.expanduser(args.model_path))
    tokenizer, model, image_processor, _ = load_pretrained_model(
        os.path.expanduser(args.model_path), args.model_base, model_name,
        device=args.device)

    with open(os.path.expanduser(args.questions_file)) as f:
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    out_path = os.path.expanduser(args.answers_file)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    use_se = getattr(model.config, "mm_use_im_start_end", False)

    with open(out_path, "w") as ans_file:
        for rec in questions:
            qs = with_image_token(_format_question(
                rec["question"], rec["candidates"], args.lang), use_se)
            ids = np.asarray(
                tokenizer_image_token(conv_prompt(args.conv_mode, qs),
                                      tokenizer), np.int32)[None, :]
            image = Image.open(os.path.join(
                args.image_folder, rec["img_path"])).convert("RGB")
            pixels = np.asarray(process_images([image], image_processor,
                                               model.config), np.float32)
            out = model.generate(
                ids, images=pixels, image_sizes=[image.size],
                matryoshka_vis_token_scale=args.matryoshka_vis_token_scale,
                do_sample=False, temperature=0.0, max_new_tokens=8,
                eos_token_id=getattr(tokenizer, "eos_token_id", 2),
                pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0)
            text = tokenizer.batch_decode(
                out, skip_special_tokens=True)[0].strip()
            ans_file.write(json.dumps({**rec, "response": text}) + "\n")
            ans_file.flush()


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--image-folder", type=str, required=True)
    parser.add_argument("--questions-file", type=str, required=True)
    parser.add_argument("--answers-file", type=str, required=True)
    parser.add_argument("--conv-mode", type=str, default="llava_v1")
    parser.add_argument("--lang", type=str, default="en", choices=["en", "cn"])
    parser.add_argument("--matryoshka_vis_token_scale", type=str, default=None)
    parser.add_argument("--num-chunks", type=int, default=1)
    parser.add_argument("--chunk-idx", type=int, default=0)
    return parser


if __name__ == "__main__":
    eval_model(build_parser().parse_args())
