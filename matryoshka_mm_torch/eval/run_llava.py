"""Single-image VQA entry on the PyTorch port: ``eval_model(args)``
(port of ``matryoshka_mm_tpu/eval/run_llava.py``): load the model, build
the conversation prompt, preprocess the image, generate at the chosen
Matryoshka scale, print the answer.

    python -m matryoshka_mm_torch.eval.run_llava --model-path debug://tiny \\
        --device cpu --image-file img.png --query "What is shown?" \\
        --matryoshka_vis_token_scale ver=v0_numtoks=4
"""

from __future__ import annotations

import argparse
import re
from typing import List

import numpy as np

from matryoshka_mm_tpu.constants import (DEFAULT_IM_END_TOKEN,
                                         DEFAULT_IM_START_TOKEN,
                                         DEFAULT_IMAGE_TOKEN,
                                         IMAGE_PLACEHOLDER)
from matryoshka_mm_tpu.conversation import SeparatorStyle, conv_templates
from matryoshka_mm_tpu.mm_utils import (KeywordsStoppingCriteria,
                                        get_model_name_from_path,
                                        process_images,
                                        tokenizer_image_token)

from ..models.builder import load_pretrained_model


def image_parser(args) -> List[str]:
    return args.image_file.split(args.sep)


def load_image(image_file: str):
    from PIL import Image

    if image_file.startswith(("http://", "https://")):
        raise ValueError("remote images are not fetched; pass a local file")
    return Image.open(image_file).convert("RGB")


def pick_conv_mode(model_name: str) -> str:
    name = model_name.lower()
    if "llama-2" in name:
        return "llava_llama_2"
    if "mistral" in name:
        return "mistral_instruct"
    if "v1.6-34b" in name:
        return "chatml_direct"
    if "v1" in name:
        return "llava_v1"
    if "mpt" in name:
        return "mpt"
    return "llava_v0"


def eval_model(args) -> str:
    model_name = getattr(args, "model_name", None) or \
        get_model_name_from_path(args.model_path)
    tokenizer, model, image_processor, _ = load_pretrained_model(
        args.model_path, args.model_base, model_name,
        load_8bit=getattr(args, "load_8bit", False),
        load_4bit=getattr(args, "load_4bit", False),
        device=getattr(args, "device", "cuda"),
        kv_cache_dtype=getattr(args, "kv_cache_dtype", ""))

    qs = args.query
    image_token_se = DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN + \
        DEFAULT_IM_END_TOKEN
    use_se = getattr(model.config, "mm_use_im_start_end", False)
    if IMAGE_PLACEHOLDER in qs:
        qs = re.sub(IMAGE_PLACEHOLDER,
                    image_token_se if use_se else DEFAULT_IMAGE_TOKEN, qs)
    elif DEFAULT_IMAGE_TOKEN not in qs:
        qs = (image_token_se if use_se else DEFAULT_IMAGE_TOKEN) + "\n" + qs

    conv_mode = pick_conv_mode(model_name)
    if getattr(args, "conv_mode", None) is not None \
            and conv_mode != args.conv_mode:
        print(f"[WARNING] the auto inferred conversation mode is {conv_mode}"
              f", while `--conv-mode` is {args.conv_mode}, using "
              f"{args.conv_mode}")
        conv_mode = args.conv_mode

    conv = conv_templates[conv_mode].copy()
    conv.append_message(conv.roles[0], qs)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt()

    images = [load_image(f) for f in image_parser(args)]
    images_np = process_images(images, image_processor, model.config)
    input_ids = np.asarray(tokenizer_image_token(prompt, tokenizer),
                           np.int32)[None, :]

    stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
    stopping = KeywordsStoppingCriteria([stop_str], tokenizer,
                                        input_ids.shape[1]) \
        if stop_str else None

    output_ids = model.generate(
        input_ids,
        images=np.asarray(images_np, np.float32),
        image_sizes=[im.size for im in images],
        matryoshka_vis_token_scale=getattr(args, "matryoshka_vis_token_scale",
                                           None),
        do_sample=args.temperature > 0,
        temperature=args.temperature,
        top_p=args.top_p if args.top_p is not None else 1.0,
        max_new_tokens=args.max_new_tokens,
        eos_token_id=getattr(tokenizer, "eos_token_id", 2),
        pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0,
        stopping_criteria=stopping,
        num_beams=getattr(args, "num_beams", 1),
    )
    outputs = tokenizer.batch_decode(output_ids,
                                     skip_special_tokens=True)[0].strip()
    if stop_str and outputs.endswith(stop_str):
        outputs = outputs[: -len(stop_str)].strip()
    print(outputs)
    return outputs


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default="debug://tiny")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--model-name", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--load-4bit", action="store_true")
    parser.add_argument("--kv-cache-dtype", type=str, default="",
                        help='"" (the model dtype) or "int8"')
    parser.add_argument("--image-file", type=str, required=True)
    parser.add_argument("--query", type=str, required=True)
    parser.add_argument("--conv-mode", type=str, default=None)
    parser.add_argument("--sep", type=str, default=",")
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--top_p", type=float, default=None)
    parser.add_argument("--num_beams", type=int, default=1)
    parser.add_argument("--max_new_tokens", type=int, default=512)
    parser.add_argument("--matryoshka_vis_token_scale", type=str,
                        default=None)
    return parser


if __name__ == "__main__":
    eval_model(build_parser().parse_args())
