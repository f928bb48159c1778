"""Interactive CLI chat (reference: llava/serve/cli.py:1-129); the port of
``matryoshka_mm_tpu/serve/cli.py``.

Multi-turn chat with streaming output (``generate.stream_generate``: the
flash kernel's prefill and a captured decode on the card) and the
``--matryoshka_vis_token_scale`` knob (an int scale, converted to the kv
spec like the reference :105,127).

    python -m matryoshka_mm_torch.serve.cli --model-path debug://7b \\
        --image-file photo.png --matryoshka_vis_token_scale 144
"""

from __future__ import annotations

import argparse

import numpy as np

from ..constants import DEFAULT_IM_END_TOKEN, DEFAULT_IM_START_TOKEN, DEFAULT_IMAGE_TOKEN
from ..conversation import SeparatorStyle, conv_templates
from ..mm_utils import get_model_name_from_path, process_images, tokenizer_image_token
from ..models.builder import load_pretrained_model


def load_image(image_file):
    from io import BytesIO

    from PIL import Image

    if image_file.startswith("http://") or image_file.startswith("https://"):
        import requests

        response = requests.get(image_file)
        image = Image.open(BytesIO(response.content)).convert("RGB")
    else:
        image = Image.open(image_file).convert("RGB")
    return image


def main(args):
    from ..generate import GenerationConfig, stream_generate

    model_name = get_model_name_from_path(args.model_path)
    tokenizer, model, image_processor, context_len = load_pretrained_model(
        args.model_path, args.model_base, model_name, args.load_8bit,
        args.load_4bit, device=args.device,
        kv_cache_dtype=args.kv_cache_dtype)

    if "llama-2" in model_name.lower():
        conv_mode = "llava_llama_2"
    elif "mistral" in model_name.lower():
        conv_mode = "mistral_instruct"
    elif "v1.6-34b" in model_name.lower():
        conv_mode = "chatml_direct"
    elif "v1" in model_name.lower():
        conv_mode = "llava_v1"
    elif "mpt" in model_name.lower():
        conv_mode = "mpt"
    else:
        conv_mode = "llava_v0"

    if args.conv_mode is not None and conv_mode != args.conv_mode:
        print(f"[WARNING] the auto inferred conversation mode is {conv_mode}, "
              f"while `--conv-mode` is {args.conv_mode}, using {args.conv_mode}")
        conv_mode = args.conv_mode

    conv = conv_templates[conv_mode].copy()
    roles = ("user", "assistant") if "mpt" in model_name.lower() else conv.roles

    image = load_image(args.image_file)
    pixel_values = np.asarray(
        process_images([image], image_processor, model.config), np.float32)

    scale_spec = None
    if args.matryoshka_vis_token_scale is not None:
        scale_spec = f"ver=v0_numtoks={args.matryoshka_vis_token_scale}"

    first_turn = True
    while True:
        try:
            inp = input(f"{roles[0]}: ")
        except EOFError:
            inp = ""
        if not inp:
            print("exit...")
            break

        print(f"{roles[1]}: ", end="", flush=True)

        if image is not None and first_turn:
            if getattr(model.config, "mm_use_im_start_end", False):
                inp = (DEFAULT_IM_START_TOKEN + DEFAULT_IMAGE_TOKEN
                       + DEFAULT_IM_END_TOKEN + "\n" + inp)
            else:
                inp = DEFAULT_IMAGE_TOKEN + "\n" + inp
            first_turn = False

        conv.append_message(conv.roles[0], inp)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()

        input_ids = np.asarray(
            tokenizer_image_token(prompt, tokenizer), np.int32)[None, :]
        stop_str = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2

        gen_cfg = GenerationConfig(
            max_new_tokens=args.max_new_tokens,
            temperature=args.temperature,
            do_sample=args.temperature > 0,
            eos_token_id=getattr(tokenizer, "eos_token_id", 2),
            pad_token_id=getattr(tokenizer, "pad_token_id", 0) or 0,
            decode_chunk=8)

        if args.speculative:
            # prompt-lookup decoding gives no incremental stream; greedy
            # only: print the completed answer
            import dataclasses as _dc

            from ..generate import speculative_generate

            out_ids = speculative_generate(
                model.params, model.cfg, input_ids, pixel_values,
                matryoshka_vis_token_scale=scale_spec,
                gen_cfg=_dc.replace(gen_cfg, temperature=0.0,
                                    do_sample=False))
            outputs = tokenizer.decode(
                [int(t) for t in out_ids[0] if t != gen_cfg.pad_token_id],
                skip_special_tokens=True)
            if stop_str and stop_str in outputs:
                outputs = outputs.split(stop_str)[0]
            print(outputs)
            conv.messages[-1][-1] = outputs
            if args.debug:
                print("\n", {"prompt": prompt, "outputs": outputs}, "\n")
            continue

        printed = ""
        outputs = ""
        for ids in stream_generate(model.params, model.cfg, input_ids,
                                   pixel_values,
                                   matryoshka_vis_token_scale=scale_spec,
                                   gen_cfg=gen_cfg):
            outputs = tokenizer.decode(
                [int(t) for t in ids[0] if t != gen_cfg.pad_token_id],
                skip_special_tokens=True)
            if stop_str and stop_str in outputs:
                outputs = outputs.split(stop_str)[0]
                print(outputs[len(printed):], end="", flush=True)
                printed = outputs
                break
            print(outputs[len(printed):], end="", flush=True)
            printed = outputs
        print()
        conv.messages[-1][-1] = outputs

        if args.debug:
            print("\n", {"prompt": prompt, "outputs": outputs}, "\n")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model-path", type=str, default="debug://7b")
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--image-file", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--conv-mode", type=str, default=None)
    parser.add_argument("--temperature", type=float, default=0.2)
    parser.add_argument("--max-new-tokens", type=int, default=512)
    parser.add_argument("--load-8bit", action="store_true")
    parser.add_argument("--load-4bit", action="store_true")
    parser.add_argument("--kv-cache-dtype", type=str, default="",
                        choices=["", "int8"],
                        help="int8: KV cache stored int8 with per-slot "
                             "scales (half the KV HBM per token)")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--matryoshka_vis_token_scale", type=int, default=None)
    parser.add_argument("--speculative", action="store_true",
                        help="prompt-lookup speculative decoding "
                             "(greedy; pairs with --load-8bit)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
