"""IG-VLM inference pipeline over a dataframe of videos+questions
(reference: IG-VLM/pipeline_processor/llava_pipeline.py:23-156,
model_processor/llava2_model_processor.py:68-80; the PyTorch port of
``matryoshka_mm_tpu/igvlm/pipeline.py``).

A row whose video cannot be read, or whose API call fails, gets an
``ERROR: ...`` prediction and the run goes on, as in the JAX package; an
error of the local model is raised.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..constants import DEFAULT_IMAGE_TOKEN
from ..conversation import SeparatorStyle, conv_templates
from ..mm_utils import process_images, tokenizer_image_token
from ..models.builder import load_pretrained_model
from .grid import video_to_grid_image


class _GridQAPipeline:
    """Shared driver: per-row video -> frame grid -> single-image QA with
    resume from an existing results file (reference: llava_pipeline.py /
    gpt4_pipeline.py share this idempotent-dataframe structure)."""

    def __init__(self, path_qa: str, dir_video: str, path_result: str,
                 frame_fixed_number: int = 6):
        import pandas as pd

        self.frame_fixed_number = frame_fixed_number
        self.dir_video = dir_video
        self.path_result = path_result
        self.df_qa = pd.read_csv(path_qa)
        self.user_prompt = "{question}"

    def set_component(self, user_prompt: str, max_new_tokens: int = 128,
                      temperature: float = 0.0, **kw):
        self.user_prompt = user_prompt
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature

    def _ask(self, image, question: str) -> str:
        raise NotImplementedError

    def do_pipeline(self):
        import pandas as pd

        df = self.df_qa
        if os.path.exists(self.path_result):
            prev = pd.read_csv(self.path_result)
            done = set(prev["question_id"]) if "question_id" in prev else set()
        else:
            prev, done = None, set()

        rows = [] if prev is None else prev.to_dict("records")
        for _, row in df.iterrows():
            qid = row.get("question_id", row.name)
            if qid in done:
                continue
            video = os.path.join(self.dir_video, str(row["video_name"]))
            question = self.user_prompt.format(**row.to_dict())
            # an unreadable video fails its row only
            try:
                image = video_to_grid_image(video, self.frame_fixed_number)
            except (OSError, ValueError) as e:
                pred = f"ERROR: {e}"
            else:
                pred = self._ask(image, question)
            rows.append({**row.to_dict(), "question_id": qid, "pred": pred})
            pd.DataFrame(rows).to_csv(self.path_result, index=False)
        return pd.DataFrame(rows), self.path_result


class LlavaPipeline(_GridQAPipeline):
    """Local model backend: loads the model once, onto ``device``."""

    def __init__(self, model_path: str, path_qa: str, dir_video: str,
                 path_result: str, model_base: Optional[str] = None,
                 matryoshka_vis_token_scale: Optional[str] = None,
                 conv_mode: str = "llava_v1", frame_fixed_number: int = 6,
                 device: str = "cuda"):
        super().__init__(path_qa, dir_video, path_result, frame_fixed_number)
        (self.tokenizer, self.model, self.image_processor,
         self.context_len) = load_pretrained_model(model_path, model_base,
                                                   None, device=device)
        self.matryoshka_vis_token_scale = matryoshka_vis_token_scale
        self.conv_mode = conv_mode

    def _ask(self, image, question: str) -> str:
        pixels = np.asarray(process_images([image], self.image_processor,
                                           self.model.config), np.float32)
        conv = conv_templates[self.conv_mode].copy()
        conv.append_message(conv.roles[0], DEFAULT_IMAGE_TOKEN + "\n" + question)
        conv.append_message(conv.roles[1], None)
        prompt = conv.get_prompt()
        ids = np.asarray(tokenizer_image_token(prompt, self.tokenizer),
                         np.int32)[None, :]
        out = self.model.generate(
            ids, images=pixels,
            matryoshka_vis_token_scale=self.matryoshka_vis_token_scale,
            do_sample=getattr(self, "temperature", 0.0) > 0,
            temperature=getattr(self, "temperature", 0.0),
            max_new_tokens=getattr(self, "max_new_tokens", 128),
            eos_token_id=getattr(self.tokenizer, "eos_token_id", 2),
            pad_token_id=getattr(self.tokenizer, "pad_token_id", 0) or 0)
        text = self.tokenizer.batch_decode(out, skip_special_tokens=True)[0].strip()
        conv2 = conv_templates[self.conv_mode].copy()
        stop = conv2.sep if conv2.sep_style != SeparatorStyle.TWO else conv2.sep2
        if stop and stop in text:
            text = text.split(stop)[0].strip()
        return text


class Gpt4vPipeline(_GridQAPipeline):
    """API backend (reference: IG-VLM/pipeline_processor/gpt4_pipeline.py +
    eval_gpt4v_* entries): the same video->grid preprocessing, answered by
    an OpenAI-compatible vision endpoint.  ``post_fn`` is injectable for
    tests; offline without OPENAI_API_KEY every row records the
    ``ConfigError``."""

    def __init__(self, path_qa: str, dir_video: str, path_result: str,
                 model_version: str = "gpt-4-vision-preview",
                 frame_fixed_number: int = 6, post_fn=None):
        super().__init__(path_qa, dir_video, path_result, frame_fixed_number)
        from ..lmms_eval.models.gpt4v import GPT4V

        self._api = GPT4V(model_version=model_version, post_fn=post_fn)

    def _ask(self, image, question: str) -> str:
        try:
            return self._api._one(
                question, image,
                {"max_new_tokens": getattr(self, "max_new_tokens", 128),
                 "temperature": getattr(self, "temperature", 0.0)})
        except RuntimeError as e:   # a failed API call fails its row only
            return f"ERROR: {e}"
