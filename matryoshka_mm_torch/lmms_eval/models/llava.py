"""LLaVA model adapter for the lmms-eval harness
(reference: lmms-eval/lmms_eval/models/llava.py:44-428; the PyTorch port
of ``matryoshka_mm_tpu/lmms_eval/models/llava.py``).

Honors ``matryoshka_vis_token_scale`` by setting it on the model config and
forwarding it to generate (reference :96-97, :401).  The model loads onto
``device`` (``"cuda"`` unless the caller asks for the CPU): on the card a
``generate_until`` call prefills through the flash-attention kernel and
decodes through the decode-attention kernel, and a ``loglikelihood``
request is one flash-kernel forward with no decode.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ...constants import DEFAULT_IMAGE_TOKEN
from ...conversation import SeparatorStyle, conv_templates
from ...mm_utils import process_images, tokenizer_image_token
from ...models.builder import load_pretrained_model
from ..api.instance import Instance
from ..api.model import lmms
from ..api.registry import register_model


@register_model("llava")
class Llava(lmms):
    def __init__(self, pretrained: str = "debug://tiny",
                 model_base: Optional[str] = None,
                 model_name: Optional[str] = None,
                 conv_template: str = "vicuna_v1",
                 matryoshka_vis_token_scale: Optional[str] = None,
                 device: str = "cuda", batch_size: int = 1, **kwargs):
        super().__init__()
        (self.tokenizer, self.model, self.image_processor,
         self.context_len) = load_pretrained_model(pretrained, model_base,
                                                   model_name, device=device)
        self.conv_template = conv_template
        # plumb the scale knob through the model config (reference :96-97)
        self.model.config.matryoshka_vis_token_scale = matryoshka_vis_token_scale
        self.matryoshka_vis_token_scale = matryoshka_vis_token_scale
        self.batch_size = max(int(batch_size), 1)

    def _build_prompt(self, context: str, has_image: bool) -> str:
        conv = conv_templates[self.conv_template].copy()
        q = (DEFAULT_IMAGE_TOKEN + "\n" + context) if has_image else context
        conv.append_message(conv.roles[0], q)
        conv.append_message(conv.roles[1], None)
        return conv.get_prompt()

    def _postprocess(self, text: str) -> str:
        text = text.strip()
        conv = conv_templates[self.conv_template].copy()
        stop = conv.sep if conv.sep_style != SeparatorStyle.TWO else conv.sep2
        if stop and stop in text:
            text = text.split(stop)[0].strip()
        return text

    def generate_until(self, requests: List[Instance]) -> List[str]:
        """Batched greedy/sampled generation.  Requests are grouped by
        generation kwargs and image presence, left-padded to a shared
        length, and decoded as one pool (reference adapter batches through
        a collator the same way, lmms-eval models/llava.py:300+)."""
        import json as _json

        out: List[Optional[str]] = [None] * len(requests)
        groups = {}
        for i, req in enumerate(requests):
            _, gen_kwargs, visual = req.arguments
            key = (_json.dumps(gen_kwargs, sort_keys=True, default=str),
                   visual is not None)
            groups.setdefault(key, []).append(i)

        for (gk_s, has_img), idxs in groups.items():
            gen_kwargs = _json.loads(gk_s)
            temperature = float(gen_kwargs.get("temperature", 0.0))
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                ids_list, pix_list = [], []
                for i in chunk:
                    context, _, visual = requests[i].arguments
                    prompt = self._build_prompt(context, has_img)
                    ids_list.append(np.asarray(
                        tokenizer_image_token(prompt, self.tokenizer),
                        np.int32))
                    if has_img:
                        pix_list.append(np.asarray(process_images(
                            [visual], self.image_processor,
                            self.model.config), np.float32)[0])
                L = max(len(x) for x in ids_list)
                B = len(chunk)
                input_ids = np.zeros((B, L), np.int32)
                mask = np.zeros((B, L), bool)
                for r, x in enumerate(ids_list):          # left padding
                    input_ids[r, L - len(x):] = x
                    mask[r, L - len(x):] = True
                pixels = np.stack(pix_list) if has_img else None
                output_ids = self.model.generate(
                    input_ids, images=pixels, attention_mask=mask,
                    matryoshka_vis_token_scale=self.matryoshka_vis_token_scale,
                    do_sample=temperature > 0, temperature=temperature,
                    top_p=float(gen_kwargs.get("top_p", 1.0)),
                    max_new_tokens=int(gen_kwargs.get("max_new_tokens", 16)),
                    eos_token_id=getattr(self.tokenizer, "eos_token_id", 2),
                    pad_token_id=getattr(self.tokenizer, "pad_token_id", 0) or 0)
                texts = self.tokenizer.batch_decode(output_ids,
                                                    skip_special_tokens=True)
                for i, t in zip(chunk, texts):
                    t = self._postprocess(t)
                    out[i] = t
                    requests[i].resps.append(t)
        return out  # type: ignore[return-value]

    @torch.inference_mode()
    def loglikelihood(self, requests: List[Instance]) -> List[Tuple[float, bool]]:
        """Score P(continuation | context [+ image]); greedy-match flag.
        One forward a request, in the model's dtype, with the config's
        ``attn_impl`` (``"auto"``: the flash kernel on the card)."""
        from ...constants import IGNORE_INDEX
        from ...train.losses import compute_seq_logprob

        out = []
        for req in requests:
            logits, labels = self.request_logits(req)
            lp = float(compute_seq_logprob(logits, labels)[0])
            shift_labels = labels[0, 1:]
            preds = logits.argmax(-1)[0, :-1]
            mask = shift_labels != IGNORE_INDEX
            greedy = bool((preds[mask] == shift_labels[mask]).all())
            out.append((lp, greedy))
            req.resps.append((lp, greedy))
        return out

    @torch.inference_mode()
    def request_logits(self, req: Instance
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One ``loglikelihood`` request's float32 logits (1, S, V) and the
        labels they score (1, S): the spliced sequence for a request with
        an image, the token ids for a text-only one.  Raises ``ValueError``
        when the splice, clipped to ``tokenizer_model_max_length``, drops
        continuation tokens: what survives would be scored as if it were
        the whole continuation."""
        from ...constants import IGNORE_INDEX
        from ...generate import rank_view
        from ...kvconfig import parse_kv_from_string
        from ...models.llama import llama_logits
        from ...models.llava import forward_spliced, prepare_multimodal

        # weights placed over ranks: this rank's view, as generate takes it
        params, cfg = rank_view(self.model.params, self.model.cfg)
        device = params["llama"]["embed_tokens"].device
        context, continuation, visual = req.arguments
        prompt = self._build_prompt(context, visual is not None)
        ctx_ids = tokenizer_image_token(prompt, self.tokenizer)
        cont_ids = self.tokenizer(continuation).input_ids
        if cont_ids and cont_ids[0] == getattr(self.tokenizer,
                                               "bos_token_id", None):
            cont_ids = cont_ids[1:]
        ids = np.asarray(ctx_ids + list(cont_ids), np.int64)[None, :]
        labels = np.full_like(ids, IGNORE_INDEX)
        labels[0, len(ctx_ids):] = ids[0, len(ctx_ids):]
        ids_t = torch.as_tensor(ids, device=device)
        labels_t = torch.as_tensor(labels, device=device)
        if visual is None:
            return llama_logits(params["llama"], cfg.llama, ids_t), labels_t

        scale = self.matryoshka_vis_token_scale
        numtoks = cfg.vision.num_patches
        if scale:
            kvs = parse_kv_from_string(scale)
            if isinstance(kvs.get("numtoks"), int):
                numtoks = int(kvs["numtoks"])
        pixels = np.asarray(process_images(
            [visual], self.image_processor, self.model.config), np.float32)
        spliced, _ = prepare_multimodal(
            params, cfg, ids_t, torch.as_tensor(pixels, device=device),
            numtoks=numtoks, labels=labels_t)
        kept = int((spliced.labels != IGNORE_INDEX).sum())
        if kept < len(cont_ids):
            raise ValueError(
                f"the spliced sequence of {spliced.labels.shape[1]} positions "
                f"(tokenizer_model_max_length "
                f"{cfg.tokenizer_model_max_length}) keeps {kept} of the "
                f"continuation's {len(cont_ids)} tokens at {numtoks} visual "
                f"tokens")
        return forward_spliced(params, cfg, spliced), spliced.labels
