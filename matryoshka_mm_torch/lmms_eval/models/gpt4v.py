"""API-backed vision-model adapter (reference:
lmms-eval/lmms_eval/models/gpt4v.py).

Proves the harness is model-agnostic: any OpenAI-compatible vision chat
endpoint (``/chat/completions`` with image_url content parts) can run the
same task corpus as the local llava adapter.  Configure with
``--model gpt4v --model_args model_version=...``; requires
``OPENAI_API_KEY`` (and optionally ``OPENAI_BASE_URL`` for compatible
gateways) — offline it raises a clear error instead of mis-scoring.

The PyTorch port's copy of ``matryoshka_mm_tpu/lmms_eval/models/gpt4v.py``.
"""

from __future__ import annotations

import base64
import io
import os
import time
from typing import Callable, List, Optional, Tuple

from ..api.instance import Instance
from ..api.model import lmms
from ..api.registry import register_model


class ConfigError(RuntimeError):
    """Non-retryable setup problem (missing key, 4xx auth) — surfaced
    immediately instead of burning the retry/backoff loop."""


def _image_to_data_url(image) -> str:
    buf = io.BytesIO()
    image.save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f"data:image/png;base64,{b64}"


@register_model("gpt4v")
class GPT4V(lmms):
    """generate_until via an OpenAI-compatible vision endpoint.

    ``post_fn(payload) -> response_json`` is injectable for tests; the
    default posts to ``$OPENAI_BASE_URL/chat/completions``.
    """

    def __init__(self, model_version: str = "gpt-4-vision-preview",
                 max_retries: int = 5, timeout: float = 120.0,
                 post_fn: Optional[Callable] = None, **kwargs):
        super().__init__()
        self.model_version = model_version
        self.max_retries = int(max_retries)
        self.timeout = float(timeout)
        self._post = post_fn or self._default_post

    def _default_post(self, payload: dict) -> dict:
        api_key = os.environ.get("OPENAI_API_KEY")
        if not api_key:
            raise ConfigError(
                "OPENAI_API_KEY not set; the gpt4v adapter needs an "
                "OpenAI-compatible endpoint (set OPENAI_BASE_URL for "
                "gateways)")
        base = os.environ.get("OPENAI_BASE_URL", "https://api.openai.com/v1")
        import requests

        r = requests.post(f"{base}/chat/completions",
                          headers={"Authorization": f"Bearer {api_key}"},
                          json=payload, timeout=self.timeout)
        if 400 <= r.status_code < 500 and r.status_code != 429:
            raise ConfigError(f"gpt4v endpoint rejected the request "
                              f"({r.status_code}): {r.text[:200]}")
        r.raise_for_status()
        return r.json()

    def _one(self, text: str, visual, gen_kwargs: dict) -> str:
        content = [{"type": "text", "text": text}]
        visuals = visual if isinstance(visual, (list, tuple)) else \
            [visual] if visual is not None else []
        for v in visuals:
            content.append({"type": "image_url",
                            "image_url": {"url": _image_to_data_url(v)}})
        payload = {
            "model": self.model_version,
            "messages": [{"role": "user", "content": content}],
            "max_tokens": int(gen_kwargs.get("max_new_tokens", 128)),
            "temperature": float(gen_kwargs.get("temperature", 0.0)),
        }
        err = None
        for attempt in range(self.max_retries):
            try:
                resp = self._post(payload)
                return resp["choices"][0]["message"]["content"].strip()
            except ConfigError:
                raise               # misconfiguration: retrying can't help
            except Exception as e:  # noqa: BLE001
                err = e
                time.sleep(min(2.0 * (attempt + 1), 10.0))
        raise RuntimeError(f"gpt4v request failed after "
                           f"{self.max_retries} retries: {err}")

    def generate_until(self, requests: List[Instance]) -> List[str]:
        out = []
        for inst in requests:
            text, gen_kwargs, visual = inst.arguments
            out.append(self._one(text, visual, dict(gen_kwargs or {})))
        return out

    def loglikelihood(self, requests: List[Instance]
                      ) -> List[Tuple[float, bool]]:
        raise NotImplementedError(
            "chat-completion APIs expose no per-token logprobs over a "
            "forced continuation; use a generate_until task variant "
            "(the reference gpt4v adapter has the same limitation)")
