"""Conversation prompt templates.

Registry of the prompt formats used by the Vicuna / LLaMA-2 / MPT / plain
model families.  The *rendered prompt strings* must match the reference
byte-for-byte so tokenized inputs (and therefore cached activations and
benchmark answers) agree (reference behavior: llava/conversation.py:9-399).
The template **data** below (system prompts, role names, separators) is that
compatibility contract; the rendering machinery is this framework's own:
each separator style is a small pure renderer registered in
``_RENDERERS``, and a ``Conversation`` is just history + a style tag.

The reference's gradio-specific helpers (``to_gradio_chatbot``) are not
reproduced — this repo's web UI (serve/web_server.py) renders its own chat
transcript from the message list.
"""

from __future__ import annotations

import base64
import dataclasses
from enum import Enum, auto
from io import BytesIO
from typing import Any, Callable, Dict, List, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()


def _text_of(message: Any) -> str:
    """A message is either a string or an (text, image, mode) tuple."""
    return message[0] if isinstance(message, tuple) else message


# ---------------------------------------------------------------------------
# per-style renderers: (conv, [(role, message), ...]) -> prompt string
# ---------------------------------------------------------------------------

def _render_single(conv: "Conversation", msgs) -> str:
    parts = [conv.system, conv.sep]
    for role, m in msgs:
        parts.append(f"{role}: {_text_of(m)}{conv.sep}" if m else f"{role}:")
    return "".join(parts)


def _render_two(conv: "Conversation", msgs) -> str:
    seps = (conv.sep, conv.sep2)
    parts = [conv.system, seps[0]]
    for i, (role, m) in enumerate(msgs):
        parts.append(f"{role}: {_text_of(m)}{seps[i % 2]}" if m
                     else f"{role}:")
    return "".join(parts)


def _render_mpt(conv: "Conversation", msgs) -> str:
    parts = [conv.system, conv.sep]
    for role, m in msgs:
        parts.append(f"{role}{_text_of(m)}{conv.sep}" if m else role)
    return "".join(parts)


def _render_llama2(conv: "Conversation", msgs) -> str:
    if msgs:
        role0, m0 = msgs[0]
        assert m0, "first message should not be none"
        assert role0 == conv.roles[0], "first message should come from user"
    parts: List[str] = []
    for i, (_role, m) in enumerate(msgs):
        if not m:
            continue
        text = _text_of(m)
        if i == 0 and conv.system:
            text = f"<<SYS>>\n{conv.system}\n<</SYS>>\n\n{text}"
        if i % 2 == 0:                     # user turn
            parts.append(f"{conv.sep}[INST] {text} [/INST]")
        else:                              # assistant turn
            parts.append(f" {text} {conv.sep2}")
    # the leading BOS separator is supplied by the tokenizer, not the prompt
    return "".join(parts).lstrip(conv.sep)


def _render_plain(conv: "Conversation", msgs) -> str:
    seps = (conv.sep, conv.sep2)
    parts = [conv.system]
    for i, (_role, m) in enumerate(msgs):
        if m:
            parts.append(f"{_text_of(m)}{seps[i % 2]}")
    return "".join(parts)


_RENDERERS: Dict[SeparatorStyle, Callable] = {
    SeparatorStyle.SINGLE: _render_single,
    SeparatorStyle.TWO: _render_two,
    SeparatorStyle.MPT: _render_mpt,
    SeparatorStyle.LLAMA_2: _render_llama2,
    SeparatorStyle.PLAIN: _render_plain,
}


@dataclasses.dataclass
class Conversation:
    """Chat history plus a prompt style; renders into a model prompt."""

    system: str
    roles: Tuple[str, ...]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: str = None
    version: str = "Unknown"

    # -- rendering -----------------------------------------------------
    def _normalized_messages(self):
        """Resolve the image carried by the first user turn into prompt
        text: either an ``<image>\\n`` prefix or the mmtag exchange."""
        msgs = self.messages
        if not msgs or not isinstance(msgs[0][1], tuple):
            return msgs
        role0 = msgs[0][0]
        text0 = _text_of(msgs[0][1]).replace("<image>", "").strip()
        if "mmtag" in self.version:
            head = [(self.roles[0], "<Image><image></Image>"),
                    (self.roles[1], "Received."),
                    (role0, text0)]
        else:
            head = [(role0, f"<image>\n{text0}")]
        return head + [tuple(m) for m in msgs[1:]]

    def get_prompt(self) -> str:
        try:
            render = _RENDERERS[self.sep_style]
        except KeyError:
            raise ValueError(f"Invalid style: {self.sep_style}") from None
        return render(self, self._normalized_messages())

    def append_message(self, role, message):
        self.messages.append([role, message])

    # -- image handling ------------------------------------------------
    def process_image(self, image, image_process_mode, return_pil=False,
                      image_format="PNG", max_len=1344, min_len=672):
        """Apply the UI's Pad/Crop/Resize choice plus a size cap; returns a
        PIL image or a base64 payload for the serving protocol."""
        from .image_processing import expand2square

        if image_process_mode == "Pad":
            image = expand2square(image, (122, 116, 104))
        elif image_process_mode == "Resize":
            image = image.resize((336, 336))
        elif image_process_mode not in ("Default", "Crop"):
            raise ValueError(
                f"Invalid image_process_mode: {image_process_mode}")

        w, h = image.size
        if max(w, h) > max_len:
            aspect = max(w, h) / min(w, h)
            short = int(min(max_len / aspect, min_len, min(w, h)))
            long_ = int(short * aspect)
            image = image.resize((long_, short) if w >= h else (short, long_))
        if return_pil:
            return image
        buf = BytesIO()
        image.save(buf, format=image_format)
        return base64.b64encode(buf.getvalue()).decode()

    def get_images(self, return_pil=False):
        out = []
        for i, (_role, m) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0 and isinstance(m, tuple):
                _text, image, mode = m
                if isinstance(image, list):
                    image = image[0]
                out.append(self.process_image(image, mode,
                                              return_pil=return_pil))
        return out

    # -- misc ------------------------------------------------------------
    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system, roles=self.roles,
            messages=[[role, m] for role, m in self.messages],
            offset=self.offset, sep_style=self.sep_style,
            sep=self.sep, sep2=self.sep2, version=self.version)

    def dict(self):
        has_images = any(isinstance(m, tuple) for _r, m in self.messages)
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": ([[r, _text_of(m)] for r, m in self.messages]
                         if has_images else self.messages),
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


conv_vicuna_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[
        ["Human", "What are the key differences between renewable and non-renewable energy sources?"],
        ["Assistant",
         "Renewable energy sources are those that can be replenished naturally in a relatively "
         "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
         "Non-renewable energy sources, on the other hand, are finite and will eventually be "
         "depleted, such as coal, oil, and natural gas. Here are some key differences between "
         "renewable and non-renewable energy sources:\n"
         "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
         "energy sources are finite and will eventually run out.\n"
         "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
         "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
         "and other negative effects.\n"
         "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
         "have lower operational costs than non-renewable sources.\n"
         "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
         "locations than non-renewable sources.\n"
         "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
         "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
         "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
         "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the user's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llama_2 = Conversation(
    system="""You are a helpful, respectful and honest assistant. Always answer as helpfully as possible, while being safe.  Your answers should not include any harmful, unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure that your responses are socially unbiased and positive in nature.

If a question does not make any sense, or is not factually coherent, explain why instead of answering something not correct. If you don't know the answer to a question, please don't share false information.""",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_llava_llama_2 = Conversation(
    system="You are a helpful language and vision assistant. "
           "You are able to understand the visual content that the user provides, "
           "and assist the user with a variety of tasks using natural language.",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = Conversation(
    system="""<|im_start|>system
A conversation between a user and an LLM-based AI assistant. The assistant gives helpful and honest answers.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_llava_plain = Conversation(
    system="",
    roles=("", ""),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_llava_v0 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_llava_v0_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("Human", "Assistant"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_llava_v1 = Conversation(
    system="A chat between a curious human and an artificial intelligence assistant. "
           "The assistant gives helpful, detailed, and polite answers to the human's questions.",
    roles=("USER", "ASSISTANT"),
    version="v1",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_llava_v1_mmtag = Conversation(
    system="A chat between a curious user and an artificial intelligence assistant. "
           "The assistant is able to understand the visual content that the user provides, and assist the user with a variety of tasks using natural language."
           "The visual content will be provided with the following format: <Image>visual content</Image>.",
    roles=("USER", "ASSISTANT"),
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

conv_mistral_instruct = Conversation(
    system="",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.LLAMA_2,
    sep="",
    sep2="</s>",
)

conv_chatml_direct = Conversation(
    system="""<|im_start|>system
Answer the questions.""",
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    messages=[],
    offset=0,
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

default_conversation = conv_vicuna_v1
conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "llama_2": conv_llama_2,
    "mistral_instruct": conv_mistral_instruct,
    "chatml_direct": conv_chatml_direct,
    "mistral_direct": conv_chatml_direct,

    "plain": conv_llava_plain,
    "v0_plain": conv_llava_plain,
    "llava_v0": conv_llava_v0,
    "v0_mmtag": conv_llava_v0_mmtag,
    "llava_v1": conv_llava_v1,
    "v1_mmtag": conv_llava_v1_mmtag,
    "llava_llama_2": conv_llava_llama_2,

    "mpt": conv_mpt,
}
