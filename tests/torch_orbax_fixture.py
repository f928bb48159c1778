"""The committed fixture ``tests/data/torch_orbax/`` and how it is made.

It holds what the port's orbax reader is held against where neither JAX,
orbax nor ``zstandard`` is installed (``chip_smoke.py orbax``):

* ``ckpt/``: a tiny float32 LLaVA (2 decoder layers, one head of 64, so
  the card's attention kernels take it) written by the JAX package's
  ``save_checkpoint``, and ``tokens.json``: a prompt (token ids, the seed
  and shape of its pixels), the generation settings and the JAX
  ``generate``'s greedy tokens on it;
* ``frames/``: zstd frames written by ``zstandard`` (levels 1, 3 and 19,
  with and without checksum and content size, raw / RLE / compressed
  blocks, concatenated and skippable frames), and ``frames.json``: each
  frame's settings and the SHA-256 of its content.

``tests/test_torch_orbax.py`` rebuilds the checkpoint and the tokens in a
temporary directory and holds the committed ones equal to them;
``tests/test_torch_zstd.py`` holds every frame against ``zstandard``.
Rewrite the fixture with ``python -m tests.torch_orbax_fixture``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_orbax"
PROMPT = {"input_ids": [[1, 23, 57, -200, 88, 91, 14]],
          "pixel_seed": 1, "pixel_shape": [1, 3, 56, 56],
          "matryoshka_vis_token_scale": "ver=v0_numtoks=4",
          "gen": {"max_new_tokens": 8, "decode_chunk": 3,
                  "eos_token_id": -1}}


def jax_config():
    from matryoshka_mm_tpu.models.llava import LlavaConfig

    cfg = LlavaConfig.tiny_debug()
    return dataclasses.replace(cfg, llama=dataclasses.replace(
        cfg.llama, vocab_size=256, num_hidden_layers=2,
        num_attention_heads=1, num_key_value_heads=1))


def prompt_arrays(prompt=PROMPT):
    ids = np.asarray(prompt["input_ids"], np.int32)
    px = np.random.default_rng(prompt["pixel_seed"]).standard_normal(
        prompt["pixel_shape"]).astype(np.float32)
    return ids, px


def write_checkpoint(path) -> list:
    """The JAX tiny model (seed 0) saved by the JAX ``save_checkpoint`` at
    ``path``; returns the JAX greedy tokens on :data:`PROMPT`."""
    import jax

    from matryoshka_mm_tpu.generate import GenerationConfig, generate
    from matryoshka_mm_tpu.models.llava import init_llava_params
    from matryoshka_mm_tpu.utils.checkpoint import save_checkpoint

    cfg = jax_config()
    params = init_llava_params(jax.random.PRNGKey(0), cfg)
    save_checkpoint(str(path), params, cfg, step=3)
    ids, px = prompt_arrays()
    tokens = generate(params, cfg, ids, px,
                      matryoshka_vis_token_scale=PROMPT[
                          "matryoshka_vis_token_scale"],
                      gen_cfg=GenerationConfig(**PROMPT["gen"]))
    return np.asarray(tokens).tolist()


def corpora() -> dict:
    """Inputs that drive each block, literal and sequence mode."""
    rng = np.random.default_rng(0)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"epsilon ", b"\n"]
    text = b"".join(words[i] for i in rng.integers(0, 6, 260_000))
    rec = np.random.default_rng(0)
    return {
        "text": text[:1_100_000],           # > 1 MiB; treeless literals
        "words": text[:400_000],            # repeated OF / ML tables
        "fp16": rng.standard_normal(20_000).astype(np.float16).tobytes(),
        "zeros": bytes(300_000),            # RLE blocks
        "random": rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),
        "ramp": np.arange(20_000, dtype=np.int32).tobytes(),
        "records": b"".join(b"HDR:" + rec.integers(0, 256, 4, np.uint8)
                            .tobytes() + b":END\n" for _ in range(8_000)),
        "small": b"abcabcabd" * 7 + b"z",
    }


# name: (corpus, level, checksum, content size)
FRAMES = {"text_l19_check": ("text", 19, True, True),
          "words_l19": ("words", 19, False, True),
          "fp16_l1_check": ("fp16", 1, True, True),
          "zeros_l3": ("zeros", 3, False, True),
          "random_l1_nosize": ("random", 1, True, False),
          "records_l1_nosize": ("records", 1, False, False),
          "records_l19": ("records", 19, False, True),
          "small_l1_check": ("small", 1, True, True)}


def make_frames() -> dict:
    """``{name: (frame bytes, content bytes)}``, plus ``concat``: two
    frames around a skippable frame."""
    import zstandard

    data = corpora()
    out = {}
    for name, (corpus, level, check, size) in FRAMES.items():
        c = zstandard.ZstdCompressor(level=level, write_checksum=check,
                                     write_content_size=size)
        out[name] = (c.compress(data[corpus]), data[corpus])
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"skip!"
    out["concat"] = (out["small_l1_check"][0] + skip + out["zeros_l3"][0],
                     data["small"] + data["zeros"])
    return out


def write_fixture(root: Path = FIXTURE) -> None:
    if root.exists():
        shutil.rmtree(root)
    (root / "frames").mkdir(parents=True)
    tokens = write_checkpoint(root / "ckpt")
    with open(root / "tokens.json", "w") as f:
        json.dump({**PROMPT, "tokens": tokens}, f, indent=1)
    table = {}
    for name, (frame, content) in make_frames().items():
        (root / "frames" / f"{name}.zst").write_bytes(frame)
        table[name] = {"sha256": hashlib.sha256(content).hexdigest(),
                       "size": len(content),
                       **dict(zip(("corpus", "level", "checksum",
                                   "content_size"),
                                  FRAMES.get(name, ("concat",))))}
    with open(root / "frames.json", "w") as f:
        json.dump(table, f, indent=1)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_fixture()
    print(f"wrote {FIXTURE}")
