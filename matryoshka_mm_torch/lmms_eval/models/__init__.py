from . import gpt4v, llava, llava_sglang  # noqa: F401  (register adapters)
