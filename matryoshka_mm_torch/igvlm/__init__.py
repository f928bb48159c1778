"""IG-VLM: video QA via image grids (the PyTorch port of
``matryoshka_mm_tpu/igvlm/``).

Re-implementation of the vendored IG-VLM fork (reference: IG-VLM/): a video
is sampled to a fixed number of frames, composed into a near-square grid
collage, and answered by the single-image VLM.  Scoring: exact multiple
choice (eval_llava_multiplechoice), the GPT judge with per-question resume
(eval_llava_openended), and the five-dimension text-generation benchmark
incl. paired-question consistency (eval_llava_textgeneration_openended).
"""

from .evaluation import (eval_gpt3, eval_gpt3_consistency,  # noqa: F401
                         eval_multiple_choice, openai_judge)
from .grid import create_grid_view, extract_frames  # noqa: F401
from .pipeline import LlavaPipeline  # noqa: F401
