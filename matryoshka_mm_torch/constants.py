"""Framework-wide constants.

Mirrors the public constants of the reference implementation
(reference: llava/constants.py:1-13) so that checkpoints, datasets and
serialized conversations remain interchangeable.
"""

CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15

LOGDIR = "."

# Model constants
IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"

# Matryoshka defaults: the 24x24 CLIP ViT-L/14-336 patch grid pooled into a
# coarse-to-fine pyramid (reference: scripts/v1_5/finetune.sh:36).
DEFAULT_TOKSCALES = (1, 9, 36, 144, 576)
