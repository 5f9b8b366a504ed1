"""Model constants (the port's copy of ``slime_tpu/constants.py``).

The values mirror the reference constant set (llava/constants.py:7-13) and
the anyres geometry (llava/process_image.py:11-21), so datasets, checkpoints
and prompts interoperate with the JAX package unchanged.
"""
import os as _os

# Serving heartbeat protocol (llava/constants.py:1-2)
CONTROLLER_HEART_BEAT_EXPIRATION = 30
WORKER_HEART_BEAT_INTERVAL = 15

# The web UI's conversation-log directory (SLIME_LOGDIR, else under the
# user's home), as the JAX package's
LOGDIR = _os.environ.get("SLIME_LOGDIR", _os.path.join(_os.path.expanduser("~"), ".slime_tpu",
                                                       "logs"))

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200
DEFAULT_IMAGE_TOKEN = "<image>"

# AnyRes geometry: 576 ViT patches of 14 px per 336x336 view
PATCH_SIZE = 14
PATCH_NUM_WIDTH = 24
PATCH_NUM_HEIGHT = 24
MAX_PATCHES = PATCH_NUM_WIDTH * PATCH_NUM_HEIGHT
IMAGE_WIDTH = PATCH_SIZE * PATCH_NUM_WIDTH      # 336
IMAGE_HEIGHT = PATCH_SIZE * PATCH_NUM_HEIGHT    # 336

# Static crop budget: one global view + up to 7 local crops, padded with a
# crop mask so every batch has one shape
MAX_LOCAL_CROPS = 7
MAX_CROPS = 1 + MAX_LOCAL_CROPS

# CLIP-L/336 preprocessing (OpenAI CLIP normalization)
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)
