"""Model configuration and constants, shared with the JAX package.

The dataclasses and constants of ``slime_tpu.config`` / ``slime_tpu.constants``
are plain Python, so the port uses them as they are; importing them through
this module (the package ``__init__`` first) never loads jax.
"""
from slime_tpu.config import LLMConfig, SliMEConfig, VisionConfig  # noqa: F401
from slime_tpu.constants import (CLIP_IMAGE_MEAN, CLIP_IMAGE_STD,  # noqa: F401
                                 IGNORE_INDEX, IMAGE_TOKEN_INDEX, IMAGE_WIDTH,
                                 MAX_CROPS)
