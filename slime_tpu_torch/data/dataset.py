"""The host input pipeline, shared with the JAX package, under the port's name.

``slime_tpu.data.dataset`` and ``slime_tpu.data.image_ops`` are plain numpy
and PIL, so the port uses them as they are: ``collate`` builds the
fixed-shape training batch, ``Prefetcher`` runs the input pipeline in a
producer thread, and ``process_anyres_image_host`` cuts an image into the
anyres crops (uint8 with ``normalize=False``; ``encode_images`` normalizes).

This module exists for ``chip_smoke.py``, which runs where jax is not
installed and so names only ``slime_tpu_torch``: importing the shared
modules through the port, after the package ``__init__`` has imported
``slime_tpu`` with ``SLIME_PLATFORM`` hidden, never loads jax. Port modules
import the shared modules directly, as the trainer does.
"""
from slime_tpu.data.dataset import Prefetcher, collate  # noqa: F401
from slime_tpu.data.image_ops import process_anyres_image_host  # noqa: F401
