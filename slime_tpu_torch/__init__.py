"""SliME in PyTorch for one NVIDIA H100: a port of the JAX package ``slime_tpu``.

Module names mirror ``slime_tpu``. The JAX package stays the reference the
port is tested against; this package imports ``torch`` and never ``jax``.
Its hand-written CUDA kernels live in ``csrc/`` and are built at first use
(``ops/_cuda.py``).

The port reuses the jax-free modules of ``slime_tpu`` (``config``,
``constants``, ``data.anyres``, ``data.tokenization``; see ``config.py``).
``slime_tpu/__init__.py`` imports jax when ``SLIME_PLATFORM`` is set, so the
first import of ``slime_tpu`` happens here with that variable hidden, and the
environment is restored afterwards.
"""
import os as _os
import sys as _sys

__version__ = "0.1.0"

if "slime_tpu" not in _sys.modules:
    _platform = _os.environ.pop("SLIME_PLATFORM", None)
    try:
        import slime_tpu  # noqa: F401
    finally:
        if _platform is not None:
            _os.environ["SLIME_PLATFORM"] = _platform
