"""SliME in PyTorch for one NVIDIA H100: a port of the JAX package ``slime_tpu``.

Module names mirror ``slime_tpu``. The JAX package stays the reference the
port is tested against; this package imports ``torch`` and nothing of
``jax`` or ``slime_tpu``: it keeps its own copies of the configuration, the
constants and the host data path. Its hand-written CUDA kernels live in
``csrc/`` and are built at first use (``ops/_cuda.py``).

Entry points (``*.init``, ``params.from_jax_numpy``,
``data.image_ops.make_device_anyres_fn``) put their tensors on the current
CUDA device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
