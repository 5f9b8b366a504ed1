"""The checkpoint tools: the port's counterparts of the JAX package's
``scripts/{verify_released_weights,merge_lora_weights,extract_mm_projector,
weight_tools,convert_sqa_to_llava}.py``, each runnable with ``python -m
slime_tpu_torch.tools.<name>``."""
