"""Model families of the port (Llama only so far; ROADMAP.md queues the
others) and LoRA adapters for the Llama tree."""

from .llama import (  # noqa: F401
    MODEL_PRESETS,
    LlamaConfig,
    forward,
    init_params,
    init_permutation_params,
    llama3_1b,
    llama3_8b,
    permutation_pair,
    tiny_llama,
)
from .lora import (  # noqa: F401
    DEFAULT_TARGETS,
    LoraShapeError,
    init_lora,
    init_lora_nonzero,
    lora_param_count,
    lora_rank,
    merge_lora,
    validate_lora,
)
