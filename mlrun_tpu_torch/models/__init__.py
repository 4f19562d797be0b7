"""Model families of the port (Llama only so far; ROADMAP.md queues the
others)."""

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
