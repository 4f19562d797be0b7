"""Model families of the port — Llama, MoE, BERT, ViT and T5 — and LoRA
adapters for the Llama tree. As in the reference package, BERT's verbs
are exported at package level, while ``vit`` and ``t5`` stay namespaced
(``vit.classify``, ``t5.encode``)."""

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
from .bert import (  # noqa: F401
    BertConfig,
    bert_base,
    classification_loss,
    classify,
    encode,
    mlm_logits,
    mlm_loss,
    tiny_bert,
)
from .moe import (  # noqa: F401
    MoEConfig,
    mixtral_8x7b_like,
    tiny_moe,
)
from . import vit  # noqa: F401  (vit.classify/encode stay namespaced —
# bert exports the same verb names at package level)
from .vit import ViTConfig, tiny_vit, vit_b16, vit_l16  # noqa: F401
from . import t5  # noqa: F401  (t5.encode/decode stay namespaced)
from .t5 import T5Config, t5_base, t5_large, tiny_t5  # noqa: F401
