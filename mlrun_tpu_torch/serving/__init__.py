"""LLM serving of the port: the paged continuous-batching engine
(``paged``), the scheduler core and the dense engine (``llm_batch``), the
prefill forward, ``LLMEngine`` and ``LLMModelServer`` (``llm``), batch-1
speculative decoding (``speculative``), sampling, the V2 model server, and
copies of the reference's prefix cache and typed errors."""

from .samples import (  # noqa: F401
    SampleRing,
    emit_sample,
    get_sample_observer,
    sampling_enabled,
    set_sample_observer,
)
