"""Serving of the port: the serving graph (``states``: steps, flows,
routers and queues; ``server``: ``GraphServer``; ``routers``; ``remote``:
HTTP steps; ``asgi``: the standard-library HTTP gateway), the V2 and v1
model servers, LLM serving on the paged continuous-batching engine
(``paged``), the scheduler core and the dense engine (``llm_batch``), the
prefill forward, ``LLMEngine`` and ``LLMModelServer`` (``llm``), batch-1
speculative decoding (``speculative``), sampling, the engine fleet and
canary splits, the sample tap, and copies of the reference's prefix cache
and typed errors. The names exported here are the reference package's
``serving`` exports, plus the sample tap."""

from .canary import (  # noqa: F401
    CanaryRouter,
    get_canary_router,
    set_canary_router,
    split_key_for,
)
from .fleet import (  # noqa: F401
    ConsistentHashRing,
    EngineFleet,
    EngineReplica,
)
from .remote import BatchHttpRequests, RemoteCallError, RemoteStep  # noqa: F401
from .resilience import (  # noqa: F401
    AdmissionController,
    AdmissionRejected,
    CircuitBreaker,
    CircuitOpenError,
    DeadlineExceeded,
    DegradationLadder,
    EngineStoppedError,
    PromptTooLongError,
    QueueFullError,
    ReplicaUnavailableError,
    ResilienceError,
    ServerDrainingError,
    StepResilience,
)
from .routers import (  # noqa: F401
    EnrichmentModelRouter,
    EnrichmentVotingEnsemble,
    ModelRouter,
    ParallelRun,
    PrefixAffinityRouter,
    VotingEnsemble,
)
from .samples import (  # noqa: F401
    SampleRing,
    emit_sample,
    get_sample_observer,
    sampling_enabled,
    set_sample_observer,
)
from .server import (  # noqa: F401
    GraphContext,
    GraphServer,
    MockEvent,
    MockTrigger,
    Response,
    create_graph_server,
    v2_serving_handler,
    v2_serving_init,
)
from .states import (  # noqa: F401
    BaseStep,
    FlowStep,
    QueueStep,
    RootFlowStep,
    RouterStep,
    TaskStep,
)
from .v2_serving import TpuModelServer, V2ModelServer  # noqa: F401
from .v1_serving import MLModelServer  # noqa: F401
