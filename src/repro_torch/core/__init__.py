# The paper's primary contribution: context-aware execution migration --
# generalized to an N-environment placement fabric.
from repro_torch.core.analyzer import (
    BlockPolicy, CostMatrixPolicy, Decision, HorizonPolicy, KnowledgePolicy,
    MigrationAnalyzer, PerfModel, PlacementPolicy, SingleCellPolicy,
    fit_linear, intersection, substitute_kwarg,
)
from repro_torch.core.chunkstore import (
    CHUNK_BYTES, DiskChunkStore, MemoryChunkStore, array_chunk_digests,
    digest_bytes, split_chunks,
)
from repro_torch.core.context import (
    ContextDetector, get_sequences, sequence_stats,
)
from repro_torch.core.events import Event, EventLoop
from repro_torch.core.fabric import (
    LIFECYCLE, EnvironmentRegistry, ExecutionEnvironment, Link,
)
from repro_torch.core.gateway import (
    GatewayReport, GatewayService, GatewayTenant, WarmPool, WireFrontend,
    poisson_attach_storm,
)
from repro_torch.core.interaction import (
    MODELS, ConfidenceGate, EnsembleModel, FrequencyModel, InteractionModel,
    MarkovModel, RecencyModel, make_model,
)
from repro_torch.core.kb import KnowledgeBase, ParamEstimate, ProvRecord
from repro_torch.core.migration import (
    EnvFailure, HybridRuntime, MigrationEngine, MigrationResult,
    PipelinedMigrationEngine,
)
from repro_torch.core.notebook import Cell, Notebook
from repro_torch.core.reducer import (
    SerializationFailure, SerializedState, StateReducer,
)
from repro_torch.core.replica import RaceTicket, SessionReplicaSet
from repro_torch.core.scheduler import (
    AutoscalePolicy, CapacityArbiter, ScheduleReport, SessionCheckpointer,
    SessionReport, SessionScheduler, WorkloadTrace, gpu_training_notebook,
    remote_sensing_notebook,
)
from repro_torch.core.simclock import SimClock, WallClock
from repro_torch.core.simulator import (
    TRACES, Trace, cell_frequency, policy_grid, simulate,
    synthetic_loops_trace, tf_guide_trace,
)
from repro_torch.core.state import ExecutionState
from repro_torch.core.transport import (
    TRANSPORTS, DigestMirrorStore, LoopbackTransport, MigrationPeer,
    MuxEnvServer, MuxPeer, MuxStream, SocketTransport, SubprocessEnv,
    TokenBucket, Transport, WireReceiver, attach_peer,
)
from repro_torch.core.wire import Frame, FrameDecoder, WireError

__all__ = [
    "BlockPolicy", "CostMatrixPolicy", "Decision", "HorizonPolicy",
    "KnowledgePolicy",
    "MigrationAnalyzer", "PerfModel", "PlacementPolicy", "SingleCellPolicy",
    "fit_linear", "intersection", "substitute_kwarg", "CHUNK_BYTES",
    "DiskChunkStore", "MemoryChunkStore", "array_chunk_digests",
    "digest_bytes", "split_chunks", "ContextDetector",
    "get_sequences", "sequence_stats", "Event", "EventLoop", "LIFECYCLE",
    "EnvironmentRegistry", "ExecutionEnvironment", "Link",
    "MODELS", "ConfidenceGate", "EnsembleModel", "FrequencyModel",
    "InteractionModel", "MarkovModel", "RecencyModel", "make_model",
    "KnowledgeBase", "ParamEstimate",
    "ProvRecord", "EnvFailure", "HybridRuntime", "MigrationEngine",
    "MigrationResult",
    "PipelinedMigrationEngine", "Cell", "Notebook", "SerializationFailure",
    "SerializedState", "StateReducer", "AutoscalePolicy", "CapacityArbiter",
    "ScheduleReport", "SessionCheckpointer",
    "SessionReport", "SessionScheduler", "WorkloadTrace",
    "gpu_training_notebook", "remote_sensing_notebook", "SimClock",
    "WallClock", "Trace",
    "TRACES", "cell_frequency", "policy_grid", "simulate",
    "synthetic_loops_trace", "tf_guide_trace", "ExecutionState",
    "TRANSPORTS", "DigestMirrorStore", "LoopbackTransport", "MigrationPeer",
    "MuxEnvServer", "MuxPeer", "MuxStream",
    "SocketTransport", "SubprocessEnv", "TokenBucket", "Transport",
    "WireReceiver", "attach_peer", "Frame", "FrameDecoder", "WireError",
    "GatewayReport", "GatewayService", "GatewayTenant", "WarmPool",
    "WireFrontend", "poisson_attach_storm", "RaceTicket", "SessionReplicaSet",
]
