# The fault-tolerance runtime of the fleet plane.  The reference package's
# mesh context (``DistContext``, ``make_rules``, ``shard``) and its sharded
# steps belong to the distributed layer, which is not ported yet.
from repro_torch.distributed.fault import (
    Coordinator, ElasticTrainer, FaultEvent, WorkerState,
)

__all__ = ["Coordinator", "ElasticTrainer", "FaultEvent", "WorkerState"]
