# The distributed layer: the mesh context and its rules, the placement
# trees, the data-parallel train step and the serve steps (DistContext,
# make_rules, shard, the sharding trees, build_train_step with FSDP and
# ZeRO-1, build_prefill_step, build_decode_step, cache_specs and
# sp_decode_attention; fsdp.py, the steps' per-unit gather;
# tensor_parallel.py, the tp steps' operators over 'model'), and the
# fault-tolerance runtime of the fleet plane.  context is imported first:
# the model modules import it while this package may still be loading.
from repro_torch.distributed.context import (
    DistContext, gather_rows, make_rules, shard,
)
from repro_torch.distributed.decode_attn import sp_decode_attention
from repro_torch.distributed.fault import (
    Coordinator, ElasticTrainer, FaultEvent, WorkerState,
)
from repro_torch.distributed.sharding import (
    batch_pspec, batch_shardings, cache_shardings, fsdp_sharding,
    opt_shardings, params_shardings, zero1_sharding,
)
from repro_torch.distributed.steps import (
    TensorSpec, build_decode_step, build_prefill_step, build_train_step,
    cache_specs, distribute_tree, gather_tree, init_sharded_opt_state,
    input_specs,
)

__all__ = [
    "Coordinator", "DistContext", "ElasticTrainer", "FaultEvent",
    "TensorSpec", "WorkerState", "batch_pspec", "batch_shardings",
    "build_decode_step", "build_prefill_step", "build_train_step",
    "cache_shardings", "cache_specs", "distribute_tree", "fsdp_sharding",
    "gather_rows", "gather_tree", "init_sharded_opt_state", "input_specs",
    "make_rules", "opt_shardings", "params_shardings", "shard",
    "sp_decode_attention", "zero1_sharding",
]
