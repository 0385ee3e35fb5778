"""Data-parallel training over ``torch.distributed`` (``cgnn_tpu/
parallel``): one process a card, the JAX package's multi-process
contract (dist.py: the process group, host shards and coordination;
mesh.py: a rank's card; data_parallel.py: the step, the replicated state
and the per-rank batch lists, which train/loop.py ``fit`` runs as its
per-step loop under a live process group). There is no ``compat.py``:
``shard_map`` and ``pcast`` have no PyTorch counterpart. Graph sharding
(``edge_parallel``) and the multi-device forward paths (``executor``)
are not ported yet (ROADMAP Queue 1, items 9b and 9c)."""

from cgnn_tpu_torch.parallel.data_parallel import (
    CoordinatedCheckpoint,
    ParallelTrainStep,
    ReplicaDriftError,
    check_replicated,
    empty_batch_like,
    make_parallel_eval_step,
    make_parallel_train_step,
    parallel_batches,
    replicate_state,
    stack_batches,
    state_digest,
)
from cgnn_tpu_torch.parallel.mesh import device_count, rank_device

__all__ = [
    "CoordinatedCheckpoint",
    "ParallelTrainStep",
    "ReplicaDriftError",
    "check_replicated",
    "device_count",
    "empty_batch_like",
    "make_parallel_eval_step",
    "make_parallel_train_step",
    "parallel_batches",
    "rank_device",
    "replicate_state",
    "stack_batches",
    "state_digest",
]
