"""Data-parallel and graph-sharded training over ``torch.distributed``
(``cgnn_tpu/parallel``): one process a card, the JAX package's
multi-process contract (dist.py: the process group, its graph and data
groups, host shards, coordination and the autograd collectives; mesh.py:
a rank's card and its place in a D x G layout; data_parallel.py: the
step, the replicated state and the per-rank batch lists; edge_parallel.py:
a rank's strip or chunk of every batch's edge leaves), which
train/loop.py ``fit`` runs under a live process group, in its per-step
loop and in its epoch driver (``agree_batches``: the same shape groups on
every rank). There is no ``compat.py``: ``shard_map`` and ``pcast`` have
no PyTorch counterpart (``dist.Group``'s collectives take their place).
executor.py is the mesh engine of the forward paths (``MeshExecutor``:
bulk predict and serving over a device set, one process)."""

from cgnn_tpu_torch.parallel.data_parallel import (
    CoordinatedCheckpoint,
    ParallelTrainStep,
    ReplicaDriftError,
    ScheduleDivergedError,
    agree_batches,
    agree_lists,
    check_replicated,
    empty_batch_like,
    make_parallel_eval_step,
    make_parallel_train_step,
    parallel_batches,
    replicate_state,
    stack_batches,
    state_digest,
)
from cgnn_tpu_torch.parallel.dist import Group
from cgnn_tpu_torch.parallel.executor import MeshExecutor
from cgnn_tpu_torch.parallel.edge_parallel import (
    EDGE_FIELDS,
    chunk_transpose,
    edge_nbytes,
    pad_edges_divisible,
    prepare_dense_sharded,
    rank_view,
)
from cgnn_tpu_torch.parallel.mesh import (
    data_group_ranks,
    device_count,
    graph_group_ranks,
    rank_device,
    rank_layout,
)

__all__ = [
    "EDGE_FIELDS",
    "CoordinatedCheckpoint",
    "Group",
    "MeshExecutor",
    "ParallelTrainStep",
    "ReplicaDriftError",
    "ScheduleDivergedError",
    "agree_batches",
    "agree_lists",
    "check_replicated",
    "chunk_transpose",
    "data_group_ranks",
    "device_count",
    "edge_nbytes",
    "empty_batch_like",
    "graph_group_ranks",
    "make_parallel_eval_step",
    "make_parallel_train_step",
    "pad_edges_divisible",
    "parallel_batches",
    "prepare_dense_sharded",
    "rank_device",
    "rank_layout",
    "rank_view",
    "replicate_state",
    "stack_batches",
    "state_digest",
]
