"""Multi-process runs over ``torch.distributed`` (``cgnn_tpu/parallel/
dist.py``): one process per card, the JAX package's multi-process
contract.

- **Lifecycle**: ``initialize`` / ``initialize_from_env`` start the
  process group from the environment triple ``CGNN_TPU_COORDINATOR``
  (``host:port`` of rank 0's store) / ``CGNN_TPU_NUM_PROCESSES`` /
  ``CGNN_TPU_PROCESS_ID``, with a timeout that every collective honours,
  so a rank that dies or hangs fails its peers instead of blocking them.
  The backend is the caller's: gloo on the CPU; NCCL on CUDA where every
  rank has its own card; gloo on CUDA where ranks share one
  (``resolve_backend``). Call it before anything touches CUDA.
- **Data**: ``host_shard`` gives each process its strided slice of a
  dataset, disjoint and complete.
- **Coordination** on a gloo group of CPU tensors of its own, so it works
  under NCCL too: ``barrier``, ``broadcast_str`` (process 0 -> every
  process, a fixed 256-slot wire), ``min_over_hosts`` /
  ``max_over_hosts`` (the step-count equalizers), ``all_gather_object``
  and ``broadcast_object`` (small host records: the shape agreement of
  the epoch driver), and ``ReloadCoordinator``, the cross-process
  hot-reload agreement. ``hosts_problem`` names a run that spans hosts
  (the epoch driver and pack-once staging are host-local).
- **The data collective**: ``SumReducer``, an in-place SUM all-reduce of
  one tensor over the process group (or one ``Group`` of it). Gloo with
  a CUDA tensor is staged through a page-locked host copy, chosen by the
  backend.
- **Graph sharding** (``initialize(graph_shards=G)``): the world is D x G
  ranks (parallel/mesh.py ``rank_layout``); each graph group (the G
  ranks that shard one data index's batches) and each data group (the D
  ranks of one graph index) is a ``Group``, made with ``new_group`` in
  the same order on every rank. A ``Group`` carries the collectives the
  sharded model differentiates through (``enter``, ``sum_partials``,
  ``gather_strips``) and plain ones (``all_reduce_``, ``mean_``).
  ``graph_hosts_problem`` names a graph group that spans hosts (the JAX
  package keeps graph meshes on one host).
- **Checkpointing**: ``is_coordinator`` gates saves: process 0 alone
  commits.

The JAX package's global-array helpers (``replicate_global``,
``shard_global``, ``localize``) have no counterpart: a rank holds its
own tensors, and ``parallel.data_parallel.replicate_state`` makes them
equal. Collectives block and must be called by every process in the same
order. Everything degrades to a no-op in a single-process run:
``active()`` is False, ``barrier`` returns at once and ``host_shard``
returns the whole sequence.
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from typing import Callable, Sequence

import torch

from cgnn_tpu_torch.parallel import mesh

_ENV_COORD = "CGNN_TPU_COORDINATOR"
_ENV_NPROC = "CGNN_TPU_NUM_PROCESSES"
_ENV_PID = "CGNN_TPU_PROCESS_ID"

# fixed wire width for broadcast_str (save names are ckpt-%08d, 13
# chars; 256 leaves room for tags and short records without a
# variable-size collective)
_STR_BYTES = 256
# every collective's bound, and the rendezvous's: a rank that does not
# arrive within it fails its peers' call
DEFAULT_TIMEOUT_S = 120.0


class Group:
    """Some of the run's ranks as one collective group: ``ranks`` (world
    ranks, in order), ``size``, this rank's ``index`` among them, the
    torch process group ``pg`` (None for a group of one) and the
    run's ``backend``. Gloo with a CUDA tensor is staged through a
    page-locked host copy; a low-precision tensor is summed in f32 and
    rounded back. A group of one reduces nothing.

    The autograd collectives of graph sharding (models/cgcnn.py), each
    the transpose of the other's role (JAX's ``pcast`` / ``psum``):

    - ``enter(x)``: a replicated tensor entering the sharded region;
      identity forward, SUM all-reduce of the cotangent backward (each
      rank's cotangent is the part from its own shard);
    - ``sum_partials(x)``: per-rank partial sums made whole; SUM
      all-reduce forward, identity backward (replicated code consumes
      the sum, so its cotangent is already whole on every rank);
    - ``gather_strips(x)``: the ranks' [n, ...] strips concatenated in
      rank order; all-gather forward, backward "take my strip".

    Every collective blocks and must be called by every rank of the
    group in the same order."""

    def __init__(self, ranks, pg, backend: str, rank: int):
        self.ranks = tuple(ranks)
        self.size = len(self.ranks)
        self.index = self.ranks.index(rank)
        self.pg = pg
        self.backend = backend

    def staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and self.backend == "gloo"

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """SUM of ``t`` over the group, in place (``t`` contiguous)."""
        if self.size == 1:
            return t
        import torch.distributed as tdist

        buf = t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
        if self.staged(buf):
            host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
            host.copy_(buf)
            tdist.all_reduce(host, group=self.pg)
            buf.copy_(host, non_blocking=True)
        else:
            tdist.all_reduce(buf, group=self.pg)
        if buf is not t:
            t.copy_(buf)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """The group's mean of ``t``, in place (no gradient)."""
        if self.size > 1:
            self.all_reduce_(t).div_(self.size)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' ``t`` concatenated on dim 0, in rank order."""
        if self.size == 1:
            return t
        import torch.distributed as tdist

        staged = self.staged(t)
        src = t.contiguous()
        if staged:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(src)
            src = host
        if src.dtype in (torch.bfloat16, torch.float16):
            src = src.view(torch.uint8)  # bits as bytes: gloo has no bf16
        parts = [torch.empty_like(src) for _ in range(self.size)]
        tdist.all_gather(parts, src, group=self.pg)
        out = torch.cat(parts).view(t.dtype)
        return out.to(t.device, non_blocking=True) if staged else out

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self) if self.size > 1 else x

    def sum_partials(self, x: torch.Tensor) -> torch.Tensor:
        return _SumPartials.apply(x, self) if self.size > 1 else x

    def gather_strips(self, x: torch.Tensor) -> torch.Tensor:
        return _GatherStrips.apply(x, self) if self.size > 1 else x


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.contiguous().clone()), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce_(x.contiguous().clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherStrips(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = x.shape[0]
        ctx.index = group.index
        return group.all_gather(x)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None


class _Run:
    """The live process group of this process (``initialize``): the
    world, its host (gloo) group, and the graph and data groups of a
    graph-sharded run (``graph`` None without sharding; ``data`` the
    world then)."""

    def __init__(self, backend: str, rank: int, world: int, host_group,
                 graph_shards: int = 1, groups: tuple = (None, None)):
        self.backend = backend
        self.rank = rank
        self.world = world
        self.host_group = host_group
        self.graph_shards = graph_shards
        self.world_group = Group(range(world), None, backend, rank)
        self.graph, data = groups
        self.data = data or self.world_group


_run: _Run | None = None


def configured_env() -> dict | None:
    """The multi-process env config, or None when unset."""
    coord = os.environ.get(_ENV_COORD, "")
    if not coord:
        return None
    try:
        nproc = int(os.environ[_ENV_NPROC])
        pid = int(os.environ[_ENV_PID])
    except (KeyError, ValueError):
        raise ValueError(
            f"{_ENV_COORD} is set but {_ENV_NPROC}/{_ENV_PID} are not "
            f"both integers — all three configure a multi-process run"
        ) from None
    return {"coordinator": coord, "num_processes": nproc, "process_id": pid}


def env_for(coordinator: str, num_processes: int, process_id: int) -> dict:
    """The environment triple of one process of a run."""
    return {_ENV_COORD: coordinator, _ENV_NPROC: str(num_processes),
            _ENV_PID: str(process_id)}


def resolve_backend(requested: str, device_type: str, world: int,
                    cards: int) -> tuple[str | None, str]:
    """-> (backend, '') or (None, why the request cannot run).
    ``requested`` 'auto' is gloo on the CPU and NCCL on CUDA; 'gloo' is
    gloo everywhere. NCCL needs a card for every rank (it refuses two
    ranks on one device): ranks that share a card take gloo only when
    the caller asks for it."""
    if device_type != "cuda" or requested == "gloo":
        return "gloo", ""
    if world > cards:
        return None, (
            f"{world} ranks but {cards} visible CUDA card(s): NCCL needs a "
            f"card for every rank; pass --dist-backend gloo for ranks that "
            f"share a card")
    return "nccl", ""


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               backend: str = "gloo", timeout_s: float = DEFAULT_TIMEOUT_S,
               log_fn: Callable = print, graph_shards: int = 1) -> None:
    """Join the process group of ``num_processes`` ranks whose store rank
    0 serves at ``coordinator`` (``host:port``); with ``graph_shards`` G >
    1 also make the graph and data groups of a D x G layout (module
    docstring). Idempotent per process."""
    global _run
    if _run is not None:
        return
    import torch.distributed as tdist

    if num_processes < 2:
        raise ValueError(f"num_processes must be >= 2, got {num_processes}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    if graph_shards < 1 or num_processes % graph_shards:
        raise ValueError(f"{num_processes} processes do not split into "
                         f"graph groups of {graph_shards}")
    timeout = datetime.timedelta(seconds=timeout_s)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    tdist.init_process_group(backend, init_method=init,
                             world_size=num_processes, rank=process_id,
                             timeout=timeout)
    host = (tdist.group.WORLD if backend == "gloo"
            else tdist.new_group(backend="gloo", timeout=timeout))
    groups = (None, None)
    if graph_shards > 1:
        groups = _make_groups(process_id, num_processes, graph_shards,
                              backend, timeout)
    _run = _Run(backend, process_id, num_processes, host, graph_shards,
                groups)
    layout = (f"; data x{num_processes // graph_shards} * graph "
              f"x{graph_shards}" if graph_shards > 1 else "")
    log_fn(f"dist: process {process_id}/{num_processes} up ({backend}; "
           f"coordinator {coordinator}; timeout {timeout_s:g} s{layout})")


def _make_groups(rank: int, world: int, graph_shards: int, backend: str,
                 timeout) -> tuple:
    """(this rank's graph Group, its data Group): every group made on
    every rank, in one order (``new_group`` is a collective); a group
    that spans the world is the world's own."""
    import torch.distributed as tdist

    n_data = world // graph_shards

    def make(ranks):
        if len(ranks) == world:
            return tdist.group.WORLD
        if len(ranks) == 1:
            return None
        return tdist.new_group(ranks, timeout=timeout)

    graph = data = None
    for d in range(n_data):
        ranks = mesh.graph_group_ranks(d, graph_shards)
        pg = make(ranks)
        if rank in ranks:
            graph = Group(ranks, pg, backend, rank)
    for g in range(graph_shards):
        ranks = mesh.data_group_ranks(g, world, graph_shards)
        pg = make(ranks)
        if rank in ranks:
            data = Group(ranks, pg, backend, rank)
    return graph, data


def initialize_from_env(*, backend: str = "gloo",
                        timeout_s: float = DEFAULT_TIMEOUT_S,
                        log_fn: Callable = print,
                        graph_shards: int = 1) -> bool:
    """Initialize iff the CGNN_TPU_* env triple is set -> did it."""
    cfg = configured_env()
    if cfg is None:
        return False
    initialize(cfg["coordinator"], cfg["num_processes"], cfg["process_id"],
               backend=backend, timeout_s=timeout_s, log_fn=log_fn,
               graph_shards=graph_shards)
    return True


def shutdown() -> None:
    """Leave the process group (a no-op when none is live)."""
    global _run
    if _run is None:
        return
    import torch.distributed as tdist

    _run = None
    tdist.destroy_process_group()


def active() -> bool:
    """True in a live multi-process run."""
    return _run is not None


def backend() -> str | None:
    return _run.backend if _run is not None else None


def process_index() -> int:
    return _run.rank if _run is not None else 0


def process_count() -> int:
    return _run.world if _run is not None else 1


def graph_shards() -> int:
    """G of a graph-sharded run, else 1."""
    return _run.graph_shards if _run is not None else 1


def graph_group() -> Group | None:
    """This rank's graph group (None without graph sharding)."""
    return _run.graph if _run is not None else None


def data_group() -> Group | None:
    """This rank's data group: the ranks a data-parallel step averages
    over (the world without graph sharding; None single-process)."""
    return _run.data if _run is not None else None


def data_index() -> int:
    """This rank's data index: what its host shard, its shuffle and its
    dropout follow (its rank without graph sharding)."""
    return mesh.rank_layout(process_index(), graph_shards())[0]


def data_count() -> int:
    """D: the data indices of the run."""
    return process_count() // graph_shards()


def graph_hosts_problem() -> str:
    """'' when every graph group lies on one host, else which does not
    (a collective over the world: every rank gets the same answer)."""
    if _run is None or _run.graph is None:
        return ""
    hosts = all_gather_object(socket.gethostname())
    for d in range(data_count()):
        ranks = mesh.graph_group_ranks(d, _run.graph_shards)
        names = sorted({hosts[r] for r in ranks})
        if len(names) > 1:
            return (f"graph group {d} (ranks {ranks[0]}-{ranks[-1]}) spans "
                    f"hosts {names}: graph shards exchange activations in "
                    f"every conv, so a graph group must lie on one host")
    return ""


def hosts_problem() -> str:
    """'' when every rank of the run lies on one host, else which hosts
    it spans (a collective over the world: every rank gets the same
    answer). The epoch driver, pack-once and device-resident staging are
    host-local: the JAX package refuses them across hosts."""
    if _run is None:
        return ""
    names = sorted(set(all_gather_object(socket.gethostname())))
    if len(names) > 1:
        return (f"the ranks span hosts {names}: multi-host DP runs the "
                f"per-step loop; drop --scan-epochs/--device-resident/"
                f"--pack-once")
    return ""


def is_coordinator() -> bool:
    """Process 0: the ONE checkpoint committer of a multi-process run."""
    return process_index() == 0


def host_shard(seq: Sequence, index: int | None = None,
               count: int | None = None) -> list:
    """This process's strided slice of ``seq`` (``seq[i::n]``): shard
    sizes differ by at most one, and the union over all processes is
    exactly ``seq``. A full copy in single-process runs."""
    i = process_index() if index is None else index
    n = process_count() if count is None else count
    if i < 0 or i >= n:
        raise ValueError(f"host_shard index {i} outside [0, {n})")
    return list(seq[i::n])


# ---- host coordination (gloo, CPU tensors) ----------------------------


def barrier(name: str) -> None:
    """Block until every process reaches this point (a no-op when
    single-process). A process that does not arrive within the timeout
    fails the others' call, which names ``name``."""
    if _run is None:
        return
    import torch.distributed as tdist

    try:
        tdist.monitored_barrier(group=_run.host_group)
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def broadcast_str(value: str) -> str:
    """Process 0's ``value`` on every process (a fixed 256-slot wire, one
    int32 a byte, as the JAX package's; longer values are cut)."""
    if _run is None:
        return value
    import torch.distributed as tdist

    raw = value.encode()[:_STR_BYTES]
    buf = torch.zeros(_STR_BYTES, dtype=torch.int32)
    buf[: len(raw)] = torch.tensor(list(raw), dtype=torch.int32)
    tdist.broadcast(buf, src=0, group=_run.host_group)
    out = buf[buf != 0].to(torch.uint8).numpy().tobytes()
    return out.decode(errors="replace")


def all_gather_object(obj) -> list:
    """Every process's ``obj`` (picklable), in process order (``[obj]``
    in a single-process run)."""
    if _run is None:
        return [obj]
    import torch.distributed as tdist

    out = [None] * _run.world
    tdist.all_gather_object(out, obj, group=_run.host_group)
    return out


def broadcast_object(obj, src: int = 0):
    """Process ``src``'s ``obj`` (picklable) on every process."""
    if _run is None:
        return obj
    import torch.distributed as tdist

    box = [obj if _run.rank == src else None]
    tdist.broadcast_object_list(box, src=src, group=_run.host_group)
    return box[0]


def _reduce_int(value: int, op) -> int:
    import torch.distributed as tdist

    t = torch.tensor([int(value)], dtype=torch.int64)
    tdist.all_reduce(t, op=op, group=_run.host_group)
    return int(t[0])


def min_over_hosts(value: int) -> int:
    """min(value) across processes: every process must run the SAME
    number of collective steps an epoch, so a training epoch is cut to
    the shortest process's batch count."""
    if _run is None:
        return int(value)
    import torch.distributed as tdist

    return _reduce_int(value, tdist.ReduceOp.MIN)


def max_over_hosts(value: int) -> int:
    """max(value) across processes: the eval step count, which the
    processes with fewer batches pad up to."""
    if _run is None:
        return int(value)
    import torch.distributed as tdist

    return _reduce_int(value, tdist.ReduceOp.MAX)


# ---- the data collective ----------------------------------------------


class SumReducer:
    """In-place SUM all-reduce of one tensor over the process group, or
    over ``group`` (a ``Group``; its ``data_group()``'s ranks for a
    data-parallel step) -> ``reducer(t)``; a no-op in a single-process
    run and over a group of one. NCCL reduces a CUDA tensor where it
    lies; gloo reduces CPU tensors, so a CUDA tensor is copied to a
    page-locked host buffer (the copy waits for the stream's earlier
    work), reduced there and copied back on the stream."""

    def __init__(self, group: Group | None = None):
        self._host: torch.Tensor | None = None
        self._group = group

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if _run is None:
            return t
        import torch.distributed as tdist

        group = self._group or _run.world_group
        if group.size == 1:
            return t
        if not group.staged(t):
            tdist.all_reduce(t, group=group.pg)
            return t
        host = self._host
        if host is None or host.shape != t.shape or host.dtype != t.dtype:
            host = self._host = torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True)
        host.copy_(t)
        tdist.all_reduce(host, group=group.pg)
        t.copy_(host, non_blocking=True)
        return t


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """Rank ``src``'s values of ``tensors`` into every rank's, in place:
    one broadcast a (device, dtype) group, through a flat copy (gloo
    with a CUDA tensor staged on the host, as ``SumReducer``)."""
    if _run is None:
        return
    import torch.distributed as tdist

    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for (device, _), ts in groups.items():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        wire = (flat.cpu() if device.type == "cuda"
                and _run.backend == "gloo" else flat)
        tdist.broadcast(wire, src=src)
        if wire is not flat:
            flat.copy_(wire)
        with torch.no_grad():
            for t, v in zip(ts, flat.split([t.numel() for t in ts])):
                t.copy_(v.view(t.shape))


# ---- cross-process hot reload -----------------------------------------


class ReloadCoordinator:
    """Cross-process agreement on which committed save to hot-swap to
    (``cgnn_tpu/parallel/dist.py``). Every ``poll`` on every process calls
    this with the newest committed save it sees locally (or None).
    Process 0's view wins: it broadcasts the candidate name; the others
    WAIT (bounded) until their own filesystem view shows that save's
    commit marker, and everyone swaps only after one shared barrier.
    Returns the agreed name, or None for "no swap this round", which is
    itself an agreement. Each call is a collective: every process must
    poll in lockstep."""

    def __init__(self, manager, *, visibility_timeout_s: float = 30.0,
                 log_fn: Callable = print):
        self._mgr = manager
        self._timeout = visibility_timeout_s
        self._log = log_fn
        self._round = 0

    def __call__(self, newest: str | None) -> str | None:
        self._round += 1
        if not active():
            return newest
        agreed = broadcast_str((newest or "") if is_coordinator() else "")
        if not agreed:
            barrier(f"cgnn-reload-idle-{self._round}")
            return None
        deadline = time.monotonic() + self._timeout
        while not self._mgr.is_committed(agreed):
            # process 0 saw the manifest; this process's view may lag
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"process {process_index()} never saw the commit "
                    f"marker of {agreed} within {self._timeout}s — "
                    f"shared checkpoint directory out of sync")
            time.sleep(0.05)
        barrier(f"cgnn-reload-{agreed}-{self._round}")
        return agreed
