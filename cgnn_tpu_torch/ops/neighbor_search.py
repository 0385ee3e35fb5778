"""Periodic neighbor search and featurization on the device, for the raw
wire (``cgnn_tpu/ops/neighbor_search.py``).

Given a staged :class:`RawBatch` (positions, lattice, species;
data/rawbatch.py), build the dense-layout ``GraphBatch`` the model reads on
the device: the host ``knn_neighbor_list`` + atom table + Gaussian
expansion chain, under the padded-capacity discipline.

- Per structure, every (atom j, periodic image k) pair is a candidate of
  center i, candidate index c = j*K + k over the rung's fixed image grid
  (``RawSpec.images``, lexicographic order). The first ``dense_m`` valid
  candidates in (distance, c) order are the edges: the host featurizer's
  ``max_num_nbr`` truncation in its canonical order.
- Invalid candidates and empty slots are selected away, never multiplied:
  an empty slot is a self-loop with zero distance and mask.

The search has three pieces, the pattern of ops/fused_epilogue.py:

- ``neighbor_search_cuda``, the wrapper of kernel 8 (``csrc/
  neighbor_search.cu``): CUDA tensors only, launches on the current
  stream, raises on a refused launch, counts ``.launches``;
- ``neighbor_search_reference``, its plain PyTorch version: the candidate
  distances [G, S, S*K] in the kernel's order of f32 operations (no
  matmul, so no other summation order), the validity mask, the radius
  test, and a stable sort on the distance key, which over candidates in
  index order is the lexicographic (d, c) order (``torch.topk`` orders
  ties arbitrarily and is not used);
- ``neighbor_search``, the dispatcher: with the default
  ``impl='pallas'`` the device decides, a CUDA tensor launching the kernel
  (or raising) and a CPU tensor running the plain version;
  ``impl='xla'`` asks for the plain version by name.

The cap-overflow flag stays a torch expression outside the kernel, as in
the JAX package: each structure's needed image counts are re-derived from
its staged lattice (``needed_images``, the f32 formula of
``data.rawbatch.needed_images_f32``) and a structure needing more than the
caps is flagged. Padding slots never flag.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from cgnn_tpu_torch.data.elements import full_embedding_table
from cgnn_tpu_torch.data.graph import GraphBatch
from cgnn_tpu_torch.data.rawbatch import RawBatch, RawSpec
from cgnn_tpu_torch.device import resolve_device
from cgnn_tpu_torch.ops import _build
from cgnn_tpu_torch.ops.fused_epilogue import check_impl, runs_kernel

MAX_M = 32  # the kernel keeps at most 32 neighbors a center
SMEM_LIMIT = 48 * 1024  # the kernel's shared memory, without opt-in
# the plain version works on chunks of structures of at most this many
# candidates, which bounds its [g, S, S, K, 3] intermediates (~0.1 GB)
REFERENCE_CHUNK = 1 << 23


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root of an f32 tensor, on every
    device: the root taken in f64, then rounded to f32 (f64 carries enough
    bits for that double rounding to be exact). ``torch.sqrt`` of a
    contiguous f32 CPU tensor goes through a vector library that is off
    by an ulp on some inputs; kernel 8 and the JAX package take sqrt_rn."""
    return torch.sqrt(x.double()).float()


def needed_images(lats: torch.Tensor, radius: float) -> torch.Tensor:
    """[G, 3] f32 needed-image counts from [G, 3, 3] f32 lattices: the
    order of operations of ``data.rawbatch.needed_images_f32``."""
    a0, a1, a2 = lats[:, 0], lats[:, 1], lats[:, 2]

    def cross(u, v):
        return torch.stack([u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                            u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                            u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0]], dim=1)

    c0 = cross(a1, a2)
    cr = torch.stack([c0, cross(a2, a0), cross(a0, a1)], dim=1)  # [G, 3, 3]
    det = torch.abs(a0[:, 0] * c0[:, 0] + a0[:, 1] * c0[:, 1]
                    + a0[:, 2] * c0[:, 2])
    sq = cr * cr
    norms = sqrt_rn(sq[..., 0] + sq[..., 1] + sq[..., 2])
    r = float(np.float32(radius))
    return torch.ceil(r * norms / det[:, None] - float(np.float32(1e-4)))


@functools.lru_cache(maxsize=64)
def radius_threshold(radius: float) -> float:
    """T, the largest f32 whose correctly rounded square root is <= the f32
    radius r. sqrt_rn is monotone, so for every f32 d2 ``d2 <= T`` holds
    exactly when ``sqrt_rn(d2) <= r`` (NaN and inf fail both): kernel 8
    cuts on d2 and takes the root only of what passes. Raises ValueError
    unless 0 <= r < inf in f32 (the search below would not end)."""
    with np.errstate(over="ignore"):  # r or r*r may be inf in f32
        r = np.float32(radius)
        if not 0 <= r < np.inf:
            raise ValueError(f"radius {radius} outside [0, inf) in f32")
        t = r * r  # inf comes down to the largest f32 below
        while not np.sqrt(t) <= r:
            t = np.nextafter(t, np.float32(-np.inf))
        while np.sqrt(np.nextafter(t, np.float32(np.inf))) <= r:
            t = np.nextafter(t, np.float32(np.inf))
    return float(t)


_CAPS: dict = {}


def caps_tensor(spec: RawSpec, device) -> torch.Tensor:
    """[3] f32 image caps on ``device``, made once per caps and device
    (a host-to-device copy: never inside a captured step)."""
    device = torch.device(device)
    key = (tuple(int(c) for c in spec.images), str(device))
    caps = _CAPS.get(key)
    if caps is None:
        caps = _CAPS[key] = torch.tensor(key[0], dtype=torch.float32,
                                         device=device)
    return caps


def cap_overflow(lats, amask, spec: RawSpec,
                 caps: torch.Tensor | None = None) -> torch.Tensor:
    """[G] bool: the structure needs more periodic images than the caps
    (padding slots, with no real atom, never flag). ``caps``: the spec's
    ``caps_tensor`` on lats' device (built here when not given: a
    host-to-device copy)."""
    if caps is None:
        caps = caps_tensor(spec, lats.device)
    return ((needed_images(lats, spec.radius) > caps).any(dim=1)
            & (amask > 0).any(dim=1))


def offsets_tensor(spec: RawSpec, device) -> torch.Tensor:
    """[K, 3] f32 image offsets (lexicographic) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        spec.offsets_grid(), np.float32)).to(device)


# ---------------------------------------------------------------------------
# the plain version
# ---------------------------------------------------------------------------


def _rows_times_lattice(x, lats):
    """[g, P, 3] coefficients times [g, 3, 3] row-vector lattices:
    (x0*L0 + x1*L1) + x2*L2, one rounding per product and sum."""
    return (x[..., 0:1] * lats[:, None, 0, :]
            + x[..., 1:2] * lats[:, None, 1, :]
            + x[..., 2:3] * lats[:, None, 2, :])


def _search_chunk(frac, lats, amask, offsets, radius, home, m):
    g, s, _ = frac.shape
    k = offsets.shape[0]
    cart = _rows_times_lattice(frac, lats)  # [g, S, 3]
    shifts = _rows_times_lattice(offsets.expand(g, k, 3), lats)  # [g, K, 3]
    pos = cart[:, :, None, :] + shifts[:, None, :, :]  # [g, S(j), K, 3]
    diff = pos[:, None] - cart[:, :, None, None, :]  # [g, S(i), S(j), K, 3]
    d2 = (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
          + diff[..., 2] * diff[..., 2])
    d = sqrt_rn(d2).reshape(g, s, s * k)  # candidate c = j*K + k
    live = amask > 0
    dev = frac.device
    valid = live[:, :, None, None] & live[:, None, :, None]  # [g, S, S, 1]
    self_home = (torch.eye(s, dtype=torch.bool, device=dev)[:, :, None]
                 & (torch.arange(k, device=dev) == home)[None, None, :])
    valid = (valid & ~self_home).reshape(g, s, s * k)
    valid &= d <= float(np.float32(radius))
    key = torch.where(valid, d, torch.full_like(d, float("inf")))
    sk, order = torch.sort(key, dim=-1, stable=True)
    sk, order = sk[..., :m], order[..., :m]
    n_valid = valid.sum(dim=-1)
    em = torch.arange(m, device=dev) < n_valid[..., None]
    own = torch.arange(s, dtype=torch.int32, device=dev)[None, :, None]
    nbr = torch.where(em, (order // k).to(torch.int32), own)
    dist = torch.where(em, sk, torch.zeros_like(sk))
    ne = torch.clamp_max(n_valid, m).sum(dim=-1).to(torch.int32)
    return nbr, dist, em.to(torch.float32), ne


def neighbor_search_reference(frac, lats, amask, offsets, radius: float,
                              home: int, m: int):
    """Kernel 8's plain version -> (neighbors [G, S, M] i32 local,
    distances [G, S, M] f32, edge_mask [G, S, M] f32, n_edges [G] i32);
    chunked over structures to bound its memory."""
    g, s, _ = frac.shape
    k = offsets.shape[0]
    step = max(1, REFERENCE_CHUNK // max(1, s * s * k))
    parts = [_search_chunk(frac[a:a + step], lats[a:a + step],
                           amask[a:a + step], offsets, radius, home, m)
             for a in range(0, g, step)]
    return tuple(torch.cat(p) for p in zip(*parts))


# ---------------------------------------------------------------------------
# the Hopper kernel
# ---------------------------------------------------------------------------


_INPUTS = (("frac", torch.float32), ("lats", torch.float32),
           ("amask", torch.uint8), ("offsets", torch.float32))


def smem_bytes(s: int, k: int, m: int) -> int:
    """Shared memory of one block (one center, 4 warps): the warps' key
    queues (64 keys each), the 128 lane lists of M keys, positions, shifts
    and the real atoms' slots."""
    return (4 * 64 + 128 * m) * 8 + (4 * s + 3 * k) * 4


def neighbor_search_cuda(frac, lats, amask, offsets, radius: float,
                         home: int, m: int):
    """Kernel 8 (replaces neighbor_search.py ``_search_kernel``): frac [G,
    S, 3] f32, lats [G, 3, 3] f32, amask [G, S] u8, offsets [K, 3] f32, on
    one CUDA device -> the outputs of ``neighbor_search_reference``
    (``ne`` is zeroed on the stream by the kernel's entry, not by a fill
    launch). Devices are compared by index and a message is formatted
    only for a fault."""
    dev = frac.device
    if dev.type != "cuda":
        raise ValueError(f"neighbor_search_cuda takes CUDA tensors, got {dev}")
    if frac.dim() != 3 or frac.shape[-1] != 3:
        raise ValueError(f"frac must be [G, S, 3], got {tuple(frac.shape)}")
    g, s, _ = frac.shape
    k = offsets.shape[0] if offsets.dim() == 2 else -1
    index = frac.get_device()
    for (name, dtype), t, shape in zip(
            _INPUTS, (frac, lats, amask, offsets),
            ((g, s, 3), (g, 3, 3), (g, s), (k, 3))):
        if t.get_device() != index:
            raise ValueError(f"{name} is on {t.device}, frac on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.shape != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{list(t.shape)}")
    if not 1 <= m <= MAX_M:
        raise ValueError(f"max_num_nbr {m} outside the kernel's [1, {MAX_M}]")
    if not 0 <= home < k:
        raise ValueError(f"home image {home} outside [0, {k})")
    if smem_bytes(s, k, m) > SMEM_LIMIT or s * k >= 2**31:
        raise ValueError(
            f"S={s}, K={k}, M={m} need {smem_bytes(s, k, m)} B of shared "
            f"memory and {s * k} candidate indices; the kernel takes "
            f"{SMEM_LIMIT} B and fewer than 2^31")
    # four allocations; views of one buffer were tried and the host time
    # a call did not separate the two (its spread in one tree is 2x)
    nbr = torch.empty((g, s, m), dtype=torch.int32, device=dev)
    dist = torch.empty((g, s, m), dtype=torch.float32, device=dev)
    em = torch.empty((g, s, m), dtype=torch.float32, device=dev)
    ne = torch.empty(g, dtype=torch.int32, device=dev)
    if g * s == 0:
        return nbr, dist, em, ne.zero_()
    _build.launch(
        "neighbor_search",
        _build.entry("neighbor_search", "neighbor_search_f32", 8, 5, 1),
        (frac.data_ptr(), lats.data_ptr(), amask.data_ptr(),
         offsets.data_ptr(), nbr.data_ptr(), dist.data_ptr(), em.data_ptr(),
         ne.data_ptr()),
        {"G": g, "S": s, "K": k, "M": m, "home": home,
         "T": radius_threshold(radius)},
        dev)
    neighbor_search_cuda.launches += _build.counted(1)
    return nbr, dist, em, ne


neighbor_search_cuda.launches = 0


# ---------------------------------------------------------------------------
# dispatch, the expander, the cost model
# ---------------------------------------------------------------------------


def neighbor_search(frac, lats, amask, spec: RawSpec, impl: str = "pallas",
                    offsets: torch.Tensor | None = None,
                    caps: torch.Tensor | None = None):
    """Batched search -> (neighbors [G, S, M] i32 local, distances [G, S,
    M] f32, edge_mask [G, S, M] f32, n_edges [G] i32, overflow [G] bool).
    ``offsets`` and ``caps``: the spec's ``offsets_tensor`` and
    ``caps_tensor`` on frac's device (built here when not given)."""
    check_impl(impl)
    if offsets is None:
        offsets = offsets_tensor(spec, frac.device)
    args = (frac, lats, amask, offsets, spec.radius, spec.home_image,
            spec.dense_m)
    if runs_kernel(impl, frac):
        out = neighbor_search_cuda(
            *(a if a.is_contiguous() else a.contiguous() for a in args[:4]),
            *args[4:])
    else:
        out = neighbor_search_reference(*args)
    return (*out, cap_overflow(lats, amask, spec, caps))


def make_raw_expander(spec: RawSpec, impl: str = "pallas",
                      device="cuda", edge_dtype=torch.float32) -> Callable:
    """RawBatch -> (GraphBatch, overflow [G] bool, n_edges [G] i32), the
    raw wire's graph construction on ``device``.

    The atom table, the Gaussian centres, the offsets grid and the image
    caps move to the device once, here: a flush copies only its batch. The GraphBatch has the per-structure block layout:
    structure g owns node slots ``[g*S, (g+1)*S)``; every dense-layout
    invariant holds (centers = slot // M, masks zero on padding, padding
    edge slots self-loop their node). Fields the model does not read
    (geometry, force labels, transpose slots) are None. The edge
    features are cast to ``edge_dtype`` (bf16 for a bf16 model) on the
    device, last, as the JAX expander casts them (neighbor_search.py:292);
    the search itself runs on f32 positions either way.
    """
    check_impl(impl)
    dev = resolve_device(device)
    table = torch.from_numpy(full_embedding_table()).to(dev)
    mu = torch.from_numpy(np.asarray(spec.gauss_filter, np.float32)).to(dev)
    var2 = float(np.float32(spec.gauss_var) ** 2)
    offsets = offsets_tensor(spec, dev)
    caps = caps_tensor(spec, dev)
    m = spec.dense_m

    def expand(rb: RawBatch):
        g_cap, s_cap = rb.species.shape
        nbr, dist, emask, n_edges, overflow = neighbor_search(
            rb.frac, rb.lattices, rb.atom_mask, spec, impl=impl,
            offsets=offsets, caps=caps)
        node_mask = rb.atom_mask.reshape(-1).to(torch.float32)
        nodes = table.index_select(0, rb.species.reshape(-1)) \
            * node_mask[:, None]
        # the one radial-basis formula, division form
        efea = torch.exp(-((dist[..., None] - mu) ** 2) / var2)
        edges = (efea * emask[..., None]).to(edge_dtype).reshape(
            g_cap * s_cap, m, -1)
        base = (torch.arange(g_cap, dtype=torch.int32, device=dev)
                * s_cap)[:, None, None]
        gb = GraphBatch(
            nodes=nodes,
            edges=edges,
            centers=torch.arange(g_cap * s_cap * m, dtype=torch.int32,
                                 device=dev) // m,
            neighbors=(nbr + base).reshape(-1),
            node_graph=torch.arange(g_cap * s_cap, dtype=torch.int32,
                                    device=dev) // s_cap,
            node_mask=node_mask,
            edge_mask=emask.reshape(-1),
            graph_mask=rb.graph_mask,
            targets=rb.targets,
            target_mask=rb.target_mask,
            positions=None,
            lattices=None,
            edge_offsets=None,
            node_targets=None,
        )
        return gb, overflow & (rb.graph_mask > 0), n_edges

    return expand


def neighbor_search_cost(g: int, s: int, k: int, m: int, real_pairs: int,
                         real_atoms: int, filled: int) -> dict:
    """Compulsory bytes and f32 operations of one kernel-8 call on this
    data. Bytes: every input read once (frac, lattices, atom mask,
    offsets) and every output written once (neighbors, distances, edge
    mask, n_edges). Operations: the least work of any exact design, in
    flop-equivalents at the f32 FMA rate (no product may fuse with a sum,
    so each add, subtraction, square and compare takes an FMA slot, 2
    flops): per candidate of a real (i, j) pair, ``real_pairs`` = the sum
    over structures of (real atoms)^2, 3 subtractions, 3 squares, 2 adds
    and the radius compare (18); per real (j, k), ``real_atoms`` = the
    real atoms, the image position's 3 adds (6); and one correctly rounded
    root per filled slot, ``filled`` = the sum of n_edges, on the SFU at
    16 a clock an SM, an eighth of the FMA rate (16). Padding atoms and
    rows cost no candidates; the selection is integer and shuffle work,
    not counted. ``flops_before``: the earlier count, 14 a candidate
    (image adds, sqrt and two compares included)."""
    nbytes = (g * s * 3 * 4 + g * 9 * 4 + g * s + k * 3 * 4
              + 3 * g * s * m * 4 + g * 4)
    return {"bytes": nbytes,
            "flops": 18 * real_pairs * k + 6 * real_atoms * k + 16 * filled,
            "flops_before": 14 * real_pairs * k}
