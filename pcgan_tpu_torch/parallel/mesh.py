"""The named-axis mesh across processes (counterpart of
``pcgan_tpu/parallel/mesh.py:22-153`` and ``pcgan_tpu/config.py:292-309``).

One process per card, launched by ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node N ...``), which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``. Each process is one device of the mesh
and computes on ``cuda:LOCAL_RANK`` (or the CPU under ``--device cpu``).
The ranks are laid out row-major over ``--mesh_shape`` and its
``--mesh_axes`` (``data``, ``spatial``, ``model``), as ``make_mesh``
reshapes ``devices[:n]``; the mesh's product must equal the world size.
Under ``--dcn_data k`` the layout is the hybrid mesh's instead: the data
axis factors granule-major over k granules (a granule is a torchrun node,
``GROUP_RANK``), so only data-axis collectives cross between nodes.

Every rank knows its coordinate on each axis and holds one process group
per axis line through it (``axis_group``; None for an axis of size 1).
Rank r's rows of a global batch are those of its **data coordinate**, so
the ranks of one model line load and compute the same rows, as
``P('data')`` lays them out in JAX. The step's collectives are
``torch.distributed``'s: NCCL on the card, gloo on the CPU; a failed
initialisation or collective raises.

A process started outside torchrun creates no process group and issues no
collective: it is the one-device path. Under torchrun every rank joins the
group, a world of one included, so the NCCL path also runs on one card.

An axis of size 1 is the plain path, as in JAX. ``--spatial_shards`` is
parsed and read by nothing, as in JAX. A ``spatial`` axis > 1 splits the
activations along H (``parallel/spatial.py``) under every training flag:
the model levers (attention, the multiscale D, the U-Net, the resize conv,
group norm, dropout, ``--remat``) and the loss and data levers (R1, the
gradient penalty, feature matching, VGG, DiffAugment and ADA) included.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA, SPATIAL, MODEL = "data", "spatial", "model"


def resolve_mesh_shape(shape: Sequence[int], n_devices: int
                       ) -> Tuple[int, ...]:
    """Replace a single -1 with whatever divides the device count (the JAX
    package's function, copied)."""
    shape = tuple(shape)
    if shape.count(-1) > 1:
        raise ValueError(f"at most one -1 in mesh_shape, got {shape}")
    known = int(np.prod([s for s in shape if s != -1])) or 1
    if -1 in shape:
        if n_devices % known:
            raise ValueError(f"mesh {shape} incompatible with {n_devices} "
                             f"devices")
        shape = tuple(n_devices // known if s == -1 else s for s in shape)
    if int(np.prod(shape)) > n_devices:
        raise ValueError(f"mesh {shape} needs more than {n_devices} devices")
    return shape


def hybrid_layout(shape: Sequence[int], axes: Sequence[str], dcn_data: int,
                  ranks: Sequence[int], granules: Sequence) -> np.ndarray:
    """The hybrid mesh (``make_hybrid_mesh``, ``pcgan_tpu/parallel/
    mesh.py:62-112``) over ``ranks`` whose granule ids are ``granules``:
    the data axis factors granule-major over ``dcn_data`` granules (sorted
    by id), the inner axes stay inside a granule, and a granule holding
    more ranks than the mesh needs gives its first ones. Returns the rank
    ids in the mesh's shape. Raises JAX's errors."""
    axes = tuple(axes)
    if DATA not in axes:
        raise ValueError("--dcn_data needs a 'data' mesh axis to span DCN")
    shape = resolve_mesh_shape(shape, len(ranks))
    dpos = axes.index(DATA)
    groups: Dict = {}
    for r, g in zip(ranks, granules):
        groups.setdefault(g, []).append(r)
    # the granule count first: one process (one granule) reports that,
    # not its data axis of one
    if len(groups) != dcn_data:
        raise ValueError(
            f"--dcn_data {dcn_data}: found {len(groups)} DCN granule(s) "
            f"({sorted(map(str, groups))}) — dcn_data must equal the number "
            f"of slices (or processes, on platforms without slice metadata)")
    if shape[dpos] % dcn_data:
        raise ValueError(f"data axis ({shape[dpos]}) must be divisible by "
                         f"--dcn_data {dcn_data}")
    inner = list(shape)
    inner[dpos] = shape[dpos] // dcn_data
    per = int(np.prod(inner))
    short = {str(g): len(v) for g, v in groups.items() if len(v) < per}
    if short:
        raise ValueError(f"mesh {shape} needs {per} devices per granule; "
                         f"granules short of that: {short}")
    blocks = [np.asarray(groups[g][:per]).reshape(inner)
              for g in sorted(groups)]
    return np.concatenate(blocks, axis=dpos)


@dataclass
class DataMesh:
    """This process's place on the mesh. ``group`` is the world's process
    group, None for one process outside torchrun (no collective at all).
    ``layout`` holds the global ranks in the mesh's shape over ``axes``
    (default: the world on one data axis); ``axis_groups`` the group of
    this rank's line along each axis larger than 1 (``build_axis_groups``;
    a one-axis data mesh uses ``group``)."""
    world: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Any = None
    owns_group: bool = False
    axes: Tuple[str, ...] = (DATA,)
    layout: Optional[np.ndarray] = None
    axis_groups: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        if self.layout is None:
            self.layout = np.arange(self.world).reshape(self.world)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.layout.shape))

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 for an absent axis)."""
        if axis not in self.axes:
            return 0
        where = np.argwhere(self.layout == self.rank)
        return int(where[0][self.axes.index(axis)]) if len(where) else 0

    def line(self, axis: str) -> List[int]:
        """The global ranks of this rank's line along ``axis``, in
        coordinate order."""
        if axis not in self.axes:
            return [self.rank]
        idx = list(np.argwhere(self.layout == self.rank)[0])
        idx[self.axes.index(axis)] = slice(None)
        return [int(r) for r in self.layout[tuple(idx)]]

    def axis_group(self, axis: str):
        """The process group of this rank's line along ``axis``: the
        world's group for a one-axis data mesh under torchrun, None where
        the line is this rank alone (no collective)."""
        if self.group is None:
            return None
        if self.axes == (DATA,) and axis == DATA:
            return self.group
        return self.axis_groups.get(axis)

    @property
    def data_size(self) -> int:
        return self.size(DATA)

    @property
    def data_rank(self) -> int:
        return self.coord(DATA)

    @property
    def data_group(self):
        return self.axis_group(DATA)

    def local_rows(self, batch: Dict, rows=None) -> Dict:
        """This rank's rows of a global batch (numpy arrays or tensors
        along axis 0): those of its data coordinate, [d*b, (d+1)*b), or
        ``rows``'s index (``parallel.rows.Rows``) when given; the
        counterpart of ``put_global_batch``."""
        out = {}
        n_data, d = self.data_size, self.data_rank
        for k, v in batch.items():
            n = v.shape[0]
            if n % n_data:
                raise ValueError(f"batch of {n} rows ({k}) does not split "
                                 f"over {n_data} data ranks")
            b = n // n_data
            if rows is None:
                out[k] = v[d * b:(d + 1) * b]
            else:
                idx = rows.index(b)
                out[k] = v[idx.numpy() if isinstance(v, np.ndarray)
                           else idx.to(v.device)]
        return out

    def close(self) -> None:
        """Destroys the process group this mesh created."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group, self.owns_group, self.axis_groups = None, False, {}


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None) -> DataMesh:
    """Joins the process group and returns this process's ``DataMesh``.

    Outside torchrun (no ``WORLD_SIZE`` in the environment and none given)
    it creates no group: one process on ``resolve_device(device)``. Else
    rank, world size and local rank come from torchrun's environment unless
    given; the device is ``cuda:LOCAL_RANK`` (raises when that card is not
    visible) or the CPU; the backend is NCCL for cuda and gloo for the CPU
    unless given (two ranks may share one card over gloo; the CLIs never
    ask for that). A group that already exists is joined as it is."""
    from pcgan_tpu_torch.device import resolve_device
    env = os.environ
    if world_size is None and "WORLD_SIZE" not in env:
        return DataMesh(device=resolve_device(device))
    world = int(env["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(env["RANK"] if rank is None else rank)
    local = int(env.get("LOCAL_RANK", rank) if local_rank is None
                else local_rank)
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if local >= n:
            raise RuntimeError(
                f"LOCAL_RANK {local}: only {n} CUDA device(s) are visible; "
                f"launch at most {n} process(es) per node")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    owns = not dist.is_initialized()
    if owns:
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method, rank=rank, world_size=world)
    elif (dist.get_world_size(), dist.get_rank()) != (world, rank):
        raise RuntimeError(
            f"a process group of {dist.get_world_size()} ranks (this one "
            f"{dist.get_rank()}) exists; asked for rank {rank} of {world}")
    return DataMesh(world, rank, dev, dist.group.WORLD, owns)


def check_mesh_shape(shape: Sequence[int], world: int) -> Tuple[int, ...]:
    """``--mesh_shape`` resolved against the world size, whose product it
    must equal: each process is one device of the mesh."""
    flag = ",".join(map(str, shape))
    try:
        dims = resolve_mesh_shape(shape, world)
    except ValueError as e:
        raise ValueError(f"--mesh_shape {flag}: {e} (one device per "
                         f"process, {world} process(es))") from None
    n = int(np.prod(dims))
    if n != world:
        what = (f"a data axis of {n}" if len(dims) == 1
                else f"a mesh of {n} device(s)")
        raise ValueError(f"--mesh_shape {flag}: {what} over {world} "
                         f"process(es); each process is one device of the "
                         f"mesh: pass -1 or a shape of {world} devices")
    return dims


def build_axis_groups(mesh: DataMesh) -> DataMesh:
    """Creates the process group of every line of every axis larger than 1
    (every rank creates every group, in the same order, as
    ``torch.distributed.new_group`` requires) and keeps this rank's. A
    one-axis data mesh keeps the world's group instead."""
    if mesh.group is None or mesh.axes == (DATA,):
        return mesh
    lay = mesh.layout
    for i, ax in enumerate(mesh.axes):
        if lay.shape[i] == 1:
            continue
        lines = np.moveaxis(lay, i, -1).reshape(-1, lay.shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if mesh.rank in line:
                mesh.axis_groups[ax] = g
    return mesh


def granules_of_ranks(mesh: DataMesh,
                      granule_of: Optional[Callable] = None) -> List:
    """The granule id of every rank: ``granule_of(rank)`` when given (tests),
    else each rank's torchrun node (``GROUP_RANK``), gathered."""
    if granule_of is not None:
        return [granule_of(r) for r in range(mesh.world)]
    mine = int(os.environ.get("GROUP_RANK", 0))
    if mesh.group is None:
        return [mine]
    out = [None] * mesh.world
    dist.all_gather_object(out, mine, group=mesh.group)
    return out


def make_mesh(mesh: DataMesh, shape: Sequence[int], axes: Sequence[str],
              dcn_data: int = 1,
              granule_of: Optional[Callable] = None) -> DataMesh:
    """``mesh`` (this process's place in the world) laid out over ``axes``:
    row-major over ``shape``, or the hybrid mesh when ``dcn_data > 1``;
    then the axis groups. Raises for a shape whose product is not the
    world size."""
    axes = tuple(axes)
    if dcn_data > 1:
        lay = hybrid_layout(shape, axes, dcn_data, list(range(mesh.world)),
                            granules_of_ranks(mesh, granule_of))
        check_mesh_shape(lay.shape, mesh.world)
    else:
        lay = np.arange(mesh.world).reshape(check_mesh_shape(shape,
                                                             mesh.world))
    mesh.axes, mesh.layout = axes, lay
    return build_axis_groups(mesh)


def mesh_from_config(cfg, granule_of: Optional[Callable] = None
                     ) -> DataMesh:
    """The CLIs' mesh: the group is joined and ``--mesh_shape``/
    ``--mesh_axes`` laid out over the world (the hybrid mesh under
    ``--dcn_data``). Outside torchrun, ``--mesh_shape -1`` with several
    cards visible raises rather than train on one card of several."""
    p = cfg.parallel
    shape = tuple(p.mesh_shape)
    if ("WORLD_SIZE" not in os.environ and shape == (-1,)
            and cfg.run.device == "cuda" and torch.cuda.is_available()
            and torch.cuda.device_count() > 1):
        n = torch.cuda.device_count()
        raise SystemExit(
            f"--mesh_shape -1 with {n} cards visible: launch one process per "
            f"card with torchrun --nproc_per_node {n} (python -m "
            f"torch.distributed.run), or pass --mesh_shape 1 for one card")
    mesh = init_distributed(cfg.run.device)
    try:
        return make_mesh(mesh, shape, p.mesh_axes, p.dcn_data, granule_of)
    except BaseException:
        mesh.close()
        raise


def mesh_label(mesh: DataMesh) -> str:
    """``data=2xmodel=2``: the axes and their sizes, as JAX prints them."""
    return "x".join(f"{ax}={n}" for ax, n in mesh.shape.items())


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s generators: ``seed`` itself on rank 0 (a
    world of one draws what a plain run draws), a ``SeedSequence`` draw of
    (seed, rank) on the others, as JAX folds ``axis_index`` into its keys."""
    if rank == 0:
        return int(seed)
    state = np.random.SeedSequence([int(seed) % 2 ** 63, int(rank)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def all_reduce_flat(tensors: List[torch.Tensor], group,
                    mean: bool = False) -> List[torch.Tensor]:
    """Every tensor summed (``mean``: then divided by the world size) over
    ``group``; one collective per dtype, the tensors flattened into one
    contiguous buffer. Returns new tensors (views of the reduced buffer)."""
    out = list(tensors)
    parts: Dict[Tuple, List[int]] = {}
    for i, t in enumerate(tensors):
        parts.setdefault((t.dtype, t.device), []).append(i)
    for (dtype, dev), idx in parts.items():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        if mean:
            # a true division, as pmean's: a CUDA division by a Python
            # number would multiply by its reciprocal
            flat = flat / torch.tensor(dist.get_world_size(group),
                                       dtype=dtype, device=dev)
        pieces = flat.split([tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.view(tensors[i].shape)
    return out
