"""The data axis across processes (counterpart of
``pcgan_tpu/parallel/mesh.py:22-44, 124-153``).

One process per card, launched by ``torchrun`` (``python -m
torch.distributed.run --nproc_per_node N ...``), which sets ``RANK``,
``WORLD_SIZE`` and ``LOCAL_RANK``. Each process is one device of the
mesh's ``data`` axis and computes on ``cuda:LOCAL_RANK`` (or the CPU under
``--device cpu``). Rank r holds rows [r*b, (r+1)*b) of every global batch
of B = world * b rows, as JAX lays device r's shard under ``P('data')``.
The step's collectives are ``torch.distributed``'s: NCCL on the card, gloo
on the CPU; a failed initialisation or collective raises.

A process started outside torchrun creates no process group and issues no
collective: it is the one-device path. Under torchrun every rank joins the
group, a world of one included, so the NCCL path also runs on one card.

Only the data axis is ported: ``--zero1``, a ``model`` or ``spatial`` mesh
axis, ``--spatial_shards`` and ``--dcn_data`` (the GSPMD step and the
hybrid mesh) raise ``NotImplementedError`` naming ROADMAP.md A10b.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

A10B = "ROADMAP.md A10b"


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


def reject_unported_parallel(cfg) -> None:
    """The parallel flags beyond one data axis raise, each named."""
    p = cfg.parallel
    off = {"--mesh_shape/--mesh_axes": p.mesh_axes != ("data",),
           "--spatial_shards": p.spatial_shards != 1,
           "--zero1": p.zero1, "--dcn_data": p.dcn_data != 1}
    for flag, on in off.items():
        if on:
            raise NotImplementedError(
                f"{flag}: the GSPMD step (a model or spatial axis, ZeRO-1) "
                f"and the hybrid mesh are not ported to pcgan_tpu_torch yet "
                f"({A10B}); the port runs data parallelism over one 'data' "
                f"axis")


@dataclass
class DataMesh:
    """This process's place on the data axis. ``group`` is the process
    group the step's collectives run over, None for one process outside
    torchrun (no collective at all)."""
    world: int = 1
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Any = None
    owns_group: bool = False

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.world}

    def local_rows(self, batch: Dict) -> Dict:
        """Rank r's rows [r*b, (r+1)*b) of a global batch (numpy arrays or
        tensors along axis 0): the counterpart of ``put_global_batch``."""
        out = {}
        for k, v in batch.items():
            n = v.shape[0]
            if n % self.world:
                raise ValueError(f"batch of {n} rows ({k}) does not split "
                                 f"over {self.world} ranks")
            b = n // self.world
            out[k] = v[self.rank * b:(self.rank + 1) * b]
        return out

    def close(self) -> None:
        """Destroys the process group this mesh created."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.group, self.owns_group = None, False


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


def check_data_axis(shape: Sequence[int], world: int) -> None:
    """``--mesh_shape`` must resolve to a data axis of exactly the world
    size: each process is one device of it."""
    flag = ",".join(map(str, shape))
    try:
        (n,) = resolve_mesh_shape(shape, world)
    except ValueError as e:
        raise ValueError(f"--mesh_shape {flag}: {e} (one device per "
                         f"process, {world} process(es))") from None
    if n != world:
        raise ValueError(f"--mesh_shape {flag}: a data axis of {n} over "
                         f"{world} process(es); each process is one device "
                         f"of the data axis: pass -1 or {world}")


def mesh_from_config(cfg) -> DataMesh:
    """The CLIs' mesh: the unported flags raise, the group is joined and
    ``--mesh_shape`` checked against the world size. Outside torchrun,
    ``--mesh_shape -1`` with several cards visible raises rather than train
    on one card of several."""
    reject_unported_parallel(cfg)
    shape = tuple(cfg.parallel.mesh_shape)
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
        check_data_axis(shape, mesh.world)
    except ValueError:
        mesh.close()
        raise
    return mesh


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
