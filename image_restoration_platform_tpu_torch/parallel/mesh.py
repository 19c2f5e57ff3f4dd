"""Device meshes: a named grid of device slots in one process.

Counterpart of image_restoration_platform_tpu/parallel/mesh.py. The axes
are the reference's:

  data    — batch-sharded serving and training (DP)
  tensor  — output-channel-sharded layers (TP, parallel/sharding.py)
  spatial — image rows sharded with a halo exchanged at every convolution
            (parallel/halo.py)
  pipe    — GPipe stages of a network (parallel/pipeline.py)

The reference's mesh is single-controller: one process places shards on
its devices. So is this one. A ``Mesh`` holds a numpy array of
``torch.device`` slots shaped (data, tensor, spatial, pipe), and the
programs of this package hand tensors from slot to slot with copies. A
slot may repeat a device: ``[cuda:0] * 4`` runs a four-slot mesh on one card
(its slots share the card's stream, so they run one after another), and
``[cpu] * 8`` is the tests' counterpart of the reference's eight virtual
CPU devices. Only the data axis spans processes, through
``torch.distributed`` (``maybe_initialize_distributed``), as the
reference's data axis spans hosts. ``capture_plan`` says, from the layout
alone, which mesh programs a CUDA graph can hold: those whose slots are one
device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

AXIS_DATA = "data"
AXIS_TENSOR = "tensor"
AXIS_SPATIAL = "spatial"
AXIS_PIPE = "pipe"


def mesh_axes() -> tuple[str, str, str, str]:
    return (AXIS_DATA, AXIS_TENSOR, AXIS_SPATIAL, AXIS_PIPE)


class Mesh:
    """Device slots laid out on named axes. ``devices`` is the object array
    of ``torch.device``; ``shape`` maps each axis name to its size."""

    def __init__(self, devices: np.ndarray, axis_names: tuple[str, ...] = mesh_axes()):
        if devices.ndim != len(axis_names):
            raise ValueError(f"a {devices.ndim}-D slot array does not fit axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def primary(self) -> torch.device:
        """The first slot: where a mesh program gathers its outputs."""
        return self.devices.flat[0]

    def slots(self, axis: str) -> list[torch.device]:
        """The slots along ``axis`` at index 0 of every other axis."""
        index = [0] * len(self.axis_names)
        index[self.axis_names.index(axis)] = slice(None)
        return list(self.devices[tuple(index)])

    def tensor_slots(self, data_index: int) -> list[torch.device]:
        """The tensor slots of one data row (spatial and pipe index 0)."""
        return list(self.devices[data_index, :, 0, 0])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, slots={[str(d) for d in self.devices.flat]})"


@dataclass(frozen=True)
class CapturePlan:
    """Where each mesh program may be captured as CUDA graphs: the one
    device every slot it touches is, or None where it touches distinct
    devices. A capture records work on one device's stream; an op that a
    capture issues on another device's tensors runs on that device's
    stream, which is not capturing, so it runs once, eagerly, and is
    missing from every replay. So a program over distinct devices runs
    eagerly, and the plan is decided from the layout before any capture.

    ``rows``: each data row's restore program (the row's tensor slots);
    ``grid``: the data and tensor slots together (the tiled SR program,
    which gathers every row's tiles on the first slot, and the train
    step, which gathers every row's outputs and gradients there);
    ``spatial``: the spatial slots (``sr_spatial``)."""

    rows: tuple
    grid: torch.device | None
    spatial: torch.device | None


def _one_device(slots) -> torch.device | None:
    devices = {torch.device(d) for d in slots}
    return devices.pop() if len(devices) == 1 else None


def capture_plan(mesh: Mesh) -> CapturePlan:
    """The capture plan of ``mesh``'s layout (no device is touched)."""
    d = mesh.devices
    return CapturePlan(
        rows=tuple(_one_device(d[i, :, 0, 0]) for i in range(d.shape[0])),
        grid=_one_device(d[:, :, 0, 0].flat),
        spatial=_one_device(d[0, 0, :, 0]),
    )


def _check_device(device: torch.device) -> torch.device:
    """A CUDA slot needs its card: no slot falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: build the mesh on CPU slots (devices=[torch.device('cpu')] * n)")
        index = 0 if device.index is None else device.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"no card {device}: {torch.cuda.device_count()} visible")
        device = torch.device("cuda", index)
    return device


def maybe_initialize_distributed(backend: str | None = None) -> bool:
    """Join the process group the environment names, with the reference's
    variables: ``JAX_COORDINATOR`` (host:port of rank 0),
    ``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``, so one deployment file
    drives both packages. NCCL when a card is present, else gloo. Does
    nothing without ``JAX_COORDINATOR``, and nothing again once joined.
    Returns whether a process group is up."""
    import torch.distributed as dist

    coordinator = os.environ.get("JAX_COORDINATOR")
    if not coordinator:
        return dist.is_available() and dist.is_initialized()
    if dist.is_initialized():
        return True
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(
        backend,
        init_method=f"tcp://{coordinator}",
        world_size=int(os.environ.get("JAX_NUM_PROCESSES", 1)),
        rank=int(os.environ.get("JAX_PROCESS_ID", 0)),
    )
    return True


def process_group_backend() -> str | None:
    """The backend of the process group this process joined, or None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


def process_span() -> tuple[int, int]:
    """(processes, this rank) of the data axis: (1, 0) without a process group."""
    import torch.distributed as dist

    if process_group_backend() is not None:
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(devices=None, data: int = -1, tensor: int = 1, spatial: int = 1, pipe: int = 1) -> Mesh:
    """Build a (data, tensor, spatial, pipe) mesh over ``devices`` (default:
    every visible card; CPU slots only when passed). ``data=-1`` absorbs the
    rest; ``pipe`` is innermost, as in the reference."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: pass devices=[torch.device('cpu')] * n for a CPU mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_check_device(d) for d in devices]
    n = len(devices)
    inner = tensor * spatial * pipe
    if inner > n or n % inner != 0:
        raise ValueError(f"{n} devices not divisible by tensor({tensor}) x spatial({spatial}) x pipe({pipe})")
    if data == -1:
        data = n // inner
    if data * inner != n:
        raise ValueError(f"mesh {data}x{tensor}x{spatial}x{pipe} != device count {n}")
    slots = np.empty(n, dtype=object)
    slots[:] = devices
    return Mesh(slots.reshape(data, tensor, spatial, pipe), mesh_axes())


@lru_cache(maxsize=1)
def default_mesh() -> Mesh:
    """Process-wide mesh over every visible card from the MESH_DATA /
    MESH_TENSOR / MESH_SPATIAL knobs."""
    from ..config import load_config

    cfg = load_config().mesh
    return make_mesh(data=cfg.data, tensor=cfg.tensor, spatial=cfg.spatial)
