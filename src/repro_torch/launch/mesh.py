"""Device meshes on ``torch.distributed``.

Defined as FUNCTIONS (never module-level constants) so importing this module
touches no process group. A mesh is an ``init_device_mesh`` over the
initialized default process group: NCCL (``device_type="cuda"``) on GPUs,
gloo (``"cpu"``) in the CPU tests, and for the dry run torch's fake
backend, which gives one process the 256 or 512 ranks of a production mesh
and runs no collective (:func:`init_fake_world`).
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """16x16 single pod (256 GPUs) or 2x16x16 (512 GPUs, 2 pods).

    Axes: 'pod' carries only cross-pod gradient reduction; 'data' is
    batch/FSDP; 'model' is TP/EP/sequence-sharding."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    device_type: str = "cuda") -> DeviceMesh:
    """Small (data, model) mesh; the world size must be n_data * n_model."""
    return init_device_mesh(device_type, (n_data, n_model), mesh_dim_names=("data", "model"))


def init_fake_world(world_size: int, rank: int = 0) -> None:
    """A default process group of ``world_size`` ranks in this one process,
    on torch's fake backend (collectives return at once and move no data):
    enough to build a production mesh and trace a step's sharding and
    collectives without the GPUs. Its store lives in torch's internal
    testing package, imported here and nowhere else."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
