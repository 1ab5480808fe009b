"""Production and host mesh construction.

FUNCTIONS (not module-level constants), so importing this module creates no
process group and no mesh: the dry run brings up a ``fake`` process group of
256 or 512 ranks in a process of its own, while tests and the card see the
world they were started with.
"""
from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: (data=16, model=16) = 256 ranks.
    Multi-pod: (pod=2, data=16, model=16) = 512 ranks; the 'pod' axis is pure
    data parallelism and composes with 'data' for gradient reductions.
    Built on the process group that is up (``fake`` for the dry run), whose
    world size must be the mesh's."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device, shape, mesh_dim_names=axes)


def make_host_mesh(model: int = 1, device: str = "cuda"):
    """(data, model) mesh over the current world (one rank per card, or per
    CPU process on gloo): ``model`` ranks of tensor parallelism, the rest
    data parallel."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    n = dist.get_world_size()
    model = min(model, n)
    return init_device_mesh(device, (n // model, model),
                            mesh_dim_names=("data", "model"))
