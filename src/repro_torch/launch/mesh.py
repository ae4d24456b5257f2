"""Production mesh definition and H100 hardware constants, the port of the
reference's ``launch/mesh.py``.

A FUNCTION (not a module-level constant) so importing this module never
touches process-group state. The reference's chip counts and axis names
are kept, the shapes re-expressed for H100 nodes with the model axis on
one 8-GPU NVLink node: single "pod" (32, 8) = 256 GPUs, axes ("data",
"model"); multi-pod (2, 32, 8) = 512 GPUs, axes ("pod", "data", "model"),
the "pod" axis the slow inter-node dimension (pure data parallelism).
``shape`` builds any other mesh, e.g. the reference's (16, 16) and (2,
16, 16).

Unless a process group is already initialised, the mesh sits on a *fake*
one (``torch.testing``'s ``FakeStore``, one process standing for every
rank): collectives on it move nothing, which is what the dry run needs.

``make_shard_mesh`` is the 1-D mesh of the sharded stage-1 cache: the
first S local CUDA devices, one shard's bucket range on each
(``kernels/ann_topk_sharded.py``). One process drives them all, as the
reference's single controller does, with no process group.
"""
from __future__ import annotations

import math

# H100 SXM5 80GB constants for the roofline, from NVIDIA's H100 Tensor
# Core GPU datasheet (SXM5 column).
HW = {
    # 989 TFLOP/s dense BF16 tensor core (1979 with 2:4 sparsity)
    "peak_flops_bf16": 989e12,
    # 3.35 TB/s HBM3
    "hbm_bw": 3.35e12,
    # NVLink 4: 900 GB/s per GPU in total, i.e. 450 GB/s each way
    "nvlink_bw": 450e9,
    # one ConnectX-7 NDR InfiniBand port (400 Gb/s) per GPU between nodes
    "ib_bw": 400e9 / 8,
    # 80 GB of HBM3
    "hbm_bytes": 80e9,
}

# the mesh axis each link serves: the model axis inside a node, the rest
# across nodes
AXIS_LINK = {"model": "nvlink_bw", "data": "ib_bw", "pod": "ib_bw"}

SINGLE = ((32, 8), ("data", "model"))
MULTI = ((2, 32, 8), ("pod", "data", "model"))


def mesh_name(shape) -> str:
    return "x".join(str(n) for n in shape)


def make_shard_mesh(n_shards: int):
    """The first ``n_shards`` local CUDA devices, in order, the stage-1
    cache partition axis (DESIGN.md §13): shard s's bucket range lives on
    device s. Raises, as the reference does, when the host has fewer."""
    import torch

    n = torch.cuda.device_count()
    if n < n_shards:
        raise ValueError(f"mesh needs {n_shards} devices, host has {n}")
    return [torch.device("cuda", i) for i in range(n_shards)]


def make_production_mesh(*, multi_pod: bool = False, shape=None,
                         device_type: str = "cpu"):
    """The (32, 8) single-pod or (2, 32, 8) multi-pod mesh, or one of
    ``shape`` (2-D: data, model; 3-D: pod, data, model), over ranks 0..n-1
    of the default process group; a fake one of 512 ranks (the multi-pod
    mesh's, so that both meshes fit one process) is made first if there is
    none."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if shape is None:
        shape, names = MULTI if multi_pod else SINGLE
    else:
        shape = tuple(shape)
        names = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=max(FAKE_WORLD,
                                               math.prod(shape)))
    return DeviceMesh(device_type,
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=names)


FAKE_WORLD = math.prod(MULTI[0])
