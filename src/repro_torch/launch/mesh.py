"""Device meshes over the process group, and the card's spec-sheet numbers.

Port of the reference ``launch/mesh.py``. ``make_host_mesh`` builds a
``("data", "model")`` ``DeviceMesh`` over every rank of the initialised
process group (``torch.distributed``), as the reference's spans every
device it sees. ``make_production_mesh`` builds the reference's
production meshes, 16 x 16 per pod and two pods, over a process group of
256 or 512 ranks: 32 or 64 nodes of 8 H100 cards. ``init_fake_world``
makes such a group in one process (torch's ``"fake"`` backend, whose
collectives do nothing) for the dry run, which traces one rank's program
on fake tensors. Nothing here touches the process group at import.
"""
from __future__ import annotations

import datetime
import math
import os
import socket
from typing import Optional

import torch


def init_distributed(device: str = "cuda", timeout_s: float = 600.0
                     ) -> bool:
    """Initialise the default process group unless one exists: nccl for
    the card, gloo for the CPU. Under ``torchrun`` its environment names
    the rendezvous, the rank and the world; without it the process is a
    world of one at a free port of this host. Returns whether this call
    created the group (the caller then destroys it)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    timeout = datetime.timedelta(seconds=timeout_s)
    if "RANK" in os.environ:
        dist.init_process_group(backend, timeout=timeout)
    else:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        dist.init_process_group(backend, init_method=f"tcp://localhost:"
                                f"{port}", rank=0, world_size=1,
                                timeout=timeout)
    return True


def make_host_mesh(model_axis: Optional[int] = None, device: str = "cuda"):
    """A ``(world // m, m)`` mesh named ``("data", "model")`` over the
    process group's ranks (m = ``model_axis`` or 1), on the card unless the
    caller names ``"cpu"``. The process group must be initialised."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: initialise the process group "
                           "first (torch.distributed.init_process_group)")
    n = dist.get_world_size()
    m = model_axis or 1
    if n % m:
        raise ValueError(f"model axis {m} does not divide the world {n}")
    return init_device_mesh(device, (n // m, m),
                            mesh_dim_names=("data", "model"))


def make_production_mesh(multi_pod: bool = False, device: str = "cuda"):
    """The reference's production mesh over the initialised process group:
    ``(16, 16)`` named ``("data", "model")``, or with ``multi_pod``
    ``(2, 16, 16)`` named ``("pod", "data", "model")``; on the card unless
    the caller names ``"cpu"``. Refuses a world of another size."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                    else ((16, 16), ("data", "model")))
    want = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError("make_production_mesh: initialise the process "
                           "group first (torch.distributed."
                           "init_process_group)")
    if dist.get_world_size() != want:
        raise ValueError(f"the {'x'.join(map(str, shape))} production mesh "
                         f"needs a world of {want} ranks, not "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device, shape, mesh_dim_names=names)


def init_fake_world(world: int, rank: int = 0) -> None:
    """Initialise the default process group as torch's ``"fake"`` backend:
    a world of ``world`` ranks in this one process, this process rank
    ``rank``, whose collectives return at once. For the dry run and its
    tests only; the caller destroys the group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


# NVIDIA H100 SXM5 80 GB, from its data sheet (per card). A 16 x 16 mesh
# of them spans 32 nodes of 8 cards, so each axis of 16 crosses nodes: its
# collectives run at the inter-node rate, one 400 Gb/s NDR InfiniBand port
# per GPU as in a DGX H100 (its data sheet: 8 x 400 Gb/s ConnectX-7 for the
# 8 GPUs), 50e9 B/s per card and direction. NVLink joins the 8 cards of a
# node only.
HW = {
    "name": "h100-sxm5-80gb",
    "peak_flops_bf16": 989e12,      # dense tensor-core bf16, FLOP/s
    "hbm_bw": 3.35e12,              # bytes/s
    "nvlink_bw": 450e9,             # per direction, all links, bytes/s
    "internode_bw": 50e9,           # per card and direction, bytes/s
    "hbm_bytes": 80e9,
}
