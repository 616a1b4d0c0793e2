"""Device meshes over the process group, and the card's spec-sheet numbers.

Port of the reference ``launch/mesh.py``. ``make_host_mesh`` builds a
``("data", "model")`` ``DeviceMesh`` over every rank of the initialised
process group (``torch.distributed``), as the reference's spans every
device it sees. The production mesh of the reference (16 x 16 per pod, two
pods) has no counterpart yet: ``--multi-pod`` waits for it.
"""
from __future__ import annotations

import datetime
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


# NVIDIA H100 SXM5 80 GB, from its data sheet (per card)
HW = {
    "name": "h100-sxm5-80gb",
    "peak_flops_bf16": 989e12,      # dense tensor-core bf16, FLOP/s
    "hbm_bw": 3.35e12,              # bytes/s
    "nvlink_bw": 450e9,             # per direction, all links, bytes/s
    "hbm_bytes": 80e9,
}
