"""Roofline terms of a dry-run record: a model of the card, not a
measurement.

Port of the reference ``launch/roofline.py``, over the port's ``HW`` (an
H100) and its cost counter (``launch/op_cost.py``) in place of compiled
HLO. Per (arch x shape x mesh):

    compute term    = flops per card / bf16 tensor-core peak    (seconds)
    memory term     = traffic per card / HBM rate               (seconds)
    collective term = collective bytes per card / inter-node rate (seconds)

The counter traces one rank's program, so every term is per card. Each
axis of the production meshes crosses nodes (``launch/mesh.HW``), so the
collective term reads the inter-node rate; what the same bytes would take
over NVLink alone goes beside it in the record's ``note``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List

from repro_torch.launch.mesh import HW


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    peak_mem_per_chip: float
    collectives: Dict[str, int] = field(default_factory=dict)
    model_flops: float = 0.0           # 6·N·D analytic (global)
    note: str = ""

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / HW["peak_flops_bf16"]

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / HW["hbm_bw"]

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / HW["internode_bw"]

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global counted flops): remat and redundancy."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def model_flops_estimate(cfg, ishape) -> float:
    """MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N_active·D for
    decode and prefill. N counts active params (MoE) excluding
    embeddings' lookup."""
    n = cfg.active_param_count()
    if ishape.kind == "train":
        tokens = ishape.global_batch * ishape.seq_len
        return 6.0 * n * tokens
    if ishape.kind == "prefill":
        tokens = ishape.global_batch * ishape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * ishape.global_batch  # decode: one token per request


def analyze(cost, peak: float, *, arch: str, shape: str, mesh_name: str,
            chips: int, cfg=None, ishape=None, note: str = "") -> Roofline:
    """The record's terms from one rank's ``op_cost.Cost`` and its peak
    live bytes (the counterpart of the compiled program's memory
    analysis)."""
    colls = {k: int(v) for k, v in cost.per_collective.items()}
    coll = float(sum(colls.values()))
    nvlink = coll / HW["nvlink_bw"]
    note = (f"{note}; " if note else "") + \
        f"collective over NVLink alone: {nvlink:.3e} s"
    mf = model_flops_estimate(cfg, ishape) if cfg is not None else 0.0
    return Roofline(arch, shape, mesh_name, chips, cost.flops, cost.traffic,
                    coll, float(peak), colls, mf, note)


def format_table(rows: List[Roofline]) -> str:
    hdr = (f"{'arch':22s} {'shape':12s} {'mesh':10s} "
           f"{'compute_s':>10s} {'memory_s':>10s} {'coll_s':>10s} "
           f"{'dominant':>10s} {'useful%':>8s} {'mem/chip':>10s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        lines.append(
            f"{r.arch:22s} {r.shape:12s} {r.mesh:10s} "
            f"{r.compute_s:10.3e} {r.memory_s:10.3e} {r.collective_s:10.3e} "
            f"{r.dominant:>10s} {100*r.useful_flops_ratio:8.1f} "
            f"{r.peak_mem_per_chip/2**30:9.2f}G")
    return "\n".join(lines)
