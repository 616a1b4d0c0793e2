"""The paper's analytical performance model (§IV, Figs. 1, 4, 5).

A roofline/capacity model in the style the paper cites (LIFE): throughput
predicted from compute FLOPS, memory capacity, and memory bandwidth. The
paper does not publish its constants; every assumption here is explicit and
swept in benchmarks/bench_fig4.py. EXPERIMENTS.md §Fidelity records which
workload point recovers the headline 538.7x.

Key mechanics reproduced:
  * capacity: methods without KV reuse store (shared+unique) KV per request;
    reuse stores shared once (Fig. 1b left).
  * bandwidth: non-batched methods read the shared KV once *per request*
    per step (GEMV); batched methods (ChunkAttention prefixes, MoSKA any
    chunk) read each active chunk once *per step* (GEMM) — Fig. 1b right.
  * sparsity: routed methods (LongHeads, MoBA, MoSKA) read/compute only the
    routed fraction per request.
  * reuse also skips the shared-context *prefill*: non-reuse baselines pay
    a full 16M-token prefill per request — the dominant cost in
    high-sharing workloads and the main source of the paper's headline gap.
  * disaggregation (MoSKA): unique and shared work run on separate node
    pools and are limited independently.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional


# ---------------------------------------------------------------------------
# hardware / model / workload descriptions
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GPUSpec:
    name: str = "H200"
    mem_bytes: float = 141 * 2**30
    bw: float = 4.8e12
    flops_fp8: float = 1979e12
    flops_fp16: float = 989.5e12

    def flops(self, dtype: str) -> float:
        return self.flops_fp8 if dtype == "fp8" else self.flops_fp16


@dataclass(frozen=True)
class ClusterSpec:
    gpu: GPUSpec = field(default_factory=GPUSpec)
    gpus_per_node: int = 8
    num_nodes: int = 2

    @property
    def total_mem(self) -> float:
        return self.gpu.mem_bytes * self.gpus_per_node * self.num_nodes

    @property
    def total_bw(self) -> float:
        return self.gpu.bw * self.gpus_per_node * self.num_nodes

    def total_flops(self, dtype: str) -> float:
        return self.gpu.flops(dtype) * self.gpus_per_node * self.num_nodes

    def node_mem(self) -> float:
        return self.gpu.mem_bytes * self.gpus_per_node

    def node_bw(self) -> float:
        return self.gpu.bw * self.gpus_per_node

    def node_flops(self, dtype: str) -> float:
        return self.gpu.flops(dtype) * self.gpus_per_node


@dataclass(frozen=True)
class LLMSpec:
    """Llama 3.1 8B by default (the paper's model)."""
    name: str = "llama3.1-8b"
    num_layers: int = 32
    d_model: int = 4096
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    d_ff: int = 14336
    vocab: int = 128256
    params: float = 8.03e9

    def kv_bytes_per_token(self, dtype: str) -> float:
        itemsize = 1 if dtype == "fp8" else 2
        return 2 * self.num_layers * self.num_kv_heads * self.head_dim * itemsize

    def attn_flops_per_token(self, context: float) -> float:
        # scores (2*H*hd*ctx) + PV (2*H*hd*ctx), summed over layers
        return 4 * self.num_heads * self.head_dim * self.num_layers * context

    def linear_flops_per_token(self) -> float:
        return 2.0 * self.params


@dataclass(frozen=True)
class Workload:
    shared_tokens: float = 16 * 2**20
    unique_tokens: float = 64 * 2**10
    slo_tokens_per_s: float = 35.0
    output_tokens: float = 128.0     # generated tokens per request
    chunk_tokens: float = 2048.0
    dtype: str = "fp8"
    # fraction of the shared context that is a strict common PREFIX.
    # Prefix-matching systems (SGLang, ChunkAttention, FlashInfer) can only
    # reuse/batch this part (§II.B); MoSKA batches any identical chunk.
    prefix_fraction: float = 1.0
    # how much concurrent requests' routed chunk sets overlap (CAG domain
    # locality). 1.0: all requests hit the same keep_frac hot set; 0.0: iid.
    route_locality: float = 0.9
    # SLO slack tolerated before a batch point is declared infeasible
    slo_tolerance: float = 0.05


@dataclass(frozen=True)
class Method:
    """Feature flags per Table I."""
    name: str
    kv_reuse: bool            # shared KV stored once & prefill skipped
    shared_batched: bool      # GEMM batching of shared reads (read once/step)
    sparse: bool              # routed sparse attention (read keep_frac)
    disagg: bool              # dedicated unique/shared node pools
    keep_frac: float = 0.25   # paper: 75% sparsity


FLASH_ATTENTION = Method("FlashAttention", False, False, False, False)
SGLANG = Method("SGLang", True, False, False, False)
LONGHEADS = Method("LongHeads", False, False, True, False)
CHUNK_ATTENTION = Method("ChunkAttention", True, True, False, False)
MOSKA = Method("MoSKA", True, True, True, True)

METHODS = [FLASH_ATTENTION, SGLANG, LONGHEADS, CHUNK_ATTENTION, MOSKA]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@dataclass
class Point:
    method: str
    shared_tokens: float
    max_batch: int
    decode_rate: float          # achievable tokens/s/request at max_batch
    throughput: float           # aggregate effective tokens/s
    capacity_used: float        # bytes
    bw_bound: float             # steps/s bound from bandwidth
    compute_bound: float        # steps/s bound from compute
    throughput_amortized: float = 0.0  # incl. per-request prefill recompute
    unique_node_mfu: float = 0.0
    shared_node_mfu: float = 0.0
    unique_node_mem: float = 0.0
    shared_node_mem: float = 0.0
    unique_node_bw: float = 0.0
    shared_node_bw: float = 0.0


def _sharable_tokens(m: Method, w: Workload) -> float:
    """Tokens of shared context this method can actually reuse/batch.

    MoSKA's chunk registry is position-independent within the corpus; prefix
    systems reuse only the strict common prefix (§II.B). The remainder
    behaves like additional *unique* context for them.
    """
    if m.name == "MoSKA":
        return w.shared_tokens
    return w.shared_tokens * w.prefix_fraction


def _effective_unique(m: Method, w: Workload) -> float:
    return w.unique_tokens + (w.shared_tokens - _sharable_tokens(m, w)
                              if m.kv_reuse else 0.0)


def _capacity_bytes(m: Method, b: int, llm: LLMSpec, w: Workload,
                    cluster: ClusterSpec) -> float:
    kvb = llm.kv_bytes_per_token(w.dtype)
    weights = llm.params * (1 if w.dtype == "fp8" else 2) * cluster.num_nodes
    if m.kv_reuse:
        unique = b * _effective_unique(m, w) * kvb
        shared = _sharable_tokens(m, w) * kvb   # stored once
    else:
        unique = b * w.unique_tokens * kvb
        shared = b * w.shared_tokens * kvb      # per request
    return weights + unique + shared


def _union_fraction(frac: float, locality: float, b: int) -> float:
    """Fraction of chunks touched by >=1 of b requests routing to ``frac``."""
    if frac >= 1.0:
        return 1.0
    iid = 1.0 - (1.0 - frac) ** b
    return frac + (1.0 - locality) * (iid - frac)


def _decode_step_bytes(m: Method, b: int, llm: LLMSpec, w: Workload):
    """(unique_bytes, shared_bytes) read from memory per decode step."""
    kvb = llm.kv_bytes_per_token(w.dtype)
    frac = m.keep_frac if m.sparse else 1.0
    sharable = _sharable_tokens(m, w)
    if m.kv_reuse:
        unique = b * _effective_unique(m, w) * kvb
    else:
        # non-reuse methods still read their private copy of everything
        unique = b * (w.unique_tokens + frac * w.shared_tokens) * kvb
        sharable = 0.0
    if m.shared_batched and sharable > 0:
        union = _union_fraction(frac, w.route_locality, b)
        shared = union * sharable * kvb         # each active chunk read once
    else:
        shared = b * frac * sharable * kvb      # per-request GEMV re-reads
    # weights are also streamed once per step (FFN/projections)
    weights = llm.params * (1 if w.dtype == "fp8" else 2)
    return unique + weights, shared


def _decode_step_flops(m: Method, b: int, llm: LLMSpec, w: Workload):
    frac = m.keep_frac if m.sparse else 1.0
    unique = b * (llm.attn_flops_per_token(w.unique_tokens)
                  + llm.linear_flops_per_token())
    shared = b * llm.attn_flops_per_token(frac * w.shared_tokens)
    return unique, shared


def _decode_rate(m: Method, b: int, llm: LLMSpec, w: Workload,
                 cluster: ClusterSpec):
    """steps/s achievable at batch b, plus the individual bounds."""
    ub, sb = _decode_step_bytes(m, b, llm, w)
    uf, sf = _decode_step_flops(m, b, llm, w)
    if m.disagg:
        # unique pool: num_nodes-1 nodes... the paper dedicates 1 node each
        u_nodes = max(cluster.num_nodes - 1, 1)
        s_nodes = 1
        bw_bound = min(u_nodes * cluster.node_bw() / max(ub, 1e-9),
                       s_nodes * cluster.node_bw() / max(sb, 1e-9))
        fl_bound = min(u_nodes * cluster.node_flops(w.dtype) / max(uf, 1e-9),
                       s_nodes * cluster.node_flops(w.dtype) / max(sf, 1e-9))
    else:
        bw_bound = cluster.total_bw / max(ub + sb, 1e-9)
        fl_bound = cluster.total_flops(w.dtype) / max(uf + sf, 1e-9)
    return min(bw_bound, fl_bound), bw_bound, fl_bound


def _prefill_seconds(m: Method, llm: LLMSpec, w: Workload,
                     cluster: ClusterSpec) -> float:
    """Per-request prefill cost. Reuse methods only prefill the contexts
    they cannot cache; others recompute the shared context too."""
    if m.kv_reuse:
        tokens = _effective_unique(m, w)
    else:
        tokens = w.unique_tokens + w.shared_tokens
    flops = tokens * (llm.linear_flops_per_token()
                      + llm.attn_flops_per_token(tokens / 2.0))
    eff = 0.5  # sustained prefill efficiency
    return flops / (cluster.total_flops(w.dtype) * eff)


def _capacity_batch(m: Method, llm: LLMSpec, w: Workload,
                    cluster: ClusterSpec) -> int:
    kvb = llm.kv_bytes_per_token(w.dtype)
    if m.disagg:
        # unique KV on the unique pool; shared store on the shared pool
        u_nodes = max(cluster.num_nodes - 1, 1)
        u_mem = u_nodes * cluster.node_mem() - llm.params
        spill = max(_sharable_tokens(m, w) * kvb - cluster.node_mem(), 0.0)
        per_req = _effective_unique(m, w) * kvb
        return max(int((u_mem - spill) // per_req), 0)
    lo, hi = 0, 1
    while (_capacity_bytes(m, hi, llm, w, cluster) <= cluster.total_mem
           and hi < 10**7):
        lo, hi = hi, hi * 2
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if _capacity_bytes(m, mid, llm, w, cluster) <= cluster.total_mem:
            lo = mid
        else:
            hi = mid
    return lo


def _max_batch(m: Method, llm: LLMSpec, w: Workload,
               cluster: ClusterSpec) -> int:
    """Largest batch with (a) KV fitting in memory, (b) decode meeting SLO
    (within tolerance). rate(b) is monotone non-increasing: binary search."""
    cap_b = _capacity_batch(m, llm, w, cluster)
    if cap_b == 0:
        return 0
    slo = w.slo_tokens_per_s * (1.0 - w.slo_tolerance)

    def ok(b):
        return _decode_rate(m, b, llm, w, cluster)[0] >= slo

    if ok(cap_b):
        return cap_b
    if not ok(1):
        return 0
    lo, hi = 1, cap_b
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo


def evaluate(m: Method, llm: LLMSpec, w: Workload,
             cluster: ClusterSpec) -> Point:
    b = _max_batch(m, llm, w, cluster)
    if b == 0:
        return Point(m.name, w.shared_tokens, 0, 0.0, 0.0,
                     _capacity_bytes(m, 1, llm, w, cluster), 0.0, 0.0)
    rate, bw_bound, fl_bound = _decode_rate(m, b, llm, w, cluster)
    rate = min(rate, w.slo_tokens_per_s)
    # primary (Fig. 4) metric: steady-state decode throughput
    thr = b * rate
    # secondary: amortized over per-request prefill recomputation
    t_pre = _prefill_seconds(m, llm, w, cluster)
    t_dec = w.output_tokens / rate
    thr_am = b * w.output_tokens / (t_pre + t_dec)

    p = Point(m.name, w.shared_tokens, b, rate, thr,
              _capacity_bytes(m, b, llm, w, cluster), bw_bound, fl_bound,
              throughput_amortized=thr_am)

    # node-level utilization (Fig. 5)
    kvb = llm.kv_bytes_per_token(w.dtype)
    ub, sb = _decode_step_bytes(m, b, llm, w)
    uf, sf = _decode_step_flops(m, b, llm, w)
    node_mem = cluster.node_mem()
    u_nodes = max(cluster.num_nodes - 1, 1) if m.disagg else cluster.num_nodes
    p.unique_node_mem = (b * _effective_unique(m, w) * kvb + llm.params) / (
        u_nodes * node_mem)
    p.shared_node_mem = min(_sharable_tokens(m, w) * kvb / node_mem, 1.0)
    p.unique_node_bw = rate * ub / (u_nodes * cluster.node_bw())
    p.shared_node_bw = rate * sb / cluster.node_bw()
    p.unique_node_mfu = rate * uf / (u_nodes * cluster.node_flops(w.dtype))
    # shared-node MFU: kernel-level roofline utilization of the batched GEMM
    # (operational intensity vs ridge point; see DESIGN.md)
    kv_read = sb if sb > 0 else 1.0
    intensity = sf / kv_read
    ridge = cluster.gpu.flops(w.dtype) / cluster.gpu.bw
    p.shared_node_mfu = min(1.0, intensity / ridge) * 0.85
    return p


def sweep_shared_context(methods: List[Method] = METHODS,
                         shared_grid: Optional[List[float]] = None,
                         llm: LLMSpec = LLMSpec(),
                         w: Workload = Workload(),
                         cluster: ClusterSpec = ClusterSpec()
                         ) -> Dict[str, List[Point]]:
    """Fig. 4: batch capability + throughput vs shared context size."""
    if shared_grid is None:
        shared_grid = [m * 2**20 for m in (1, 2, 4, 8, 16)]
    out: Dict[str, List[Point]] = {}
    for m in methods:
        pts = []
        for s in shared_grid:
            pts.append(evaluate(m, llm, dataclasses.replace(
                w, shared_tokens=s), cluster))
        out[m.name] = pts
    return out


def utilization_vs_batch(m: Method, batches: List[int],
                         llm: LLMSpec = LLMSpec(), w: Workload = Workload(),
                         cluster: ClusterSpec = ClusterSpec()) -> List[Point]:
    """Fig. 5: force batch sizes, report node utilization."""
    pts = []
    for b in batches:
        rate, bw_bound, fl_bound = _decode_rate(m, b, llm, w, cluster)
        rate = min(rate, w.slo_tokens_per_s)
        p = Point(m.name, w.shared_tokens, b, rate, b * rate,
                  _capacity_bytes(m, b, llm, w, cluster), bw_bound, fl_bound)
        kvb = llm.kv_bytes_per_token(w.dtype)
        ub, sb = _decode_step_bytes(m, b, llm, w)
        uf, sf = _decode_step_flops(m, b, llm, w)
        u_nodes = max(cluster.num_nodes - 1, 1)
        p.unique_node_mem = min((b * w.unique_tokens * kvb + llm.params)
                                / (u_nodes * cluster.node_mem()), 1.0)
        p.shared_node_mem = min(w.shared_tokens * kvb / cluster.node_mem(),
                                1.0)
        p.unique_node_bw = min(rate * ub / (u_nodes * cluster.node_bw()), 1.0)
        p.shared_node_bw = min(rate * sb / cluster.node_bw(), 1.0)
        p.unique_node_mfu = rate * uf / (u_nodes * cluster.node_flops(w.dtype))
        intensity = sf / max(sb, 1.0)
        ridge = cluster.gpu.flops(w.dtype) / cluster.gpu.bw
        p.shared_node_mfu = min(1.0, intensity / ridge) * 0.85
        pts.append(p)
    return pts


def kv_cache_size_fig1a(seq_lens: List[int], llm: LLMSpec = LLMSpec()
                        ) -> Dict[str, List[float]]:
    """Fig. 1a: normalized KV size under common optimization stacks."""
    base = [2 * llm.num_layers * llm.num_heads * llm.head_dim * 2 * s
            for s in seq_lens]  # MHA fp16
    gqa = [b * llm.num_kv_heads / llm.num_heads for b in base]
    gqa_q = [g / 2 for g in gqa]                     # + int8 KV
    gqa_q_sparse = [g * 1.0 for g in gqa_q]          # sparsity: same storage
    return {"MHA fp16": base, "+GQA": gqa, "+quant int8": gqa_q,
            "+sparse (storage unchanged)": gqa_q_sparse}


def bandwidth_scaling_fig1b(batches: List[int], llm: LLMSpec = LLMSpec(),
                            w: Workload = Workload()) -> Dict[str, List[float]]:
    """Fig. 1b: capacity & bandwidth requirement scaling with batch."""
    kvb = llm.kv_bytes_per_token(w.dtype)
    ctx = w.shared_tokens
    return {
        "capacity_no_share": [b * ctx * kvb for b in batches],
        "capacity_shared": [ctx * kvb for _ in batches],
        "bandwidth_no_share": [b * ctx * kvb * w.slo_tokens_per_s
                               for b in batches],
        "bandwidth_shared_gemv": [b * ctx * kvb * w.slo_tokens_per_s
                                  for b in batches],
        "bandwidth_shared_gemm": [ctx * kvb * w.slo_tokens_per_s
                                  for _ in batches],
    }


def size_host_pool_blocks(workset_tokens: float, block_size: int,
                          device_pool_blocks: Optional[int] = None,
                          active_tokens: float = 0.0) -> int:
    """Host-tier sizing heuristic (``--host-pool-blocks auto``).

    The host pool's job is to keep the *prefix working set* — the corpus
    of distinct (corpus, prompt) prefixes the request stream revisits —
    swappable instead of rebuilt. The capacity-model view: the two tiers
    together should hold the working set, so the host tier needs whatever
    the device pool cannot keep resident once the *active* requests'
    unique KV has claimed its share.

      host_blocks = ceil(workset / bs)
                    - max(device_blocks - 1 - ceil(active / bs), 0)

    (the -1 is the reserved null block). With an elastic device pool
    (``device_pool_blocks=None``) the device side grows on demand and
    evicts only under an explicit memory budget, so the conservative
    answer is the full working set — host capacity is cheap relative to
    HBM, and oversizing costs only host RAM.
    """
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    workset_blocks = math.ceil(max(workset_tokens, 0.0) / block_size)
    if device_pool_blocks is None:
        return workset_blocks
    active_blocks = math.ceil(max(active_tokens, 0.0) / block_size)
    device_resident = max(device_pool_blocks - 1 - active_blocks, 0)
    return max(workset_blocks - device_resident, 0)


def headline_gain(llm: LLMSpec = LLMSpec(), w: Workload = Workload(),
                  cluster: ClusterSpec = ClusterSpec()) -> Dict[str, float]:
    """Max MoSKA gain over each baseline across the Fig. 4 sweep."""
    res = sweep_shared_context(llm=llm, w=w, cluster=cluster)
    moska = {p.shared_tokens: p.throughput for p in res["MoSKA"]}
    gains = {}
    for name, pts in res.items():
        if name == "MoSKA":
            continue
        g = 0.0
        for p in pts:
            if p.throughput > 0:
                g = max(g, moska[p.shared_tokens] / p.throughput)
            elif moska[p.shared_tokens] > 0:
                g = math.inf
        gains[name] = g
    return gains
