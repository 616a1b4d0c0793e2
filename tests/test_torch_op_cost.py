"""The port's cost counter (``repro_torch.launch.op_cost``) against the
reference's HLO coster (``repro.launch.hlo_cost``) on the functions of
``tests/test_hlo_cost.py``, the tensor-parallel trap it exists for (a
``FlopCounterMode`` over ``DTensor`` products counts the global shapes),
the kernels' work (``kernels/work.py``) against ``FlopCounterMode`` over
their plain versions, and the wrappers' fake-tensor branch."""
import contextlib

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro.launch.hlo_cost import analyze_hlo
from repro_torch.kernels import ops, ref, work
from repro_torch.launch.op_cost import OpCounter, analyze_ops


def _hlo(f, *args):
    return analyze_hlo(jax.jit(f).lower(*args).compile().as_text())


@pytest.mark.parametrize("L", [2, 16])
def test_layer_loop_equals_the_scan_of_the_reference(L):
    def f(x, ws):
        def body(c, w):
            return jnp.tanh(c @ w), None
        y, _ = jax.lax.scan(body, x, ws)
        return y
    want = _hlo(f, jax.ShapeDtypeStruct((128, 128), jnp.float32),
                jax.ShapeDtypeStruct((L, 128, 128), jnp.float32))

    def g(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x
    got, _ = analyze_ops(g, torch.randn(128, 128), torch.randn(L, 128, 128))
    assert got.flops == pytest.approx(want.flops, rel=0.01)
    assert got.flops == 2 * 128**3 * L


def test_nested_loops_equal_the_nested_scans():
    def f(x, ws):
        def outer(c, w):
            def inner(c2, _):
                return jnp.tanh(c2 @ w), None
            c2, _ = jax.lax.scan(inner, c, None, length=3)
            return c2, None
        y, _ = jax.lax.scan(outer, x, ws)
        return y
    want = _hlo(f, jax.ShapeDtypeStruct((64, 64), jnp.float32),
                jax.ShapeDtypeStruct((4, 64, 64), jnp.float32))

    def g(x, ws):
        for w in ws:
            for _ in range(3):
                x = torch.tanh(x @ w)
        return x
    got, _ = analyze_ops(g, torch.randn(64, 64), torch.randn(4, 64, 64))
    assert got.flops == pytest.approx(want.flops, rel=0.01)


def test_rectangular_dot():
    want = _hlo(lambda a, b: a @ b,
                jax.ShapeDtypeStruct((64, 256), jnp.float32),
                jax.ShapeDtypeStruct((256, 32), jnp.float32))
    got, _ = analyze_ops(lambda a, b: a @ b, torch.randn(64, 256),
                         torch.randn(256, 32))
    assert got.flops == want.flops == 2 * 64 * 256 * 32
    # the operands and the output
    assert got.traffic == 4 * (64 * 256 + 256 * 32 + 64 * 32)


@contextlib.contextmanager
def _fake_world(n):
    from repro_torch.launch.mesh import init_fake_world
    init_fake_world(n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_all_reduce_bytes_equal_the_reference():
    hlo = """
HloModule m
ENTRY %main (y: bf16[32]) -> bf16[32] {
  %y = bf16[32]{0} parameter(0)
  ROOT %ar.1 = bf16[32]{0} all-reduce(%y), to_apply=%sum
}
"""
    want = analyze_hlo(hlo)
    with _fake_world(4):
        t = torch.zeros(32, dtype=torch.bfloat16)
        got, _ = analyze_ops(lambda: dist.all_reduce(t))
    assert got.per_collective == {"all-reduce": 64.0}
    assert got.collective == want.collective == 64


def test_dtensor_products_count_the_local_shapes():
    """x (2,048 x 4,096) by rows over data, w1 (4,096 x 16,384) by columns
    over model, w2 by rows: one rank's products are (128, 4,096) x (4,096,
    1,024) and (128, 1,024) x (1,024, 4,096), 2.147e9 FLOPs, and one
    all-reduce of the (128, 4,096) fp32 partial sums."""
    from repro_torch.launch.mesh import make_production_mesh
    with _fake_world(256):
        mesh = make_production_mesh(device="cpu")
        _dtensor_mlp(mesh)


def _dtensor_mlp(mesh):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    with FakeTensorMode():
        x = distribute_tensor(torch.randn(2048, 4096), mesh,
                              [Shard(0), Replicate()])
        w1 = distribute_tensor(torch.randn(4096, 16384), mesh,
                               [Replicate(), Shard(1)])
        w2 = distribute_tensor(torch.randn(16384, 4096), mesh,
                               [Replicate(), Shard(0)])

        def mlp():
            y = (x @ w1) @ w2
            return y.redistribute(mesh, [Shard(0), Replicate()])
        got, _ = analyze_ops(mlp)
        with FlopCounterMode(display=False) as plain:
            mlp()
    local = 2 * 128 * 4096 * 1024 * 2
    assert local == 2147483648
    assert got.flops == local
    assert got.per_collective == {"all-reduce": 128 * 4096 * 4.0}
    # the trap: a plain counter counts the global products
    assert plain.get_total_flops() != local
    assert plain.get_total_flops() >= 2 * 2048 * 4096 * 16384 * 2


def _kernel_args(name, s):
    """Inputs of each kernel at shape set ``s``, every dispatch slot valid
    and every cache full (the count without data)."""
    E, cap, H, KH, D, C, B, S = s
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g)
    if name == "shared_chunk_attention":
        return (r(E, cap, H, D), r(E, C, KH, D), r(E, C, KH, D),
                torch.ones(E, cap, dtype=torch.bool))
    if name == "shared_chunk_attention_q8":
        q8 = torch.randint(-127, 127, (E, C, KH, D), dtype=torch.int8,
                           generator=g)
        return (r(E, cap, H, D), q8, q8.clone(), r(E, C, KH).abs(),
                r(E, C, KH).abs(), torch.ones(E, cap, dtype=torch.bool))
    if name == "decode_attention":
        return (r(B, H, D), r(B, S, KH, D), r(B, S, KH, D),
                torch.full((B,), S, dtype=torch.int32))
    if name == "shared_tail_attention":
        return (r(B, H, D), r(S, KH, D), r(S, KH, D),
                torch.zeros(B, dtype=torch.int32))
    if name == "paged_decode_attention":
        bs, M = 16, S // 16
        table = torch.arange(B * M, dtype=torch.int32).view(B, M)
        return (r(B, H, D), r(B * M, bs, KH, D), r(B * M, bs, KH, D), table,
                torch.full((B,), S, dtype=torch.int32))
    return (r(B, H, D), r(E, KH, D))                    # router_scores


SHAPES = [(4, 8, 8, 2, 16, 32, 3, 64), (6, 16, 12, 4, 32, 64, 5, 96)]
PRODUCT_KERNELS = ("shared_chunk_attention", "shared_chunk_attention_q8",
                   "decode_attention", "paged_decode_attention",
                   "router_scores", "shared_tail_attention")


@pytest.mark.parametrize("s", SHAPES, ids=["small", "larger"])
@pytest.mark.parametrize("name", PRODUCT_KERNELS)
def test_kernel_work_equals_the_plain_versions_products(name, s):
    args = _kernel_args(name, s)
    with FlopCounterMode(display=False) as fc:
        getattr(ref, f"{name}_ref")(*args)
    flops, byts = work.WORK[name](*args)
    assert flops == fc.get_total_flops() > 0
    assert byts > 0


def test_merges_multiply_no_matrices():
    outs, lses = torch.randn(3, 5, 4, 8), torch.randn(3, 5, 4)
    with FlopCounterMode(display=False) as fc:
        ref.lse_merge_ref(outs, lses)
    assert fc.get_total_flops() == 0
    assert work.lse_merge(outs, lses) == (0.0, float(
        4 * (outs.numel() + lses.numel() + outs[0].numel()
             + lses[0].numel())))


def test_fake_tensors_report_their_work_and_real_ones_compute():
    args = _kernel_args("decode_attention", SHAPES[0])
    heard = []
    work._listeners.append(lambda *a: heard.append(a))
    try:
        out, lse = ops.decode_attention(*args)            # real: computed
        assert not heard and torch.isfinite(out).all()
        with FakeTensorMode() as mode:
            fake = [mode.from_tensor(a) for a in args]
            fo, fl = ops.decode_attention(*fake)
        assert fo.shape == out.shape and fl.shape == lse.shape
        assert fo.dtype == out.dtype and fl.dtype == torch.float32
        assert heard == [("decode_attention",
                          *work.decode_attention(*args))]
    finally:
        work._listeners.clear()
    assert ops.decode_attention.launches == 0


def test_counter_takes_the_kernels_and_the_peak():
    args = _kernel_args("shared_chunk_attention", SHAPES[1])
    with FakeTensorMode() as mode:
        fake = [mode.from_tensor(a) for a in args]
        cost, peak = analyze_ops(ops.shared_chunk_attention, *fake)
    flops, byts = work.shared_chunk_attention(*args)
    assert cost.flops == flops and cost.traffic == byts
    arg_bytes = sum(a.numel() * a.element_size() for a in args)
    qd = args[0]
    out_bytes = qd.numel() * 4 + qd.shape[0] * qd.shape[1] * qd.shape[2] * 4
    assert peak == arg_bytes + out_bytes


def test_counter_leaves_the_propagator_as_it_was():
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    before = ShardingPropagator._propagate_tensor_meta_non_cached
    with OpCounter():
        assert ShardingPropagator._propagate_tensor_meta_non_cached \
            is not before
    assert ShardingPropagator._propagate_tensor_meta_non_cached is before
