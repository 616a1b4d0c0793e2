"""Parity of the port's slotted unique-KV cache with the reference's on the
CPU. The port writes in place; the reference returns new arrays. Both must
hold the same values after the same writes, including the clamp of an
append at ``max_seq`` (an idle slot that keeps advancing writes at
``max_seq - 1``, as ``dynamic_update_slice`` clamps its start)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kvcache import cache as jc
from repro_torch.kvcache import cache as tc
from torch_parity import both, randn

L, B, S, KH, D = 2, 3, 8, 2, 4


def _exact(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32),
                                  np.asarray(b, np.float32))


def _pair(dtype="float32"):
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return (jc.init_kv_cache(L, B, S, KH, D, jd),
            tc.init_kv_cache(L, B, S, KH, D, td))


def _same(cj, ct):
    _exact(ct.k.float().numpy(), cj.k)
    _exact(ct.v.float().numpy(), cj.v)
    _exact(ct.length.numpy(), cj.length)
    _exact(ct.offset.numpy(), cj.offset)


def test_init_and_properties():
    cj, ct = _pair()
    _same(cj, ct)
    assert ct.max_seq == cj.max_seq == S
    assert ct.k.dtype == torch.float32 and ct.length.dtype == torch.int32
    assert ct.nbytes == 2 * L * B * S * KH * D * 4 + 2 * B * 4
    _exact(ct.positions.numpy(), cj.positions)


def test_write_prefix_in_place():
    cj, ct = _pair()
    kj, kt = both(randn(1, (B, 5, KH, D)))
    vj, vt = both(randn(2, (B, 5, KH, D)))
    k2, v2 = jc.write_prefix(cj.k[0], cj.v[0], kj, vj)
    ptr = ct.k.data_ptr()
    tc.write_prefix(ct.k[0], ct.v[0], kt, vt)
    assert ct.k.data_ptr() == ptr
    _exact(ct.k[0].numpy(), k2)
    _exact(ct.v[0].numpy(), v2)


@pytest.mark.parametrize("lengths", [[0, 3, 7], [8, 9, 2], [7, 8, 12]])
def test_append_token_clamps_at_max_seq(lengths):
    cj, ct = _pair()
    kj, kt = both(randn(3, (B, S, KH, D)))
    vj, vt = both(randn(4, (B, S, KH, D)))
    kl_j, vl_j = kj, vj
    ct.k[0].copy_(kt)
    ct.v[0].copy_(vt)
    nj, nt = both(randn(5, (B, KH, D)))
    mj, mt = both(randn(6, (B, KH, D)))
    lj, lt = both(np.asarray(lengths, np.int32))
    kl_j, vl_j = jc.append_token(kl_j, vl_j, nj, mj, lj)
    tc.append_token(ct.k[0], ct.v[0], nt, mt, lt)
    _exact(ct.k[0].numpy(), kl_j)
    _exact(ct.v[0].numpy(), vl_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_new,true_len", [(8, None), (4, 3), (8, 5)])
def test_write_slot_prefix_and_read_slot(dtype, S_new, true_len):
    cj, ct = _pair(dtype)
    # stale contents in every slot, which the write must not leak
    stale = randn(7, (L, B, S, KH, D))
    sj, st = both(stale, dtype)
    cj = jc.KVCache(sj, sj, cj.length + 6, cj.offset + 1)
    ct.k.copy_(st)
    ct.v.copy_(st)
    ct.length.fill_(6)
    ct.offset.fill_(1)
    pj, pt = both(randn(8, (L, 1, S_new, KH, D)), dtype)
    slot_j = jc.KVCache(pj, pj * 2, jnp.full((1,), S_new, jnp.int32),
                        jnp.full((1,), 50, jnp.int32))
    slot_t = tc.KVCache(pt, pt * 2, torch.full((1,), S_new, dtype=torch.int32),
                        torch.full((1,), 50, dtype=torch.int32))
    cj = jc.write_slot_prefix(cj, slot_j, 1, true_len)
    tc.write_slot_prefix(ct, slot_t, 1, true_len)
    _same(cj, ct)
    rj, rt = jc.read_slot(cj, 1), tc.read_slot(ct, 1)
    _same(rj, rt)
    with pytest.raises(ValueError):
        big = tc.init_kv_cache(L, 1, S + 1, KH, D)
        tc.write_slot_prefix(ct, big, 0)
