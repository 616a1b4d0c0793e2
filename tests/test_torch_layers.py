"""Parity of the port's ``models/layers.py`` with the reference package's,
on the CPU: the same numpy inputs through both, fp32 within 2e-5 and bf16
within 2e-2."""
import numpy as np
import pytest

from repro.models import layers as JL
from repro_torch.models import layers as TL
from torch_parity import assert_close, both, randn

DTYPES = ["float32", "bfloat16"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm(dtype):
    xj, xt = both(randn(0, (2, 5, 32), 3.0), dtype)
    sj, st = both(randn(1, (32,), 0.1), dtype)
    assert_close(TL.rms_norm(xt, st, 1e-5), JL.rms_norm(xj, sj, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos_shape", [(7,), (2, 7)])
def test_apply_rope_split_half(dtype, pos_shape):
    xj, xt = both(randn(2, (2, 7, 4, 16)), dtype)
    pos = np.random.default_rng(3).integers(0, 5000, pos_shape)
    pj, pt = both(pos)
    assert_close(TL.apply_rope(xt, pt, 10000.0),
                 JL.apply_rope(xj, pj, 10000.0), dtype)


@pytest.mark.parametrize("bias", [False, True])
def test_qkv_project_and_swiglu(bias):
    d, H, KH, D, f = 32, 4, 2, 8, 48
    names = {"wq": (d, H * D), "wk": (d, KH * D), "wv": (d, KH * D)}
    if bias:
        names.update(bq=(H * D,), bk=(KH * D,), bv=(KH * D,))
    pj, pt = {}, {}
    for i, (n, shape) in enumerate(names.items()):
        pj[n], pt[n] = both(randn(10 + i, shape, 0.2))
    xj, xt = both(randn(4, (3, 5, d)))
    for a, b in zip(TL.qkv_project(xt, pt, H, KH, D),
                    JL.qkv_project(xj, pj, H, KH, D)):
        assert a.shape == b.shape
        assert_close(a, b)
    mj, mt = {}, {}
    for i, (n, shape) in enumerate({"w_gate": (d, f), "w_up": (d, f),
                                    "w_down": (f, d)}.items()):
        mj[n], mt[n] = both(randn(20 + i, shape, 0.2))
    assert_close(TL.swiglu_mlp(xt, mt), JL.swiglu_mlp(xj, mj))


FLASH_CASES = [
    # Sq, Sk, H, KH, causal, q_offset, kv_offset, kv_len, window, block_k
    (20, 20, 4, 2, True, 0, 0, None, 0, 8),      # ragged last key block
    (16, 16, 4, 4, False, 0, 0, None, 0, 16),    # non-causal, MHA
    (5, 24, 4, 1, True, 19, 0, 24, 0, 8),        # chunk against a context
    (12, 12, 4, 2, True, 7, 7, 10, 0, 4),        # kv_len masks the tail
    (20, 20, 8, 2, True, 3, 3, None, 6, 8),      # sliding window
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("Sq,Sk,H,KH,causal,qo,ko,kv_len,window,bk",
                         FLASH_CASES)
def test_flash_attention(dtype, Sq, Sk, H, KH, causal, qo, ko, kv_len,
                         window, bk):
    D = 16
    qj, qt = both(randn(5, (2, Sq, H, D)), dtype)
    kj, kt = both(randn(6, (2, Sk, KH, D)), dtype)
    vj, vt = both(randn(7, (2, Sk, KH, D)), dtype)
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko, kv_len=kv_len,
              window=window, block_k=bk, return_lse=True)
    o2, l2 = JL.flash_attention(qj, kj, vj, **kw)
    # the port also blocks over queries: cut them into ragged blocks too
    o1, l1 = TL.flash_attention(qt, kt, vt, block_q=6, **kw)
    assert o1.dtype == qt.dtype and o1.shape == qt.shape
    assert_close(o1, o2, dtype)
    assert_close(l1, l2, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,KH,window", [(4, 4, 0), (8, 2, 0), (8, 2, 5)])
def test_decode_attention(dtype, H, KH, window):
    B, S, D = 3, 24, 16
    qj, qt = both(randn(8, (B, H, D)), dtype)
    kj, kt = both(randn(9, (B, S, KH, D)), dtype)
    vj, vt = both(randn(10, (B, S, KH, D)), dtype)
    lj, lt = both(np.array([1, 13, 24], np.int32))
    o1, l1 = TL.decode_attention(qt, kt, vt, lt, window=window,
                                 return_lse=True)
    o2, l2 = JL.decode_attention(qj, kj, vj, lj, window=window,
                                 return_lse=True)
    assert_close(o1, o2, dtype)
    assert_close(l1, l2, dtype)
    assert_close(TL.decode_attention(qt, kt, vt, lt, window=window), o2,
                 dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", [2, 3])
def test_merge_partial_attention(dtype, P):
    outs, lses = [], []
    for p in range(P):
        outs.append(both(randn(11 + p, (2, 5, 4, 16)), dtype))
        lse = randn(21 + p, (2, 5, 4), 3.0)
        lse[0, 0] = -1e30                       # a partial that saw nothing
        lses.append(both(lse))
    o1, l1 = TL.merge_partial_attention([o[1] for o in outs],
                                        [l[1] for l in lses])
    o2, l2 = JL.merge_partial_attention([o[0] for o in outs],
                                        [l[0] for l in lses])
    assert o1.shape == (2, 5, 4, 16) and l1.shape == (2, 5, 4)
    assert_close(o1, o2, dtype)
    assert_close(l1, l2)
