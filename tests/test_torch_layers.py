"""Parity of the port's ``models/layers.py`` with the reference package's,
on the CPU: the same numpy inputs through both, fp32 within 2e-5 and bf16
within 2e-2."""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models import layers as JL
from repro_torch import obs
from repro_torch.kernels import ref as tref
from repro_torch.kernels import work
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


# Who computes flash_attention, by what its inputs show: label, dtype of
# q/k/v, head dim, device, inputs that require grad, grad mode, kv_len,
# whether the kernel takes them
KERNEL_RULE = [
    ("bf16 on the card", torch.bfloat16, 128, "cuda", False, True, None,
     True),
    ("D 64, an int kv_len", torch.bfloat16, 64, "cuda", False, True, 12,
     True),
    ("grad inputs under no_grad", torch.bfloat16, 128, "cuda", True, False,
     None, True),
    ("fp32", torch.float32, 128, "cuda", False, True, None, False),
    ("a head dim with no build", torch.bfloat16, 32, "cuda", False, True,
     None, False),
    ("autograd", torch.bfloat16, 128, "cuda", True, True, None, False),
    ("the CPU", torch.bfloat16, 128, "cpu", False, True, None, False),
    ("the CPU under autograd", torch.float32, 64, "cpu", True, True, None,
     False),
    ("a tensor kv_len", torch.bfloat16, 64, "cuda", False, True, "tensor",
     False),
]


@pytest.mark.parametrize("label,dtype,D,device,grad,mode,kv_len,kernel",
                         KERNEL_RULE, ids=[c[0] for c in KERNEL_RULE])
def test_flash_attention_takes_the_kernel_by_what_its_inputs_show(
        label, dtype, D, device, grad, mode, kv_len, kernel):
    """Fake tensors, so no card is needed: the rule's answer, and where a
    fake can run it (the kernel's entry reports its work and computes
    nothing; the plain version runs on the CPU's fakes) the call, which
    counts itself in the registry under who computed it."""
    reg = obs.MetricsRegistry()
    prev = obs.set_registry(reg)
    try:
        with FakeTensorMode(), torch.set_grad_enabled(mode):
            q = torch.empty(2, 20, 8, D, dtype=dtype, device=device,
                            requires_grad=grad)
            k, v = (torch.empty(2, 20, 2, D, dtype=dtype, device=device,
                                requires_grad=grad) for _ in range(2))
            n = torch.tensor(12) if kv_len == "tensor" else kv_len
            assert TL._takes_kernel(q, k, v, n) == kernel
            if kernel or device == "cpu":
                out, lse = TL.flash_attention(q, k, v, kv_len=n, q_offset=3,
                                              kv_offset=3, return_lse=True)
                assert out.shape == q.shape and out.dtype == dtype
                assert lse.shape == q.shape[:3]
                assert lse.dtype == torch.float32
                assert reg.counter(TL.KERNEL_CALLS).value == int(kernel)
                assert reg.counter(TL.PLAIN_CALLS).value == int(not kernel)
    finally:
        obs.set_registry(prev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Sq,Sk,H,KH,causal,qo,ko,kv_len,window,bk",
                         FLASH_CASES)
def test_flash_attention_on_the_cpu_is_the_blocked_einsum_bit_for_bit(
        dtype, Sq, Sk, H, KH, causal, qo, ko, kv_len, window, bk):
    """On the CPU, fp32 or bf16, with autograd, flash_attention is the
    plain version (``kernels/ref.py``), outputs and gradients equal."""
    D = 16
    _, q = both(randn(5, (2, Sq, H, D)), str(dtype)[6:])
    _, k = both(randn(6, (2, Sk, KH, D)), str(dtype)[6:])
    _, v = both(randn(7, (2, Sk, KH, D)), str(dtype)[6:])
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko, kv_len=kv_len,
              window=window)
    got, want = [], []
    for fn, sink in ((lambda *a: TL.flash_attention(
            *a, block_k=bk, block_q=6, return_lse=True, **kw), got),
                     (lambda *a: tref.flash_prefill_attention_ref(
                         *a, block_q=6, block_k=bk, **kw), want)):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out, lse = fn(*leaves)
        (out.float().sum() + lse.sum()).backward()
        sink += [out, lse] + [t.grad for t in leaves]
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Sq,Sk,H,KH,causal,qo,ko,kv_len,window,bk",
                         FLASH_CASES + [(9, 9, 2, 1, True, 0, 4, None, 0, 4),
                                        (6, 8, 2, 1, True, 0, 0, 0, 0, 4)])
def test_prefill_kernel_work_counts_the_valid_pairs(Sq, Sk, H, KH, causal,
                                                    qo, ko, kv_len, window,
                                                    bk):
    """``work.flash_prefill_attention``: 4 D H operations for each valid
    (query, key) pair, as the plain version's mask counts them (rows with
    no valid key do none)."""
    B, D = 2, 16
    q = torch.empty(B, Sq, H, D, dtype=torch.bfloat16)
    k = torch.empty(B, Sk, KH, D, dtype=torch.bfloat16)
    qp = qo + np.arange(Sq)[:, None]
    kj = np.arange(Sk)[None, :]
    mask = (kj < (Sk if kv_len is None else kv_len)) & np.ones((Sq, 1), bool)
    if causal:
        mask &= ko + kj <= qp
    if window:
        mask &= ko + kj > qp - window
    flops, byts = work.flash_prefill_attention(q, k, k, causal, qo, ko,
                                               kv_len, window)
    assert flops == 4.0 * B * H * D * mask.sum()
    assert byts >= 2 * q.numel() * 2 + B * Sq * H * 4


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
