"""Golden values of the architecture files: the same seed gives the same
weights, reference numbers, model FLOPs and counted-kernel work, bit for
bit, as the harness gave before the block moved into ``bench/archs/`` and
the counted kernels into ``bench/counted/`` (commit 55a627b, where
``moska_bench/weights.py``, ``reference.py``, ``flops.py``, ``check.py``
and ``trace.py`` held them; ``test_bench_golden.json`` holds what that
commit's code gave for exactly the inputs below).

The specs are the tiny dense and MoE cells of
``test_bench_correctness.py`` at its seed; the reference runs on one
thread, so that its float32 sums go in one order. Tensors are compared by
the SHA-256 of their bytes."""
import hashlib
import json
import sys
import types
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from moska_bench import trace, weights  # noqa: E402
from moska_bench.arch import load as load_arch  # noqa: E402
from moska_bench.check import prefill_bucket  # noqa: E402

GOLDEN = json.loads((BENCH / "test_bench_golden.json").read_text())
SEED = 2 ** 31 + 3
PROMPT = 24


def _sha(t: torch.Tensor) -> str:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def _spec(kind: str) -> dict:
    """The tiny spec of ``kind``: dense or moe, served in float32 as the
    tiny cells are, or in bfloat16 (``_bf16``) as the real ones are."""
    src = ("granite-moe-1b-a400m" if kind.startswith("moe")
           else "mistral-large-123b-l8")
    spec = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    spec["model"].update(dtype="bfloat16" if kind.endswith("_bf16")
                         else "float32", num_layers=2, d_model=128,
                         num_heads=4, num_kv_heads=2, head_dim=32, d_ff=128,
                         vocab_size=512)
    spec["model"]["moska"].update(chunk_size=32, top_k_chunks=2)
    if kind.startswith("moe"):
        spec["model"]["moe"].update(num_experts=4, top_k=2)
    return spec


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _weights(kind: str):
    spec = _spec(kind)
    arch = load_arch(spec, ROOT)
    return spec["model"], arch, weights.make_weights(
        spec, arch.layout, SEED, torch.device("cpu"))


@pytest.mark.parametrize("kind", ["dense", "moe", "dense_bf16", "moe_bf16"])
def test_weights_are_the_same_leaves_bit_for_bit(kind):
    _, _, w = _weights(kind)
    got = [[k, list(v.shape), str(v.dtype), _sha(v)] for k, v in w.items()]
    assert got == GOLDEN[kind]["leaves"]


def _reference_values(m: dict, arch, w) -> dict:
    """Every number the judge reads of the reference, in both precisions:
    a prompt's logits, rows and ties without and with a store, the store,
    a decode wave over a made-up cache, and layer 0's rows."""
    vocab = m["vocab_size"]
    toks = [(7 * i + 3) % vocab for i in range(40)]
    corpus = [(5 * i + 1) % vocab for i in range(256)]
    bucket = prefill_bucket(PROMPT, 96)
    r = {}
    for prec in ("tf32", "fp8"):
        ref = arch.reference.Reference(m, w, prec)
        lg, kv = ref.sequence(toks, 0, PROMPT, bucket, logits_from=PROMPT - 1,
                              keep_kv=True)
        r[f"{prec}.logits"] = _sha(lg)
        r[f"{prec}.kv"] = [_sha(k) + _sha(v) for k, v in kv]
        r[f"{prec}.margins"] = {k: _sha(x) for k, x in ref.margins.items()}
        store = ref.corpus(corpus)
        r[f"{prec}.store"] = [_sha(a) + _sha(b) + _sha(c) for a, b, c in
                              zip(store.k, store.v, store.emb)]
        lg, _ = ref.sequence(toks, store.tokens, PROMPT, bucket, store,
                             logits_from=PROMPT - 1)
        r[f"{prec}.logits_store"] = _sha(lg)
        r[f"{prec}.chosen_store"] = {k: [_sha(x) for x in v]
                                     for k, v in ref.chosen.items()}
        g = torch.Generator().manual_seed(11)
        shape = (m["num_layers"], 5, 48, m["num_kv_heads"], m["head_dim"])
        ck = torch.randn(shape, generator=g)
        cv = torch.randn(shape, generator=g)
        lens = torch.tensor([3, 10, 20, 30, 40])
        tk = torch.tensor([1, 50, 99, 200, 300])
        for st, name in ((None, "nostore"), (store, "store")):
            pos = lens + (st.tokens if st else 0)
            lg, new = ref.wave(tk, pos, lens, ck, cv, st)
            r[f"{prec}.wave_{name}"] = [_sha(lg)] + [_sha(a) + _sha(b)
                                                     for a, b in new]
            r[f"{prec}.wave_{name}.chosen"] = {
                k: [_sha(x) for x in v] for k, v in ref.chosen.items()}
        k, v = ref.first_kv(torch.tensor(toks), torch.arange(40) + 5)
        r[f"{prec}.first_kv"] = _sha(k) + _sha(v)
    return r


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_reference_gives_the_same_numbers_bit_for_bit(kind, one_thread):
    m, arch, w = _weights(kind)
    got = _reference_values(m, arch, w)
    want = {k: v for k, v in GOLDEN[kind].items()
            if k.startswith(("tf32.", "fp8."))}
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_model_flops_and_coupling_are_the_same(kind):
    spec = _spec(kind)
    m, layout = spec["model"], load_arch(spec, ROOT).layout
    got = {f"prefill{a}": layout.prefill(m, *a)
           for a in ((24, 0), (24, 8), (1000, 16), (5, 3))}
    got.update({f"decode{a}": layout.decode(m, *a)
                for a in ((50, 0), (50, 8), (2000, 16))})
    assert got == GOLDEN[kind]["flops"]
    assert {str(c): layout.batch_coupled(m, c) for c in (0, 4, 8, 16)} == \
        GOLDEN[kind]["coupled"]


def test_counted_kernels_keep_the_same_work():
    """Each counted kernel's fixed work, work per count, counts and bound,
    through ``KernelCounts`` on a stub of ``ops``."""
    def sca(qd, k, v, qmask):
        return qd.sum()

    def dec(q, k, v, kv_len, window=0):
        return q.sum()
    sca.launches, dec.launches = 3, 5
    ops = types.SimpleNamespace(shared_chunk_attention=sca,
                                decode_attention=dec)
    kc = trace.KernelCounts(ops)
    kc.install()
    kc.on = True
    g = torch.Generator().manual_seed(5)
    E, cap, H, D, C, KH = 16, 40, 12, 128, 2048, 8
    qd = torch.zeros(E, cap, H, D, dtype=torch.bfloat16)
    k = torch.zeros(E, C, KH, D, dtype=torch.bfloat16)
    qmask = torch.rand(E, cap, generator=g) < 0.3
    qmask[3] = False
    ops.shared_chunk_attention(qd, k, k, qmask)
    B, S = 7, 300
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    cache = torch.zeros(B, S, KH, D, dtype=torch.bfloat16)
    lens = torch.randint(0, 400, (B,), generator=g, dtype=torch.int32)
    ops.decode_attention(q, cache, cache, lens)
    ops.decode_attention(q, cache, cache, lens, 64)
    kc.on = False
    kc.uninstall()
    got = {n: {"fixed": [list(f) for f in c.fixed],
               "per": [[list(x) for x in p] for p in c.per],
               "counts": [x.tolist() for x in c.counts],
               "bound_s": kc.bound_s(n)} for n, c in kc.calls.items()}
    assert got == GOLDEN["counted"]
