"""The afmoe architecture's files on the CPU: the benchmark's reference
(``archs/afmoe/reference.py``) agrees with the plain reference of the
test suite (``tests/afmoe_reference.py``), the layout's FLOPs count what
its docstring says, and a tiny trinity cell runs end to end: the sound
program is correct, the float8 control and a program that skips the tail
are not.

The tiny cell keeps the block's structure (a dense leading layer, then a
sliding-sliding-sliding-full period of MoE layers over a document whose
tail the sliding layers share, 16 experts top-8 with a shared expert and
a seeded bias) at widths the CPU runs in seconds, served in float32 under
the limits of ``test_bench_correctness.py``."""
import importlib.util
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import run  # noqa: E402
from moska_bench import check  # noqa: E402
from moska_bench.arch import load as load_arch  # noqa: E402
from moska_bench.weights import make_weights  # noqa: E402

SEED = 2 ** 31 + 5
WINDOW = 48
LIMITS = {"served_gap": 1e-3, "wave_gap": 1e-3, "store_err": 1e-4,
          "cache_err": 1e-4}


def _spec(capacity_factor: float = 1.25) -> dict:
    spec = json.loads((BENCH / "configs" / "trinity-mini.json").read_text())
    m = spec["model"]
    m.update(dtype="float32", num_layers=5, d_model=128, num_heads=4,
             num_kv_heads=2, head_dim=32, d_ff=64, dense_d_ff=96,
             vocab_size=512, num_dense_layers=1, embed_scale=128 ** 0.5,
             layer_windows=[WINDOW] * 4 + [0])
    m["moe"].update(num_experts=16, top_k=8, shared_expert_width=64,
                    capacity_factor=capacity_factor)
    m["moska"].update(chunk_size=32, top_k_chunks=4)
    return spec


def _arch(spec):
    return load_arch(spec, ROOT)


def _tests_reference():
    path = ROOT / "tests" / "afmoe_reference.py"
    mod_spec = importlib.util.spec_from_file_location("afmoe_reference_t",
                                                      path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("rows", [None, 32])
def test_bench_reference_agrees_with_the_tests_reference(monkeypatch, rows):
    """The document alone through both references, at a capacity factor
    that drops nothing (the test suite's reference has no capacity): the
    logits of every position agree within float32 rounding, also where
    the bench reference takes the document's queries a block at a time."""
    spec = _spec(capacity_factor=2.0)
    m = spec["model"]
    arch = _arch(spec)
    if rows:
        monkeypatch.setattr(arch.reference, "ROWS", rows)
    w = make_weights(spec, arch.layout, SEED, torch.device("cpu"))
    tokens = torch.randint(0, 512, (96,),
                           generator=torch.Generator().manual_seed(1))
    ref = arch.reference.Reference(m, w, "tf32")
    got, _ = ref.sequence(tokens.tolist(), 0, 96, 96, logits_from=0)
    t = _tests_reference()
    tw = {"embed": w["embed"], "unembed": w["unembed"],
          "final_norm": 1 + w["final_norm"]}
    names = {"ln1": "input_norm", "ln2": "pre_mlp_norm",
             "post_attn": "post_attn_norm", "post_mlp": "post_mlp_norm",
             "q_norm": "q_norm", "k_norm": "k_norm"}
    proj = {"wq": "q_proj", "wk": "k_proj", "wv": "v_proj",
            "wg": "gate_proj", "wo": "o_proj", "router": "router",
            "expert_bias": "expert_bias", "e_gate": "experts.gate",
            "e_up": "experts.up", "e_down": "experts.down",
            "sh_gate": "shared.gate", "sh_up": "shared.up",
            "sh_down": "shared.down", "w_gate": "mlp.gate",
            "w_up": "mlp.up", "w_down": "mlp.down"}
    for key, t_ in w.items():
        if not key.startswith("layers."):
            continue
        i, leaf = key.split(".")[1], key.split(".")[2]
        p = f"layers.{i}."
        if leaf in names:
            tw[p + names[leaf]] = 1 + t_
        else:
            tw[p + proj[leaf]] = t_
    plain = t.AfmoeReference(dict(
        num_layers=5, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        vocab_size=512, rope_theta=m["rope_theta"], rms_eps=m["rms_eps"],
        layer_types=["sliding"] * 4 + ["full"], sliding_window=WINDOW,
        num_dense_layers=1, num_experts=16, top_k=8, route_norm=True,
        route_scale=m["moe"]["route_scale"], mup_enabled=True), tw)
    want = plain.forward(tokens.tolist())
    assert float((got - want).abs().max()) < 1e-3 * float(want.abs().max())


def test_layout_counts_a_sliding_query_over_its_window():
    spec = _spec()
    m = spec["model"]
    lay = _arch(spec).layout
    # the same token, one position on: only the attention differs
    full_keys = lambda ctx, chunks: ctx + (  # noqa: E731
        min(4, chunks) * 32 if chunks else 0)
    for ctx, chunks in ((5, 0), (60, 0), (5, 8), (70, 8)):
        base = chunks * 32
        att = (4 * lay.flops.attention(m, 1, min(base + ctx, WINDOW))
               + lay.flops.attention(m, 1, full_keys(ctx, chunks)))
        want = lay._per_token(m) + att + lay.flops.logits(m)
        assert lay.decode(m, ctx, chunks) == want
    # a prompt: the sum of its positions' windows
    for n, chunks in ((10, 0), (60, 0), (10, 8)):
        base = chunks * 32
        band = sum(min(base + j + 1, WINDOW) for j in range(n))
        causal = n * (n + 1) / 2
        want = (n * lay._per_token(m)
                + 4 * lay.flops.attention(m, 1, band)
                + lay.flops.attention(m, 1, causal)
                + lay.flops.attention(m, n, lay.flops.shared_keys(m, chunks))
                + lay.flops.logits(m))
        assert lay.prefill(m, n, chunks) == pytest.approx(want, rel=1e-12)
    assert lay.batch_coupled(m, 8)


def _cell(tmp_path: Path) -> run.Cell:
    spec = _spec()
    mix = dict(clients=6, max_seq=96, corpus_tokens=256,
               prompt_tokens=[8, 48], output_tokens=[8, 40], warm_waves=1,
               profile_waves=1, check_requests=3)
    files = {}
    for kind, body in (("cfg", spec), ("mix", mix), ("lim", LIMITS)):
        files[kind] = tmp_path / f"trinity.{kind}.json"
        files[kind].write_text(json.dumps(body))
    e2e = [{"name": "tokens_per_s", "unit": "tokens/s"},
           {"name": "setup_s", "unit": "s"}]
    return run.Cell("tiny-trinity", 1, files["cfg"], files["mix"],
                    files["lim"], e2e, [])


def _run(cell, control=False):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run.run_cell(cell, SEED, 1.0, False, device="cpu",
                            control=control)
    finally:
        torch.set_num_threads(threads)


def test_tiny_trinity_cell_is_correct_and_the_control_is_not(tmp_path):
    cell = _cell(tmp_path)
    res = _run(cell, control=True)
    assert list(res["checks"]) == list(LIMITS)
    assert res["correct"] is True, res["checks"]
    assert not check.passes(res["control"], LIMITS), res["control"]


def test_tiny_trinity_cell_without_the_tail_is_incorrect(tmp_path,
                                                         monkeypatch):
    from repro_torch.core import moska_attention as MA
    monkeypatch.setattr(MA, "shared_tail_merge",
                        lambda q, o_u, *a, **k: o_u)
    res = _run(_cell(tmp_path))
    assert res["correct"] is False, res["checks"]
