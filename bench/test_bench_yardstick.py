"""CPU tests of the benchmark's yardstick: traffic, statistics, trace
reduction, kernel work, and the shape of BENCHMARK.json."""
import json
import math
import re
import shutil
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

import run  # noqa: E402
from moska_bench import peaks, stats, traffic, work  # noqa: E402
from moska_bench.record import RunRecord, reader  # noqa: E402
from moska_bench.trace import busy_and_gaps, innermost  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _mix(**kw) -> traffic.Mix:
    base = dict(name="t", clients=16, max_seq=256, corpus_tokens=128,
                prompt_tokens=(8, 64), output_tokens=(16, 128),
                warm_waves=1, profile_waves=1, check_requests=2)
    base.update(kw)
    return traffic.Mix(**base)


def test_traffic_is_deterministic_for_a_seed():
    mix = _mix()
    a = traffic.generate(mix, 100, 2 ** 31 + 7, 64, torch.device("cpu"))
    b = traffic.generate(mix, 100, 2 ** 31 + 7, 64, torch.device("cpu"))
    c = traffic.generate(mix, 100, 2 ** 31 + 8, 64, torch.device("cpu"))
    assert a.prompts == b.prompts and np.array_equal(a.outputs, b.outputs)
    assert np.array_equal(a.corpus, b.corpus)
    assert a.prompts != c.prompts


def test_every_seed_serves_the_same_lengths_with_its_own_tokens():
    mix = _mix()
    runs = [traffic.generate(mix, 100, s, 64, torch.device("cpu"))
            for s in (1, 2)]
    assert [len(x) for x in runs[0].prompts] == \
        [len(x) for x in runs[1].prompts]
    assert runs[0].outputs.tolist() == runs[1].outputs.tolist()
    assert runs[0].prompts != runs[1].prompts
    B = mix.clients
    for blk in range(1, 4):        # each block: the same stratified lengths
        sl = slice(blk * B, (blk + 1) * B)
        assert sorted(len(x) for x in runs[0].prompts[sl]) == sorted(
            traffic.log_uniform_quantiles(*mix.prompt_tokens, B))


def test_a_seeded_order_is_drawn_from_the_seed(tmp_path):
    f = tmp_path / "seeded.json"
    body = dict(clients=16, max_seq=256, corpus_tokens=0,
                prompt_tokens=[8, 64], output_tokens=[16, 128],
                warm_waves=1, profile_waves=1, check_requests=2,
                order="seeded")
    f.write_text(json.dumps(body))
    mix = traffic.load_mix(f)
    assert mix.order == "seeded"
    runs = [traffic.generate(mix, 100, s, 64, torch.device("cpu"))
            for s in (1, 2)]
    lens = [[len(x) for x in r.prompts] for r in runs]
    assert lens[0] != lens[1]
    assert runs[0].outputs.tolist() != runs[1].outputs.tolist()
    for blk in range(4):           # each block: the same lengths, reordered
        sl = slice(blk * 16, (blk + 1) * 16)
        assert sorted(lens[0][sl]) == sorted(lens[1][sl])
        assert sorted(runs[0].outputs[sl]) == sorted(runs[1].outputs[sl])
    f.write_text(json.dumps(dict(body, order="random")))
    with pytest.raises(ValueError):
        traffic.load_mix(f)


def test_length_laws_and_preaging():
    lo, hi, n = 128, 512, 4096
    x = traffic.log_uniform_quantiles(lo, hi, n)
    assert x.min() >= lo and x.max() <= hi
    # log-uniform: the median sits at the geometric mean
    assert abs(np.median(x) - math.sqrt(lo * (hi + 1))) < 3
    r = traffic.residual_quantiles(lo, hi, n)
    assert r.min() >= 1 and r.max() <= hi
    # residual life of L: mean E[L^2] / (2 E[L])
    u = np.exp(np.linspace(math.log(lo), math.log(hi + 1), 200001))
    want = (u ** 2).mean() / (2 * u.mean())
    assert abs(r.mean() - want) / want < 0.02
    mix = _mix(output_tokens=(lo, hi), clients=64)
    t = traffic.generate(mix, 100, 5, 128, torch.device("cpu"))
    assert t.outputs[:64].mean() < t.outputs[64:].mean()
    assert sorted(t.outputs[:64]) == sorted(
        traffic.residual_quantiles(lo, hi, 64))


def test_prompts_cover_every_bucket_of_the_range_in_the_first_block():
    from moska_bench.check import prefill_bucket
    mix = _mix(clients=256, prompt_tokens=(256, 2048), max_seq=2560,
               output_tokens=(128, 512))
    t = traffic.generate(mix, 100, 9, 256, torch.device("cpu"))
    hit = {prefill_bucket(len(p), 2560) for p in t.prompts[:256]}
    # every bucket that holds at least 1/256 of the law's mass
    share = {}
    for n in range(256, 2049):
        b = prefill_bucket(n, 2560)
        share[b] = share.get(b, 0.0) + math.log((n + 1) / n) / math.log(
            2049 / 256)
    assert hit == {b for b, s in share.items() if s >= 1 / 256}


def _logs():
    # two requests; the second stalls 1 s between its 2nd and 3rd tokens
    a = stats.RequestLog(0.0, 4, [0.5, 0.6, 0.7, 0.8])
    b = stats.RequestLog(1.0, 4, [1.2, 1.3, 2.3, 2.4])
    early = stats.RequestLog(-1.0, 4, [-0.5, 0.05])
    return [a, b, early]


def test_rates_are_over_the_whole_window():
    w = stats.Window(0.0, 2.0)
    # tokens in (0, 2]: a's 4, b's 2 (1.2, 1.3), early's 1 (0.05)
    assert stats.tokens_in(w, _logs()) == 7
    assert stats.tokens_per_s(w, _logs()) == 3.5


def test_tails_take_every_request_and_every_gap():
    w = stats.Window(0.0, 3.0)
    ttft = sorted(stats.ttft_samples(w, _logs()))
    assert ttft == pytest.approx([0.2, 0.5])          # early's landed before
    itl = stats.itl_samples(w, _logs())
    assert len(itl) == 3 + 3 + 1
    assert max(itl) == pytest.approx(1.0)             # the stall is a gap
    assert stats.p95(itl) == pytest.approx(
        np.percentile(np.asarray(itl), 95))
    assert stats.p95(itl) > 0.5
    rec = RunRecord("cell", {}, 2, w, _logs(), 1.0, 0, 0.0, {}, [])
    read = {n: reader(BENCH / "metrics", n)(rec) for n in (
        "tokens_per_s", "ttft_p95_ms", "itl_p95_ms", "ttft_p95_ms.hostpaced",
        "itl_p95_ms.hostpaced")}
    assert read["tokens_per_s"] == 9 / 3      # a 4, b 4, early 1
    assert read["itl_p95_ms"] == pytest.approx(stats.p95(itl) * 1e3)
    assert read["ttft_p95_ms"] == pytest.approx(stats.p95(ttft) * 1e3)
    assert read["itl_p95_ms.hostpaced"] == read["itl_p95_ms"]
    assert read["ttft_p95_ms.hostpaced"] == read["ttft_p95_ms"]


def test_idle_share_comes_from_merged_kernel_intervals():
    window = (0, 100)
    iv = [(10, 30), (20, 40), (35, 50), (60, 70), (95, 120), (-5, 2)]
    busy, gaps = busy_and_gaps(window, iv)
    assert busy == 2 + 40 + 10 + 5            # overlaps counted once
    assert gaps == [(2, 10), (50, 60), (70, 95)]
    spans = [(0, 100, "bench.wave"), (45, 80, "bench.decode_step")]
    assert innermost(spans, 65) == "bench.decode_step"
    assert innermost(spans, 6) == "bench.wave"
    assert innermost(spans, 200) == "bench.outside_spans"


def test_frozen_work_counts_match_hand_counts():
    E, cap, H, D, C, KH = 4, 8, 6, 16, 32, 2
    qd = torch.zeros(E, cap, H, D, dtype=torch.bfloat16)
    k = torch.zeros(E, C, KH, D, dtype=torch.bfloat16)
    qmask = torch.zeros(E, cap, dtype=torch.bool)
    fl, by = work.shared_chunk_attention(qd, k, k, qmask, valid=5, active=3)
    assert fl == 4 * 5 * H * C * D
    assert by == (5 * H * D * 2 + 3 * C * 2 * KH * D * 2 + E * cap
                  + E * cap * H * D * 2 + E * cap * H * 4)
    B, S = 3, 40
    q = torch.zeros(B, H, D, dtype=torch.bfloat16)
    kc = torch.zeros(B, S, KH, D, dtype=torch.bfloat16)
    lens = torch.zeros(B, dtype=torch.int32)
    fl, by = work.decode_attention(q, kc, kc, lens, tokens=70)
    assert fl == 4 * 70 * H * D
    assert by == 2 * B * H * D * 2 + 2 * 70 * KH * D * 2 + B * 4 + B * H * 4


def _layout():
    from moska_bench.arch import load
    spec = json.loads((BENCH / "configs" /
                       "mistral-large-123b-l8.json").read_text())
    return load(spec, ROOT).layout


def test_model_flops_count_projections_ffn_and_attention():
    flops = _layout()
    m = dict(num_layers=2, d_model=8, num_heads=2, num_kv_heads=1,
             head_dim=4, d_ff=16, vocab_size=10, moe=None,
             moska=dict(chunk_size=32, top_k_chunks=2))
    per = 2 * (8 * 8 + 2 * 8 * 4 + 8 * 8 + 3 * 8 * 16)
    assert flops.decode(m, 5, 0) == 2 * (per + 4 * 2 * 4 * 5) + 2 * 8 * 10
    assert flops.decode(m, 5, 4) == \
        2 * (per + 4 * 2 * 4 * (5 + 64)) + 2 * 8 * 10
    assert flops.prefill(m, 3, 0) == \
        2 * (3 * per + 4 * 2 * 4 * 6) + 2 * 8 * 10


def _benchmark():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_json_names_and_units():
    b = _benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
    assert len(names) == len(set(names))
    for c in b["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200 and "\n" not in w["why"]


def test_benchmark_json_is_whole():
    """Every cell has its files, every metric its reader, every cell
    reports setup_s, another end-to-end metric and a per-layer one."""
    b = _benchmark()
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    e2e = {m["name"] for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = run.load_cell(ROOT, w["name"])
        assert cell.traffic_file.exists() and cell.limits_file.exists()
        mine = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in mine and len(mine) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in mine
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_a_new_traffic_file_is_picked_up_with_no_code_change(tmp_path):
    """A cell added by files alone: a fourth mix, its limits, and an entry
    in BENCHMARK.json run end to end on the CPU."""
    b = _benchmark()
    spec = json.loads((BENCH / "configs" /
                       "mistral-large-123b-l8.json").read_text())
    spec["name"] = "tiny-dense"
    spec["model"].update(num_layers=1, d_model=64, num_heads=2,
                         num_kv_heads=1, head_dim=32, d_ff=64,
                         vocab_size=128)
    spec["model"]["moska"].update(chunk_size=32, top_k_chunks=2)
    for d in ("configs", "traffic", "limits"):
        (tmp_path / "bench" / d).mkdir(parents=True)
    for d in ("metrics", "archs"):
        shutil.copytree(BENCH / d, tmp_path / "bench" / d)
    (tmp_path / "bench/configs/tiny-dense.json").write_text(
        json.dumps(spec))
    mix = dict(clients=4, max_seq=64, corpus_tokens=128,
               prompt_tokens=[4, 24], output_tokens=[4, 24], warm_waves=1,
               profile_waves=1, check_requests=2, why="a test's own mix")
    (tmp_path / "bench/traffic/bursty-test.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench/limits/tiny-dense.bursty-test.json").write_text(
        json.dumps({"served_gap": 1.0, "store_err": 1.0}))
    b["configs"].append({"name": "tiny-dense", "source": "test",
                         "file": "bench/configs/tiny-dense.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-dense.bursty-test",
                           "config": "tiny-dense", "traffic": "bursty-test",
                           "chips": 1, "why": "test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    cell = run.load_cell(tmp_path, "tiny-dense.bursty-test")
    assert cell.traffic_file == tmp_path / "bench/traffic/bursty-test.json"
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = run.run_cell(cell, 2 ** 31 + 11, 0.3, False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res["correct"] is True
    assert {"tokens_per_s", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"


def _new_arch_cell(root: Path, arch: str, edit=None) -> "run.Cell":
    """A cell whose architecture, configuration, mix and limits are all new
    files in a copy of the benchmark at ``root``: the architecture a copy
    of the present one under the name ``arch``, its reference edited by
    ``edit``."""
    b = _benchmark()
    for d in ("metrics", "archs"):
        shutil.copytree(BENCH / d, root / "bench" / d)
    shutil.copytree(BENCH / "archs" / "gqa_swiglu_moe",
                    root / "bench" / "archs" / arch)
    ref = root / "bench" / "archs" / arch / "reference.py"
    if edit is not None:
        ref.write_text(edit(ref.read_text()))
    for d in ("configs", "traffic", "limits"):
        (root / "bench" / d).mkdir(parents=True)
    spec = json.loads((BENCH / "configs" /
                       "mistral-large-123b-l8.json").read_text())
    spec["name"] = "tiny-arch"
    spec["reference"] = f"bench/archs/{arch}/reference.py"
    spec["model"].update(dtype="float32", num_layers=2, d_model=64,
                         num_heads=2, num_kv_heads=1, head_dim=32, d_ff=64,
                         vocab_size=128)
    spec["model"]["moska"].update(chunk_size=32, top_k_chunks=2)
    (root / "bench/configs/tiny-arch.json").write_text(json.dumps(spec))
    mix = dict(clients=4, max_seq=64, corpus_tokens=128,
               prompt_tokens=[4, 24], output_tokens=[4, 24], warm_waves=1,
               profile_waves=1, check_requests=2, why="a test's own mix")
    (root / "bench/traffic/arch-test.json").write_text(json.dumps(mix))
    (root / "bench/limits/tiny-arch.arch-test.json").write_text(
        json.dumps({"served_gap": 1e-3, "store_err": 1e-4}))
    b["configs"].append({"name": "tiny-arch", "source": "test",
                         "file": "bench/configs/tiny-arch.json",
                         "reduced": [], "why": "test"})
    b["workloads"].append({"name": "tiny-arch.arch-test",
                           "config": "tiny-arch", "traffic": "arch-test",
                           "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    return run.load_cell(root, "tiny-arch.arch-test")


def _no_rope(src: str) -> str:
    a = "return self._rope(q, pos), self._rope(k, pos), v"
    assert a in src
    return src.replace(a, "return q, k, v")


@pytest.mark.parametrize("edit,correct", [(None, True), (_no_rope, False)])
def test_a_new_architecture_is_picked_up_with_no_code_change(tmp_path, edit,
                                                             correct):
    """A cell added by files alone, its architecture among them, runs end
    to end on the CPU and is judged by its own reference: a copy of the
    present block is correct, a copy whose reference leaves out RoPE is
    not."""
    cell = _new_arch_cell(tmp_path, "gqa_copy", edit)
    assert cell.root == tmp_path
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = run.run_cell(cell, 2 ** 31 + 13, 0.3, False, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert res["correct"] is correct, res["checks"]
    assert {"tokens_per_s", "setup_s"} <= set(res["metrics"])


@pytest.mark.parametrize("reference", [None, "bench/archs/none/reference.py",
                                       "bench/archs/gqa_swiglu_moe/x.py"])
def test_a_configuration_without_its_architecture_fails_by_name(reference):
    from moska_bench.arch import load
    spec = {"name": "no-arch", "model": {}}
    if reference is not None:
        spec["reference"] = reference
    with pytest.raises((KeyError, FileNotFoundError), match="no-arch"):
        load(spec, ROOT)


def test_a_counted_kernel_file_is_installed_counted_and_uninstalled(
        tmp_path):
    """``KernelCounts`` wraps what a file of its directory names, counts
    its calls while on, and hands the kernel's launch count back."""
    from moska_bench.trace import KernelCounts
    (tmp_path / "scaled_copy.py").write_text(
        "import torch\n"
        "OP = 'scaled_copy'\n"
        "def work(x, n=1):\n"
        "    return (2.0 * x.numel(), 8.0 * x.numel()), ((0.0, 4.0),)\n"
        "def counts(x, n=1):\n"
        "    return torch.tensor([n])\n")

    def scaled_copy(x, n=1):
        ops.scaled_copy.launches += 1   # as ``ops``' kernels count
        return x * n
    scaled_copy.launches = 2
    ops = types.SimpleNamespace(scaled_copy=scaled_copy)
    kc = KernelCounts(ops, tmp_path)
    assert set(kc.calls) == {"scaled_copy"}
    kc.install()
    assert ops.scaled_copy is not scaled_copy
    x = torch.ones(10)
    ops.scaled_copy(x)                  # off: not counted
    kc.on = True
    assert torch.equal(ops.scaled_copy(x, n=3), 3 * x)
    ops.scaled_copy(x, 5)
    kc.on = False
    kc.uninstall()
    assert ops.scaled_copy is scaled_copy
    assert scaled_copy.launches == 2 + 3      # handed back
    c = kc.calls["scaled_copy"]
    assert c.fixed == [(20.0, 80.0)] * 2 and len(c.per) == 2
    assert [int(t) for t in c.counts] == [3, 5]
    assert kc.bound_s("scaled_copy") == pytest.approx(
        (80 + 12) / peaks.HBM_BYTES_S + (80 + 20) / peaks.HBM_BYTES_S)
