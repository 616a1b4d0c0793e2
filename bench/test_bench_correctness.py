"""The judge on the CPU at a size a test run holds: a sound program comes
out correct, the float8 control and a broken decode step do not.

The tiny cells keep the structure of the real ones (dense GQA over a
store, a batch-coupled store whose chunk capacity can drop routes, no
store, an MoE FFN) at widths the CPU runs in seconds. They are served in
float32, so that no near-tie of a chunk or expert choice flips between
the program and the float32 reference at these narrow widths, under
limits of their own that float8 rounding fails by orders of magnitude."""
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

LIMITS = {"served_gap": 1e-3, "wave_gap": 1e-3, "store_err": 1e-4,
          "cache_err": 1e-4}


def _limits(spec: dict, corpus: int) -> dict:
    """The numbers a tiny cell computes, each under ``LIMITS``."""
    chunks = corpus // spec["model"]["moska"]["chunk_size"]
    coupled = load_arch(spec, ROOT).layout.batch_coupled(spec["model"],
                                                         chunks)
    keys = ["served_gap"] + (["wave_gap"] if coupled else []) + (
        ["store_err"] if corpus else []) + (["cache_err"] if coupled else [])
    return {k: LIMITS[k] for k in keys}


SEED = 2 ** 31 + 3


def _cell(tmp_path: Path, name: str, top_k_chunks: int, corpus: int,
          moe: bool = False, order: str = "fixed") -> run.Cell:
    src = "granite-moe-1b-a400m" if moe else "mistral-large-123b-l8"
    spec = json.loads((BENCH / "configs" / f"{src}.json").read_text())
    spec["model"].update(dtype="float32", num_layers=2, d_model=128,
                         num_heads=4,
                         num_kv_heads=2, head_dim=32, d_ff=128,
                         vocab_size=512)
    spec["model"]["moska"].update(chunk_size=32, top_k_chunks=top_k_chunks)
    if moe:
        spec["model"]["moe"].update(num_experts=4, top_k=2)
    mix = dict(clients=6, max_seq=96, corpus_tokens=corpus,
               prompt_tokens=[8, 48], output_tokens=[8, 40], warm_waves=1,
               profile_waves=1, check_requests=3, order=order)
    files = {}
    for kind, body in (("cfg", spec), ("mix", mix),
                       ("lim", _limits(spec, corpus))):
        files[kind] = tmp_path / f"{name}.{kind}.json"
        files[kind].write_text(json.dumps(body))
    e2e = [{"name": "tokens_per_s", "unit": "tokens/s"},
           {"name": "setup_s", "unit": "s"}]
    return run.Cell(name, 1, files["cfg"], files["mix"], files["lim"], e2e,
                    [])


CELLS = {
    # 8 chunks, top-2 at capacity factor 2: a chunk can drop a slot
    "coupled-store": dict(top_k_chunks=2, corpus=256),
    # 8 chunks, top-4: K * cf covers every chunk, requests judged alone
    "store": dict(top_k_chunks=4, corpus=256),
    "no-store": dict(top_k_chunks=2, corpus=0),
    "moe-no-store": dict(top_k_chunks=2, corpus=0, moe=True),
    # the lengths in an order the seed draws
    "moe-seeded-order": dict(top_k_chunks=2, corpus=0, moe=True,
                             order="seeded"),
}


def _run(cell: run.Cell, control: bool = False) -> dict:
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return run.run_cell(cell, SEED, 1.0, False, device="cpu",
                            control=control)
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_sound_program_is_correct_and_the_control_is_not(tmp_path, name):
    cell = _cell(tmp_path, name, **CELLS[name])
    res = _run(cell, control=True)
    limits = json.loads(cell.limits_file.read_text())
    assert list(res["checks"]) == list(limits)
    assert res["correct"] is True, res["checks"]
    assert not check.passes(res["control"], limits), res["control"]


def _alter_token(monkeypatch):
    """A served token altered where the engine produces it."""
    from repro_torch.serving.engine import ServingEngine
    orig = ServingEngine._read_tokens

    def read(self, logits):
        nxt, ready = orig(self, logits)
        return (nxt + 1) % logits.shape[-1], ready
    monkeypatch.setattr(ServingEngine, "_read_tokens", read)


def _stale_cache(monkeypatch):
    """A decode step that leaves the unique cache as it was."""
    from repro_torch.models import dense
    monkeypatch.setattr(dense, "append_token", lambda k, v, nk, nv, n: (k, v))


def _half_batch(monkeypatch):
    """A decode step that computes half of the batch and hands the other
    half the same rows."""
    from repro_torch.models import dense
    orig = dense.decode_step

    def step(cfg, params, tokens, cache, **kw):
        logits, cache = orig(cfg, params, tokens, cache, **kw)
        half = logits.shape[0] // 2
        logits[half:2 * half] = logits[:half]
        return logits, cache
    monkeypatch.setattr(dense, "decode_step", step)


def _fed_wrong_before_the_check(monkeypatch):
    """Every decode step before the checked wave feeds slot 0 token 0 (as
    a loop of ``ServingEngine.run()`` calls does); the checked wave, whose
    model calls run with the judge's wrapped ``route``, is sound."""
    from repro_torch.core import router
    from repro_torch.models import dense
    orig, plain = dense.decode_step, router.route

    def step(cfg, params, tokens, cache, **kw):
        if router.route is plain:
            tokens = tokens.clone()
            tokens[0] = 0
        return orig(cfg, params, tokens, cache, **kw)
    monkeypatch.setattr(dense, "decode_step", step)


@pytest.mark.parametrize("fault", [_alter_token, _stale_cache, _half_batch])
@pytest.mark.parametrize("name", ["coupled-store", "store", "no-store",
                                  "moe-no-store"])
def test_a_broken_decode_step_is_judged_incorrect(tmp_path, monkeypatch,
                                                   fault, name):
    fault(monkeypatch)
    res = _run(_cell(tmp_path, name, **CELLS[name]))
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", ["coupled-store", "moe-no-store"])
def test_a_token_fed_wrong_before_the_checked_wave_is_judged_incorrect(
        tmp_path, monkeypatch, name):
    """In a batch-coupled cell only the first tokens and one wave are
    served again: layer 0's rows of every slot's history are what show a
    wrong token fed in the window."""
    _fed_wrong_before_the_check(monkeypatch)
    res = _run(_cell(tmp_path, name, **CELLS[name]))
    assert res["correct"] is False, res["checks"]
