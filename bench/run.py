"""The serving benchmark of the PyTorch/CUDA port: one cell, one seed, one
measured window, on the card this process starts on.

Run from the root of a checkout:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a configuration
(``bench/configs/<config>.json``) under a traffic mix
(``bench/traffic/<traffic>.json``), judged against the limits in
``bench/limits/<cell>.json``. The configuration's ``reference`` names its
architecture's directory (``bench/archs/<arch>/``: the weights' layout and
FLOPs, the program's build, the plain reference; ``moska_bench/arch.py``).
The run makes the weights, the corpus and every prompt from the seed on
the device, builds
``repro_torch.serving.engine.ServingEngine`` (slotted layout, no early
stop), registers the corpus, fills the batch with pre-aged requests, runs
the warm waves, then drives the closed loop (``moska_bench/loop.py``) for
the window. ``--trace 0`` reports the cell's end-to-end metrics; ``--trace
1`` its per-layer metrics, with the profiled waves that follow the window.
Then the reference judges what was served (``moska_bench/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (and ``breakdown`` with
``--trace 1``), and last ``checks``: each number compared beside its
limit, which are also the last lines of standard error. Every build and
kernel cache stays inside the checkout (``build/``).
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
#: top-level modules that may not be loaded in the process that reports
BANNED = ("jax", "jaxlib", "flax", "repro")
#: pool of requests drawn per run, in blocks of ``clients``
POOL_BLOCKS = 16
#: offset of the traffic's seed from the weights' (independent streams)
TRAFFIC_SEED = 1 << 40


def _paths() -> None:
    for p in (str(BENCH), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def say(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


@dataclass
class Cell:
    name: str
    chips: int
    config_file: Path
    traffic_file: Path
    limits_file: Path
    end_to_end: List[dict]
    per_layer: List[dict]
    #: the checkout whose files the configuration names (its architecture)
    root: Path = ROOT

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


def _reports(entry: dict, cell: str, moved: set) -> bool:
    """Whether a metric entry belongs to ``cell``: listed there, or listed
    nowhere and moving an end-to-end metric the cell reports."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in moved


def load_cell(root: Path, name: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    e2e = [m for m in spec["end_to_end"] if _reports(m, name, set())]
    moved = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"] if _reports(m, name, moved)]
    bench = root / "bench"
    return Cell(name, int(w["chips"]), root / configs[w["config"]]["file"],
                bench / "traffic" / f"{w['traffic']}.json",
                bench / "limits" / f"{name}.json", e2e, per, root)


def banned_modules(names=None) -> List[str]:
    """The banned top-level names among ``names`` (default: the modules
    this process has loaded), each compared whole: ``repro_torch`` is not
    ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def _hist(reg, name: str):
    h = reg.get(name)
    return (h.sum, h.count) if h is not None else (0.0, 0)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", control: bool = False,
             t_start: float = T_START) -> dict:
    """One run; returns the result object (the JSON line's content)."""
    import torch
    from moska_bench import check
    from moska_bench.arch import load as load_arch
    from moska_bench.loop import CORPUS_ID, ClosedLoop
    from moska_bench.record import RunRecord, reader
    from moska_bench.traffic import generate, load_mix
    from moska_bench.weights import DTYPES, load_spec, make_weights
    from repro_torch import obs
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import EngineConfig, ServingEngine

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    spec = load_spec(cell.config_file)
    model = spec["model"]
    arch = load_arch(spec, cell.root)
    cfg = arch.program.program_config(spec)
    mix = load_mix(cell.traffic_file)
    limits = json.loads(cell.limits_file.read_text())
    obs.reset_registry()
    reg = obs.get_registry()

    def mark(what: str) -> None:
        if cuda:
            torch.cuda.synchronize()
        say(f"[setup] {what} at {time.perf_counter() - t_start:.3f} s")

    mark("imports")
    weights = make_weights(spec, arch.layout, seed, dev)
    params = arch.program.program_params(cfg, weights)
    mark("weights")
    traffic = generate(mix, model["vocab_size"], seed + TRAFFIC_SEED,
                       POOL_BLOCKS * mix.clients, dev)
    eng = ServingEngine(cfg, params, EngineConfig(
        max_slots=mix.clients, max_seq=mix.max_seq, eos_id=-1,
        cache_dtype=DTYPES[model["dtype"]]))
    mark("traffic and engine")
    if cuda:
        from repro_torch.kernels.build import library
        library()               # built on a checkout's first run, loaded after
        mark("kernels loaded")
    chunks = (eng.register_corpus(CORPUS_ID, traffic.corpus)
              if mix.shared else 0)
    mark("corpus registered")
    loop = ClosedLoop(eng, traffic, mix, model, chunks, arch.layout)
    coupled = arch.layout.batch_coupled(model, chunks)
    plan = Plan(loop, mix, seconds, trace, coupled, reg, ops, cuda,
                arch.program.CHOICES)
    loop.drive(plan)
    window, traced, counts = plan.window, plan.traced, plan.counts
    register = [s.duration_s for s in reg.spans
                if s.name == "engine.register_corpus"]
    rec = RunRecord(cell.name, model, mix.clients, window,
                    list(loop.logs.values()), window.open_s - t_start,
                    plan.peak, loop.model_flops(window), plan.hist,
                    plan.steps,
                    sum(register) if register else None, traced, counts)
    metrics = {}
    for m in cell.metrics(trace):
        v = reader(BENCH / "metrics", m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = sum(1 for r in rec.logs
                    if any(window.holds(x) for x in r.token_s))

    # -- judged after the window ------------------------------------------
    sample = check.pick([check.Served(list(r.prompt), list(r.generated))
                         for r in (loop.requests[u]
                                   for u in loop.finished_in(window))],
                        mix.check_requests * (
                            check.FIRST_TOKENS_PER_REQUEST if coupled
                            else 1), seed)
    wave = plan.wave
    program_store = eng.stores.get(CORPUS_ID)
    loop.eng = None
    del eng, params
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    verdict = check.judge(arch.reference.Reference, model, weights,
                          mix.max_seq, traffic.corpus if mix.shared else None,
                          program_store, sample, wave, coupled, control)
    say(f"[check] reference {time.perf_counter() - t_ref:.1f} s; window "
        f"{window.seconds:.3f} s, {len(loop.waves)} waves, sample of "
        f"{len(sample)}")
    for k, x in sorted(verdict.detail.items()):
        say(f"[check] {k} {x!r}")
    for k, x in verdict.numbers.items():
        say(f"[check] number {k} {x!r}")
    for row in verdict.widest():
        say(f"[check] widest gap, route tie, expert tie {row}")
    for k, x in verdict.control.items():
        say(f"[check] control number {k} {x!r}")
    lines = check.verdict_lines(verdict.numbers, limits)
    result = {"correct": check.passes(verdict.numbers, limits),
              "attempted": attempted, "failed": 0, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if cuda else "cpu"),
                         "count": cell.chips,
                         "memory_peak_bytes": plan.peak}}
    if traced is not None:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = traced.breakdown()
    if control:
        result["control"] = verdict.control
        result["control_correct"] = check.passes(verdict.control, limits)
    result["checks"] = lines
    return result


class Plan:
    """The run's phases, advanced at the end of each wave: filling the
    batch and the warm waves, the measured window, the profiled waves of a
    traced run, and the checked wave of a batch-coupled cell."""

    HISTS = ("engine/prefill_latency_s", "engine/wave_active_slots")

    def __init__(self, loop, mix, seconds: float, trace: bool,
                 coupled: bool, reg, ops, cuda: bool, choices):
        self.loop, self.mix, self.seconds = loop, mix, seconds
        self.trace, self.coupled, self.reg, self.ops = trace, coupled, reg, ops
        self.cuda, self.choices = cuda, choices
        self.phase, self.n = "warm", 0
        self.window = self.traced = self.counts = self.wave = None
        self.peak, self.hist, self.steps = 0, {}, []

    def __call__(self, t: float) -> bool:
        self.n += 1
        return getattr(self, "_" + self.phase)(t)

    def _warm(self, t: float) -> bool:
        if self.n == 1:
            say(f"[setup] batch filled at {t - T_START:.3f} s")
        if self.n >= 1 + self.mix.warm_waves:
            self.t_open = t
            self._opened = {n: _hist(self.reg, n) for n in self.HISTS}
            self._steps0 = len(self.loop.eng.metrics["decode_step_s"])
            self.phase = "window"
        return True

    def _window(self, t: float) -> bool:
        import torch
        from moska_bench.stats import Window
        if t - self.t_open < self.seconds:
            return True
        self.window = Window(self.t_open, t)
        self.peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        self.hist = {n: tuple(a - b for a, b in zip(_hist(self.reg, n), v))
                     for n, v in self._opened.items()}
        self.steps = self.loop.eng.metrics["decode_step_s"][self._steps0:]
        if not self.trace:
            return self._to_check()
        from moska_bench import trace as tr
        self.counts = tr.KernelCounts(self.ops)
        self.counts.install()
        self.counts.on = True
        self._spans = tr.spans(self.loop.eng)
        self._spans.__enter__()
        self._prof = tr.Profiled().__enter__()
        self._k = 0
        self._range = torch.profiler.record_function("bench.wave")
        self._range.__enter__()
        self.phase = "profile"
        return True

    def _profile(self, t: float) -> bool:
        import torch
        self._range.__exit__(None, None, None)
        self._k += 1
        if self._k < self.mix.profile_waves:
            self._range = torch.profiler.record_function("bench.wave")
            self._range.__enter__()
            return True
        self._prof.__exit__(None, None, None)
        self._spans.__exit__(None, None, None)
        self.counts.on = False
        self.counts.uninstall()
        self.traced = self._prof.result
        return self._to_check()

    def _to_check(self) -> bool:
        from moska_bench import capture
        if not self.coupled:
            return False
        self._before = self.loop.occupancy()
        self._choices = capture.record_next_wave(self.loop.eng,
                                                 self.choices)
        self.phase = "check"
        return True

    def _check(self, t: float) -> bool:
        """After one more wave of the whole batch: per slot the token fed,
        the rows before it, the token served and the prompt, with the
        program's cache after it."""
        import torch
        from moska_bench import capture
        from moska_bench.check import WaveState
        capture.stop(self.loop.eng)
        slots = self.mix.clients
        uid_at = {s: u for u, s in self._before.items()}
        admitted = sorted(s for u, s in self.loop.occupancy().items()
                          if u not in self._before)
        for u, s in self.loop.occupancy().items():
            if u not in self._before:
                uid_at[s] = u
        calls = self._choices.calls
        if len(calls) != len(admitted) + 1:
            raise RuntimeError(f"checked wave: {len(calls)} model calls for "
                               f"{len(admitted)} admissions and a step")
        if sorted(uid_at) != list(range(slots)):
            raise RuntimeError(f"checked wave ran {len(uid_at)} of {slots} "
                               "slots")
        reqs = [self.loop.requests[uid_at[b]] for b in range(slots)]
        cache = self.loop.eng._cache
        dev = cache.k.device
        self.wave = WaveState(
            torch.tensor([r.generated[-2] for r in reqs], device=dev),
            torch.tensor([len(r.prompt) + len(r.generated) - 2
                          for r in reqs], device=dev),
            torch.tensor([r.generated[-1] for r in reqs], device=dev),
            [list(r.prompt) + list(r.generated[:-2]) for r in reqs],
            cache.k, cache.v, calls[-1],
            dict(zip(admitted, calls[:-1])))
        return False


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # calibration only: also judge the float8 control
    ap.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    _paths()
    cell = load_cell(ROOT, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        say(f"{cell.name} needs {cell.chips} CUDA device(s); "
            f"this process sees {torch.cuda.device_count()}")
        return 3
    say(f"[bench] {cell.name} seed={args.seed} seconds={args.seconds} "
        f"trace={args.trace} card: {card()}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      control=args.control)
    banned = banned_modules()       # the window has closed; nothing printed
    if banned:
        say(f"modules loaded that the benchmark may not load: {banned}")
        return 4
    if args.control:
        say(f"control_correct {result['control_correct']}")
    for k, line in result["checks"].items():
        say(f"{k} {line['value']!r} limit {line['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
