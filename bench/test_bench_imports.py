"""Import guard of the benchmark: what it runs loads neither JAX nor the
JAX package, and its reference loads nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

BANNED = {"jax", "jaxlib", "flax", "repro"}
#: every architecture's reference and layout, and what the judge judges
#: with: plain PyTorch and NumPy only
REFERENCE = tuple(sorted(
    str(p.relative_to(BENCH)) for p in
    [*BENCH.glob("archs/*/reference.py"), *BENCH.glob("archs/*/layout.py")]
)) + ("moska_bench/reference.py", "moska_bench/check.py")


def _imports(path: Path):
    """Every module a file imports, as written."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


def _sources():
    return [p for p in BENCH.rglob("*.py") if not p.name.startswith("test_")]


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & BANNED, (path, tops & BANNED)


def test_top_level_names_are_compared_whole():
    import run
    assert run.banned_modules(["repro_torch", "repro_torch.models.dense",
                               "reproduce", "jaxtyping", "torch"]) == []
    assert run.banned_modules(["repro.core.router", "jax._src",
                               "flax.linen", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_the_reference_imports_nothing_of_the_program():
    assert "archs/gqa_swiglu_moe/reference.py" in REFERENCE
    for rel in REFERENCE:
        tops = {m.split(".")[0] for m in _imports(BENCH / rel)}
        assert tops <= {"__future__", "contextlib", "math", "dataclasses",
                        "typing", "numpy", "torch", "moska_bench"}, (rel, tops)
        mods = set(_imports(BENCH / rel))
        assert not any("kernels.ref" in m or m.startswith("repro_torch")
                       for m in mods)


def test_the_reference_loads_nothing_of_the_program_when_run():
    """Each architecture's reference and layout, loaded as a run loads
    them, with the judge."""
    code = ("import sys; sys.path[:0] = [%r];"
            "import moska_bench.check;"
            "from moska_bench.record import load_module;"
            "[load_module(%r + '/' + f, 'x') for f in %r];"
            "bad = sorted({m.split('.')[0] for m in sys.modules}"
            " & {'repro_torch', 'repro', 'jax', 'jaxlib', 'flax'});"
            "print(bad); sys.exit(1 if bad else 0)") % (
                str(BENCH), str(BENCH), REFERENCE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_a_run_loads_no_jax(tmp_path):
    """The harness with the port imported, as a run loads it."""
    code = ("import sys; sys.path[:0] = [%r, %r];"
            "import run; run._paths();"
            "import repro_torch.serving.engine, moska_bench.loop,"
            " moska_bench.trace, moska_bench.record, moska_bench.weights,"
            " moska_bench.arch, json;"
            "[moska_bench.arch.load(json.load(open(c)), %r)"
            " for c in %r];"
            "moska_bench.trace.KernelCounts(None);"
            "print(run.banned_modules());"
            "sys.exit(1 if run.banned_modules() else 0)") % (
                str(BENCH), str(ROOT / "src"), str(ROOT),
                [str(c) for c in sorted(BENCH.glob("configs/*.json"))])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
