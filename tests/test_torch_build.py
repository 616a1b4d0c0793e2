"""The kernel build's lock (``repro_torch.kernels.build.build``), on the
CPU: two processes that start together on a tree with no build must run
the compiler once between them, the second loading the first's library.
``nvcc`` is a stand-in script that takes half a second per call, logs its
arguments and touches its ``-o`` output."""
import json
import multiprocessing as mp
import stat

NVCC = """#!/bin/sh
sleep 0.5
echo "$@" >> "{log}"
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then touch "$2"; fi
  shift
done
"""


def _build(root, nvcc, out):
    from pathlib import Path
    from repro_torch.kernels import build
    build.BUILD_ROOT = Path(root)
    build._nvcc = lambda: nvcc
    info = build.build()
    Path(out).write_text(json.dumps([str(info.path), info.cached]))


def test_ranks_that_start_together_build_once(tmp_path):
    from repro_torch.kernels import build
    log = tmp_path / "nvcc.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_build, args=(str(tmp_path / "build"),
                                              str(nvcc),
                                              str(tmp_path / f"r{i}.json")))
             for i in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=60)
        assert p.exitcode == 0
    got = [json.loads((tmp_path / f"r{i}.json").read_text())
           for i in range(2)]
    assert got[0][0] == got[1][0]
    assert sorted(cached for _, cached in got) == [False, True]
    calls = log.read_text().splitlines()
    sources = sorted(build.CSRC.glob("*.cu"))
    assert len(calls) == len(sources) + 1          # each compile, one link
    assert sum(" -c " in c for c in calls) == len(sources)
