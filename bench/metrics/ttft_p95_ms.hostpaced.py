"""The time-to-first-token tail of a host-paced cell,
read as ``ttft_p95_ms`` is."""
from pathlib import Path

from moska_bench.record import reader

read = reader(Path(__file__).parent, "ttft_p95_ms")
