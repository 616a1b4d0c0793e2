"""The inter-token tail of a host-paced cell,
read as ``itl_p95_ms`` is."""
from pathlib import Path

from moska_bench.record import reader

read = reader(Path(__file__).parent, "itl_p95_ms")
