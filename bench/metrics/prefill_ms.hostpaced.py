"""The mean admission prefill of a host-paced cell,
read as ``prefill_ms`` is."""
from pathlib import Path

from moska_bench.record import reader

read = reader(Path(__file__).parent, "prefill_ms")
