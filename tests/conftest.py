import os

# smoke tests and benches must see the REAL device count (1 CPU device);
# only launch/dryrun.py forces 512 host devices. Keep determinism cheap.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_default_matmul_precision", "highest")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA card and the CUDA toolkit; skips "
        "elsewhere")
