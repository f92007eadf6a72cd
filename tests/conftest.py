"""Skip jax-dependent test modules when jax is unavailable (e.g. the
lightweight CI container, which installs requirements-dev.txt only)."""

collect_ignore = []
try:
    import jax  # noqa: F401
except Exception:
    collect_ignore = ["test_archs.py", "test_decision_jax.py",
                      "test_kernels.py", "test_runtime.py"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's hand-written kernels); "
        "skips elsewhere")
