"""pytest settings of the benchmark's own tests (``python -m pytest portbench/tests``)."""


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one (decided inside the test)")
