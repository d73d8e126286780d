"""pytest settings of the benchmark's own tests (run with
`python -m pytest occbench/tests`): the `card` marker, for tests that need
a CUDA card and skip without one (decided inside each test)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips where there is none")
