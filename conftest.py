"""Repository-wide pytest settings: registers the `cuda` marker."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc; skips on machines without them",
    )
