"""Registers the ``cuda`` marker: tests that need a CUDA device (the torch
port's kernels). They decide inside a fixture whether a card is present
and skip without one."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the torch port's kernels); skips without one")
