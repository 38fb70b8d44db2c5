"""One intra-op thread per process for the port's CPU tests.

Every ``tests/test_torch_*.py`` calls :func:`one_thread` when it is
imported. The suite runs under pytest-xdist with several workers, one
process each; torch's default gives every process as many intra-op threads
as the machine has cores, so the workers' threads outnumber the cores many
times over and the port's many small ops crawl. With one thread a process,
a file run alone and the same file inside the suite run alike.
"""
import torch


def one_thread() -> None:
    """Set this process's torch to one intra-op thread."""
    torch.set_num_threads(1)
