"""The port's test files' thread limit, imported by each as an autouse
fixture."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """One intra-op thread for a file's small steps: the suite runs six
    files at once, and a pool the size of the machine in each of them
    oversubscribes the cores, its waiting threads spinning."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
