"""The benchmark's CPU tests run tiny tensors through many small ops:
one intra-op thread each, so that test workers side by side do not
oversubscribe the cores."""

import pytest
import torch


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
