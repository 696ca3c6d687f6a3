"""The port's heavy test files run torch on two threads.

Import ``few_threads`` into a test module (``from torch_threads import
few_threads``) and pytest applies it to every test there: the test
workers share the machine's cores, and torch's default of one thread per
core in each of them oversubscribes it many times over.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads for the module's tests, then the old count."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
