"""One torch CPU thread for the duration of a parity-test module.

The suite runs in several worker processes at once; torch's default of one
thread per core in each of them oversubscribes the machine and starves the
timing-sensitive serving tests that run beside the parity tests. Import the
fixture into a test module to apply it there."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)
