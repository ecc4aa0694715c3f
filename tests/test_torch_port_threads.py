"""`one_thread`, the autouse fixture the port's CPU test modules import.

Under the test run's parallel workers torch's default intra-op pool (a
thread per core in every worker) oversubscribes the cores, and small ops
slow down many times over: six runs at once of a tiny pipeline's two steps
took ~190 s each on the default pool against ~1.5 s on one thread. A module
that runs torch on the CPU imports the fixture:

    from test_torch_port_threads import one_thread  # noqa: F401  (autouse)
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the importing module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_one_thread_pins_torch_for_the_module():
    assert torch.get_num_threads() == 1
