"""Fixtures shared by the port copies of the reference's runtime suites
(``tests/test_torch_ref_*.py``).

Each copy imports the ones it uses, and lists them among its deviations
from the reference file.  The two autouse fixtures stand in for what
``tests/conftest.py`` does for the reference's suites; ``device`` runs a
kernel case once on the CPU and once, marked ``cuda``, on the card.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def _port_device_module():
    """RT_SCHEDULER_DEVICE=cpu for the whole module: a module-scoped
    fixture that starts a runtime is set up before any function-scoped
    one, and without the variable the runtime asks for the GPU.  The
    port's Config reads the environment when it is built, and an earlier
    test file may have left one built without the variable, so it is
    rebuilt here, and again when the variable is gone."""
    from ray_tpu_torch.common.config import Config as PortConfig
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RT_SCHEDULER_DEVICE", "cpu")
        PortConfig.reset()
        yield
    PortConfig.reset()


@pytest.fixture(autouse=True)
def _port_state(monkeypatch):
    """Reset the port's process-global state around each test (Config,
    chaos, breakers, the clock and transport seams), as
    ``tests/conftest.py`` resets the reference's."""
    from ray_tpu_torch.common import clock
    from ray_tpu_torch.common.config import Config as PortConfig
    from ray_tpu_torch.rpc import breaker, chaos, transport
    monkeypatch.setenv("RT_SCHEDULER_DEVICE", "cpu")
    PortConfig.reset()
    chaos.disable()
    breaker.reset_registry()
    yield
    clock.uninstall()
    transport.uninstall()
    chaos.disable()
    breaker.reset_registry()
    PortConfig.reset()


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    """The device of a kernel or delta-engine case: "cpu" (the plain
    PyTorch versions), then "cuda", which skips without a GPU."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return request.param
