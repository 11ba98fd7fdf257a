"""Runtime-env pip provisioning from a local wheelhouse.

Scenario sources: upstream's pip runtime-env plugin provisions a cached
virtualenv per requirement set and workers start inside it
(``python/ray/_private/runtime_env/`` — SURVEY.md §1 layer 10;
re-derived, not copied).  Here the wheelhouse install is offline
(``--no-index``) into a digest-keyed package dir: a task imports a
package ABSENT from the base interpreter, a cache hit skips the
install, and an unsatisfiable requirement fails with
RuntimeEnvSetupError.
"""

import os
import zipfile

import pytest

import ray_tpu_torch
from ray_tpu_torch.runtime.runtime_env import RuntimeEnvSetupError
from torch_ref_fixtures import _port_device_module, _port_state  # noqa: F401

# Port copy of tests/test_runtime_env_pip.py: the reference's file with
# ``ray_tpu`` renamed to ``ray_tpu_torch``.  Deviations, none of which
# loosens a check:
# - the autouse fixtures of tests/torch_ref_fixtures.py: ``_port_state``
#   resets the port's process-global state (Config, chaos, breakers, the
#   clock and transport seams) as tests/conftest.py resets the
#   reference's, and ``_port_device_module`` sets RT_SCHEDULER_DEVICE=cpu
#   for the module before any module-scoped fixture starts a runtime:
#   the port's device programs run on the GPU unless asked for the CPU
#   (subprocesses inherit the variable).


PKG = "rtwheel_demo"
WHEEL_CODE = "def answer():\n    return 42\n\nVERSION = '1.0.0'\n"


def _build_wheel(wheelhouse: str) -> str:
    """Hand-assemble a minimal PEP-427 wheel (a wheel is a zip with
    dist-info) — no build backend, no network."""
    os.makedirs(wheelhouse, exist_ok=True)
    name = f"{PKG}-1.0.0-py3-none-any.whl"
    path = os.path.join(wheelhouse, name)
    di = f"{PKG}-1.0.0.dist-info"
    with zipfile.ZipFile(path, "w") as z:
        z.writestr(f"{PKG}/__init__.py", WHEEL_CODE)
        z.writestr(f"{di}/METADATA",
                   f"Metadata-Version: 2.1\nName: {PKG}\n"
                   "Version: 1.0.0\n")
        z.writestr(f"{di}/WHEEL",
                   "Wheel-Version: 1.0\nGenerator: test\n"
                   "Root-Is-Purelib: true\nTag: py3-none-any\n")
        z.writestr(f"{di}/RECORD",
                   f"{PKG}/__init__.py,,\n{di}/METADATA,,\n"
                   f"{di}/WHEEL,,\n{di}/RECORD,,\n")
    return path


@pytest.fixture
def wheelhouse(tmp_path):
    wh = str(tmp_path / "wheelhouse")
    _build_wheel(wh)
    return wh


@pytest.fixture
def driver(wheelhouse):
    from ray_tpu_torch.api import _get_runtime
    ray_tpu_torch.init(resources={"CPU": 4}, num_workers=2,
                 system_config={"runtime_env_wheelhouse": wheelhouse})
    try:
        yield _get_runtime()
    finally:
        ray_tpu_torch.shutdown()


class TestPipProvisioning:
    def test_task_imports_wheelhouse_package(self, driver):
        """The package is NOT importable in the base env, but a task
        with pip=[...] gets it."""
        with pytest.raises(ImportError):
            __import__(PKG)

        @ray_tpu_torch.remote(runtime_env={"pip": [PKG]})
        def use_pkg():
            import rtwheel_demo
            return rtwheel_demo.answer(), rtwheel_demo.VERSION

        out = ray_tpu_torch.get(use_pkg.remote(), timeout=120)
        assert out == (42, "1.0.0")

    def test_cache_hit_skips_reinstall(self, driver):
        @ray_tpu_torch.remote(runtime_env={"pip": [PKG]})
        def use_pkg(i):
            import rtwheel_demo
            return i + rtwheel_demo.answer()

        outs = ray_tpu_torch.get([use_pkg.remote(i) for i in range(6)],
                           timeout=120)
        assert outs == [i + 42 for i in range(6)]
        mgr = driver.cluster.runtime_env_manager
        assert mgr.stats()["num_pip_installs"] == 1, mgr.stats()

    def test_version_pin_resolves_from_wheelhouse(self, driver):
        @ray_tpu_torch.remote(runtime_env={"pip": [f"{PKG}==1.0.0"]})
        def use_pkg():
            import rtwheel_demo
            return rtwheel_demo.VERSION

        assert ray_tpu_torch.get(use_pkg.remote(), timeout=120) == "1.0.0"

    def test_unsatisfiable_requirement_errors(self, driver):
        @ray_tpu_torch.remote(runtime_env={"pip": ["definitely-absent-xyz"]})
        def doomed():
            return 1

        with pytest.raises(RuntimeEnvSetupError):
            ray_tpu_torch.get(doomed.remote(), timeout=120)

    def test_actor_in_pip_env(self, driver):
        @ray_tpu_torch.remote(runtime_env={"pip": [PKG]})
        class Holder:
            def __init__(self):
                import rtwheel_demo
                self.v = rtwheel_demo.answer()

            def get(self):
                return self.v

        h = Holder.remote()
        assert ray_tpu_torch.get(h.get.remote(), timeout=120) == 42
        ray_tpu_torch.kill(h)

    def test_conda_python_pin_mismatch_fails_loudly(self, driver):
        """A conda interpreter pin this deployment cannot satisfy must
        fail staging (not silently drop): no conda binary, no egress —
        see the README capability-matrix descope."""
        @ray_tpu_torch.remote(runtime_env={"conda": {
            "dependencies": ["python=2.7", f"{PKG}=1.0.0"]}})
        def doomed():
            return 1

        with pytest.raises(RuntimeEnvSetupError):
            ray_tpu_torch.get(doomed.remote(), timeout=120)

    def test_conda_spec_provisions_via_wheelhouse(self, driver):
        """Conda python-level deps really provision (offline, through
        the pip wheelhouse path); a matching interpreter pin passes."""
        import sys
        pin = "%d.%d" % sys.version_info[:2]

        @ray_tpu_torch.remote(runtime_env={"conda": {
            "dependencies": [f"python={pin}", f"{PKG}=1.0.0"]}})
        def use_pkg():
            import rtwheel_demo
            return rtwheel_demo.VERSION

        assert ray_tpu_torch.get(use_pkg.remote(), timeout=120) == "1.0.0"
