"""The port's native arena under its concurrency stress harness.

``ray_tpu_torch/native/arena_stress.cc`` and its Makefile are copies of
the reference's, built against the port's own ``native/arena.cc``; the
checks on the harness's output are tests/test_native_stress.py's.  The
plain build runs in the suite, the ASAN and TSAN builds under the slow
marker (``make -C ray_tpu_torch/native sanitize``)."""

import os
import subprocess

import pytest

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ray_tpu_torch", "native")


def _make(target: str, timeout: float):
    return subprocess.run(["make", "-C", NATIVE, target],
                          capture_output=True, text=True,
                          timeout=timeout)


def test_stress_clean():
    r = _make("stress", 120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ARENA STRESS PASSED" in r.stdout
    assert "corruptions=0" in r.stdout
    assert "leaked=0" in r.stdout
    assert os.path.isfile(os.path.join(NATIVE, "build", "stress"))


@pytest.mark.slow
@pytest.mark.parametrize("target", ["asan", "tsan"])
def test_sanitizers_clean(target):
    r = _make(target, 600)
    assert r.returncode == 0, \
        f"{target}: {r.stdout[-2000:]}{r.stderr[-2000:]}"
    assert "ARENA STRESS PASSED" in r.stdout
