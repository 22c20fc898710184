"""Shared fixtures.  NOTE: tests run on the single real CPU device — the
512-device XLA flag is set ONLY inside launch/dryrun.py (and subprocess
tests that need a multi-device mesh spawn a fresh interpreter)."""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

# ---------------------------------------------------------------------------
# Optional-dependency shim: several test modules import `hypothesis` at the
# top level for property-based tests.  Without this shim a missing install
# kills *collection* of those modules (taking all their plain pytest tests
# down too).  Install the real package via requirements-dev.txt to run the
# property tests; with the shim, property tests skip and everything else runs.
# ---------------------------------------------------------------------------
try:
    import hypothesis  # noqa: F401
except ImportError:
    def _skip_given(*_a, **_k):
        def deco(fn):
            def skipper(*args, **kwargs):
                pytest.skip("hypothesis not installed (see requirements-dev.txt)")
            skipper.__name__ = fn.__name__
            skipper.__doc__ = fn.__doc__
            return skipper
        return deco

    def _identity_settings(*_a, **_k):
        def deco(fn):
            return fn
        return deco

    class _FakeStrategy:
        def __getattr__(self, name):
            return self

        def __call__(self, *a, **k):
            return self

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _skip_given
    _hyp.settings = _identity_settings
    _hyp.assume = lambda *a, **k: True
    _st = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "lists", "sampled_from", "booleans",
                  "tuples", "just", "one_of", "text", "composite",
                  "fixed_dictionaries", "dictionaries", "none"):
        setattr(_st, _name, _FakeStrategy())
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU and nvcc; skips elsewhere (run with: "
        "PYTHONPATH=src python -m pytest -m gpu tests/test_torch_*.py)")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def run_with_devices(code: str, n_devices: int = 8, timeout: int = 560) -> str:
    """Run python code in a subprocess with n forced host devices."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"subprocess failed:\n{out.stdout}\n{out.stderr}")
    return out.stdout


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def virtual_clock():
    """A monotonic clock that only moves when the test advances it."""
    from service_harness import VirtualClock
    return VirtualClock()


@pytest.fixture
def make_harness():
    """Factory for virtual-clock-driven SolverService harnesses:
    ``make_harness(registry, block_width=..., ...)`` — each step advances
    the injected clock one tick, so scheduling tests are deterministic
    (no sleeps, no wall-clock assertions)."""
    from service_harness import ServiceHarness

    def factory(registry, **kwargs):
        return ServiceHarness(registry, **kwargs)

    return factory
