"""Test configuration.

The suite runs on the CPU: a virtual 8-device CPU platform, so that mesh
sharding (psum album reduction) is testable without accelerators, and
Pallas kernels run in interpret mode. Set before jax initialises a
backend, hence in this module rather than a fixture.

Tests that need the card carry the ``gpu`` marker and skip here; they
run on a machine with a GPU through ``python chip_smoke.py``, whose
phases cover the same kernels compiled for the card.
"""

import os
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except ImportError:
    pass


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when the process has none."""
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU in this process (tests run on the CPU)")


@pytest.fixture(scope="session")
def fixtures_dir(tmp_path_factory):
    """Directory with generated MP3 fixtures (lame-encoded)."""
    from mp3rgain_tpu.testing import fixtures

    out = tmp_path_factory.mktemp("mp3fixtures")
    return fixtures.generate_standard_fixtures(out)
