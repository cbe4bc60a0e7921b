"""Driver-gate regression tests for __graft_entry__.

dryrun_multichip must be self-contained: it re-execs in a subprocess that
forces a virtual n-device CPU mesh regardless of the ambient platform
(an ambient single-GPU or 1-device mesh would skip all sharding).
"""

import subprocess
import sys

import pytest


def _load_entry_module():
    import importlib.util
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(repo, "__graft_entry__.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dryrun_multichip_runs_8_devices():
    mod = _load_entry_module()
    # Must succeed even though this pytest process has jax pinned to the
    # 8-CPU platform already — the subprocess isolates it either way.
    mod.dryrun_multichip(8)


def test_dryrun_multichip_asserts_device_count(monkeypatch):
    """The child must fail loudly if the forced device count is absent."""
    import os

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # Force only 2 virtual devices but claim the child (n=8) directly:
    # the in-child assertion must trip.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["_MP3RGAIN_DRYRUN_CHILD"] = "1"
    code = "import __graft_entry__ as g; g.dryrun_multichip(8)"
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=repo,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode != 0
    assert "virtual device count not forced" in (proc.stderr + proc.stdout)


def test_entry_returns_jittable():
    mod = _load_entry_module()
    fn, args = mod.entry()
    import jax

    jitted = jax.jit(fn)
    hist, loud, peak = jitted(*args)
    hist.block_until_ready()
    assert hist.shape[0] == args[0].shape[0]
