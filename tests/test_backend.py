"""The path-choice module (mp3rgain_tpu/backend.py) and the compile cache
location (mp3rgain_tpu/utils/jaxcache.py)."""

import os
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from mp3rgain_tpu import backend  # noqa: E402
from mp3rgain_tpu.utils import jaxcache  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_platform_picks_interpret_and_host_stages(monkeypatch):
    monkeypatch.delenv("MP3RGAIN_DEVICE_ENTROPY", raising=False)
    monkeypatch.delenv("MP3RGAIN_AAC_DEVICE_PREP", raising=False)
    assert backend.platform() == "cpu"
    assert backend.interpret_kernels()
    assert not backend.device_entropy()
    assert not backend.aac_device_prep()
    assert backend.dsp_precision() == "highest"
    assert all(d.platform == "cpu" for d in backend.local_devices())


@pytest.mark.parametrize("var,fn", [
    ("MP3RGAIN_DEVICE_ENTROPY", backend.device_entropy),
    ("MP3RGAIN_AAC_DEVICE_PREP", backend.aac_device_prep),
])
@pytest.mark.parametrize("value,expect", [("1", True), ("0", False),
                                          ("false", False)])
def test_stage_overrides(monkeypatch, var, fn, value, expect):
    monkeypatch.setenv(var, value)
    assert fn() is expect


def test_pinned_default_device_is_the_platform_observed():
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        assert backend.platform() == "cpu"
    with jax.default_device("cpu"):
        assert backend.platform() == "cpu"


def test_gpu_platform_picks_compiled_kernels(monkeypatch):
    monkeypatch.delenv("MP3RGAIN_DEVICE_ENTROPY", raising=False)
    monkeypatch.delenv("MP3RGAIN_AAC_DEVICE_PREP", raising=False)
    monkeypatch.setattr(backend, "platform", lambda: "gpu")
    assert not backend.interpret_kernels()
    assert backend.device_entropy() and backend.aac_device_prep()
    assert backend.dsp_precision() == backend.GPU_DSP_PRECISION
    backend.require_route("k", interpret=False)
    with pytest.raises(RuntimeError, match="interpret mode"):
        backend.require_route("k", interpret=True)


@pytest.mark.parametrize("plat", ["cpu", "METAL"])
def test_compiled_kernel_refused_off_the_gpu(monkeypatch, plat):
    monkeypatch.setattr(backend, "platform", lambda: plat)
    with pytest.raises(RuntimeError, match="GPU only"):
        backend.require_route("k", interpret=False)


def test_entropy_kernel_without_interpret_raises_on_cpu():
    """A GPU-only kernel requested on the CPU without interpret mode is an
    error, not a silent fallback."""
    from mp3rgain_tpu.decode import entropy_kernel as ek

    meta = np.zeros((4, 12), np.int32)
    md = np.zeros((4, 528), np.uint8)
    with pytest.raises(RuntimeError, match="GPU only"):
        ek.decode_spectra(md, meta, interpret=False)


def _cache_dir_in_child(env_extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra)
    code = (
        "import jax; from mp3rgain_tpu.utils import jaxcache as c; "
        "c.ensure_compilation_cache(); "
        "print(c.cache_dir()); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    return out[-2], out[-1]


def test_compile_cache_honours_the_environment(tmp_path):
    want = str(tmp_path / "cc")
    chosen, configured = _cache_dir_in_child(
        {"JAX_COMPILATION_CACHE_DIR": want})
    assert chosen == want and configured == want


def test_compile_cache_default_is_fixed_inside_the_checkout():
    chosen, configured = _cache_dir_in_child({})
    expect = os.path.join(ROOT, ".cache", "xla")
    assert chosen == expect == jaxcache.DEFAULT_CACHE_DIR
    assert configured == expect
