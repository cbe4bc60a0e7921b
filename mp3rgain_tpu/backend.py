"""Which path runs on this process's device.

Every choice between a compiled kernel, its interpret mode and a host
stage is made here, from what the process can observe: the platform of
the device JAX computes on (the default backend, or the device a caller
pinned with ``jax.default_device``).

  - ``gpu``: Pallas kernels compile through Triton. The MP3 Huffman
    decode runs on the device (raw-bits path) and AAC requantisation
    runs on the device (``decode/aac_prep.py``).
  - ``cpu``: the platform the tests use. Pallas kernels run in interpret
    mode; MP3 Huffman decode and AAC requantisation stay on the host.

A kernel asked to compile for a platform it has no route to raises; no
path falls back silently.

``MP3RGAIN_DEVICE_ENTROPY`` and ``MP3RGAIN_AAC_DEVICE_PREP`` (``1`` or
``0``) override the two stage choices, e.g. to run the raw-bits path in
interpret mode on the CPU.
"""

from __future__ import annotations

import os

import jax


# Matmul precision of the float32 DSP GEMMs on the GPU: MP3 synthesis
# (class-core IMDCT and polyphase GEMMs), the blocked equal-loudness IIR
# and the AAC IMDCT. Three bf16 passes on the tensor cores: on an H100
# (700 W) they held every smoke-corpus gain within 0.02 dB of the CPU
# path at a 64x60 s tail time of 51 ms, where float32 ("highest") took
# 91 ms and TF32 ("high" and "default" lower to it) 31 ms but moved
# gains by up to 8.8 dB (96 kHz AAC) and 0.26 dB (short-block MP3).
# Exactness-critical selections never go through a matmul
# (constant-index gathers, or HIGHEST in decode/aac_prep.py).
GPU_DSP_PRECISION = "BF16_BF16_F32_X3"


def platform() -> str:
    """Platform of the device this process computes on ("gpu", "cpu")."""
    dev = jax.config.jax_default_device
    if dev is not None:
        return dev if isinstance(dev, str) else dev.platform
    return jax.default_backend()


def dsp_precision() -> str:
    """Matmul precision for the DSP GEMMs on this platform (the CPU
    computes float32 dots at full precision)."""
    return GPU_DSP_PRECISION if platform() == "gpu" else "highest"


def local_devices():
    """This process's devices of the computing platform."""
    return jax.local_devices(backend=platform())


def interpret_kernels() -> bool:
    """Pallas kernels run in interpret mode on the CPU only."""
    return platform() == "cpu"


def require_route(kernel: str, interpret: bool) -> None:
    """Raise unless `kernel` can run as asked on this platform.

    Compiled kernels exist for the GPU (Triton route); interpret mode is
    for the CPU. Anything else is an error, never a fallback."""
    p = platform()
    if interpret and p != "cpu":
        raise RuntimeError(
            f"{kernel}: interpret mode is for the CPU backend, not {p!r}"
        )
    if not interpret and p != "gpu":
        raise RuntimeError(
            f"{kernel}: compiles for the GPU only (platform {p!r}); "
            "use interpret=True on the CPU"
        )


def _override(name: str) -> bool | None:
    env = os.environ.get(name)
    if env is None:
        return None
    return env not in ("0", "false", "")


def device_entropy() -> bool:
    """MP3 Huffman decode on the device (raw-bits path). On an H100 with
    16 host cores it ran a 64x60 s stereo batch end to end in 0.39 s
    against 2.61 s for the host-decoded path (12x240 s album: 0.23 s
    against 2.30 s), so it is the GPU default."""
    env = _override("MP3RGAIN_DEVICE_ENTROPY")
    return platform() == "gpu" if env is None else env


def aac_device_prep() -> bool:
    """AAC requantisation on the device (pure XLA)."""
    env = _override("MP3RGAIN_AAC_DEVICE_PREP")
    return platform() == "gpu" if env is None else env
