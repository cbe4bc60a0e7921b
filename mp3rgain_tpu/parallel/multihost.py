"""Multi-host (DCN) data parallelism for library scans.

Single-host data parallelism rides one process's local devices
(runner.py's dp mesh, NCCL between the GPUs of a host); this module
extends the same album-union collectives across ``jax.distributed``
process groups, where XLA routes the psum / pmax over the network
(NCCL between GPU hosts, gloo TCP on the CPU test platform).

Architecture — deliberately minimal cross-host traffic:

- Tracks are partitioned round-robin across processes
  (:func:`process_slice`); file IO, host unpack and the whole device
  analysis pipeline stay process-local (the existing single-host
  ``MeshRunner`` over :func:`local_mesh`). Nothing per-track ever
  crosses DCN — tracks are independent until the album reduction,
  exactly as in the reference's sequential loop
  (/root/reference/src/replaygain.rs:1053-1062).
- The only global communication is the album union: ONE (12000,)
  histogram psum + peak pmax over the global dp mesh
  (:func:`album_union_global`), the multi-host analog of
  ``LoudnessHistogram::accumulate`` (src/replaygain.rs:658-662) and the
  album-peak max (src/replaygain.rs:1056).

Usage: one process per host, owning all of that host's GPUs (its
local dp mesh), or one process per GPU with ``CUDA_VISIBLE_DEVICES``
naming a different card for each. Two processes never share a card: a
JAX process reserves most of a card's memory when it first uses it::

    from mp3rgain_tpu.parallel import multihost
    multihost.initialize("host0:8476", num_processes=4, process_id=rank)
    mine = multihost.process_slice(paths)
    ... analyze `mine` with scan/runner as usual ...
    hist, peak = multihost.album_union_global(local_hist, local_peak)

Validated by ``__graft_entry__.dryrun_multihost`` (2-process CPU group,
album union asserted bit-equal to single-process) and
tests/test_multihost.py; a multi-process NCCL group has not run on
GPUs yet.
"""

from __future__ import annotations

import numpy as np

# jax imports are deferred into the functions: scan.album_union and
# cli._use_batch probe is_multihost() on paths that must stay cheap for
# pure host byte-surgery commands, and importing this module must not
# drag the jax runtime in.

_initialized = False


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """Join a jax.distributed process group.

    Must run before any other JAX backend use in the process. The CPU
    backend's cross-process collectives use gloo TCP (it has no other
    implementation); GPU collectives use NCCL whatever this setting.
    """
    import jax

    global _initialized
    if _initialized:
        return
    if num_processes > 1:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    _initialized = True


def is_multihost() -> bool:
    """True when running inside a >1-process jax.distributed group."""
    import sys

    if not _initialized and "jax" not in sys.modules:
        # Cheap probe: host-only CLI paths (-g/-l/-u/...) call this and
        # must not pay a jax import; a process group can't exist in a
        # process that never imported jax.
        return False
    import jax

    return jax.process_count() > 1


def maybe_initialize_from_env() -> bool:
    """Join a process group from the MP3RGAIN_COORDINATOR /
    MP3RGAIN_NUM_PROCESSES / MP3RGAIN_PROCESS_ID environment (device
    knobs stay out of the mp3gain short-flag namespace, SURVEY.md §5).
    Returns True when a >1-process group is (now) active.

    Distributed CLI semantics: launch the same mp3rgain command on every
    host with a distinct MP3RGAIN_PROCESS_ID; each process analyzes and
    rewrites its round-robin slice of the file list and prints results
    for that slice; album gain is reduced globally over DCN
    (scan.album_union), so every process applies the identical steps.
    """
    import os

    coord = os.environ.get("MP3RGAIN_COORDINATOR")
    nprocs = int(os.environ.get("MP3RGAIN_NUM_PROCESSES", "0") or 0)
    pid = os.environ.get("MP3RGAIN_PROCESS_ID")
    if coord and nprocs > 1 and pid is not None:
        initialize(coord, nprocs, int(pid))
    return is_multihost()


def process_slice(items: list) -> list:
    """This process's round-robin shard of a global work list.

    Round-robin (not contiguous blocks) so that length-sorted corpora
    spread long and short tracks evenly across hosts."""
    import jax

    return list(items[jax.process_index()::jax.process_count()])


def local_mesh():
    """A dp mesh over this process's local devices only (for the
    per-track analysis pipeline, which never communicates cross-host)."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.local_devices()), axis_names=("dp",))


def global_mesh():
    """The 1-D dp mesh over every device of every process."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=("dp",))


def _union_fn(mesh):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    @jax.jit
    def fn(hist, peak):
        # Every device ends up holding the full reduction (its output
        # row), so each PROCESS can read the result from its own
        # addressable shard — no cross-host readback needed after the
        # collective.
        def shard(h, p):
            total_h = jax.lax.psum(jnp.sum(h, axis=0), axis_name="dp")
            total_p = jax.lax.pmax(jnp.max(p), axis_name="dp")
            return total_h[None], total_p[None]

        return jax.shard_map(
            shard, mesh=mesh,
            in_specs=(P("dp"), P("dp")),
            out_specs=(P("dp"), P("dp")),
        )(hist, peak)

    return fn


def album_union_global(local_hist: np.ndarray, local_peak: float):
    """Cross-host album reduction.

    local_hist: (12000,) uint32/uint64 histogram of this process's
    tracks; local_peak: max |PCM| over this process's tracks. Returns
    (hist (12000,) np.uint64, peak float), identical on every process.

    Implementation: each process contributes its histogram on local
    device row 0 (zeros elsewhere), then one shard_map psum/pmax over
    the global dp mesh — the only DCN collective in the framework.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = global_mesh()
    k = len(jax.local_devices())
    n_global = mesh.devices.size

    hist32 = np.asarray(local_hist)
    # Album histograms can exceed uint32 over pod-scale corpora only in
    # theory (2^32 windows = 6,800 years of audio); the device reduce is
    # float64-exact in int64 range.
    local_rows_h = np.zeros((k, hist32.shape[0]), np.int64)
    local_rows_h[0] = hist32.astype(np.int64)
    local_rows_p = np.zeros((k,), np.float32)
    local_rows_p[0] = np.float32(local_peak)

    sharding = NamedSharding(mesh, P("dp"))
    gh = jax.make_array_from_process_local_data(
        sharding, local_rows_h, (n_global, hist32.shape[0])
    )
    gp = jax.make_array_from_process_local_data(
        sharding, local_rows_p, (n_global,)
    )
    total_h, total_p = _union_fn(mesh)(gh, gp)
    # Each process reads the reduction from its own addressable shard
    # (every device's row holds the identical full result).
    hist_out = np.asarray(total_h.addressable_shards[0].data)[0]
    peak_out = float(np.asarray(total_p.addressable_shards[0].data)[0])
    return hist_out.astype(np.uint64), peak_out
