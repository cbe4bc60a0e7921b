"""Multi-host (DCN) data parallelism tests (SURVEY.md §2.6, round-4
VERDICT missing #2).

The framework's one cross-host collective is the album union (histogram
psum + peak pmax over the global dp mesh). These tests spawn a real
2-process ``jax.distributed`` group on CPU (gloo TCP collectives, 2
virtual devices per process) and assert the DCN reduction is bit-equal
to a single-process analysis — the same oracle pattern as
``__graft_entry__.dryrun_multichip`` uses for the single-host mesh.

The spawned children force their own CPU platform; this test runs the
parent side only and therefore works under the ambient conftest CPU
mesh as well as in a GPU session.
"""

import pytest


def test_dryrun_multihost_2proc():
    import __graft_entry__ as g

    # Raises on any child assertion failure / timeout / nonzero exit.
    g.dryrun_multihost(n_processes=2, devices_per_process=2)


def test_cli_album_gain_multihost_matches_single(fixtures_dir, tmp_path):
    """Distributed CLI album gain: two processes, each analyzing its
    round-robin slice, must print the IDENTICAL album gain as a
    single-process run over all files — the scan.album_union DCN
    reduction at work through the real product surface."""
    import json
    import os
    import shutil
    import socket
    import subprocess
    import sys

    files = []
    for i, name in enumerate(
        ["test_stereo.mp3", "test_joint_stereo.mp3", "test_mono.mp3",
         "test_vbr.mp3"]
    ):
        p = tmp_path / f"a{i}_{name}"
        shutil.copy(fixtures_dir / name, p)
        files.append(str(p))

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    argv = [sys.executable, "-m", "mp3rgain_tpu.cli", "-a", "-n",
            "-o", "json", *files]

    ref = subprocess.run(argv, env=env, capture_output=True, text=True,
                         timeout=900)
    assert ref.returncode == 0, ref.stderr[-2000:]
    ref_album = json.loads(ref.stdout)["album"]

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for pid in range(2):
        cenv = dict(env)
        cenv["MP3RGAIN_COORDINATOR"] = f"localhost:{port}"
        cenv["MP3RGAIN_NUM_PROCESSES"] = "2"
        cenv["MP3RGAIN_PROCESS_ID"] = str(pid)
        procs.append(subprocess.Popen(argv, env=cenv,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=900)
        assert p.returncode == 0, err[-2000:]
        # gloo prints "[Gloo] Rank N is connected..." banners on stdout;
        # the CLI's (pretty-printed) JSON document starts at the first
        # line that is exactly "{".
        payload = out[out.index("{"):]
        outs.append(json.loads(payload))
    for pid, out in enumerate(outs):
        # each process reports its round-robin slice...
        assert len(out["files"]) == 2
        # ...but the album block is the GLOBAL union, identical across
        # processes and equal to the single-process run.
        assert out["album"]["gain_db"] == ref_album["gain_db"], (pid, out["album"])
        assert out["album"]["loudness_db"] == ref_album["loudness_db"]
        assert out["album"]["peak"] == ref_album["peak"]


def test_process_slice_single_process():
    """Outside a distributed group, process_slice is the identity and
    is_multihost is False (the scan path must not change behavior)."""
    from mp3rgain_tpu.parallel import multihost

    assert not multihost.is_multihost()
    items = ["a", "b", "c"]
    assert multihost.process_slice(items) == items
