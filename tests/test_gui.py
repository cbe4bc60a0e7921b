"""GUI app-state tests (headless; reference mp3rgui/src/app.rs logic)."""

import shutil

import pytest

from mp3rgain_tpu import replaygain
from mp3rgain_tpu.gui import AppState
from mp3rgain_tpu.replaygain import REPLAYGAIN_REFERENCE_DB


@pytest.fixture()
def state(fixtures_dir, tmp_path):
    s = AppState()
    for name in ("test_mono.mp3", "test_joint_stereo.mp3"):
        shutil.copy(fixtures_dir / name, tmp_path / name)
    s.add_folder(tmp_path)
    return s


def test_add_files_dedup_and_filters(tmp_path, fixtures_dir):
    s = AppState()
    mp3 = tmp_path / "a.mp3"
    shutil.copy(fixtures_dir / "test_mono.mp3", mp3)
    (tmp_path / "._a.mp3").write_bytes(b"junk")  # resource fork: skipped
    (tmp_path / "notes.txt").write_text("x")  # non-audio: skipped
    assert s.add_files([mp3, mp3, tmp_path / "._a.mp3", tmp_path / "notes.txt"]) == 1
    assert len(s.files) == 1


def test_analyze_and_target_volume_math(state):
    state.analyze_tracks()
    for f in state.files:
        assert f.status == "analyzed"
        assert f.track_gain_db is not None
        # volume = 89 - gain (app.rs display semantics)
        assert f.volume_db == pytest.approx(REPLAYGAIN_REFERENCE_DB - f.track_gain_db)
    # Raising the target by 6 dB raises the computed gain by 6 dB.
    f = state.files[0]
    g1 = state._entry_gain(f)
    state.target_db = REPLAYGAIN_REFERENCE_DB + 6.0
    assert state._entry_gain(f) == pytest.approx(g1 + 6.0)


def test_clip_prediction(state):
    state.analyze_tracks()
    f = state.files[0]
    # Force a target that guarantees predicted clipping: need
    # peak * 10^(gain/20) > 1.
    state.target_db = 100.0
    state._update_clipping(f)
    gain = state._entry_gain(f)
    expected = f.peak * 10.0 ** (gain / 20.0) > 1.0
    assert f.clipping == expected


def test_apply_and_undo_roundtrip(state):
    state.analyze_tracks()
    originals = {f.path: f.path.read_bytes() for f in state.files}
    applied = state.apply_gain(use_album=False)
    assert applied == len(state.files)
    changed = [f for f in state.files if f.path.read_bytes() != originals[f.path]]
    assert changed  # at least the non-zero-gain files were modified
    undone = state.undo_all()
    assert undone == len(changed)
    for f in state.files:
        assert f.path.read_bytes() == originals[f.path]


def test_album_analysis(state):
    state.analyze_album()
    gains = {f.album_gain_db for f in state.files}
    assert len(gains) == 1  # single shared album gain
    assert state.files[0].album_gain_db is not None


def test_rows_render(state):
    state.analyze_tracks()
    rows = list(state.rows())
    assert len(rows) == 2
    assert all(r["track_gain"] != "-" for r in rows)


def test_batch_analysis_matches_sequential(fixtures_dir, tmp_path):
    """>= scan.BATCH_THRESHOLD files route through the mesh runner and
    must produce the same per-file results as the sequential path."""
    from mp3rgain_tpu.scan import BATCH_THRESHOLD

    names = ("test_mono.mp3", "test_joint_stereo.mp3")
    paths = []
    for i in range(BATCH_THRESHOLD):
        p = tmp_path / f"t{i:02d}.mp3"
        shutil.copy(fixtures_dir / names[i % len(names)], p)
        paths.append(p)

    batch = AppState()
    assert batch.add_files(paths) == BATCH_THRESHOLD
    batch.analyze_tracks()  # takes the _analyze_batch path
    assert all(f.status == "analyzed" for f in batch.files)

    seq = AppState()
    seq.add_files(paths[:2])
    seq.analyze_tracks()  # below threshold: per-file loop
    for bf, sf in zip(batch.files[:2], seq.files):
        assert bf.track_gain_db == pytest.approx(sf.track_gain_db, abs=1e-9)
        assert bf.peak == pytest.approx(sf.peak, rel=1e-6)

    # Album over the same set: one shared album gain + clip update.
    batch.analyze_album()
    gains = {f.album_gain_db for f in batch.files}
    assert len(gains) == 1 and None not in gains


class FakeScreen:
    """Scripted stand-in for a curses window (ui_loop's screen protocol)."""

    def __init__(self, keys, h=24, w=100):
        self.keys = [ord(k) if isinstance(k, str) else k for k in keys]
        self.h, self.w = h, w
        self.cells = []  # (y, x, text, attr) of the CURRENT frame
        self.frames = []  # all completed frames
        self.refreshes = 0

    def erase(self):
        if self.cells:
            self.frames.append(self.cells)
        self.cells = []

    def getmaxyx(self):
        return self.h, self.w

    def addnstr(self, y, x, s, n, attr=0):
        self.cells.append((y, x, s[:n], attr))

    def refresh(self):
        self.refreshes += 1

    def getch(self):
        return self.keys.pop(0) if self.keys else ord("q")

    def text(self):
        return "\n".join(c[2] for c in self.cells)


def test_ui_loop_renders_and_quits(state):
    from mp3rgain_tpu import gui

    scr = FakeScreen(["q"])
    gui.ui_loop(state, scr)
    out = scr.text()
    assert "mp3rgui (GPU)" in out
    assert "test_mono.mp3" in out and "test_joint_stereo.mp3" in out
    assert scr.refreshes >= 1


def test_ui_loop_analyze_apply_undo(state):
    from mp3rgain_tpu import gui

    originals = {f.path: f.path.read_bytes() for f in state.files}
    scr = FakeScreen(["a", "g", "q"])
    gui.ui_loop(state, scr)
    assert state.status_message.startswith("Applied track gain")
    assert all(f.status == "applied" for f in state.files)
    changed = [f for f in state.files if f.path.read_bytes() != originals[f.path]]
    assert changed

    scr = FakeScreen(["u", "q"])
    gui.ui_loop(state, scr)
    assert state.status_message == f"Undid {len(changed)} file(s)"
    for f in state.files:
        assert f.path.read_bytes() == originals[f.path]


def test_ui_loop_target_and_selection_keys(state):
    from mp3rgain_tpu import gui

    t0 = state.target_db
    scr = FakeScreen(["+", "+", "-", gui.KEY_DOWN, "d", "q"])
    gui.ui_loop(state, scr)
    assert state.target_db == pytest.approx(t0 + 0.5)
    assert len(state.files) == 1  # KEY_DOWN then 'd' removed row 1
    assert state.files[0].name == "test_joint_stereo.mp3"
    # The selected row renders with the reverse attribute.
    last = scr.frames[-1] if scr.frames else scr.cells
    reversed_rows = [c for c in last if c[3] == gui.A_REVERSE]
    assert len(reversed_rows) == 1


def test_batch_progress_is_incremental_and_scan_reused(fixtures_dir, tmp_path, monkeypatch):
    """ADVICE round-2: batch analysis must report per-file progress, and
    analyze_tracks -> analyze_album must not re-decode the library."""
    from mp3rgain_tpu import gui as gui_mod
    from mp3rgain_tpu import scan as scan_mod
    from mp3rgain_tpu.scan import BATCH_THRESHOLD

    paths = []
    for i in range(BATCH_THRESHOLD):
        p = tmp_path / f"t{i:02d}.mp3"
        shutil.copy(fixtures_dir / "test_mono.mp3", p)
        paths.append(p)

    calls = {"n": 0}
    real_scan_files = scan_mod.scan_files

    def counting_scan_files(*a, **kw):
        calls["n"] += 1
        return real_scan_files(*a, **kw)

    monkeypatch.setattr(scan_mod, "scan_files", counting_scan_files)

    s = gui_mod.AppState()
    s.add_files(paths)
    seen = []
    s.analyze_tracks(progress_cb=lambda p, entry: seen.append((p, entry)))
    assert calls["n"] == 1
    # Incremental per-file updates, strictly increasing up to 1.0.
    progresses = [p for p, _ in seen]
    assert len(progresses) == BATCH_THRESHOLD
    assert progresses == sorted(progresses) and progresses[-1] == pytest.approx(1.0)
    assert all(e is not None for _, e in seen)

    s.analyze_album()  # must reuse the cached ScanResult
    assert calls["n"] == 1
    assert all(f.album_gain_db is not None for f in s.files)

    s.apply_gain()  # invalidates the cache (files changed on disk)
    s.analyze_tracks()
    assert calls["n"] == 2


def test_batch_analysis_isolates_bad_files(fixtures_dir, tmp_path):
    from mp3rgain_tpu.scan import BATCH_THRESHOLD

    paths = []
    for i in range(BATCH_THRESHOLD - 1):
        p = tmp_path / f"t{i:02d}.mp3"
        shutil.copy(fixtures_dir / "test_mono.mp3", p)
        paths.append(p)
    bad = tmp_path / "bad.mp3"
    bad.write_bytes(b"\xff\xfb" + b"\x00" * 64)  # sync but no valid frames
    paths.append(bad)

    s = AppState()
    s.add_files(paths)
    s.analyze_tracks()
    by_name = {f.name: f for f in s.files}
    assert by_name["bad.mp3"].status == "error"
    good = [f for f in s.files if f.name != "bad.mp3"]
    assert all(f.status == "analyzed" for f in good)


def test_menu_bar_renders_and_navigates(state):
    """Menu bar parity with the reference (mp3rgui/src/ui/menu.rs):
    'm' opens File, arrows move between menus/items, Esc closes."""
    from mp3rgain_tpu import gui

    scr = FakeScreen(["m", gui.KEY_RIGHT, gui.KEY_DOWN, 27, "q"])
    gui.ui_loop(state, scr)
    # Menu titles are always on row 0.
    last = scr.frames[-1] if scr.frames else scr.cells
    row0 = " ".join(c[2] for c in last if c[0] == 0)
    for title in ("File", "Analysis", "Modify Gain", "Options", "Help"):
        assert title in row0
    # While Analysis was open, its dropdown items rendered.
    all_text = "\n".join("\n".join(c[2] for c in f) for f in scr.frames)
    assert "Track Analysis" in all_text and "Album Analysis" in all_text


def test_menu_analysis_and_apply_actions(state):
    """Analysis + Modify Gain menu items drive the same AppState paths
    as the key bindings."""
    from mp3rgain_tpu import gui

    # m -> right (Analysis) -> Enter (Track Analysis) -> quit
    scr = FakeScreen(["m", gui.KEY_RIGHT, 10, "q"])
    gui.ui_loop(state, scr)
    assert all(f.status == "analyzed" for f in state.files)
    assert state.status_message == "Track analysis done"

    originals = {f.path: f.path.read_bytes() for f in state.files}
    # m -> right x2 (Modify Gain) -> Enter (Apply Track Gain) -> quit
    scr = FakeScreen(["m", gui.KEY_RIGHT, gui.KEY_RIGHT, 10, "q"])
    gui.ui_loop(state, scr)
    assert state.status_message.startswith("Applied track gain")
    assert all(f.status == "applied" for f in state.files)

    # Modify Gain -> down x3 -> Undo Gain Changes
    scr = FakeScreen(["m", gui.KEY_RIGHT, gui.KEY_RIGHT,
                      gui.KEY_DOWN, gui.KEY_DOWN, gui.KEY_DOWN, 10, "q"])
    gui.ui_loop(state, scr)
    assert state.status_message.startswith("Undid")
    for f in state.files:
        assert f.path.read_bytes() == originals[f.path]


def test_menu_options_target_and_help(state):
    from mp3rgain_tpu import gui
    from mp3rgain_tpu.replaygain import REPLAYGAIN_REFERENCE_DB

    t0 = state.target_db
    # Options -> Target +0.5
    scr = FakeScreen(["m", gui.KEY_RIGHT, gui.KEY_RIGHT, gui.KEY_RIGHT,
                      10, "q"])
    gui.ui_loop(state, scr)
    assert state.target_db == pytest.approx(t0 + 0.5)
    # Options -> down x2 -> Reset
    scr = FakeScreen(["m", gui.KEY_RIGHT, gui.KEY_RIGHT, gui.KEY_RIGHT,
                      gui.KEY_DOWN, gui.KEY_DOWN, 10, "q"])
    gui.ui_loop(state, scr)
    assert state.target_db == REPLAYGAIN_REFERENCE_DB
    # Help -> About
    scr = FakeScreen(["m", gui.KEY_LEFT, 10, "q"])
    gui.ui_loop(state, scr)
    assert "mp3rgui (GPU)" in state.status_message
    # The target readout is visible on the menu bar row.
    last = scr.frames[-1] if scr.frames else scr.cells
    row0 = " ".join(c[2] for c in last if c[0] == 0)
    assert f"Target: {state.target_db:.1f} dB" in row0


def test_menu_constant_gain_prompt(state, tmp_path):
    """Apply Constant Gain... prompts for a dB value and applies it via
    the undo-tracked surgery (exceeds the reference's TODO)."""
    from mp3rgain_tpu import gui

    originals = {f.path: f.path.read_bytes() for f in state.files}
    # Modify Gain -> down x2 -> Apply Constant Gain... -> "3.0" Enter
    keys = (["m", gui.KEY_RIGHT, gui.KEY_RIGHT, gui.KEY_DOWN, gui.KEY_DOWN, 10]
            + list("3.0") + [10, "q"])
    scr = FakeScreen(keys)
    gui.ui_loop(state, scr)
    assert state.status_message == "Applied constant gain to 2 file(s)"
    changed = [f for f in state.files if f.path.read_bytes() != originals[f.path]]
    assert len(changed) == 2  # 3.0 dB = 2 steps, both files modified
    assert state.undo_all() == 2
    for f in state.files:
        assert f.path.read_bytes() == originals[f.path]


def test_menu_add_and_clear_files(state, tmp_path, fixtures_dir):
    from mp3rgain_tpu import gui

    extra = tmp_path / "extra.mp3"
    shutil.copy(fixtures_dir / "test_mono.mp3", extra)
    n0 = len(state.files)
    # File -> Add Files... -> type path -> Enter
    keys = (["m", 10] + [ord(ch) for ch in str(extra)] + [10, "q"])
    scr = FakeScreen(keys)
    gui.ui_loop(state, scr)
    assert len(state.files) == n0 + 1
    assert state.status_message == "Added 1 file(s)"

    # File -> down x3 -> Clear File List
    scr = FakeScreen(["m", gui.KEY_DOWN, gui.KEY_DOWN, gui.KEY_DOWN, 10, "q"])
    gui.ui_loop(state, scr)
    assert state.files == []

    # File -> down x4 -> Exit leaves the loop without consuming 'q'.
    scr = FakeScreen(["m"] + [gui.KEY_DOWN] * 4 + [10, "X"])
    gui.ui_loop(state, scr)
    assert scr.keys == [ord("X")]


def test_status_panel_progress_bars(state):
    """The bottom panel shows dual File/Total bars (status.rs) and the
    file count, live-updated during analysis."""
    from mp3rgain_tpu import gui

    scr = FakeScreen(["a", "q"], h=24, w=100)
    gui.ui_loop(state, scr)
    all_frames = scr.frames + [scr.cells]
    bar_cells = [c for f in all_frames for c in f
                 if c[0] == 22 and c[2].startswith("File: [")]
    assert bar_cells, "status panel never rendered"
    assert any("Total: [############] 100%" in c[2] for c in bar_cells)
    count_cells = [c for f in all_frames for c in f if c[0] == 23]
    assert any("2 files" in c[2] for c in count_cells)
