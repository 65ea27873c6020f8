"""The port's operations: its CLI (``python -m hyper_ray_tracer_tpu_torch``)
with checkpoint/resume, preview, watch and profile, and ``render_image``'s
checkpoints, on the CPU.  The cases of ``tests/test_cli.py`` and
``tests/test_utils.py`` at their sizes, then what the port adds: the
resume is shown to start from a checkpoint that was really written, a
checkpoint of the JAX package is refused, a bad value in a watch file is
ignored, and the chunk boundaries leave the image as it is."""

import logging
import threading
import time

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu_torch import build_scene  # noqa: E402
from hyper_ray_tracer_tpu_torch import render as render_mod  # noqa: E402
from hyper_ray_tracer_tpu_torch.__main__ import main  # noqa: E402
from hyper_ray_tracer_tpu_torch.render import (  # noqa: E402
    RenderSettings,
    render_image,
)
from hyper_ray_tracer_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from hyper_ray_tracer_tpu_torch.utils import watch as W  # noqa: E402


def _png(path):
    return np.asarray(Image.open(path))


def _render(scene, progress_cb=None, **settings):
    return render_image(scene, RenderSettings(**settings), "cpu",
                        progress_cb)


# --- tests/test_cli.py's cases on the port's CLI ---

def test_cli_renders_png(tmp_path):
    out = tmp_path / "out.png"
    rc = main([
        "--scene", "three-spheres", "--width", "64", "--height", "36",
        "--samples", "2", "--depth", "4", "--output", str(out),
        "--verbosity", "0", "--cpu",
    ])
    assert rc == 0
    img = _png(out)
    assert img.shape == (36, 64, 3)
    assert img.max() > 32  # not black


def test_cli_reference_flags_accepted(tmp_path):
    """All six reference flags (the vestigial --tile-size too) parse."""
    out = tmp_path / "r.png"
    rc = main([
        "--width", "32", "--height", "18", "--samples", "1",
        "--depth", "2", "--tile-size", "80", "--scene", "two-spheres",
        "--output", str(out), "--verbosity", "0", "--cpu",
    ])
    assert rc == 0
    assert out.exists()


def test_cli_jax_compatibility_flags(tmp_path, caplog, monkeypatch):
    """--no-bvh warns that it is deprecated; --no-partition runs every
    bounce plain, and on a render that does partition (`final`, the lane
    floor lowered to this size) it leaves the PNG unchanged: the port's
    partitioned sweep is exact."""
    from hyper_ray_tracer_tpu_torch.ops import partition

    monkeypatch.setattr(partition, "PART_MIN_LANES", 256)
    made = []
    init = render_mod.PartitionSchedule.__init__
    monkeypatch.setattr(render_mod.PartitionSchedule, "__init__",
                        lambda self, *a: (made.append(self), init(self, *a))
                        and None)
    common = ["--scene", "final", "--width", "32", "--height", "18",
              "--samples", "1", "--depth", "3", "--verbosity", "0", "--cpu"]
    plain, flagged = tmp_path / "a.png", tmp_path / "b.png"
    assert main([*common, "--output", str(plain)]) == 0
    assert len(made) == 1 and any(made[0].decisions), made[0].decisions
    with caplog.at_level(logging.WARNING):
        assert main([*common, "--no-bvh", "--no-partition",
                     "--output", str(flagged)]) == 0
    assert len(made) == 1  # --no-partition made no schedule
    assert "--no-bvh is deprecated" in caplog.text
    np.testing.assert_array_equal(_png(plain), _png(flagged))


def test_cli_checkpoint_resume(tmp_path):
    out1 = tmp_path / "a.png"
    out2 = tmp_path / "b.png"
    ck = tmp_path / "c.ckpt"
    common = ["--scene", "three-spheres", "--width", "32", "--height", "18",
              "--depth", "4", "--checkpoint", str(ck), "--verbosity", "0",
              "--spp-chunk", "2", "--cpu"]
    # Full render in one go.
    assert main([*common, "--samples", "4", "--output", str(out1)]) == 0
    ck.unlink()
    # Render half, then resume to the full count: bit-identical.
    assert main([*common, "--samples", "2", "--output", str(out2)]) == 0
    assert ckpt.load_state(str(ck))[1] == 2  # the resume starts from it
    assert main([*common, "--samples", "4", "--output", str(out2)]) == 0
    assert ckpt.load_state(str(ck))[1] == 4
    np.testing.assert_array_equal(_png(out1), _png(out2))


def test_cli_progressive_preview(tmp_path):
    """--preview writes a viewable progressive PNG that ends equal to the
    final image."""
    out = tmp_path / "o.png"
    pv = tmp_path / "p.png"
    rc = main([
        "--scene", "three-spheres", "--width", "32", "--height", "18",
        "--samples", "4", "--depth", "4", "--spp-chunk", "2",
        "--output", str(out), "--preview", str(pv), "--verbosity", "0",
        "--cpu",
    ])
    assert rc == 0
    np.testing.assert_array_equal(_png(out), _png(pv))


def test_preview_chunk_granularity(tmp_path, monkeypatch):
    """A previewed render refreshes its PNG at least 8 times: the auto spp
    chunk is capped to an eighth of the samples, and the snapshot
    cadence is every chunk."""
    writes = []
    real = render_mod.write_png

    def counting(path, img):
        writes.append(path)
        return real(path, img)

    monkeypatch.setattr(render_mod, "write_png", counting)
    pv = tmp_path / "p.png"
    # 16 spp at 24x14: the auto chunk would take every sample at once.
    _render(build_scene("three-spheres"), width=24, height=14, samples=16,
            depth=4, preview_path=str(pv))
    assert len(writes) >= 8, f"only {len(writes)} preview refreshes"


def test_preview_chunk_cap_moves_only_low_bits():
    """The preview's cap changes the chunk boundaries, but every sample
    is added to the accumulator one after the other whatever the
    boundaries (``render.accumulate_samples``), so the image is the same
    bit for bit.  (When each chunk was summed on its own first, 22% of
    the values moved, by one float32 ulp near 1, on three-spheres at
    24x14x16 d4.)"""
    scene = build_scene("three-spheres")
    s = dict(width=24, height=14, samples=16, depth=4)
    auto = _render(scene, **s)
    capped = _render(scene, **s, spp_chunk=2)
    np.testing.assert_array_equal(capped, auto)
    np.testing.assert_array_equal(capped, _render(scene, **s, spp_chunk=2))


def test_watch_overrides_parsing(tmp_path):
    """load_overrides keeps the accepted keys and survives invalid JSON
    (a half-written editor save keeps the previous params)."""
    p = tmp_path / "params.json"
    p.write_text('{"samples": 8, "width": 64, "bogus": 1}')
    assert W.load_overrides(str(p)) == {"samples": 8, "width": 64}
    p.write_text('{"samples": ')  # torn write
    assert W.load_overrides(str(p)) is None
    p.write_text('[1, 2]')  # not an object
    assert W.load_overrides(str(p)) is None


def test_watch_overrides_drop_bad_values(tmp_path, caplog):
    """A value no flag accepts (a non-numeric or zero width, a bool, an
    unknown scene) is warned about and dropped, the rest kept."""
    p = tmp_path / "params.json"
    p.write_text('{"width": "abc", "height": 0, "depth": true, '
                 '"scene": "nope", "seed": 0, "samples": 3, '
                 '"spp_chunk": null}')
    with caplog.at_level(logging.WARNING):
        got = W.load_overrides(str(p), log=logging.getLogger("watch-test"))
    assert got == {"seed": 0, "samples": 3, "spp_chunk": None}
    for key in ("width", "height", "depth", "scene"):
        assert f"ignoring {key}=" in caplog.text


def _watch_session(tmp_path, monkeypatch, edits):
    """Run the CLI in watch mode on a 32x18 render and write each of
    ``edits`` to its params file in turn once the previous render is
    out, stopping the session after the last edit's re-render; returns
    the CLI's exit code and the last PNG."""
    out = tmp_path / "w.png"
    params = tmp_path / "params.json"
    params.write_text("{}")
    real_loop = W.watch_loop

    def bounded_loop(path, on_change, poll_s=0.5, log=None, max_iters=None):
        seen = []

        def counted(overrides):
            on_change(overrides)
            seen.append(overrides)
            if len(seen) == len(edits):
                raise KeyboardInterrupt  # Ctrl-C: how a session ends

        return real_loop(path, counted, poll_s=0.05, log=log,
                         max_iters=2000)

    monkeypatch.setattr(W, "watch_loop", bounded_loop)

    def edit_params():
        for text in edits:
            for _ in range(600):  # the render before this edit is out
                if out.exists():
                    break
                time.sleep(0.05)
            time.sleep(0.3)
            out.unlink()
            params.write_text(text)

    t = threading.Thread(target=edit_params)
    t.start()
    rc = main([
        "--scene", "three-spheres", "--width", "32", "--height", "18",
        "--samples", "1", "--depth", "3", "--output", str(out),
        "--verbosity", "0", "--watch", str(params), "--cpu",
    ])
    t.join(timeout=60)
    assert not t.is_alive()
    return rc, _png(out)


def test_cli_watch_rerenders(tmp_path, monkeypatch):
    """--watch re-renders with the new params when the watched JSON file
    changes."""
    rc, img = _watch_session(tmp_path, monkeypatch,
                             ['{"width": 48, "height": 26, "samples": 1}'])
    assert rc == 0
    assert img.shape == (26, 48, 3)  # the re-render overwrote the 18x32


def test_cli_watch_survives_a_bad_width(tmp_path, monkeypatch):
    """A watch file with "width": "abc" re-renders with the width left as
    it was, and the session goes on to the next edit."""
    rc, img = _watch_session(tmp_path, monkeypatch, [
        '{"width": "abc", "height": 20}',
        '{"width": 40, "height": 22}'])
    assert rc == 0
    assert img.shape == (22, 40, 3)


def test_cli_profile_writes_a_trace(tmp_path):
    """--profile LOGDIR leaves a Chrome trace of the render there, with
    the render's layers as ranges."""
    logdir = tmp_path / "prof"
    assert main(["--scene", "two-spheres", "--width", "16", "--height", "9",
                 "--samples", "1", "--depth", "2", "--verbosity", "0",
                 "--cpu", "--output", str(tmp_path / "p.png"),
                 "--profile", str(logdir)]) == 0
    traces = list(logdir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    for name in ("raygen", "trace", "shade", "compaction"):
        assert f'"{name}"' in text, name


# --- tests/test_utils.py's checkpoint cases on render_image ---

def test_checkpoint_resume_bit_identical(tmp_path):
    """Interrupted after its first chunk, with a snapshot every chunk (the
    JAX test's cadence of 8 writes no checkpoint before its interrupt),
    then resumed: equal to the uninterrupted render bit for bit."""
    scene = build_scene("three-spheres")
    base = dict(width=20, height=12, samples=4, depth=4, spp_chunk=2)
    full = _render(scene, **base)

    ck = str(tmp_path / "r.ckpt")
    calls = {"n": 0}

    def interrupt(done, total):
        calls["n"] += 1
        if calls["n"] == 1:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        _render(scene, interrupt, **base, checkpoint_path=ck,
                snapshot_every=1)
    state = ckpt.load_state(ck)
    assert state is not None and state[1] == 2

    done = []
    resumed = _render(scene, lambda d, t: done.append(d), **base,
                      checkpoint_path=ck)
    assert done == [4]  # one chunk left to render after the resume
    np.testing.assert_array_equal(full, resumed)


def test_checkpoint_mismatch_restarts(tmp_path):
    scene = build_scene("three-spheres")
    ck = str(tmp_path / "r.ckpt")
    a = _render(scene, width=20, height=12, samples=2, depth=4,
                checkpoint_path=ck)
    # Another depth: the checkpoint is ignored, not reused.
    b = _render(scene, width=20, height=12, samples=2, depth=3,
                checkpoint_path=ck)
    assert not np.array_equal(a, b)
    np.testing.assert_array_equal(
        b, _render(scene, width=20, height=12, samples=2, depth=3))


def test_checkpoint_format_version_rejected(tmp_path, caplog):
    """An accumulator written under another format (another realization
    of the estimator) is refused, not blended."""
    scene = build_scene("three-spheres")
    path = str(tmp_path / "c.ckpt")
    s = dict(width=16, height=9, samples=2, depth=3, seed=1)
    img_fresh = _render(scene, **s)

    # A checkpoint of another format claiming 1 finished sample of junk.
    junk = np.full((16 * 9, 3), 7.0, np.float64)
    ckpt.save_state(path, junk, 1, dict(scene="three-spheres", width=16,
                                        height=9, depth=3, seed=1,
                                        format=1))
    with caplog.at_level(logging.WARNING):
        img = _render(scene, **s, checkpoint_path=path)
    np.testing.assert_array_equal(img, img_fresh)  # started fresh
    assert "does not match" in caplog.text


def test_jax_checkpoint_is_refused(tmp_path, caplog):
    """A checkpoint written by the JAX package (its own save_state, the
    meta its render_image writes) is refused with a warning and the
    render starts fresh: the two estimators part on some lanes."""
    from hyper_ray_tracer_tpu.render import RENDER_FORMAT_VERSION
    from hyper_ray_tracer_tpu.utils import checkpoint as j_ckpt

    scene = build_scene("three-spheres")
    path = str(tmp_path / "j.ckpt")
    s = dict(width=16, height=9, samples=2, depth=3)
    img_fresh = _render(scene, **s)
    j_ckpt.save_state(path, np.full((16 * 9, 3), 7.0, np.float32), 1, dict(
        scene="three-spheres", width=16, height=9, depth=3, seed=0,
        format=RENDER_FORMAT_VERSION, intersector="sweep", partition=False,
        bf16_hits=False))
    with caplog.at_level(logging.WARNING):
        img = _render(scene, **s, checkpoint_path=path)
    assert "does not match" in caplog.text
    np.testing.assert_array_equal(img, img_fresh)
    assert ckpt.load_state(path)[2]["format"] == render_mod.RENDER_FORMAT
