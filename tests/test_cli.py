"""CLI smoke tests (XLA backend on CPU)."""

import json
import numpy as np
import pytest

from cosig_tpu.cli import main
from cosig_tpu.utils.png import read_png, write_png


@pytest.fixture
def scene_path(demo_scene_path):
    return demo_scene_path


def test_render_command(tmp_path, scene_path, capsys):
    out = str(tmp_path / "r.png")
    rc = main([
        "render", scene_path, "-o", out,
        "--backend", "xla", "--width", "32", "--height", "24", "--depth", "1",
    ])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (24, 32, 3)
    assert "rendered 32x24" in capsys.readouterr().out


def test_render_generated_config(tmp_path, capsys):
    out = str(tmp_path / "g.png")
    rc = main([
        "render", "generated:diffuse_sphere", "-o", out,
        "--backend", "xla", "--width", "24", "--height", "24",
    ])
    assert rc == 0
    assert read_png(out).shape == (24, 24, 3)


def test_info_command(scene_path, capsys):
    assert main(["info", scene_path]) == 0
    out = capsys.readouterr().out
    assert "788" in out
    assert "BVH" in out


def test_compare_command(tmp_path, capsys):
    rng = np.random.default_rng(0)
    a = rng.random((16, 16, 3)).astype(np.float32)
    pa, pb = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    write_png(pa, a)
    write_png(pb, a)
    assert main(["compare", pa, pb, "--threshold", "0.001"]) == 0
    result = json.loads(capsys.readouterr().out.strip())
    assert result["rmse"] == 0.0
    # Different images beyond threshold -> exit 1.
    write_png(pb, 1.0 - a)
    assert main(["compare", pa, pb, "--threshold", "0.001"]) == 1


def test_turntable_command(tmp_path, scene_path):
    from cosig_tpu.utils.gif import decode_gif_frame_count

    out = str(tmp_path / "t.gif")
    rc = main([
        "turntable", scene_path, "-o", out,
        "--backend", "xla", "--width", "16", "--height", "16",
        "--depth", "1", "--steps", "4",
    ])
    assert rc == 0
    assert decode_gif_frame_count(out) == 4


def test_preset_commands(tmp_path, capsys):
    path = str(tmp_path / "p.json")
    assert main(["preset", "save", path, "--scene", "/x.txt", "--name", "t1"]) == 0
    assert main(["preset", "load", path]) == 0
    out = capsys.readouterr().out
    assert "t1" in out


def test_render_chunked_resume(tmp_path, scene_path):
    out = str(tmp_path / "c.png")
    ck = str(tmp_path / "ck.npz")
    rc = main([
        "render", scene_path, "-o", out, "--backend", "xla",
        "--width", "24", "--height", "30", "--depth", "1",
        "--chunk-rows", "8", "--checkpoint", ck,
    ])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (30, 24, 3)
    import os
    assert not os.path.exists(ck)  # removed on completion


def test_preview_zero_readback(tmp_path, capsys, monkeypatch):
    """The preview loop must honor the reference's realtime contract
    (RayTracer.cs:76-82): zero device->host readbacks between frames.
    ``Renderer.render`` IS the readback path (np.asarray of the device
    frame), so stub it to fail loudly and count ``render_to_device``."""
    from cosig_tpu.render import renderer as renderer_mod

    calls = {"to_device": 0}
    orig = renderer_mod.Renderer.render_to_device

    def counting(self, scene, settings):
        calls["to_device"] += 1
        return orig(self, scene, settings)

    def forbidden(self, scene, settings):
        raise AssertionError("preview loop performed a per-frame readback")

    monkeypatch.setattr(renderer_mod.Renderer, "render_to_device", counting)
    monkeypatch.setattr(renderer_mod.Renderer, "render", forbidden)

    rc = main([
        "preview", "generated:diffuse_sphere", "--backend", "xla",
        "--width", "16", "--height", "16", "--frames", "3", "--orbit", "15",
    ])
    assert rc == 0
    assert calls["to_device"] == 3
    assert "FPS avg" in capsys.readouterr().out


def test_preview_save_dir_after_loop(tmp_path):
    """--save-dir reads frames back only AFTER the timed loop."""
    rc = main([
        "preview", "generated:diffuse_sphere", "--backend", "xla",
        "--width", "16", "--height", "16", "--frames", "2",
        "--save-dir", str(tmp_path),
    ])
    assert rc == 0
    assert read_png(str(tmp_path / "frame_0000.png")).shape == (16, 16, 3)
    assert read_png(str(tmp_path / "frame_0001.png")).shape == (16, 16, 3)
