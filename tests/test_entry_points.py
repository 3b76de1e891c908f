"""The GPU entry points as far as the CPU can check them: chip_smoke.py and
bench.py refuse to measure a CPU, the compile-cache helper places the
cache, and the renderer picks brute force or the BVH walk by scene size."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from cosig_tpu.models.scene import (
    CameraSettings,
    CompositeTransformation,
    ImageSettings,
    LightSource,
    MaterialDescription,
    SceneData,
    TransformElement,
    Triangle,
    TrianglesMesh,
)
from cosig_tpu.models.settings import RenderSettings
from cosig_tpu.render import renderer as renderer_mod
from cosig_tpu.utils import compile_cache

REPO = pathlib.Path(__file__).resolve().parents[1]


def _import_root(name):
    """Import a script that lives at the repo root (not in the package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, REPO / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_script(*argv):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, *argv], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("argv", [[], ["--four-cards"]], ids=["one_card", "four_cards"])
def test_chip_smoke_refuses_cpu(argv):
    proc = _run_script("chip_smoke.py", *argv)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_bench_refuses_cpu():
    proc = _run_script("bench.py", "--config", "diffuse_sphere")
    assert proc.returncode != 0
    assert "measures a GPU" in proc.stderr


def test_bench_all_fails_when_a_config_fails():
    """Every child refuses the CPU, so the sweep must exit non-zero and
    name every config as failed."""
    proc = _run_script("bench.py", "--all", "--repeats", "1")
    assert proc.returncode == 1
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert len(rec["failed"]) == 5


def test_bench_config_reports_a_frame():
    r = _import_root("bench").bench_config("diffuse_sphere", repeats=2, resolution=16)
    assert r["resolution"] == [16, 16]
    assert r["device"]["platform"] == "cpu"
    assert len(r["frame_ms"]) == 2 and r["ms_per_frame"] > 0
    assert r["image_finite"] and r["image_min"] >= 0.0
    # Depth 1, one light: at least one primary ray per pixel, at most a
    # primary and a shadow ray each.
    assert 16 * 16 <= r["rays_traced"] <= 2 * 16 * 16


def _record_config_updates(monkeypatch):
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    calls = _record_config_updates(monkeypatch)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = _record_config_updates(monkeypatch)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO / ".jaxcache")
    assert compile_cache.enable_compile_cache() == want
    assert calls == [("jax_compilation_cache_dir", want)]


def _strip_scene(n_tris: int) -> SceneData:
    """n_tris small triangles in a row facing a camera at (0, 0, 10)."""
    tris = [
        Triangle(0, (x, -0.5, 0.0), (x + 0.8, -0.5, 0.0), (x + 0.4, 0.5, 0.0))
        for x in np.linspace(-40.0, 40.0, n_tris)
    ]
    return SceneData(
        image=ImageSettings(horizontal=8, vertical=8, background=(0.0, 0.0, 0.0)),
        transformations=[
            CompositeTransformation(),
            CompositeTransformation([TransformElement.translation((0, 0, 30))]),
        ],
        camera=CameraSettings(transformation_index=0, distance=10.0, vertical_fov_deg=60.0),
        lights=[LightSource(transformation_index=1, rgb=(1, 1, 1))],
        materials=[MaterialDescription(color=(1, 1, 1), ambient=0.5, diffuse=0.5)],
        triangle_meshes=[TrianglesMesh(transformation_index=0, triangles=tris)],
    )


@pytest.mark.parametrize(
    "backend,n_tris,debug_mode,path",
    [
        ("auto", renderer_mod.BVH_MIN_TRIANGLES, 0, "brute"),
        ("auto", renderer_mod.BVH_MIN_TRIANGLES + 1, 0, "bvh"),
        ("auto", renderer_mod.BVH_MIN_TRIANGLES + 1, 3, "brute"),
        ("xla-brute", renderer_mod.BVH_MIN_TRIANGLES + 1, 0, "brute"),
    ],
    ids=["auto_at_threshold", "auto_above", "debug_above", "xla_brute_above"],
)
def test_backend_picks_closest_hit_by_size(monkeypatch, backend, n_tris, debug_mode, path):
    from cosig_tpu.ops import bvh_traverse, trace_xla

    taken = []
    for mod, name, label in (
        (trace_xla, "render_jit", "brute"),
        (bvh_traverse, "render_jit_bvh", "bvh"),
    ):
        orig = getattr(mod, name)
        monkeypatch.setattr(
            mod, name,
            lambda *a, _o=orig, _l=label, **k: (taken.append(_l), _o(*a, **k))[1],
        )
    r = renderer_mod.Renderer(backend=backend)
    img = r.render(_strip_scene(n_tris), RenderSettings(max_depth=1, debug_mode=debug_mode))
    assert taken == [path]
    assert r.last_stats.triangles == n_tris
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_unknown_backend_is_an_error():
    with pytest.raises(ValueError, match="unknown backend"):
        renderer_mod.Renderer(backend="no-such-backend")


def test_dryrun_multichip_on_virtual_mesh(capsys):
    _import_root("__graft_entry__").dryrun_multichip(8)
    assert "dryrun_multichip OK: 8 devices" in capsys.readouterr().out
