"""Multi-device sharding tests on the virtual 8-device CPU mesh: the
sharded render must equal the single-device render bit-for-bit."""

import numpy as np
import jax
import pytest

import cosig_tpu
from cosig_tpu.models.soa import compile_scene, frame_params, static_config
from cosig_tpu.ops import trace_xla
from cosig_tpu.parallel.sharding import make_mesh, render_sharded
from cosig_tpu.scene.parser import load_scene


@pytest.fixture(scope="module")
def scene(demo_scene_path):
    return load_scene(demo_scene_path)


def _both(scene, settings, n_devices):
    arrays = compile_scene(scene)
    params = frame_params(scene, settings)
    cfg = static_config(scene, settings)
    ref = np.asarray(trace_xla.render_jit(arrays, params, cfg))
    mesh = make_mesh(n_devices)
    img = np.asarray(render_sharded(arrays, params, cfg, mesh))
    return img, ref


def test_requires_devices():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"


@pytest.mark.parametrize("n", [2, 8])
def test_sharded_equals_single(scene, n):
    st = cosig_tpu.RenderSettings(resolution_override=(64, 48), max_depth=2)
    img, ref = _both(scene, st, n)
    np.testing.assert_array_equal(img, ref)


def test_sharded_height_not_divisible(scene):
    # 50 rows over 8 devices: padding path.
    st = cosig_tpu.RenderSettings(resolution_override=(32, 50), max_depth=1)
    img, ref = _both(scene, st, 8)
    assert img.shape == (50, 32, 3)
    np.testing.assert_array_equal(img, ref)


def test_sharded_with_effects():
    from cosig_tpu.scene.generate import CONFIGS

    # glass_sphere: refraction + soft-shadow jitter. (In demo_cornell a
    # silhouette tie-break between the glass box and a wall flips under
    # the drift below, which is a different test.)
    scene, _ = CONFIGS["glass_sphere"]()
    st = cosig_tpu.RenderSettings(
        resolution_override=(32, 32), max_depth=2, aa_samples=2,
        enable_soft_shadows=True, light_size=5.0,
    )
    img, ref = _both(scene, st, 4)
    # Different per-shard batch shapes let XLA:CPU vectorize reductions in a
    # different order; tolerate ULP-scale drift (observed max ~3e-4 on the
    # pow-32 specular term).
    np.testing.assert_allclose(img, ref, atol=5e-4)
