"""Golden-image regression gate (SURVEY.md section 4's recommended harness):
the bundled reference scenes rendered by the oracle must stay within a
tight RMSE of the committed goldens across refactors."""

import pathlib

import numpy as np
import pytest

import cosig_tpu
from cosig_tpu.render.renderer import Renderer
from cosig_tpu.scene.parser import load_scene
from cosig_tpu.utils.png import read_png

GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"

SETTINGS = cosig_tpu.RenderSettings(
    resolution_override=(96, 96), max_depth=3, light_intensity_scale=1.0
)


def _rmse_vs_golden(img, name):
    golden = read_png(str(GOLDEN_DIR / name)).astype(np.float32) / 255.0
    # Compare in quantized space (goldens are 8-bit PNGs).
    q = np.clip(np.round(np.asarray(img) * 255.0), 0, 255) / 255.0
    return float(np.sqrt(((q - golden) ** 2).mean()))


@pytest.mark.parametrize("name", ["test_scene_1", "test_scene_2", "eval_scene"])
def test_reference_scene_goldens_xla(reference_scene_dir, name):
    scene = load_scene(str(reference_scene_dir / f"{name}.txt"))
    img = Renderer(backend="xla").render(scene, SETTINGS)
    assert _rmse_vs_golden(img, f"{name}_96_d3.png") < 2e-3


def test_demo_scene_golden():
    scene = load_scene("scenes/demo_cornell.txt")
    img = Renderer(backend="xla").render(scene, SETTINGS.replace(max_depth=4))
    assert _rmse_vs_golden(img, "demo_cornell_96_d4.png") < 2e-3
