"""Test configuration: run everything on a virtual 8-device CPU mesh so
multi-device sharding paths are exercised without GPUs."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
# The CLI turns on the persistent compile cache; tests write none.
jax.config.update("jax_enable_compilation_cache", False)

import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
REFERENCE_SCENES = pathlib.Path("/root/reference/Assets/Resources/Scenes")
DEMO_SCENE = REPO / "scenes" / "demo_cornell.txt"


@pytest.fixture(scope="session")
def reference_scene_dir():
    if not REFERENCE_SCENES.is_dir():
        pytest.skip("reference scenes not available")
    return REFERENCE_SCENES


@pytest.fixture(scope="session")
def demo_scene_path():
    """The in-repo Cornell-box scene (788 triangles, every segment type)."""
    return str(DEMO_SCENE)
