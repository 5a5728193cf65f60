"""The map readers of the main path (mapping/map_io.py) against PyYAML
and Pillow on every committed map, and load_map with neither installed."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from monte_carlo_localization_tpu.mapping import map_io

MAPS = Path(__file__).resolve().parents[1] / "maps"
YAMLS = [
    "Spielberg_map.yaml", "basement_fixed.map.yaml", "first_map.yaml",
    "icra_2_clean.yaml", "levine.yaml", "map_1753950572.yaml",
    "map_1755669035.yaml", "new_map1.yaml", "redbull_1.yaml",
    "sibal1.yaml", "slam_map.yaml",
]
IMAGES = [
    "Spielberg_map.png", "basement_fixed.png", "first_map.pgm",
    "icra_2_clean.png", "map_1753950572.pgm", "map_1755669035.pgm",
    "new_map1.png", "redbull_1.png", "sibal1.png", "slam_map.png",
]


@pytest.mark.parametrize("name", YAMLS)
def test_map_yaml_matches_pyyaml(name):
    yaml = pytest.importorskip("yaml")
    want = yaml.safe_load((MAPS / name).read_text())
    assert map_io.read_map_yaml(MAPS / name) == want


@pytest.mark.parametrize("name", IMAGES)
def test_map_image_matches_pillow(name):
    image = pytest.importorskip("PIL.Image")
    with image.open(MAPS / name) as im:
        want = np.asarray(im.convert("L"))
    got = map_io.read_image(MAPS / name)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_yaml_reader_rejects_nesting():
    with pytest.raises(ValueError, match="nested"):
        map_io.parse_map_yaml("a:\n  b: 1\n")


def test_load_map_without_pyyaml_or_pillow():
    """The main path imports neither: block both and load a real map."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('yaml', 'PIL'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "import monte_carlo_localization_tpu\n"
        "from monte_carlo_localization_tpu import load_map\n"
        "gm = load_map('maps/Spielberg_map.yaml')\n"
        "print(gm.height, gm.width, int(gm.num_free))\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         cwd=MAPS.parent, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    h, w, free = map(int, out.stdout.split())
    assert (h, w) == (2000, 2000) and free > 0
