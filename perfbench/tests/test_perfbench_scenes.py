"""The frozen scene generators: their draws pinned by digest at a small
size, and the seed's effect."""

import hashlib
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from perfbench import harness  # noqa: E402
from perfbench.tests import small  # noqa: E402

DIGESTS = {
    # sha256 of the five parameter leaves' bytes, then of the targets'
    "bicycle-6m": "63346d7e2c66f540aa941d2bf6e63cfabd3bf3cc91f306351ed12fc5462a01fe",
    "bigcity-25m": "fe7609be60a770e85e353fa6da3950327139d5affbc4eac52d8f658c5c37e505",
}


def _digest(scene):
    h = hashlib.sha256()
    for k in ("xyz", "opacity", "log_scale", "quat", "sh"):
        h.update(scene.first[k].numpy().tobytes())
    h.update(scene.targets.numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_draws_pinned(name):
    assert _digest(harness.Scene(small.config(name), 5, "cpu")) == DIGESTS[name]


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_same_seed_same_scene_other_seed_other(name):
    cfg = small.config(name)
    a, b, c = (harness.Scene(cfg, s, "cpu") for s in (7, 7, 2**31 + 5))
    assert _digest(a) == _digest(b)
    assert not torch.equal(a.first["xyz"], c.first["xyz"])
    # the seed moves the splats, not the views: the poses are fixed
    assert torch.equal(a.cams["viewmats"], c.cams["viewmats"])


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_scene_shapes(name):
    cfg = small.config(name)
    s = harness.Scene(cfg, 3, "cpu")
    n = cfg["scene"]["n"]
    assert {k: tuple(v.shape) for k, v in s.first.items()} == {
        "xyz": (n, 3), "opacity": (n,), "log_scale": (n, 3), "quat": (n, 4), "sh": (n, 48)}
    hold = cfg["cameras"]["llffhold"]
    count = cfg["cameras"]["count"]
    assert s.targets.shape == (count - -(-count // hold), 3, 64, 96)
    assert s.targets.dtype == torch.uint8
    q = s.first["quat"]
    assert torch.allclose(q.norm(dim=1), torch.ones(n), atol=1e-5)
    assert s.capacity % cfg["capacity_granule"] == 0 and s.capacity >= n
