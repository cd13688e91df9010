"""The frozen scene generator gives the port's testing scene bit for bit."""

from __future__ import annotations

import numpy as np
import pytest

from mapmerge_torch.testing import scene as port_scene
from mmbench.traffic import scene


@pytest.mark.parametrize("seed", [5, 42, 2**31 + 11])
def test_town_views_equal_the_ports(seed):
    got, got_t = scene.town_views(3, 3000, keep=0.8, seed=seed)
    want, want_t = port_scene.town_views(3, 3000, keep=0.8, seed=seed)
    for (gx, gr), (wx, wr) in zip(got, want):
        assert np.array_equal(gx, wx) and np.array_equal(gr, wr)
    assert all(np.array_equal(a, b) for a, b in zip(got_t, want_t))
