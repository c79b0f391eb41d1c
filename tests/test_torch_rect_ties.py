"""chip_smoke.py's tie check of the min-area rect (tie_check), on the CPU.

The smoke holds the kernel's rects against the plain version's and lets a
differing box pass only as a tie: each rect equal to a float64 box of its
points along a direction between two of them, within what float32 corners
resolve, with an area inside the tie rule's band of the set's least.  Here
the JAX package's rects (an argmin over float32 areas), the port's plain
rects (the first edge within the tie rule) on the same seeded sets pass it,
and rects moved off their box do not.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.ops import geometry as geo_ref
from orientedreppoints_tpu_torch.ops import geometry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sets(smoke, kind, n):
    """The smoke's sets (1344^2, 24 px spread, 1% coincident, 1% collinear)
    or sub-pixel sets like an untrained head's (0.05-2 px over 512^2)."""
    rng = np.random.default_rng(5)
    if kind == "smoke":
        return smoke.point_sets(rng, n).astype(np.float32)
    c = rng.uniform(0, 512, (n, 1, 2))
    s = np.exp(rng.uniform(np.log(0.05), np.log(2.0), (n, 1, 1)))
    return (c + s * rng.normal(0, 1, (n, 9, 2))).reshape(n, 18).astype(
        np.float32)


@pytest.mark.parametrize("kind", ["smoke", "sub_pixel"])
def test_tie_check_passes_both_packages_rects(smoke, kind):
    p = sets(smoke, kind, 3000)
    pts = torch.from_numpy(p)
    for rects in (torch.from_numpy(np.array(
            geo_ref.min_area_rect(jnp.asarray(p)))),
            geometry.min_area_rect(pts)):
        over, band, ok = smoke.tie_check(pts, rects)
        assert bool(ok.all()), (float(over.max()), float(band.max()))
        assert float(over.max()) < 0.5


@pytest.mark.parametrize("kind", ["smoke", "sub_pixel"])
def test_tie_check_refuses_rects_off_their_box(smoke, kind):
    """Rects turned by 0.01 rad or scaled by 1.01 about their centres, or
    shifted by 2e-3 px, fail, and rect_check counts them as failed ties;
    the same rects with their corners rolled pass as equal."""
    p = sets(smoke, kind, 3000)[100:]  # past the coincident sets
    pts = torch.from_numpy(p)
    want = geometry.min_area_rect(pts)
    r = want.view(-1, 4, 2)
    c = r.mean(1, keepdim=True)
    a = 0.01
    turn = torch.tensor([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                        dtype=torch.float32)
    for bad in (((r - c) @ turn.T + c), (r - c) * 1.01 + c, r + 2e-3):
        bad = bad.reshape(-1, 8)
        moved = smoke.rect_err(bad, want) > smoke.RECT_TOL
        assert int(moved.sum()) > len(p) // 2
        assert not bool(smoke.tie_check(pts[moved], bad[moved])[2].any())
        assert not smoke.rect_check(bad, want, pts)[2]
    err, ties, ok = smoke.rect_check(r.roll(1, 1).reshape(-1, 8), want, pts)
    assert (err, ties, ok) == (0.0, 0, True)
