"""The loss's GIoU entries (ops/giou.py) on the CPU: the custom ops'
CPU registrations return what the code before them returned
(geometry.convex_giou, autograd through it, and core/losses.giou_loss's
value and filtered gradient) bit for bit, the loss and APAA call them, and
both pass torch.library.opcheck.  The CUDA kernel is held against the plain
version on the card (tests/test_torch_cuda.py, which reuses giou_rows).

This file imports no JAX."""

import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch import ops
from orientedreppoints_tpu_torch.core import apaa, losses
from orientedreppoints_tpu_torch.ops import geometry, giou

GIOU_KINDS = ("random", "padded", "duplicate", "collinear", "disjoint",
              "contained", "containing")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def giou_rows(rng, kind: str, m: int = 256):
    """m rows of the loss's GIoU of one kind, in the loss's normalised
    coordinates -> (points (m, 18), quads (m, 8), weight (m,)) float32:
    rotated rectangles (long side 0.3-6, aspect 1-5) of either winding and
    9-point sets about their centres, weight 1 with a fifth 0; a tenth of
    the rows ten times smaller, with sets spread by 0.02 (they give the
    large gradients the loss filters).

    random: sets spread by 0.05-1.5; padded: every other row a zero quad of weight 0, as
    the step pads its levels; duplicate: sets of 1-3 distinct points;
    collinear: half the sets with 4 points on a line through two others,
    half wholly on a line; disjoint: sets 40 away; contained: sets well
    inside their quad; containing: sets spread far around it."""
    c = rng.uniform(-5, 5, (m, 1, 2))
    ang = rng.uniform(0, np.pi, m)
    long = rng.uniform(0.3, 6, m)
    short = long / rng.uniform(1, 5, m)
    lx = np.array([-0.5, 0.5, 0.5, -0.5]) * long[:, None]
    ly = np.array([-0.5, -0.5, 0.5, 0.5]) * short[:, None]
    cs, sn = np.cos(ang)[:, None], np.sin(ang)[:, None]
    quads = np.stack([cs * lx - sn * ly, sn * lx + cs * ly], -1) + c
    cw = rng.random(m) < 0.5
    quads[cw] = quads[cw, ::-1]
    noise = rng.normal(0, 1, (m, 9, 2))
    pts = c + noise * rng.uniform(0.05, 1.5, (m, 1, 1))
    tiny = rng.random(m) < 0.1
    quads[tiny] = c[tiny] + 0.1 * (quads[tiny] - c[tiny])
    pts[tiny] = c[tiny] + 0.02 * noise[tiny]
    w = (rng.random(m) >= 0.2).astype(np.float32)
    if kind == "padded":
        quads[::2], w[::2] = 0, 0
    elif kind == "duplicate":
        distinct = rng.integers(1, 4, (m, 1))
        pick = rng.integers(0, 9, (m, 9)) % distinct
        pts = np.take_along_axis(pts, pick[..., None].repeat(2, -1), 1)
    elif kind == "collinear":
        t = rng.uniform(-1, 1, (m, 9, 1)) * rng.uniform(0.5, 3, (m, 1, 1))
        line = c + t * rng.normal(0, 1, (m, 1, 2))
        pts[::2, :4] = pts[::2, 4:5] + rng.uniform(0, 1, (m, 4, 1))[::2] * (
            pts[::2, 5:6] - pts[::2, 4:5])
        pts[1::2] = line[1::2]
    elif kind == "disjoint":
        pts += 40.0
    elif kind == "contained":
        pts = c + noise * (0.05 * short)[:, None, None]
    elif kind == "containing":
        pts = c + noise * 30.0
    else:
        assert kind == "random", kind
    return (pts.reshape(m, 18).astype(np.float32),
            quads.reshape(m, 8).astype(np.float32), w)


def tensors(kind, seed, m=256):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(x) for x in giou_rows(rng, kind, m))


class _GIoULossSumBefore(torch.autograd.Function):
    """core/losses._GIoULossSum as it was before orp::convex_giou_grad:
    autograd through geometry.convex_giou inside the forward."""

    @staticmethod
    def forward(ctx, pred, target, weight, divisor, loss_weight):
        div = torch.clamp(divisor.to(torch.float32), min=1e-6)
        with torch.enable_grad():
            p = pred.detach().requires_grad_(True)
            g = geometry.convex_giou(p, target)
            (dgiou,) = torch.autograd.grad(g, p, grad_outputs=weight)
        ctx.save_for_backward(dgiou, div)
        ctx.loss_weight = loss_weight
        return ((1.0 - g.detach()) * weight).sum() / div

    @staticmethod
    def backward(ctx, grad_output):
        dgiou, div = ctx.saved_tensors
        bad = (dgiou > 1.0).any(-1, keepdim=True)
        grad = torch.where(bad, 1e-6, dgiou)
        return -grad / div * ctx.loss_weight, None, None, None, None


@pytest.mark.parametrize("kind", GIOU_KINDS)
def test_convex_giou_op_is_the_plain_version_on_the_cpu(kind):
    pts, quads, _ = tensors(kind, 0)
    assert torch.equal(giou.convex_giou(pts, quads),
                       geometry.convex_giou(pts, quads))


@pytest.mark.parametrize("kind", GIOU_KINDS)
def test_convex_giou_grad_op_is_autograd_on_the_cpu(kind):
    """The value and the weighted gradient, bit for bit, also with grad
    mode off (as inside an autograd Function's forward)."""
    pts, quads, w = tensors(kind, 1)
    p = pts.clone().requires_grad_(True)
    want = geometry.convex_giou(p, quads)
    (want_grad,) = torch.autograd.grad(want, p, grad_outputs=w)
    for grad_mode in (True, False):
        with torch.set_grad_enabled(grad_mode):
            got, got_grad = giou.convex_giou_grad(pts, quads, w)
        assert torch.equal(got, want.detach())
        assert torch.equal(got_grad, want_grad)
        assert not got.requires_grad and not got_grad.requires_grad


@pytest.mark.parametrize("kind", ["random", "padded", "collinear"])
def test_giou_loss_value_and_filtered_grad_as_before(kind):
    pts, quads, w = tensors(kind, 2)
    div = torch.as_tensor(int((w > 0).sum()))
    results = []
    for fn in (losses._GIoULossSum.apply, _GIoULossSumBefore.apply):
        p = pts.clone().requires_grad_(True)
        loss = 0.375 * fn(p, quads, w, div, 0.375)
        loss.backward()
        results.append((loss.detach(), p.grad))
    (got, got_grad), (want, want_grad) = results
    assert torch.equal(got, want) and torch.equal(got_grad, want_grad)
    if kind == "random":  # rows the filter catches are present
        assert bool((giou.convex_giou_grad(pts, quads, w)[1] > 1).any())


def test_loss_and_apaa_call_the_ops():
    assert losses.convex_giou_grad is giou.convex_giou_grad
    assert apaa.convex_giou is giou.convex_giou


@pytest.mark.parametrize("entry", ["convex_giou", "convex_giou_grad"])
def test_giou_ops_pass_opcheck(entry):
    pts, quads, w = tensors("random", 3, 32)
    args = (pts, quads) if entry == "convex_giou" else (pts, quads, w)
    torch.library.opcheck(getattr(giou, entry), args)


def test_cpu_entries_launch_nothing():
    pts, quads, w = tensors("random", 4, 16)
    ops.reset_launch_counts()
    giou.convex_giou(pts, quads)
    giou.convex_giou_grad(pts, quads, w)
    assert ops.launch_counts()["convex_giou"] == 0
    with pytest.raises(ValueError, match="CUDA tensor"):
        giou.convex_giou_kernel(pts, quads, w)
    assert ops.launch_counts()["convex_giou"] == 0
