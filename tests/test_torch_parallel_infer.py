"""Sharded inference (parallel/infer.py) and the process group helpers
(parallel/dist.py) on the CPU.

test_torch_slice's narrow R-18 at 128^2 with its perturbed JAX weights:
apis.run_inference sharded over two replicas on the CPU ([cpu, cpu])
against the same call on one device, bit for bit, and against the JAX
package's run_inference (shard_map over its 8-device CPU mesh) det for
det; run_inference_tta and the Predictor sharded against one device;
batches round up as JAX's round_up_batch; the port runs sharded
inference and a two-process group with no JAX, flax or cv2 imported.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from orientedreppoints_tpu import apis as apis_ref
from orientedreppoints_tpu.models import OrientedRepPointsDetector
from orientedreppoints_tpu.parallel import infer as infer_ref
from orientedreppoints_tpu.utils import Config
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.parallel import infer
from orientedreppoints_tpu_torch.serving import Predictor
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from tools.launch_torch import launch_local
from test_torch_slice import (TINY_CONFIG, jax_ties_first,  # noqa: F401
                              perturb_head, same_min_rect)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CANVAS = (128, 128)
CPU2 = [torch.device("cpu"), torch.device("cpu")]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def det(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny_r18.py"
    path.write_text(TINY_CONFIG)
    cfg_ref = Config.fromfile(str(path))
    model_ref = OrientedRepPointsDetector(
        depth=18, num_classes=16, fpn_out_channels=32,
        head_kwargs=dict(feat_channels=32, point_feat_channels=32))
    variables = jax.jit(model_ref.init)(jax.random.PRNGKey(0),
                                        np.zeros((1,) + CANVAS + (3,),
                                                 np.float32))
    variables = perturb_head(jax.tree_util.tree_map(np.array,
                                                    dict(variables)),
                             np.random.default_rng(0))
    model, cfg = apis.init_detector(str(path), flax_to_torch(variables),
                                    compute_dtype="float32", device="cpu")
    rng = np.random.default_rng(5)
    sizes = ((128, 128), (100, 120), (96, 80), (128, 64), (70, 128))
    ds = [dict(img=rng.normal(size=hw + (3,)).astype(np.float32),
               scale_factor=sf, img_info=dict(file_name=f"im{i}.npy"))
          for i, (hw, sf) in enumerate(zip(sizes, (1.0, 0.5, 1.5, 1.0,
                                                   0.75)))]
    return dict(path=str(path), cfg=cfg, cfg_ref=cfg_ref, model=model,
                model_ref=model_ref, variables=variables, ds=ds)


def same_results(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        len(a[n]) == len(b[n]) and all(np.array_equal(x, y)
                                       for x, y in zip(a[n], b[n]))
        for n in a)


def test_round_up_batch_and_devices():
    """JAX's round_up_batch; no CUDA device here, so data_devices() and
    the entry points' "all" are None (the one-device call)."""
    for b in (1, 2, 3, 4, 5, 8):
        for n in (1, 2, 3, 4):
            got = infer.round_up_batch(b, CPU2[:1] * n)
            assert got == -(-b // n) * n >= b and got % n == 0
    assert infer.round_up_batch(5, None) == 5
    assert infer.data_devices() is None
    assert infer.data_devices(min_devices=0) == []
    assert apis.infer_devices("all", torch.device("cpu")) is None
    assert apis.infer_devices(CPU2, torch.device("cpu")) is CPU2


def test_shard_infer_splits_and_gathers():
    """Shard i of every array runs on replica i (a model of its own) under
    inference mode, and the outputs come back in order; a batch the
    devices do not split raises."""
    model = torch.nn.Linear(3, 2)
    seen = []

    def fn(m, x, y):
        seen.append((id(m), torch.is_inference_mode_enabled(), len(x)))
        return m(x) + y, x.sum(1)

    run = infer.shard_infer(fn, model, CPU2)
    x, y = torch.randn(4, 3), torch.randn(4, 2)
    a, b = run(x, y)
    with torch.no_grad():
        torch.testing.assert_close(a, model(x) + y)
    assert torch.equal(b, x.sum(1))
    assert [s[1:] for s in seen] == [(True, 2), (True, 2)]
    assert seen[0][0] == id(model) != seen[1][0]
    with pytest.raises(ValueError, match="does not split"):
        run(torch.randn(3, 3), torch.randn(3, 2))
    assert infer.shard_infer(fn, model, None)(x, y)[1].shape == (4,)


@pytest.fixture(scope="module")
def inferred(det):
    tc = det["cfg"]["test_cfg"]
    return {devs: apis.run_inference(det["model"], det["ds"], tc,
                                     canvas=CANVAS, batch_size=4,
                                     devices=devs)
            for devs in (None, tuple(CPU2))}


def test_run_inference_sharded_equals_one_device(inferred):
    """[cpu, cpu]: two replicas of two images each give the one-device
    call's detections bit for bit."""
    one, two = inferred[None], inferred[tuple(CPU2)]
    assert len(one) == 5 and sum(len(a) for r in one.values()
                                 for a in r) > 30
    assert same_results(one, two)


def test_run_inference_sharded_matches_jax(det, inferred,
                                           jax_ties_first):  # noqa: F811
    """The JAX package's run_inference (shard_map over its 8 CPU devices,
    the batch rounded up to 8) against the port's sharded one, det for
    det: scores within 1e-4, polygons within 0.05 px up to corner order
    (test_torch_slice's tolerances), dets of rounding-close scores
    matched one to one."""
    assert infer_ref.round_up_batch(4, infer_ref.data_mesh()) == 8
    ref = apis_ref.run_inference(det["model_ref"], det["variables"],
                                 det["ds"], det["cfg_ref"].test_cfg,
                                 canvas=CANVAS, batch_size=4)
    got = inferred[tuple(CPU2)]
    assert set(got) == set(ref)
    total = 0
    for name, per_class in ref.items():
        assert len(got[name]) == len(per_class) == 15
        for a, b in zip(got[name], per_class):
            assert a.shape == b.shape, name
            free = np.ones(len(b), bool)
            for row in a:
                hit = free & (np.abs(b[:, 8] - row[8]) <= 1e-4) & \
                    same_min_rect(np.tile(row[:8], (len(b), 1)), b[:, :8],
                                  tol=0.05)
                assert hit.any(), (name, row)
                free[np.argmax(hit)] = False
            total += len(a)
    assert total > 30


def test_run_inference_tta_sharded_equals_one_device(det):
    """Each scale's forward + decode and the merge over [cpu, cpu] give the
    one-device TTA detections bit for bit (batch 4: two images a replica,
    one of them padding.  A shard of one image differs at f32 rounding:
    oneDNN's convolutions round otherwise at batch 1 than at 2, 1.8e-7
    on a head output here)."""
    augs = [(0.5, False), (1.0, False), (1.0, True)]
    tc = det["cfg"]["test_cfg"]
    one, two = (apis.run_inference_tta(det["model"], det["ds"][:3], tc, augs,
                                       canvas=CANVAS, batch_size=4,
                                       devices=devs)
                for devs in (None, CPU2))
    assert sum(len(a) for r in one.values() for a in r) > 10
    assert same_results(one, two)


def test_predictor_shards_over_its_devices(det):
    """Predictor(devices=[cpu, cpu]): the batch rounds up to 4 from 3, and
    the detections equal the one-device Predictor's bit for bit."""
    sd = det["model"].state_dict()
    one = Predictor(det["path"], state_dict=sd, batch_size=3,
                    compute_dtype="float32", device="cpu")
    two = Predictor(det["path"], state_dict=sd, batch_size=3,
                    compute_dtype="float32", device="cpu", devices=CPU2)
    assert (one.batch_size, two.batch_size) == (3, 4)
    rng = np.random.default_rng(9)
    imgs = [(rng.random((h, w, 3)) * 255).astype(np.uint8)
            for h, w in ((128, 96), (90, 128), (128, 128), (60, 100),
                         (128, 110))]
    a, b = one(imgs), two(imgs)
    assert len(a) == len(b) == 5
    assert sum(len(x) for per in a for x in per) > 10
    assert all(np.array_equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p, q))


GROUP_SCRIPT = textwrap.dedent("""
    import sys
    import torch
    from orientedreppoints_tpu_torch.parallel import dist
    group = dist.init_from_env("cpu")
    r, w = dist.rank(group), dist.world_size(group)
    s = dist.all_reduce_sum(torch.tensor([r + 1.0]), group)
    m = dist.all_reduce_max(torch.tensor([10 - r]), group)
    counts = dist.row_counts(r + 1, group)
    rows = dist.gather_rows(torch.full((r + 1, 3), r), group, counts)
    dist.barrier(group)
    assert dist.cpu_group(group) is group
    dist.destroy(group)
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in (
        "jax", "flax", "cv2", "orientedreppoints_tpu"))
    print("RANK", r, w, float(s), int(m), counts, rows[:, 0].tolist(),
          loaded)
""")

NO_JAX_SCRIPT = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    from orientedreppoints_tpu_torch.parallel import dist, infer
    from orientedreppoints_tpu_torch.serving import Predictor
    from tools.launch_torch import launch_local
    cfg = dict(
        model=dict(backbone=dict(type="ResNet", depth=18),
                   neck=dict(out_channels=32, num_outs=5),
                   bbox_head=dict(num_classes=16, feat_channels=32,
                                  point_feat_channels=32)),
        test_cfg=dict(nms_pre=50, score_thr=0.0, nms=dict(iou_thr=0.4),
                      max_per_img=20, pre_nms_cap=64),
        img_norm_cfg=dict(mean=[0, 0, 0], std=[1, 1, 1], to_rgb=True),
        data=dict(test=dict(pipeline=[dict(type="RotateResize",
                                           img_scale=(64, 64))])),
        tpu=dict(canvas_buckets=[(64, 64)]),
    )
    cpu = torch.device("cpu")
    pred = Predictor(cfg, batch_size=1, compute_dtype="float32",
                     device="cpu", devices=[cpu, cpu])
    assert pred.batch_size == 2
    out = pred([np.zeros((50, 64, 3), np.uint8)] * 3)
    assert len(out) == 3 and sum(len(a) for a in out[0]) > 0
    outs = launch_local([sys.executable, "-c", sys.argv[1]], 2,
                        timeout=120)
    print(outs)
    assert [o.split()[:5] for o in outs] == [
        ["RANK", "0", "2", "3.0", "10"], ["RANK", "1", "2", "3.0", "10"]]
    assert all(o.strip().endswith("[1, 2] [0, 1, 1] []") for o in outs)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "flax", "cv2",
                                           "orientedreppoints_tpu"))
    print("LOADED", loaded)
    assert not loaded, loaded
""")


def test_parallel_runs_without_jax_flax_cv2():
    """parallel.infer (a sharded Predictor) and parallel.dist (a group of
    two gloo processes started by launch_local: sum, max, row counts,
    uneven gathered rows, barrier) with no JAX, flax, cv2 or
    orientedreppoints_tpu imported, in the parent or a rank."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT, GROUP_SCRIPT],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout


def test_launch_local_stops_the_group_when_a_rank_fails(tmp_path):
    """A rank that exits non-zero fails the launch, with its output, and
    the rank left waiting in a collective is stopped."""
    script = textwrap.dedent("""
        import sys, torch
        from orientedreppoints_tpu_torch.parallel import dist
        group = dist.init_from_env("cpu")
        if dist.rank(group) == 1:
            print("rank one gives up")
            sys.exit(3)
        dist.all_reduce_sum(torch.ones(1), group)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    with pytest.raises(RuntimeError, match="rank 1 failed") as err:
        launch_local([sys.executable, "-c", script], 2, env=env,
                          timeout=120, cwd=str(tmp_path))
    assert "rank one gives up" in str(err.value)
