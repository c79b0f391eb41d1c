"""tools/test_torch.py and a PNG tile dataset through the port, on the CPU.

Four 256^2 PNG tiles, cut by the JAX package from a cv2-rendered scene,
feed a narrow R-18 config (test_torch_slice's widths, canvas 256^2,
float32, test_cfg cut to 64 candidates an image) whose JAX weights, head
perturbed so that the decode has work, reach the port through
flax_to_torch.  The port's dataset samples equal JAX's and its detections
JAX's (test_torch_weights' tolerances); the tool, run as a user runs it
(a subprocess from the repo root, one thread), writes the .npz, Task1 and
merged files of apis.run_inference + write_task1_results + merge_by_poly
in this process, and with --flip_tta / --ms_tta the .npz of
apis.run_inference_tta.  tools/train_torch.py takes a step on the same
PNG tiles through a narrow copy of the R-50 demo config's train pipeline.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.data import synth as synth_ref
from orientedreppoints_tpu.devkit.dota2coco import \
    dota2coco_train as dota2coco_ref
from orientedreppoints_tpu.devkit.img_split import ImgSplit as ImgSplitRef
from orientedreppoints_tpu.models import decode_detections as decode_ref
from orientedreppoints_tpu.utils import Config, builder
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.devkit.result_merge import (
    merge_by_poly, write_task1_results)
from orientedreppoints_tpu_torch.models.detector import decode_detections
from orientedreppoints_tpu_torch.utils import checkpoint
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_torch_checkpoint import load_tool
from test_torch_slice import (TINY_CONFIG, jax_ties_first,  # noqa: F401
                              perturb_head, same_min_rect)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R50 = os.path.join(REPO, "configs/dota/orientedreppoints_r50_demo.py")
TILE = 256
DECODE = dict(nms_pre=64, score_thr=0.05, iou_thr=0.4, max_per_img=32,
              pre_nms_cap=64)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def narrow_config(root) -> str:
    text = TINY_CONFIG.replace(
        """test_cfg = dict(nms_pre=100, min_bbox_size=0, score_thr=0.05,
                nms=dict(type="rnms", iou_thr=0.4), max_per_img=60,
                pre_nms_cap=256)""",
        """test_cfg = dict(nms_pre=64, min_bbox_size=0, score_thr=0.05,
                nms=dict(type="rnms", iou_thr=0.4), max_per_img=32,
                pre_nms_cap=64)""")
    text = text.replace("img_scale=(128, 96)", f"img_scale=({TILE}, {TILE})")
    text = text.replace("data = dict(test=dict(pipeline=[", f"""data = dict(
    test=dict(type="DotaDataset", ann_file="{root}/split/test.json",
              img_prefix="{root}/split/images/", pipeline=[""")
    text = text.replace("tpu = dict(canvas_buckets=[(128, 128)])",
                        f"tpu = dict(canvas_buckets=[({TILE}, {TILE})], "
                        "compute_dtype=\"float32\")")
    assert "pre_nms_cap=64" in text and "test.json" in text
    assert f"canvas_buckets=[({TILE}, {TILE})]" in text
    path = os.path.join(root, "narrow.py")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """The PNG tiles, their json, the config, JAX's weights and the port's
    state dict of them (saved as w.pt)."""
    root = tmp_path_factory.mktemp("tool")
    synth_ref.generate_synth_dota(str(root / "raw"), 1, size=384,
                                  n_objects=16, seed=4)
    ImgSplitRef(str(root / "raw"), str(root / "split"), gap=128,
                subsize=TILE, num_process=1).splitdata()
    dota2coco_ref(str(root / "split"), str(root / "split" / "test.json"))
    config = narrow_config(str(root))
    model = builder.build_detector(Config.fromfile(config), "float32")
    variables = perturb_head(jax.tree_util.tree_map(np.array, dict(
        jax.jit(model.init)(jax.random.PRNGKey(2),
                            jnp.zeros((1, TILE, TILE, 3))))),
        np.random.default_rng(0))
    sd = flax_to_torch(variables)
    torch.save(sd, root / "w.pt")
    return dict(root=root, config=config, model=model, variables=variables,
                sd=sd)


def test_png_dataset_and_detections_match_jax(tiles, jax_ties_first):  # noqa
    """The test pipeline's samples of the PNG tiles equal JAX's; one
    batch of the four through both detectors gives the same detections."""
    cfg = Config.fromfile(tiles["config"])
    dcfg = {**cfg.data["test"], "test_mode": True}
    ref = builder.build_dataset(dcfg)
    ds = apis.build_dataset(dcfg)
    assert len(ds) == len(ref) == 4
    imgs = np.zeros((4, TILE, TILE, 3), np.float32)
    for i in range(4):
        got, want = ds[i], ref[i]
        assert got["img_info"] == want["img_info"]
        assert got["img_info"]["file_name"].endswith(".png")
        assert got["scale_factor"] == want["scale_factor"]
        np.testing.assert_array_equal(got["img"], want["img"])
        imgs[i] = got["img"]
    outs_ref = jax.jit(tiles["model"].apply)(tiles["variables"], imgs)
    ref_dets = jax.jit(lambda o: decode_ref(o, **DECODE))(
        {k: outs_ref[k] for k in ("cls_scores", "pts_refine")})
    model, _ = apis.init_detector(tiles["config"], state_dict=tiles["sd"],
                                  compute_dtype="float32", device="cpu")
    with torch.inference_mode():
        outs = model(torch.from_numpy(imgs))
        got = decode_detections({k: outs[k] for k in ("cls_scores",
                                                      "pts_refine")},
                                **DECODE)
    (dets, labels, valid), (dets_r, labels_r, valid_r) = (
        (t.numpy() for t in got), map(np.asarray, ref_dets))
    np.testing.assert_array_equal(valid, valid_r)
    np.testing.assert_array_equal(labels[valid], labels_r[valid])
    d, r = dets[valid], dets_r[valid]
    assert len(d) > 20
    # two conv libraries' head outputs (test_torch_weights' tolerances)
    np.testing.assert_allclose(d[:, :18], r[:, :18], rtol=0, atol=1e-2)
    np.testing.assert_allclose(d[:, 26], r[:, 26], rtol=0, atol=1e-4)
    assert np.all(same_min_rect(d[:, 18:26], r[:, 18:26], tol=0.05))


def run_tool(tiles, *flags):
    res = subprocess.run(
        [sys.executable, "tools/test_torch.py", tiles["config"],
         "--checkpoint", str(tiles["root"] / "w.pt"), "--device", "cpu",
         "--batch_size", "2", *flags],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stderr


def same_npz(path, results):
    with np.load(path) as z:
        want = {f"{k}|{ci}": arr for k, per in results.items()
                for ci, arr in enumerate(per)}
        assert sorted(z.files) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(z[k], v)
    return sum(len(v) for v in want.values())


def same_folder(a, b):
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_tool_matches_in_process(tiles, tmp_path):
    """The tool's .npz, Task1 and merged files equal the in-process path's
    on the same weights; --eval logs the tile-level mAP; with
    --flip_tta --ms_tta its .npz equals run_inference_tta's."""
    log = run_tool(tiles, "--out", str(tmp_path / "r.npz"), "--format_task1",
                   str(tmp_path / "t1"), "--merge_dir", str(tmp_path / "m"),
                   "--eval")
    assert "tile-level mAP" in log and "4 imgs in" in log
    model, cfg = apis.init_detector(tiles["config"], state_dict=tiles["sd"],
                                    compute_dtype="float32", device="cpu")
    ds = apis.build_dataset({**cfg["data"]["test"], "test_mode": True})
    kw = dict(canvas=(TILE, TILE), batch_size=2, num_fg=len(ds.CLASSES))
    results = apis.run_inference(model, ds, cfg["test_cfg"], **kw)
    assert same_npz(tmp_path / "r.npz", results) > 20
    write_task1_results(results, ds.CLASSES, str(tmp_path / "t1_in"))
    merge_by_poly(str(tmp_path / "t1_in"), str(tmp_path / "m_in"))
    same_folder(tmp_path / "t1", tmp_path / "t1_in")
    same_folder(tmp_path / "m", tmp_path / "m_in")
    run_tool(tiles, "--out", str(tmp_path / "tta.npz"), "--flip_tta",
             "--ms_tta", "0.5,1.0", "--max_images", "2")
    tta = apis.run_inference_tta(
        model, ds, cfg["test_cfg"], apis.parse_tta_spec("0.5,1.0", True),
        max_images=2, **kw)
    assert len(tta) == 2 and same_npz(tmp_path / "tta.npz", tta) > 0


def test_tool_loads_a_training_checkpoint(tiles, tmp_path):
    """load_weights takes tools/train_torch.py's checkpoint (a file or its
    directory) as well as a bare state dict."""
    tool = load_tool("test_torch")
    model, _ = apis.init_detector(tiles["config"], state_dict=tiles["sd"],
                                  compute_dtype="float32", device="cpu")
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)
    checkpoint.save_checkpoint(str(tmp_path), 3, model, opt, sched, 7)
    for path in (tmp_path / "epoch_3.pt", tmp_path, tiles["root"] / "w.pt"):
        other, _ = apis.init_detector(tiles["config"], seed=1,
                                      compute_dtype="float32", device="cpu")
        tool.load_weights(other, str(path))
        assert all(torch.equal(v, tiles["sd"][k])
                   for k, v in other.state_dict().items())


def test_train_tool_on_png_tiles(tiles, tmp_path):
    """tools/train_torch.py, one iteration from the PNG tiles through the
    R-50 demo's train pipeline (CorrectBox, RotateResize's range, flip) at
    R-18 widths 32 and a 128^2 canvas: a finite loss logged and a
    checkpoint written."""
    with open(R50) as f:
        text = f.read()
    for a, b in [("depth=50", "depth=18"),
                 ("in_channels=[256, 512, 1024, 2048]",
                  "in_channels=[64, 128, 256, 512]"),
                 ("out_channels=256", "out_channels=32"),
                 ("in_channels=256", "in_channels=32"),
                 ("feat_channels=256", "feat_channels=32"),
                 ("img_scale=[(1333, 768), (1333, 1280)]",
                  "img_scale=[(128, 96), (128, 128)]"),
                 ("canvas_buckets=[(1344, 1344)]",
                  "canvas_buckets=[(128, 128)]"),
                 ('compute_dtype="bfloat16"', 'compute_dtype="float32"'),
                 ("global_batch_size=8", "global_batch_size=2"),
                 ("max_gt=512", "max_gt=64"), ("max_pos=1024", "max_pos=256")]:
        assert a in text, a
        text = text.replace(a, b)
    root = tiles["root"]
    text += (f"\ndata['train'].update(ann_file='{root}/split/test.json', "
             f"img_prefix='{root}/split/images/')\n")
    (tmp_path / "narrow.py").write_text(text)
    assert load_tool("train_torch").main([
        str(tmp_path / "narrow.py"), "--work_dir", str(tmp_path / "w"),
        "--device", "cpu", "--max_iters", "1"]) == 0
    assert (tmp_path / "w" / "ckpts" / "epoch_1.pt").exists()
    log = (tmp_path / "w" / "train.log").read_text()
    assert "training finished at iter 1" in log
