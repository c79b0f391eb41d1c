"""The port's tools (tools/*_torch.py: parse_results, analyze_logs,
error_analysis, analyze_angle_tail, publish_model, get_flops,
sanity_overfit) against the JAX package's tools, on the CPU.

Each tool's main(argv) runs in this process.  The analysis tools read the
same seeded detection files as the JAX tools and must print the same lines
and write the same JSON; parse_results writes the same Task1 files byte for
byte; analyze_logs reads the epoch times of a log that the port's
apis.train_epochs wrote; publish_model's file loads strictly through
init_detector(state_dict=...); get_flops counts JAX's params and 2 x the
multiply-adds of every conv_general_dilated and dot_general of the JAX
forward's jaxpr (not compiled); sanity_overfit's scenes are the JAX tool's
cv2 drawing bit for bit.
"""

import contextlib
import hashlib
import importlib.util
import io
import json
import os
import os.path as osp
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu.devkit import result_merge as merge_ref
from orientedreppoints_tpu.utils import Config, builder
from orientedreppoints_tpu_torch.data.synth import generate_synth_dota
from orientedreppoints_tpu_torch.devkit import dota_utils as util
from test_torch_eval_extra import seeded_dets, write_dets

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
R50 = osp.join(REPO, "configs/dota/orientedreppoints_r50_demo.py")
TINY = dict(
    model=dict(backbone=dict(type="ResNet", depth=18),
               neck=dict(out_channels=32, num_outs=5),
               bbox_head=dict(num_classes=16, feat_channels=32,
                              point_feat_channels=32)),
    test_cfg=dict(nms_pre=50, score_thr=0.0, nms=dict(iou_thr=0.4),
                  max_per_img=20, pre_nms_cap=64))


def tool(name):
    """tools/<name>.py as a module (its main not run)."""
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", osp.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(main, argv, prog="tool"):
    """(return code, stdout) of main(argv), or of main() with sys.argv set
    to argv for the JAX tools, which parse sys.argv."""
    out = io.StringIO()
    saved = sys.argv
    with contextlib.redirect_stdout(out):
        try:
            if main.__code__.co_argcount:  # the port's main(argv)
                rc = main(argv)
            else:
                sys.argv = [prog] + list(argv)
                rc = main()
        finally:
            sys.argv = saved
    return rc, out.getvalue()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    raw = str(root / "raw")
    names = generate_synth_dota(raw, 3, size=320, n_objects=14, seed=21,
                                hard=True)
    labels = {n: util.parse_dota_poly(osp.join(raw, "labelTxt", n + ".txt"))
              for n in names}
    write_dets(str(root / "Task1_{:s}.txt"),
               seeded_dets(labels, np.random.default_rng(22)))
    with open(root / "names.txt", "w") as f:
        f.write("\n".join(names) + "\n")
    return dict(root=root, raw=raw, names=names)


def test_error_analysis_as_jax(scenes, tmp_path):
    root = scenes["root"]
    common = ["--det", str(root / "Task1_{:s}.txt"),
              "--anno", osp.join(scenes["raw"], "labelTxt", "{:s}.txt"),
              "--images", str(root / "names.txt"),
              "--classes", "plane,ship,small-vehicle,large-vehicle,harbor"]
    rc, got = run(tool("error_analysis_torch").main,
                  common + ["--out", str(tmp_path / "port.json")])
    rc_ref, want = run(tool("error_analysis").main,
                       common + ["--out", str(tmp_path / "ref.json")])
    assert rc == rc_ref == 0 and got == want and "mean:" in got
    with open(tmp_path / "port.json") as a, open(tmp_path / "ref.json") as b:
        port, ref = json.load(a), json.load(b)
    assert port == ref and len(port["per_class"]) >= 3


@pytest.mark.parametrize("classname, ovthresh", [("plane", "0.7"),
                                                 ("small-vehicle", "0.5")])
def test_analyze_angle_tail_as_jax(scenes, classname, ovthresh):
    argv = ["--det", str(scenes["root"] / "Task1_{:s}.txt"),
            "--anno", osp.join(scenes["raw"], "labelTxt", "{:s}.txt"),
            "--images_dir", osp.join(scenes["raw"], "images"),
            "--classname", classname, "--ovthresh", ovthresh]
    rc, got = run(tool("analyze_angle_tail_torch").main, argv)
    _, want = run(tool("analyze_angle_tail").main, argv)
    assert rc == 0 and got == want
    assert json.loads(got)["n_matched"] > 0


def test_parse_results_as_jax(tmp_path):
    rng = np.random.default_rng(23)
    classes = ["plane", "ship"]
    arrays = {}
    for tile in ("P0001__1.0__0___0", "P0001__1.0__0___512",
                 "P0002__1.0__0___0"):
        for ci in range(2):
            n = int(rng.integers(0, 6))
            xy = rng.uniform(0, 500, (n, 1, 2)) + rng.uniform(0, 40,
                                                             (n, 4, 2))
            arrays[f"{tile}|{ci}"] = np.concatenate(
                [xy.reshape(n, 8), rng.random((n, 1))], 1).astype(np.float32)
    np.savez(tmp_path / "res.npz", **arrays)
    rc, got = run(tool("parse_results_torch").main,
                  [str(tmp_path / "res.npz"), str(tmp_path / "port"),
                   "--merge_dir", str(tmp_path / "port_merged"),
                   "--classes", *classes])
    _, want = run(tool("parse_results").main,
                  [str(tmp_path / "res.npz"), str(tmp_path / "ref"),
                   "--classes", *classes])
    assert rc == 0
    assert got.splitlines()[0].replace("port", "ref") == want.strip()
    merge_ref.merge_by_poly(str(tmp_path / "ref"),
                            str(tmp_path / "ref_merged"), num_process=1)
    for sub in ("", "_merged"):
        for c in classes:
            port = tmp_path / f"port{sub}" / f"Task1_{c}.txt"
            ref = tmp_path / f"ref{sub}" / f"Task1_{c}.txt"
            assert port.read_bytes() == ref.read_bytes(), (sub, c)


class _Loader:
    """Two epochs of three batches: what apis.train_epochs iterates."""
    epoch = 0

    def __len__(self):
        return 3

    def __iter__(self):  # a generator, closed by train_epochs
        for _ in range(3):
            yield {"x": torch.ones(2, 4)}


def test_analyze_logs_reads_a_train_epochs_log(tmp_path):
    from orientedreppoints_tpu_torch.apis import train_epochs

    model = torch.nn.Linear(4, 1)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda s: 1.0)

    def step(batch, stats):
        loss = model(batch["x"]).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        sched.step()
        return {"loss_total": loss.detach(), "loss_cls": 2 * loss.detach()}

    log_path = tmp_path / "train.log"
    with open(log_path, "w") as f:
        train_epochs(model, _Loader(), step, opt, sched,
                     str(tmp_path / "ckpts"), 2, log_interval=2,
                     log=lambda line: f.write(f"2026-01-01 INFO {line}\n"))
    mod = tool("analyze_logs_torch")
    iters, epochs = mod.parse_log(str(log_path))
    assert [r["iter"] for r in iters] == [0, 2, 4]
    assert [e for e, _ in epochs] == [0, 1] and all(t >= 0 for _, t in epochs)
    argv = [str(log_path), "--keys", "loss_total", "loss_cls",
            "--plot", str(tmp_path / "port.png")]
    rc, got = run(mod.main, argv)
    _, want = run(tool("analyze_logs").main,
                  argv[:-1] + [str(tmp_path / "ref.png")])
    assert rc == 0 and got.replace("port.png", "ref.png") == want
    assert "epoch time: mean" in got and os.path.getsize(tmp_path / "port.png")


def test_publish_model_loads_strictly(tmp_path):
    from orientedreppoints_tpu_torch.apis import init_detector
    from orientedreppoints_tpu_torch.parallel.train import (build_optimizer,
                                                            lr_schedule)
    from orientedreppoints_tpu_torch.utils.checkpoint import save_checkpoint

    model, _ = init_detector(TINY, compute_dtype="float32", device="cpu",
                             seed=3)
    opt, sched = build_optimizer(model, lr_schedule())
    save_checkpoint(str(tmp_path / "ckpts"), 2, model, opt, sched, 17)
    save_checkpoint(str(tmp_path / "ckpts"), 1, model, opt, sched, 9)
    main = tool("publish_model_torch").main
    for argv in ([str(tmp_path / "ckpts"), str(tmp_path / "pub")],
                 [str(tmp_path / "ckpts"), str(tmp_path / "pub"),
                  "--step", "2"]):
        rc, out = run(main, argv)
        m = re.fullmatch(r"published (\S+) \((\d+) arrays, step 2\)\n", out)
        assert rc == 0 and m, out
        path = m.group(1)
        with open(path, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        assert path == str(tmp_path / f"pub-{digest[:8]}.pth")
        assert not osp.exists(tmp_path / "pub.pth")
    assert len(os.listdir(tmp_path)) == 2  # ckpts and one published file
    state = torch.load(path, map_location="cpu", weights_only=True)
    assert int(m.group(2)) == len(state) == len(model.state_dict())
    loaded, _ = init_detector(TINY, state_dict=state,
                              compute_dtype="float32", device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k


def _jaxpr_flops(jaxpr) -> int:
    """2 x multiply-adds of every conv_general_dilated and dot_general,
    sub-jaxprs included."""
    total = 0
    for eq in jaxpr.eqns:
        name = eq.primitive.name
        if name == "conv_general_dilated":
            rhs = eq.invars[1].aval.shape
            spec = eq.params["dimension_numbers"].rhs_spec
            taps = int(np.prod([rhs[i] for i in spec[1:]]))  # Cin/groups, k
            total += 2 * int(np.prod(eq.outvars[0].aval.shape)) * taps
        elif name == "dot_general":
            (lc, _), _ = eq.params["dimension_numbers"]
            k = int(np.prod([eq.invars[0].aval.shape[i] for i in lc]))
            total += 2 * int(np.prod(eq.outvars[0].aval.shape)) * k
        for p in eq.params.values():
            for sub in p if isinstance(p, (list, tuple)) else [p]:
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += _jaxpr_flops(inner)
    return total


def test_get_flops_counts_jax_params_and_multiply_adds(tmp_path):
    """R-18 (the demo config at depth 18) at 128^2: params equal; FLOPs
    equal 2 x the multiply-adds of the JAX forward's convs and matrix
    products (the DCN's matrix products included on both sides; its
    sampling is elementwise work neither side counts here)."""
    from orientedreppoints_tpu_torch.host import load_config

    mod = tool("get_flops_torch")
    cfg = load_config(R50)
    cfg["model"]["backbone"]["depth"] = 18
    n_params, flops, _ = mod.count(cfg, (128, 128), "cpu")
    jcfg = Config.fromfile(R50)
    jcfg.model["backbone"]["depth"] = 18
    model = builder.build_detector(jcfg, "float32")
    x = jnp.zeros((1, 128, 128, 3), jnp.float32)
    variables = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)
    assert n_params == sum(int(v.size)
                           for v in jax.tree.leaves(variables["params"]))
    jaxpr = jax.make_jaxpr(lambda v, im: model.apply(v, im))(variables, x)
    assert flops == _jaxpr_flops(jaxpr.jaxpr)
    # the printed lines: JAX's three, the counter named
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text(f"model = {TINY['model']!r}\n")
    rc, out = run(mod.main, [str(cfg_path), "--shape", "64", "96",
                             "--device", "cpu"])
    lines = out.splitlines()
    assert rc == 0 and lines[0] == "Input shape: (1, 64, 96, 3)"
    assert re.fullmatch(r"Params: \d+\.\d\d M", lines[1])
    assert re.fullmatch(r"Forward FLOPs \(torch\.utils\.flop_counter\): "
                        r"\d+\.\d\d GFLOPs", lines[2])


def jax_tool_scenes(img_size, batch):
    """tools/sanity_overfit.py's scene loop, as the JAX tool has it inline
    (cv2.fillPoly on the float32 image)."""
    import cv2

    rng = np.random.RandomState(0)
    gts, imgs = [], []
    for i in range(batch):
        img = rng.rand(img_size, img_size, 3).astype(np.float32) * 0.3
        polys = []
        for j in range(3):
            cx, cy = rng.rand(2) * (img_size - 120) + 60
            w, h = rng.rand() * 40 + 30, rng.rand() * 20 + 12
            a = rng.rand() * np.pi
            c, s = np.cos(a), np.sin(a)
            r = (np.array([[-w/2, -h/2], [w/2, -h/2], [w/2, h/2],
                           [-w/2, h/2]]) @ [[c, s], [-s, c]]) + [cx, cy]
            polys.append(r.reshape(-1))
            cv2.fillPoly(img, [np.round(r).astype(np.int32)],
                         (1.5 + 0.5 * j, 2.0, 1.0))
        gts.append(np.array(polys, np.float32))
        imgs.append(img)
    return np.stack(imgs), gts


@pytest.mark.parametrize("img_size, batch", [(256, 4), (160, 3)])
def test_sanity_scenes_are_the_jax_tools(img_size, batch):
    imgs, gts = tool("sanity_overfit_torch").scenes(img_size, batch)
    want, want_gts = jax_tool_scenes(img_size, batch)
    assert imgs.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(imgs, want)
    for g, w in zip(gts, want_gts):
        np.testing.assert_array_equal(g, w)
    assert (imgs[..., 1] == 2.0).sum() > 0  # the rectangles were drawn


def test_sanity_overfit_two_steps_on_the_cpu():
    mod = tool("sanity_overfit_torch")
    lines = []
    res = mod.overfit(steps=2, img=128, batch=2, device="cpu",
                      log=lines.append)
    assert np.isfinite(res["first"]) and np.isfinite(res["final"])
    assert res["total"] == 6 and lines[-1] in ("SANITY PASS", "SANITY FAIL")
    assert lines[0].startswith("step 0: loss ")
    assert res["ok"] == (res["final"] < 0.7 * res["first"]
                         and res["recall"] >= 0.5)
    assert lines[-1] == ("SANITY PASS" if res["ok"] else "SANITY FAIL")
