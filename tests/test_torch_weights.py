"""Weights made elsewhere, into the port, on the CPU.

The torchvision converter on state dicts named as torchvision names
resnet18, resnet50 and resnext50_32x4d (built here from the arch tables,
values from a seed: nothing is fetched) against the JAX package's
convert_torchvision_resnet + flax_to_torch, key for key and bit for bit;
load_pretrained_backbone (its `state_dict` wrapper, the refusal of other
backbones) and tools/train_torch.py --pretrained_backbone for one
iteration; tools/export_torch_state_dict.py on a narrow R-18's orbax
checkpoints, a full TrainState and a params-only one, whose state dict
gives the port JAX's head outputs and detections.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from orientedreppoints_tpu.models import decode_detections as decode_ref
from orientedreppoints_tpu.parallel import train as train_ref
from orientedreppoints_tpu.utils import Config, builder
from orientedreppoints_tpu.utils import checkpoint as ckpt_ref
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.models.detector import decode_detections
from orientedreppoints_tpu_torch.models.resnet import ARCH_SETTINGS
from orientedreppoints_tpu_torch.utils import checkpoint
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch
from test_backbones import TINY_EXTRA
from test_torch_checkpoint import data, load_tool  # noqa: F401
from test_torch_hrnet import REPO, tree_loads_strictly
from test_torch_slice import (DECODE, TINY_CONFIG, jax_ties_first,  # noqa
                              perturb_head, same_min_rect)

# torchvision's models: (depth, groups, width_per_group)
TORCHVISION = {"resnet18": (18, 1, 64), "resnet50": (50, 1, 64),
               "resnext50_32x4d": (50, 32, 4)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the suite runs files side by side in worker
    processes, and torch's default pool oversubscribes the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def torchvision_sd(name, rng):
    """A state dict with torchvision's names and shapes for `name`
    (torchvision.models.resnet: BasicBlock / Bottleneck, the stride on
    conv2, downsample.0 / .1 where the stride or the width changes, fc
    over 1000 classes), values from rng, as torch tensors."""
    depth, groups, base = TORCHVISION[name]
    bottleneck = depth >= 50
    exp = 4 if bottleneck else 1
    sd = {}

    def conv(key, cout, cin, k):
        sd[key + ".weight"] = rng.standard_normal((cout, cin, k, k),
                                                  np.float32)

    def bn(key, c):
        sd[key + ".weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        sd[key + ".bias"] = rng.standard_normal(c, np.float32)
        sd[key + ".running_mean"] = rng.standard_normal(c, np.float32)
        sd[key + ".running_var"] = rng.uniform(0.5, 2.0, c).astype(
            np.float32)
        sd[key + ".num_batches_tracked"] = np.int64(rng.integers(1, 9))

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    cin = 64
    for s, blocks in enumerate(ARCH_SETTINGS[depth][1]):
        planes = 64 * 2 ** s
        width = int(planes * base / 64) * groups if bottleneck else planes
        for b in range(blocks):
            key = f"layer{s + 1}.{b}"
            if bottleneck:
                conv(key + ".conv1", width, cin, 1)
                conv(key + ".conv2", width, width // groups, 3)
                conv(key + ".conv3", planes * exp, width, 1)
                for i, c in ((1, width), (2, width), (3, planes * exp)):
                    bn(f"{key}.bn{i}", c)
            else:
                conv(key + ".conv1", planes, cin, 3)
                conv(key + ".conv2", planes, planes, 3)
                bn(key + ".bn1", planes)
                bn(key + ".bn2", planes)
            if b == 0 and (s > 0 or cin != planes * exp):
                conv(key + ".downsample.0", planes * exp, cin, 1)
                bn(key + ".downsample.1", planes * exp)
            cin = planes * exp
    sd["fc.weight"] = rng.standard_normal((1000, cin), np.float32)
    sd["fc.bias"] = rng.standard_normal(1000, np.float32)
    return {k: torch.as_tensor(v) for k, v in sd.items()}


@pytest.mark.parametrize("name", list(TORCHVISION))
def test_convert_torchvision_matches_jax(name):
    """Every tensor of the JAX path (HWIO and back) equals the port's
    direct map under the same name, bit for bit, and the port's backbone
    (ResNet, or ResNeXt with the grouped conv2) takes them all
    strictly."""
    depth, groups, base = TORCHVISION[name]
    sd = torchvision_sd(name, np.random.default_rng(depth + groups))
    got = checkpoint.convert_torchvision_resnet(sd, depth)
    params, stats = ckpt_ref.convert_torchvision_resnet(
        {k: v.numpy() for k, v in sd.items()}, depth)
    want = flax_to_torch({"params": {"backbone": params},
                          "batch_stats": {"backbone": stats}})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32
        assert torch.equal(got[k], v), k
    model = apis.build_detector(dict(model=dict(
        backbone=dict(type="ResNeXt" if groups > 1 else "ResNet",
                      depth=depth, groups=groups, base_width=base),
        neck=dict(out_channels=32, num_outs=5),
        bbox_head=dict(num_classes=16, feat_channels=32,
                       point_feat_channels=32))), "float32")
    model.backbone.load_state_dict(
        {k[len("backbone."):]: v for k, v in got.items()}, strict=True)
    assert model.backbone.layer1_0.conv2.conv.weight.shape == (
        (int(64 * base / 64) * groups, base, 3, 3) if groups > 1
        else (64, 64, 3, 3))


@pytest.mark.parametrize("name", ["r101_demo", "r50_mosaic",
                                  "resnext50_32x4d"])
def test_config_tree_loads_strictly(name):
    """The R-101 and R-50 mosaic demo configs, and the R-50 demo with a
    ResNeXt-50 32x4d backbone, at their published widths: every leaf of
    JAX's build_detector tree loads strictly into the port's detector (the
    other configs: test_torch_port, test_torch_swin, test_torch_hrnet,
    test_torch_ssd_vgg)."""
    file = "r50_demo" if name.startswith("resnext") else name
    cfg = load_config(os.path.join(
        REPO, "configs/dota", f"orientedreppoints_{file}.py"))
    if name.startswith("resnext"):
        cfg["model"]["backbone"].update(type="ResNeXt", groups=32,
                                        base_width=4)
    model, _ = tree_loads_strictly(cfg)
    if name.startswith("resnext"):
        assert model.backbone.layer4_2.conv2.conv.weight.shape == (
            1024, 32, 3, 3)


def narrow_r18(frozen_stages=1):
    return dict(model=dict(
        backbone=dict(type="ResNet", depth=18, frozen_stages=frozen_stages),
        neck=dict(out_channels=32, num_outs=5),
        bbox_head=dict(num_classes=16, feat_channels=32,
                       point_feat_channels=32)))


def test_load_pretrained_backbone(tmp_path):
    """A `state_dict` wrapper is unwrapped and the backbone replaced; the
    neck and head keep their values.  Other backbones are refused."""
    sd = torchvision_sd("resnet18", np.random.default_rng(0))
    path = str(tmp_path / "r18.pth")
    torch.save({"state_dict": sd}, path)
    model = apis.build_detector(narrow_r18(), "float32")
    model.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    checkpoint.load_pretrained_backbone(model, path, 18)
    want = checkpoint.convert_torchvision_resnet(sd, 18)
    after = model.state_dict()
    assert all(torch.equal(after[k], v) for k, v in want.items())
    assert set(want) == {k for k in after if k.startswith("backbone.")}
    assert all(torch.equal(after[k], v) for k, v in before.items()
               if not k.startswith("backbone."))
    torch.save(sd, path)  # no wrapper
    model.init_weights(torch.Generator().manual_seed(1))
    checkpoint.load_pretrained_backbone(model, path, 18)
    assert torch.equal(model.backbone.stem.conv.weight,
                       want["backbone.stem.conv.weight"])
    hrnet = apis.build_detector(dict(model=dict(
        backbone=dict(type="HRNet", extra=TINY_EXTRA),
        neck=dict(out_channels=32, num_outs=5),
        bbox_head=dict(num_classes=16, feat_channels=32,
                       point_feat_channels=32))), "float32")
    with pytest.raises(ValueError, match="hrnet backbone"):
        checkpoint.load_pretrained_backbone(hrnet, path, 18)


def test_train_cli_pretrained_backbone(data, tmp_path):  # noqa: F811
    """tools/train_torch.py --pretrained_backbone on the CPU for one
    iteration (frozen_stages 1): the checkpoint's stem and layer1 equal the
    file's converted tensors (frozen, so untouched by the step), as do
    every BN statistic of the backbone."""
    root, _ = data
    text = (root / "narrow.py").read_text()
    assert "frozen_stages=-1" in text
    (tmp_path / "narrow.py").write_text(text.replace("frozen_stages=-1",
                                                     "frozen_stages=1"))
    sd = torchvision_sd("resnet18", np.random.default_rng(3))
    torch.save({"state_dict": sd}, str(tmp_path / "r18.pth"))
    assert load_tool("train_torch").main([
        str(tmp_path / "narrow.py"), "--work_dir", str(tmp_path / "w"),
        "--device", "cpu", "--max_iters", "1",
        "--pretrained_backbone", str(tmp_path / "r18.pth")]) == 0
    saved = checkpoint._read(str(tmp_path / "w" / "ckpts"))["model"]
    want = checkpoint.convert_torchvision_resnet(sd, 18)
    kept = [k for k in want if k.startswith(("backbone.stem.",
                                             "backbone.layer1_"))
            or k.endswith((".mean", ".var"))]
    assert len(kept) > 20
    assert all(torch.equal(saved[k], want[k]) for k in kept)
    # the rest trained from the file's values
    assert not torch.equal(saved["backbone.layer4_1.conv2.conv.weight"],
                           want["backbone.layer4_1.conv2.conv.weight"])


# --------------------------------------------------------------------------
# tools/export_torch_state_dict.py
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_r18(tmp_path_factory):
    """test_torch_slice's narrow R-18 config, its JAX weights (head
    perturbed so that the decode has work) saved as a TrainState
    checkpoint and as a params-only one, and JAX's head outputs and
    detections on seeded images."""
    root = tmp_path_factory.mktemp("export")
    path = root / "tiny_r18.py"
    path.write_text(TINY_CONFIG)
    model = builder.build_detector(Config.fromfile(str(path)), "float32")
    imgs = np.random.default_rng(1).normal(size=(2, 128, 128, 3)).astype(
        np.float32)
    variables = perturb_head(jax.tree_util.tree_map(
        np.array, dict(jax.jit(model.init)(jax.random.PRNGKey(5),
                                           jnp.asarray(imgs)))),
        np.random.default_rng(0))
    tx = train_ref.build_optimizer(variables["params"],
                                   train_ref.lr_schedule())
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])
    ckpt_ref.save_checkpoint(
        str(root / "train_state"), 7, train_ref.TrainState(
            step=jnp.asarray(7, jnp.int32), params=params,
            batch_stats=stats, opt_state=tx.init(params), tx=tx))
    with ocp.CheckpointManager(str(root / "params_only")) as mngr:
        mngr.save(3, args=ocp.args.StandardSave(
            {"params": params, "batch_stats": stats}))
        mngr.wait_until_finished()
    outs = jax.jit(model.apply)(variables, imgs)
    return dict(root=root, config=str(path), imgs=imgs, outs=outs,
                variables=variables)


@pytest.mark.parametrize("kind", ["train_state", "params_only"])
def test_export_tool(jax_r18, kind, jax_ties_first):  # noqa: F811
    """The exported file equals flax_to_torch of the saved tree, loads
    strictly through apis.init_detector, and the port's head outputs from
    it equal JAX's within 2e-4 of each output's largest element and its
    detections JAX's (test_torch_slice's tolerances)."""
    out = str(jax_r18["root"] / f"{kind}.pt")
    assert load_tool("export_torch_state_dict").main(
        [jax_r18["config"], str(jax_r18["root"] / kind), out]) == 0
    sd = torch.load(out, map_location="cpu", weights_only=True)
    want = flax_to_torch(jax_r18["variables"])
    assert set(sd) == set(want)
    assert all(torch.equal(sd[k], v) for k, v in want.items())
    model, _ = apis.init_detector(jax_r18["config"], state_dict=sd,
                                  compute_dtype="float32", device="cpu")
    with torch.inference_mode():
        outs = model(torch.from_numpy(jax_r18["imgs"]))
    for key in ("cls_scores", "pts_refine"):
        for got, ref in zip(outs[key], jax_r18["outs"][key]):
            ref = np.asarray(ref)
            err = np.abs(got.numpy() - ref).max()
            assert err <= 2e-4 * max(1.0, float(np.abs(ref).max())), err
    with torch.inference_mode():
        got = decode_detections({k: outs[k] for k in ("cls_scores",
                                                      "pts_refine")},
                                **DECODE)
    ref = jax.jit(lambda o: decode_ref(o, **DECODE))(
        {k: jax_r18["outs"][k] for k in ("cls_scores", "pts_refine")})
    (dets, labels, valid), (dets_r, labels_r, valid_r) = (
        (t.numpy() for t in got), map(np.asarray, ref))
    np.testing.assert_array_equal(valid, valid_r)
    np.testing.assert_array_equal(labels[valid], labels_r[valid])
    d, r = dets[valid], dets_r[valid]
    assert len(d) > 10
    # two conv libraries' head outputs (measured 1.5e-3 px)
    np.testing.assert_allclose(d[:, :18], r[:, :18], rtol=0, atol=1e-2)
    np.testing.assert_allclose(d[:, 26], r[:, 26], rtol=0, atol=1e-4)
    assert np.all(same_min_rect(d[:, 18:26], r[:, 18:26], tol=0.05))
