"""Every config of configs/dota/ read by the PyTorch port as the JAX package
reads it: the loss settings, the image normalisation, the learning rate
at each iteration around the warmup's end and every step boundary, the
optimizer (type, hyperparameters, the no-decay group, the frozen
parameters, the clip), the loader's batch, canvases and max_gt, test_cfg
and the decode settings each package's run_inference builds from it, and
the parameter tree (names and shapes: JAX's abstract init through
utils/convert.flax_to_torch against the port's detector, loaded strictly).
Shapes only: no forward pass; the port's detector is built on the meta
device.  The optimizer and tree checks trace each config's JAX init
(~0.6-4 s a config), so they run in tests/test_torch_configs_tree_{a,b}.py,
every other config each."""

import dataclasses
import glob
import inspect
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orientedreppoints_tpu import apis as japis
from orientedreppoints_tpu import parallel as jparallel
from orientedreppoints_tpu.parallel import train as train_ref
from orientedreppoints_tpu.utils import builder
from orientedreppoints_tpu.utils.config import Config
from orientedreppoints_tpu_torch import apis
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.utils.convert import flax_to_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.basename(p)[:-3] for p in glob.glob(
    os.path.join(REPO, "configs", "dota", "*.py")))
ITERS_PER_EPOCH = 20  # 160 tiles at batch 8, the synthetic tool's runs
# JAX's AdamW no-decay substrings (the default its tools build with)
NO_DECAY = inspect.signature(train_ref.build_optimizer).parameters[
    "adamw_no_decay_substrings"].default


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def path_of(name: str) -> str:
    return os.path.join(REPO, "configs", "dota", name + ".py")


@pytest.fixture(scope="module")
def readings():
    """config name -> (the JAX Config, the port's dict), read once."""
    return {name: (Config.fromfile(path_of(name)),
                   load_config(path_of(name))) for name in CONFIGS}


_TREES = {}


def trees(name, jcfg, cfg):
    """JAX's parameter tree of the config (abstract init at its canvas)
    through flax_to_torch, each leaf filled with a code: 1 where JAX's
    frozen_stages mask freezes it, 2 where its AdamW decay mask decays
    it; and the port's detector built on the meta device."""
    if name not in _TREES:
        tpu = jcfg.get("tpu", {})
        canvas = tpu.get("canvas_buckets", [(1344, 1344)])[-1]
        model = builder.build_detector(jcfg,
                                       tpu.get("compute_dtype", "bfloat16"))
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, *canvas, 3), jnp.float32))
        params = dict(shapes)["params"]
        frozen = jax.tree_util.tree_leaves(train_ref._frozen_mask(
            params, train_ref.default_frozen_prefixes(
                jcfg.model["backbone"].get("frozen_stages", 1))))
        flat, treedef = jax.tree_util.tree_flatten_with_path(params)
        codes = []
        for (path, leaf), fz in zip(flat, frozen):
            # the rule of JAX's decay_mask on its own '/'-joined path
            s = "/".join(k.key if hasattr(k, "key") else str(k)
                         for k in path).lower()
            decayed = not any(t in s for t in NO_DECAY)
            codes.append(np.full(leaf.shape, int(fz) + 2 * decayed,
                                 np.float32))
        variables = {k: jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), v)
            for k, v in dict(shapes).items()}
        variables["params"] = jax.tree_util.tree_unflatten(treedef, codes)
        sd = flax_to_torch(variables)
        with torch.device("meta"):
            port = apis.build_detector(cfg, tpu.get("compute_dtype",
                                                    "bfloat16"))
        _TREES[name] = sd, port
    return _TREES[name]


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_config_and_img_norm(name, readings):
    jcfg, cfg = readings[name]
    want = dataclasses.asdict(builder.build_loss_config(jcfg))
    got = dataclasses.asdict(apis.build_loss_config(cfg))
    assert got == want
    assert apis.build_img_norm(cfg) == builder.build_img_norm(jcfg)


def lr_iters(lr_config) -> list:
    """0, the warmup's end and every step boundary, each +- 1."""
    marks = [0, lr_config["warmup_iters"]] + [
        e * ITERS_PER_EPOCH for e in lr_config["step"]]
    return sorted({max(m + d, 0) for m in marks for d in (-1, 0, 1)})


@pytest.mark.parametrize("name", CONFIGS)
def test_lr_at_each_iteration(name, readings):
    """The port's scheduler against lr_schedule as tools/train.py and
    tools/synth_benchmark.py call it, at the same iters_per_epoch: the
    same f32 values."""
    jcfg, cfg = readings[name]
    opt, lr = jcfg.optimizer, jcfg.lr_config
    sched = train_ref.lr_schedule(
        base_lr=opt["lr"], warmup_iters=lr["warmup_iters"],
        warmup_ratio=lr["warmup_ratio"], step_epochs=lr["step"],
        iters_per_epoch=ITERS_PER_EPOCH)
    model = torch.nn.Linear(2, 2)
    model.backbone = torch.nn.Module()  # build_trainer's frozen prefixes
    optimizer, scheduler, _ = apis.build_trainer(model, cfg, ITERS_PER_EPOCH)
    base = optimizer.param_groups[0]["initial_lr"]
    iters = lr_iters(lr)
    got = np.float32([base * scheduler.lr_lambdas[0](i) for i in iters])
    want = np.float32([sched(jnp.asarray(i)) for i in iters])
    np.testing.assert_array_equal(got, want)


def check_optimizer_recipe(name, jcfg, cfg):
    """The optimizer JAX's tools build from the config: its type and
    hyperparameters, the decayed parameters (AdamW: JAX's no-decay rule
    on its paths; SGD: every trainable one), the frozen ones (JAX's
    frozen_stages mask) and the global-norm clip."""
    sd, port = trees(name, jcfg, cfg)
    port.load_state_dict(sd, strict=True, assign=True)
    optimizer, _, step = apis.build_trainer(port, cfg, ITERS_PER_EPOCH)
    opt = jcfg.optimizer
    code = {k: int(v.reshape(-1)[0]) for k, v in sd.items()}
    params = dict(port.named_parameters())
    assert {k for k, p in params.items() if not p.requires_grad} == {
        k for k in params if code[k] & 1}
    ids = {id(p): k for k, p in params.items()}
    groups = [{ids[id(p)] for p in g["params"]}
              for g in optimizer.param_groups]
    trainable = {k for k, p in params.items() if p.requires_grad}
    wd = opt.get("weight_decay", 1e-4)
    if opt["type"] == "AdamW":
        assert isinstance(optimizer, torch.optim.AdamW)
        assert [(g["weight_decay"], g["betas"], g["eps"])
                for g in optimizer.param_groups] == [
            (wd, (0.9, 0.999), 1e-8), (0.0, (0.9, 0.999), 1e-8)]
        assert groups[0] == {k for k in trainable if code[k] & 2}
        assert groups[1] == trainable - groups[0]
    else:
        assert opt["type"] == "SGD"
        assert type(optimizer) is torch.optim.SGD
        (g,) = optimizer.param_groups
        assert (g["momentum"], g["weight_decay"], g["nesterov"]) == (
            opt.get("momentum", 0.9), wd, False)
        assert groups == [trainable]
    # the clip the step applies is the one JAX's chain is built with
    clip = inspect.getclosurevars(step).nonlocals["grad_clip"]
    assert clip == jcfg.optimizer_config["grad_clip"]["max_norm"]


def decode_settings(monkeypatch, jcfg, cfg):
    """The keyword arguments each package's run_inference hands
    decode_detections for the config's test_cfg, its defaults filled in
    (JAX's, then the port's): both run over no images, with shard_infer
    replaced by a call of the core on stand-ins and the decode by a
    recorder."""
    seen = []

    def record(outs, **kw):
        seen.append(kw)

    monkeypatch.setattr(japis, "decode_detections", record)
    monkeypatch.setattr(jparallel, "shard_infer",
                        lambda fn, mesh, batch_axes: fn(None, None, "sf"))
    japis.run_inference(types.SimpleNamespace(apply=lambda v, x: None),
                        {}, [], jcfg.test_cfg)
    monkeypatch.setattr(apis, "decode_detections", record)
    monkeypatch.setattr(apis, "shard_infer",
                        lambda fn, model, devices: fn(model, None, "sf"))
    apis.run_inference(_Stub(), [], cfg["test_cfg"], devices=None)
    return seen


class _Stub(torch.nn.Module):
    """A model of one parameter (its device) that returns nothing."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        return None


@pytest.mark.parametrize("name", CONFIGS)
def test_loader_and_test_cfg(name, readings, monkeypatch):
    jcfg, cfg = readings[name]
    want = builder.build_dataloader(None, jcfg)
    got = apis.build_dataloader(None, cfg)
    assert (got.batch_size, got.canvas_buckets, got.max_gt) == (
        want.batch_size, want.canvas_buckets, want.max_gt)
    assert cfg["test_cfg"] == jcfg.test_cfg
    jax_kw, port_kw = decode_settings(monkeypatch, jcfg, cfg)
    assert port_kw == jax_kw and set(jax_kw) == {
        "nms_pre", "score_thr", "iou_thr", "max_per_img", "pre_nms_cap",
        "scale_factor"}


def check_param_tree(name, jcfg, cfg):
    """The port's detector has JAX's tree: the same names and shapes, and
    the converted tree loads into it strictly."""
    sd, port = trees(name, jcfg, cfg)
    got = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    port.load_state_dict(sd, strict=True, assign=True)
