"""parallel/train.py::step_cost_analysis on the CPU at a small size: the
FLOPs of one train step (forward and backward, FlopCounterMode) equal a
hand-run forward + backward of the same batch, exceed the forward's alone,
and leave the model, the optimizer and the scheduler as they were."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from orientedreppoints_tpu_torch.apis import (build_loss_config,
                                              build_trainer, init_detector)
from orientedreppoints_tpu_torch.core.loss_head import compute_losses
from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.parallel import train


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny(config):
    cfg = load_config(config)
    cfg["model"]["neck"]["out_channels"] = 32
    cfg["model"]["bbox_head"].update(feat_channels=32,
                                     point_feat_channels=32)
    cfg["tpu"].update(device_normalize=False, max_pos=32)
    return cfg


def batch(seed=0, size=64):
    rng = np.random.default_rng(seed)
    quad = np.float32([[10, 10, 40, 12, 38, 30, 9, 28]])
    return dict(images=rng.normal(size=(2, size, size, 3)).astype(np.float32),
                gt_polys=np.stack([quad, quad + 5]),
                gt_labels=np.int32([[3], [4]]),
                gt_valid=np.ones((2, 1), bool),
                img_hw=np.int32([[size, size], [size, size - 16]]))


@pytest.mark.parametrize("config", ["synth_r18_512", "synth_swin_512"])
def test_step_flops_equal_forward_and_backward(config):
    cfg = tiny(f"configs/dota/{config}.py")
    if config.startswith("synth_swin"):
        cfg["model"]["backbone"].update(embed_dim=16, depths=[2, 2, 2, 2],
                                        num_heads=[1, 2, 2, 4])
    model, _ = init_detector(cfg, compute_dtype="float32", device="cpu")
    optimizer, scheduler, step = build_trainer(model, cfg)
    b = batch()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt_before = scheduler.last_epoch, optimizer.param_groups[0]["lr"]
    flops = train.step_cost_analysis(step, b)
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    assert (scheduler.last_epoch, optimizer.param_groups[0]["lr"]) == (
        opt_before)
    assert not optimizer.state or all(
        not s for s in optimizer.state.values())

    # the same step's work by hand: the train-mode forward with the step's
    # DropPath key, the losses and their backward
    imgs = torch.from_numpy(b["images"])
    key = train.dropout_key(0, scheduler.last_epoch)
    forward, both = FlopCounterMode(display=False), FlopCounterMode(
        display=False)
    model.train()
    with forward, torch.no_grad():
        model(imgs, key)
    with both:
        outs = model(imgs, key)
        losses = compute_losses(
            outs, *(torch.from_numpy(b[k]) for k in (
                "gt_polys", "gt_labels", "gt_valid", "img_hw")),
            build_loss_config(cfg))
        sum(v for k, v in losses.items() if k.startswith("loss")).backward()
    model.eval()
    assert flops == both.get_total_flops()
    assert flops > forward.get_total_flops() > 0


def test_a_step_without_flops_raises():
    """A step that counts nothing raises instead of returning None."""
    model = torch.nn.Linear(2, 2)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)

    def step(batch):
        return {}

    step.model, step.optimizer = model, opt
    step.scheduler = torch.optim.lr_scheduler.LambdaLR(opt, lambda i: 1.0)
    with pytest.raises(RuntimeError, match="no FLOPs"):
        train.step_cost_analysis(step, {})
