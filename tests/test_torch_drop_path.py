"""DropPath's drop rate on the CPU: the masks drawn under dropout_key(seed,
step), block by block, over many (seed, step) pairs.

A Swin forward in train mode draws two masks a block (attention and MLP
branches), in block order, under the step's key, and none where the
block's rate is 0; test_forward_draws_in_block_order ties the draws made
here (SwinTransformer.drop_masks) to that forward; that each mask is
flax's bit for bit is tests/test_torch_drop_path_keys.py's.  Each Swin-T
block's drop share (configs/dota/synth_swin_512.py: depths 2, 2, 6, 2,
drop_path_rate 0.2, batch 8) must lie within Z_BLOCK binomial standard
deviations of its rate dpr, and the share over all blocks within Z_ALL
of the mean rate.
"""

import numpy as np
import pytest
import torch

from orientedreppoints_tpu_torch.host import load_config
from orientedreppoints_tpu_torch.models import swin
from orientedreppoints_tpu_torch.parallel.train import dropout_key


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs several files side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEEDS = (0, 1, 7, 12345)
STEPS = 250  # steps 0..249 of each seed: 1,000 pairs
# a block's share deviates by more than 4.5 sigma with chance ~7e-6, so
# ~8e-5 for one of 11 blocks
Z_BLOCK = 4.5
Z_ALL = 4.0


@pytest.fixture(scope="module")
def swin_t():
    """Swin-T's block rates (published depths, the config's drop rate) at
    a narrow width, and the config's batch."""
    cfg = load_config("configs/dota/synth_swin_512.py")
    bb = cfg["model"]["backbone"]
    model = swin.SwinTransformer(embed_dim=16, depths=bb["depths"],
                                 num_heads=[1, 2, 2, 4],
                                 window_size=bb.get("window_size", 7),
                                 drop_path_rate=bb["drop_path_rate"])
    rates = [getattr(model, n).drop_path for s in model.stages for n in s]
    return model, rates, cfg["tpu"]["global_batch_size"]


def draws(model, rates, key, batch):
    """The keep masks of one step, two a block with a rate above 0:
    [(block, mask (batch,))]."""
    masks = model.drop_masks(key, batch)
    blocks = [b for b, r in enumerate(rates) if r for _ in range(2)]
    assert len(blocks) == len(masks)
    return list(zip(blocks, masks))


def test_forward_draws_in_block_order(swin_t, monkeypatch):
    """A train-mode forward calls drop_path twice a block with the masks
    drawn under the step's key: those of draws() under the same key."""
    model, rates, _ = swin_t
    want = draws(model, rates, dropout_key(5, 17), 3)
    seen = []
    orig = swin.drop_path

    def recorded(y, rate, mask):
        out = orig(y, rate, mask)
        if mask is not None and rate:
            seen.append((rate, (out.flatten(1) != 0).any(1)))
        return out

    monkeypatch.setattr(swin, "drop_path", recorded)
    model.train()
    x = torch.randn(3, 64, 64, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model(x, dropout_key(5, 17))
    assert len(seen) == len(want) == 2 * sum(r > 0 for r in rates) == 22
    for (rate, got), (b, mask) in zip(seen, want):
        assert rate == rates[b]
        assert np.array_equal(got.numpy(), mask)


def test_drop_share_matches_each_blocks_rate(swin_t):
    model, rates, batch = swin_t
    dropped = np.zeros(len(rates))
    samples = np.zeros(len(rates))
    for seed in SEEDS:
        for step in range(STEPS):
            for b, keep in draws(model, rates, dropout_key(seed, step),
                                 batch):
                dropped[b] += int((~keep).sum())
                samples[b] += batch
    assert samples[0] == 0 and rates[0] == 0.0  # block 0 never draws
    live = samples > 0
    p, n = np.asarray(rates)[live], samples[live]
    share = dropped[live] / n
    z = (share - p) / np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(z) <= Z_BLOCK), dict(zip(p.round(4), z.round(2)))
    p_all = float((p * n).sum() / n.sum())
    z_all = (dropped.sum() / n.sum() - p_all) / np.sqrt(
        p_all * (1 - p_all) / n.sum())
    assert abs(z_all) <= Z_ALL, z_all
