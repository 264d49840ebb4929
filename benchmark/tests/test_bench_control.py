"""The control on the card: the reference with its float32 parts in TF32,
put in the program's place, is not correct by the cell's limits. The
benchmark's runs never run it; ``calibrate.py`` reads it at full size."""

import pytest

import run
from conftest import shrink


@pytest.mark.card
@pytest.mark.parametrize("cell", ["hocnet_r18_256_obj1280.warp", "hocnet_r18_256_obj1280.sup",
                                  "hocnet_r18_128_box.warp"])
def test_tf32_control_fails(card, cell):
    import torch

    from harness import compare, scene
    from reference import step as reference

    cfg = shrink(run.load_cell(cell)[0])
    cfg["data"]["image_size"] = 128
    kind, seed = cfg["traffic"]["step"], 2**31 + 77
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    mano = scene.mano_arrays(seed, card)
    pool = scene.batch_pool(cfg, mano, seed, card)[:run.CHECKED_STEPS]
    ref = reference.run_steps(cfg, kind, mano, scene.weights(cfg, seed, card), pool, card)
    ctl = reference.run_steps(cfg, kind, mano, scene.weights(cfg, seed, card), pool, card,
                              tf32=True)
    nums, _ = compare.numbers(ctl, ref)
    assert not compare.judge(nums, cfg["traffic"]["limits"]), nums
