"""The yardstick's operation and byte counts against hand counts."""

import json
from pathlib import Path

from portbench import roofline
from portbench.drivers import knee, train

ROOT = Path(__file__).resolve().parents[2]


def test_conv_counts_by_hand():
    # 10 output voxels, 4 -> 8 channels in bf16: 2 * 27 * 4 * 8 * 10 flops;
    # x 10*4*2, w 27*4*8*2, bias 8*4, out 10*8*2 bytes
    f, b = roofline.conv3x3_work(10, 4, 8, "bfloat16")
    assert f == 17280.0
    assert b == 80 + 1728 + 32 + 160
    assert roofline.bound_seconds(f, b, "bfloat16") == max(f / 989e12, b / 3.35e12)


def test_distance_counts_by_hand():
    f, b = roofline.distance_work(3, 5)
    assert f == 85 * 15
    assert b == 3 * 12 + 5 * 36 + 3 * 4


def test_segment_unet_routes():
    cfg = json.loads((ROOT / "portbench/configs/oai_knee_w24.json").read_text())
    w = knee.segment_work(cfg)
    assert len(w["all"]) == 14  # 3x3x3 convs of the production UNet
    assert w["sm90_launches"] == 65  # 13 convs x 5 z-slabs, as PERF's launch count


def test_train_step_sm90n_launches():
    cfg = json.loads((ROOT / "portbench/configs/gradicon_w24_train.json").read_text())
    # PERF's table: 96 forward and 116 data-gradient sm90n launches a step
    assert train.step_work(cfg)["sm90n_launches"] == 96 + 116
