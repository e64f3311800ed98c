"""The generator: the same inputs for the same seed, distinct knees."""

import json

import torch

from portbench import gen
from portbench.tests.conftest import HERE


def _tiny():
    return (json.loads((HERE / "tiny_knee.json").read_text()), json.loads((HERE / "tiny_stream.json").read_text()),
            json.loads((HERE / "tiny_train.json").read_text()), json.loads((HERE / "tiny_recipe.json").read_text()))


def test_same_seed_same_knees():
    cfg, tr, _, _ = _tiny()
    a = gen.knee_pool(cfg, tr, 2**31 + 5, "cpu")
    b = gen.knee_pool(cfg, tr, 2**31 + 5, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(gen.atlas(cfg, 9, "cpu"), gen.atlas(cfg, 9, "cpu"))


def test_pool_knees_distinct():
    cfg, tr, _, _ = _tiny()
    pool = gen.knee_pool(cfg, tr, 3, "cpu")
    assert len(pool) == len(gen.knee_variants(tr))
    for i in range(len(pool)):
        for j in range(i + 1, len(pool)):
            assert not torch.equal(pool[i], pool[j])


def test_stream_pool_is_sixteen_distinct_variants():
    tr = json.loads((HERE.parent / "traffic" / "stream.json").read_text())
    variants = gen.knee_variants(tr)
    assert len(variants) == 16
    assert len({tuple(sorted(v.items())) for v in variants}) == 16


def test_pair_bank_reproducible():
    _, _, cfg, tr = _tiny()
    a = gen.pair_bank(cfg, tr, 123, "cpu")
    b = gen.pair_bank(cfg, tr, 123, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(gen.phantom_pool(cfg, tr, 7, "cpu"), gen.phantom_pool(cfg, tr, 7, "cpu"))
