"""Faults of the port against the JAX package, repaired: an unreadable
shipped GradICON file, `register_pair` without JAX's `params` argument,
and the segmenter without JAX's abstract `Segmenter` base.

Both packages see the same corrupt file at a monkeypatched
`default_gradicon_weights_path`, and the same seeded phantoms registered by
the shipped width-24 weights on a (16, 32, 32) grid, held to the
tolerances of tests/test_torch_registration.py.
"""

import dataclasses
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.core.image import image_from_array as jimage
from oai_analysis_2_tpu.engine import registration as JR
from oai_analysis_2_tpu.engine import segmenter as JSeg
from oai_analysis_2_tpu.models import gradicon as JG
from oai_analysis_2_tpu_torch.core.image import image_from_array as timage
from oai_analysis_2_tpu_torch.engine import registration as TR
from oai_analysis_2_tpu_torch.engine import segmenter as TSeg
from oai_analysis_2_tpu_torch.models import gradicon as TG
from oai_analysis_2_tpu_torch.models.synthetic import random_phantom

torch.set_num_threads(2)

GRID = (16, 32, 32)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def pair():
    a = random_phantom(np.random.default_rng(1), (20, 40, 36))
    b = random_phantom(np.random.default_rng(2), (24, 36, 40))
    meta_a = dict(spacing=(0.36, 0.36, 0.7), origin=(1.0, 2.0, 3.0))
    meta_b = dict(spacing=(0.4, 0.3, 0.7), origin=(0.5, -1.0, 2.0))
    return (timage(a, device="cpu", **meta_a), timage(b, device="cpu", **meta_b),
            jimage(a, **meta_a), jimage(b, **meta_b))


@pytest.mark.parametrize("content", [b"", b"PK\x03\x04 not a zip archive"])
def test_unreadable_shipped_weights(tmp_path, monkeypatch, content):
    """A corrupt gradicon.npz: the default config, and "auto" resolves to
    instance mode, in both packages (the port raised before)."""
    bad = tmp_path / "gradicon.npz"
    bad.write_bytes(content)
    for mod in (JG, TG, TR):
        monkeypatch.setattr(mod, "default_gradicon_weights_path", lambda: bad)
    assert TR.ICON_Registration._config_from_shipped_meta() is None
    assert JR.ICON_Registration._config_from_shipped_meta() is None
    treg = TR.ICON_Registration(mode="auto", device="cpu")
    jreg = JR.ICON_Registration(mode="auto")
    assert treg.mode == jreg.mode == "instance"
    assert dataclasses.asdict(treg.config) == dataclasses.asdict(TG.GradICONConfig())
    assert dataclasses.asdict(jreg.config) == dataclasses.asdict(JG.GradICONConfig())
    assert treg.model is None and treg.params is None


def _model():
    return TG.GradICON(TG.GradICONConfig(grid_shape=GRID, stage_width=24), device="cpu")


def test_register_pair_takes_params(pair):
    """register_pair(..., model=m, params=p) equals m.load_params(p)
    followed by a call, by keyword and in JAX's positional order."""
    ta, tb, _, _ = pair
    params = TG.load_gradicon_params()
    by_keyword, _ = TR.register_pair(ta, tb, model=_model(), params=params)
    loaded = _model()
    loaded.load_params(params)
    after_load, _ = TR.register_pair(ta, tb, model=loaded)
    positional, _ = TR.register_pair(ta, tb, _model(), params, TG.GradICONConfig(grid_shape=GRID, stage_width=24))
    assert torch.equal(by_keyword.field, after_load.field)
    assert torch.equal(by_keyword.field, positional.field)
    assert by_keyword.shape == GRID


def test_model_without_weights_raises(pair):
    """A model whose weights were never loaded returns the identity map if
    run; both packages refuse it."""
    ta, tb, ja, jb = pair
    with pytest.raises(ValueError, match="without weights"):
        TR.register_pair(ta, tb, model=_model())
    with pytest.raises(ValueError, match="without weights"):
        JR.register_pair(ja, jb, model=JG.GradICON(JG.GradICONConfig(grid_shape=GRID, stage_width=24)))
    with pytest.raises(ValueError, match="without weights"):
        TR.register_pair(ta, tb, model=_model(), params=None, finetune_steps=1)


def test_validate_registration_call_shape(pair):
    """The keyword call of examples/validate_registration.py (model, params,
    config, fine-tuning, gradient mode, early stop) runs unchanged against
    the port and agrees with the JAX package's: network + 2 fine-tuning
    steps, field within 1e-3 mm on average and 0.2 mm everywhere (as
    tests/test_torch_registration.py's fine-tune test)."""
    source = (ROOT / "examples" / "validate_registration.py").read_text()
    assert "model=GradICON(cfg), params=params," in source and "config=cfg, finetune_steps=finetune," in source
    ta, tb, ja, jb = pair
    fields = []
    for R, G, a, b, extra in ((TR, TG, ta, tb, dict(device="cpu")), (JR, JG, ja, jb, {})):
        params, meta = G.load_gradicon_checkpoint()
        cfg = G.GradICONConfig(**dict(meta, grid_shape=GRID))
        phi_ab, _ = R.register_pair(
            a, b, model=G.GradICON(cfg, **extra), params=params,
            config=cfg, finetune_steps=2,
            finetune_scales=(2,), finetune_lr=0.15,
            gicon_grad="alternating", early_stop=None,
        )
        fields.append(np.asarray(phi_ab.field))
    diff = np.abs(fields[0] - fields[1])
    assert diff.mean() <= 1e-3 and diff.max() <= 0.2, (diff.mean(), diff.max())


def test_load_gradicon_params_matches():
    got, want = TG.load_gradicon_params(), JG.load_gradicon_params()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in w:
            np.testing.assert_array_equal(g[name]["kernel"], np.asarray(w[name]["kernel"]))



def test_segmenter_hierarchy_matches():
    """`Segmenter` is an abstract base with the abstract `segment`, as in
    the JAX package (`engine/segmenter.py:36-44`), and the patch segmenter
    derives from it: the same class names up the hierarchy."""
    assert issubclass(TSeg.Segmenter3DInPatchClassWise, TSeg.Segmenter)
    assert inspect.isabstract(TSeg.Segmenter)
    assert TSeg.Segmenter.__abstractmethods__ == JSeg.Segmenter.__abstractmethods__ == frozenset({"segment"})
    with pytest.raises(TypeError):
        TSeg.Segmenter()
    names = [c.__name__ for c in TSeg.Segmenter3DInPatchClassWise.__mro__]
    assert names == [c.__name__ for c in JSeg.Segmenter3DInPatchClassWise.__mro__]
    assert not inspect.isabstract(TSeg.Segmenter3DInPatchClassWise)
    assert TSeg.Segmenter3DInPatchClassWise(config={"device": "cpu"}).ready is False
