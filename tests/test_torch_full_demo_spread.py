"""`tools/port_full_demo_spread.py`: its one-ulp perturbation reaches the
knee of the unchanged JAX script's `_phantom_setup` and of the port's alike,
changes rounding only and leaves the atlas alone (16x32x32, no demo run)."""

import importlib.util
from pathlib import Path

import numpy as np

from oai_analysis_2_tpu import analysis_object as JA
from oai_analysis_2_tpu_torch import analysis_object as TA
from oai_analysis_2_tpu_torch.examples import full_demo as TF

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (16, 32, 32)


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_both_packages_get_the_same_perturbed_knee(monkeypatch):
    tool = load("port_full_demo_spread", "tools/port_full_demo_spread.py")
    script = load("jax_full_demo", "examples/full_demo.py")
    monkeypatch.setenv("OAI_DEMO_SHAPE", ",".join(map(str, SHAPE)))
    with tool.jax_knee_perturbed((3, 0.01)) as j_seen:
        j_obj, _ = script._phantom_setup()
    with tool.port_knee_perturbed((3, 0.01)) as t_seen:
        t_obj, _ = TF._phantom_setup("cpu")
    assert j_seen["knees"] == t_seen["knees"] == 1
    assert j_seen["knee"].dtype == np.float32 and j_seen["knee"].shape == SHAPE
    np.testing.assert_array_equal(j_seen["knee"], t_seen["knee"])

    knee, got = TF._phantom_knee(SHAPE), j_seen["knee"]
    moved = got != knee
    assert moved.sum() == round(0.01 * knee.size)
    # adjacent f32 values: one step from the old value reaches the new one
    assert np.array_equal(np.nextafter(knee[moved], got[moved]), got[moved])
    assert np.array_equal(got[~moved], knee[~moved])

    # the atlas as each package makes it unperturbed
    np.testing.assert_array_equal(np.asarray(j_obj.atlas_image.data), np.asarray(JA._phantom_atlas(SHAPE).data))
    np.testing.assert_array_equal(t_obj.atlas_image.data.numpy(), TA._phantom_atlas(SHAPE, "cpu").data.numpy())
    # and the wrappers are gone on leaving
    assert TF._phantom_knee.__module__ == TF.__name__
    with tool.jax_knee_perturbed(None) as j_plain:
        script._phantom_setup()
    np.testing.assert_array_equal(j_plain["knee"], knee)
