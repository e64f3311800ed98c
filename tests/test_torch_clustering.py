"""The port's k-means (`ops/clustering.py`) against the JAX package's, on
the CPU: both backends, on JAX's own test problems (Gaussian blobs, k = 2
and 3, d = 4, n = 300 / 1111 / 64) and on the split features of the small
fixture knee (48x96x96, the bench fixture's shells at a quarter of their
size: 3 FC x-bands at d = 9, TC at d = 6).

Bars: the port's device path against JAX's device path, labels equal up to
a permutation on the blobs and at least 99 % equal on the split features
(whose band edges hold near-ties), centres within 1e-4 of their largest
after matching; device against host, at least 99 % (JAX's own bar,
`tests/test_mesh.py`); each `kmeans_many` answer equal to its problem's
standalone `kmeans`. `OAI_TPU_KMEANS_BACKEND` sends `split_meshes` down the
device path with the host path's faces.
"""

import itertools

import numpy as np
import pytest
import torch

from oai_analysis_2_tpu.mesh import split as JS
from oai_analysis_2_tpu.ops import clustering as JK
from oai_analysis_2_tpu_torch.core.image import image_from_array
from oai_analysis_2_tpu_torch.mesh import split as TS
from oai_analysis_2_tpu_torch.mesh.processing import get_mesh
from oai_analysis_2_tpu_torch.ops import clustering as TK

torch.set_num_threads(2)

SHAPE = (48, 96, 96)
SPACING = (0.36, 0.36, 0.7)


def _blob_problems():
    """`tests/test_mesh.py::test_host_backend_matches_device`'s problems."""
    rng = np.random.default_rng(7)
    problems = []
    for n, k_blobs in [(300, 2), (1111, 3), (64, 2)]:
        cents = rng.normal(0, 8, (k_blobs, 4))
        pts = np.concatenate([rng.normal(c, 0.4, (n // k_blobs + 1, 4)) for c in cents]).astype(np.float32)
        problems.append(pts[:n])
    return problems


def _shell(r_inner, r_outer, center):
    z, y, x = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in SHAPE), indexing="ij")
    rr = np.sqrt(((z - center[0]) * 2.4) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2)
    shell = np.clip(1.0 - np.abs(rr - (r_inner + r_outer) / 2) / ((r_outer - r_inner) / 2), 0, 1)
    return (shell * (y < center[1])).astype(np.float32)


@pytest.fixture(scope="module")
def knee_meshes():
    """The fixture knee's smoothed FC and TC meshes (the split's input)."""
    maps = {"FC": _shell(27.0, 31.0, (24, 53, 48)), "TC": _shell(15.5, 19.5, (24, 60, 48))}
    return {kind: get_mesh(image_from_array(pm, spacing=SPACING, device="cpu")) for kind, pm in maps.items()}


@pytest.fixture(scope="module")
def split_problems(knee_meshes):
    problems = [p for kind, m in knee_meshes.items() for p in TS._split_problems(m, kind)[0]]
    assert [p.shape[1] for p in problems] == [9, 9, 9, 6]
    assert min(len(p) for p in problems) > 1000
    return problems


def _agreement(a, b, k):
    """The share of equal labels under the best permutation of b's labels,
    and that permutation."""
    a, b = np.asarray(a), np.asarray(b)
    best = max(((float(np.mean(a == np.asarray(perm)[b])), perm) for perm in itertools.permutations(range(k))),
               key=lambda t: t[0])
    return best


@pytest.mark.parametrize("k", [2, 3])
def test_device_matches_jax_device_on_blobs(k):
    """`kmeans` and `kmeans_many` with backend="device" against JAX's device
    program: labels equal up to a permutation; centres within 1e-4 of their
    largest after matching; JAX's ids (int labels, f32 centres)."""
    problems = _blob_problems()
    got_many = TK.kmeans_many(problems, k=k, backend="device", device="cpu")
    want_many = JK.kmeans_many(problems, k=k, backend="device")
    for x, got, want in zip(problems, got_many, want_many):
        share, _ = _agreement(want, got, k)
        assert share == 1.0 and got.shape == (len(x),) and got.dtype.kind == "i"
        labels, centers = TK.kmeans(x, k=k, backend="device", device="cpu")
        jlabels, jcenters = JK.kmeans(x, k=k, backend="device")
        share, perm = _agreement(jlabels, labels, k)
        assert share == 1.0
        assert centers.dtype == np.float32 and centers.shape == (k, 4)
        jc = np.asarray(jcenters)
        np.testing.assert_allclose(centers[np.argsort(perm)], jc, rtol=0, atol=1e-4 * np.abs(jc).max())


@pytest.mark.parametrize("k", [2, 3])
def test_device_matches_host_and_standalone(k):
    """The port's device path against its host path (>= 99 % up to a
    permutation), and each `kmeans_many` answer equal to the same problem's
    standalone `kmeans`."""
    problems = _blob_problems()
    dev = TK.kmeans_many(problems, k=k, backend="device", device="cpu")
    host = TK.kmeans_many(problems, k=k, backend="host")
    for x, d, h in zip(problems, dev, host):
        assert _agreement(h, d, k)[0] >= 0.99
        np.testing.assert_array_equal(d, TK.kmeans(x, k=k, backend="device", device="cpu")[0])
        np.testing.assert_array_equal(h, TK.kmeans(x, k=k, backend="host")[0])


def test_split_features_match_jax(split_problems):
    """The fixture knee's 4 split problems (k = 2): the port's device path
    against JAX's device path (>= 99 % up to a permutation, centres within
    1e-4 of their largest), against the port's host path (>= 99 %), and
    the batched answers against the standalone ones (>= 99 %: padding to the
    widest problem changes the summation order, which can move a near-tie)."""
    got = TK.kmeans_many(split_problems, k=2, backend="device", device="cpu")
    want = JK.kmeans_many(split_problems, k=2, backend="device")
    host = TK.kmeans_many(split_problems, k=2, backend="host")
    for x, g, w, h in zip(split_problems, got, want, host):
        assert _agreement(w, g, 2)[0] >= 0.99
        assert _agreement(h, g, 2)[0] >= 0.99
        labels, centers = TK.kmeans(x, k=2, backend="device", device="cpu")
        assert _agreement(labels, g, 2)[0] >= 0.99
        jlabels, jcenters = JK.kmeans(x, k=2, backend="device")
        share, perm = _agreement(jlabels, labels, 2)
        assert share >= 0.99
        jc = np.asarray(jcenters)
        np.testing.assert_allclose(centers[np.argsort(perm)], jc, rtol=0, atol=1e-4 * np.abs(jc).max())


def test_variable_sends_split_to_the_device_path(knee_meshes, monkeypatch):
    """With `OAI_TPU_KMEANS_BACKEND=device`, `split_meshes` solves its
    problems in one device call and gives the host path's inner and outer
    faces (and JAX's device path's) on the fixture meshes."""
    meshes, kinds = list(knee_meshes.values()), list(knee_meshes)
    monkeypatch.delenv("OAI_TPU_KMEANS_BACKEND", raising=False)
    host = TS.split_meshes(meshes, kinds, device="cpu")
    calls = []
    solve = TK._solve_on_device

    def spy(arrs, *args, **kwargs):
        calls.append(len(arrs))
        return solve(arrs, *args, **kwargs)

    monkeypatch.setattr(TK, "_solve_on_device", spy)
    assert TS.split_meshes(meshes, kinds, device="cpu") and calls == []  # unset: the host path
    monkeypatch.setenv("OAI_TPU_KMEANS_BACKEND", "device")
    dev = TS.split_meshes(meshes, kinds, device="cpu")
    assert calls == [4]
    jdev = JS.split_meshes(meshes, kinds)
    for (hi, ho), (di, do), (ji, jo) in zip(host, dev, jdev):
        assert hi.n_cells > 100 and ho.n_cells > 100
        for h, d, j in ((hi, di, ji), (ho, do, jo)):
            np.testing.assert_array_equal(d.faces, h.faces)
            np.testing.assert_array_equal(d.vertices, h.vertices)
            np.testing.assert_array_equal(d.faces, j.faces)


def test_backend_choice(monkeypatch):
    """JAX's values and default: unset or "host" is numpy, "device" the
    torch program, anything else raises `ValueError` (from the variable or
    the argument); an argument overrides the variable; `device=None` means
    the card and raises here, with no fall back to the CPU; no problems, no
    answers."""
    x = _blob_problems()[0]
    monkeypatch.delenv("OAI_TPU_KMEANS_BACKEND", raising=False)
    assert TK._backend(None) == JK._backend(None) == "host"
    np.testing.assert_array_equal(TK.kmeans(x)[0], TK._kmeans_np(x, 2, 50)[0])
    with pytest.raises(ValueError, match="'host' or 'device'"):
        TK.kmeans(x, backend="gpu")
    monkeypatch.setenv("OAI_TPU_KMEANS_BACKEND", "cuda")
    with pytest.raises(ValueError, match="'host' or 'device'"):
        TK.kmeans_many([x])
    with pytest.raises(ValueError):
        JK.kmeans_many([x])
    assert TK.kmeans(x, backend="host")[0].shape == (300,)
    monkeypatch.setenv("OAI_TPU_KMEANS_BACKEND", "device")
    assert TK._backend(None) == "device"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TK.kmeans_many([x])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TK.kmeans(x)
    assert TK.kmeans_many([], device="cpu") == [] == JK.kmeans_many([])
    np.testing.assert_array_equal(TK.kmeans(x, device="cpu", backend="device")[0],
                                  TK.kmeans(x, device=torch.device("cpu"))[0])
