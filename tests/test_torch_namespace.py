"""The port's public namespace against the JAX package's: every name a JAX
subpackage exports imports from the port's matching subpackage, the top
level gives `AnalysisObject` and `__version__`, importing the package
builds or loads no kernel library; and the public helpers behind those
names that had no port before (`Partition`'s tiling and assembly,
`StageTimer.print_report`, `GLOBAL_TIMER`) against the JAX package's on
the same numpy inputs, on the CPU."""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import oai_analysis_2_tpu
from oai_analysis_2_tpu.ops.tiling import Partition as JPartition
from oai_analysis_2_tpu_torch.ops.tiling import Partition as TPartition
from oai_analysis_2_tpu_torch.utils import profiling as TProf

SUBPACKAGES = ("core", "engine", "mesh", "models", "ops", "parallel", "utils")
# the JAX package's sharding helpers: the port runs on one card
ONE_CARD = {"make_device_mesh", "make_sharded_train_step", "shard_batch"}
NAMES = [(sub, name) for sub in SUBPACKAGES
         for name in importlib.import_module(f"oai_analysis_2_tpu.{sub}").__all__ if name not in ONE_CARD]


@pytest.mark.parametrize("sub,name", NAMES, ids=[f"{s}.{n}" for s, n in NAMES])
def test_jax_subpackage_name_imports_from_the_port(sub, name):
    port = importlib.import_module(f"oai_analysis_2_tpu_torch.{sub}")
    assert name in port.__all__
    assert getattr(port, name) is not None


@pytest.mark.parametrize("sub", [s for s in SUBPACKAGES if s != "parallel"])
def test_subpackage_exports_the_jax_names_in_order(sub):
    want = importlib.import_module(f"oai_analysis_2_tpu.{sub}").__all__
    assert importlib.import_module(f"oai_analysis_2_tpu_torch.{sub}").__all__ == want


def test_parallel_leaves_out_the_sharding_helpers():
    import oai_analysis_2_tpu_torch.parallel as TPar

    want = [n for n in importlib.import_module("oai_analysis_2_tpu.parallel").__all__ if n not in ONE_CARD]
    assert sorted(TPar.__all__) == sorted(want)
    assert not ONE_CARD & set(dir(TPar))


def test_top_level_names():
    import oai_analysis_2_tpu_torch as T
    from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject

    assert T.__all__ == ["__version__", "AnalysisObject"]
    assert T.__version__ == oai_analysis_2_tpu.__version__ == "2.0.0"
    assert T.AnalysisObject is AnalysisObject
    from oai_analysis_2_tpu_torch import AnalysisObject as again  # noqa: F401
    with pytest.raises(AttributeError):
        T.enable_compilation_cache


def test_importing_the_package_loads_no_kernel_library():
    """A fresh process imports the package, its seven subpackages and
    `AnalysisObject`: no kernel library is built or loaded, CUDA is not
    initialised, and nothing of JAX is imported."""
    code = (
        "import sys, json, torch\n"
        "import oai_analysis_2_tpu_torch as T\n"
        f"for s in {SUBPACKAGES!r}: __import__('oai_analysis_2_tpu_torch.' + s)\n"
        "T.AnalysisObject\n"
        "from oai_analysis_2_tpu_torch.ops import cuda_build\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(json.dumps({'libs': len(cuda_build._libs), 'mapped': 'build/kernels' in maps,\n"
        "                  'cuda': torch.cuda.is_initialized(),\n"
        "                  'jax': sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'oai_analysis_2_tpu'))}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {"libs": 0, "mapped": False, "cuda": False, "jax": []}


# (image shape, tile x, y, z, overlap x, y, z, padding mode, crop x, y, z):
# a grid that does not divide the image, a pad wider than an axis (reflected
# again), edge and constant padding, a crop margin
PARTITIONS = [
    ((10, 13, 11), (8, 6, 5), (1, 1, 1), "reflect", None),
    ((9, 7, 12), (6, 6, 7), (2, 1, 2), "reflect", (1, 2, 1)),
    ((5, 4, 3), (7, 6, 5), (2, 2, 1), "reflect", None),
    ((8, 9, 10), (5, 5, 5), (1, 1, 1), "edge", (2, 1, 1)),
    ((8, 9, 10), (6, 4, 6), (1, 1, 2), "constant", None),
]


@pytest.mark.parametrize("shape,tile,overlap,mode,crop", PARTITIONS)
def test_partition_matches_jax(shape, tile, overlap, mode, crop):
    """Tiles equal, assembly within 1e-6, the vote equal."""
    rng = np.random.default_rng(8)
    volume = rng.normal(0, 1, shape).astype(np.float32)
    tp, jp = TPartition(tile, overlap, mode), JPartition(tile, overlap, mode)
    assert tp.grid_shape(shape) == jp.grid_shape(shape) and tp.num_tiles(shape) == jp.num_tiles(shape)
    tiles_t = tp(torch.as_tensor(volume))
    tiles_j = np.asarray(jp(jnp.asarray(volume)))
    assert tuple(tiles_t.shape) == tiles_j.shape
    np.testing.assert_array_equal(tiles_t.numpy(), tiles_j)
    # the network's output stands in: each tile scaled by its index
    scaled = tiles_j * (1.0 + np.arange(len(tiles_j), dtype=np.float32))[:, None, None, None]
    got = tp.assemble(torch.as_tensor(scaled), shape, crop_size=crop)
    want = np.asarray(jp.assemble(jnp.asarray(scaled), shape, crop_size=crop))
    assert tuple(got.shape) == want.shape == shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)
    labels = rng.integers(0, 3, tiles_j.shape).astype(np.int32)
    got_vote = tp.assemble_vote(torch.as_tensor(labels), shape, 3, crop_size=crop)
    want_vote = np.asarray(jp.assemble_vote(jnp.asarray(labels), shape, 3, crop_size=crop))
    assert got_vote.dtype == torch.int32
    np.testing.assert_array_equal(got_vote.numpy(), want_vote)


def test_partition_round_trip():
    """Tiling, then assembly without a crop, gives the volume back."""
    volume = torch.as_tensor(np.random.default_rng(9).normal(0, 1, (11, 10, 9)).astype(np.float32))
    p = TPartition((6, 5, 4), (1, 1, 1))
    assert torch.equal(p.assemble(p(volume), tuple(volume.shape)), volume)


def test_stage_timer_print_report(capsys):
    timer = TProf.StageTimer()
    for name in ("segment", "register", "segment"):
        with timer.stage(name):
            pass
    timer.print_report()
    printed = json.loads(capsys.readouterr().out)
    assert printed == timer.report()
    assert printed["segment"]["calls"] == 2 and printed["register"]["calls"] == 1


def test_global_timer_is_one_stage_timer():
    from oai_analysis_2_tpu_torch.utils.profiling import GLOBAL_TIMER

    assert isinstance(GLOBAL_TIMER, TProf.StageTimer) and GLOBAL_TIMER is TProf.GLOBAL_TIMER
