"""Where the phantom full demo's result gap between the port and the JAX
package arises, stage by stage, on the CPU, in one process that imports
both packages.

    JAX_PLATFORMS=cpu python tools/port_full_demo_handoff.py [--shape 80,192,192] [--threads 8]

Each package builds its own phantom with the full demo's `_phantom_setup`
(`examples/full_demo.py` and `oai_analysis_2_tpu_torch/examples/
full_demo.py`, the first loaded by path). Printed, one JSON line each:

- `window`: both packages' 0.1 / 99.9 percentiles of the raw phantom and
  the largest difference of the windowed knees;
- `segment`: the FC / TC probability maps of each package's segmenter
  (the offline production UNet) on JAX's windowed knee;
- `register`: the displacement fields of each package's `register` on
  JAX's windowed knee;
- `warp`: the port's `resample_image` of JAX's maps by JAX's field,
  against JAX's;
- `thickness`: the port's `get_thickness_mesh` of JAX's warped maps
  against JAX's (points, mean thickness);
- `raster`: the port's `map_attributes` -> `project_thickness` ->
  `rasterize_thickness` on JAX's meshes and atlas meshes against JAX's
  (mean mapped thickness);
- `attribution`: JAX's chain from the warp on (JAX maps, JAX field), (port
  maps, JAX field), (JAX maps, port field) and (port maps, port field):
  the TC mesh and mapped mean each gives, so that a gap is pinned to the
  stage whose output moves it.

Map rows give the largest difference, the voxels that differ by more than
1e-3 and the voxels on the other side of 0.5 (the iso-level of the
meshes). The last line is one JSON object of all rows. At 80x192x192 the
run takes about 7 minutes on 8 threads.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def _load_jax_demo():
    spec = importlib.util.spec_from_file_location("jax_full_demo", ROOT / "examples" / "full_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def map_gap(a, b) -> dict:
    """Largest difference, voxels off by more than 1e-3, voxels across 0.5."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d = np.abs(a - b)
    return {"max_abs": float(d.max()), "over_1e-3": int((d > 1e-3).sum()),
            "cross_0.5": int(((a >= 0.5) != (b >= 0.5)).sum())}


def mesh_summary(inner) -> dict:
    return {"points": int(inner.n_points), "mean": float(np.mean(inner.point_data))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="80,192,192")
    ap.add_argument("--threads", type=int, default=8)
    args = ap.parse_args()
    os.environ["OAI_DEMO_SHAPE"] = args.shape

    import jax.numpy as jnp
    import torch

    import oai_analysis_2_tpu.ops.intensity as JN
    from oai_analysis_2_tpu.core.image import Image as JImage
    from oai_analysis_2_tpu.mesh import processing as JP
    from oai_analysis_2_tpu.ops.resample import DisplacementField as JField
    from oai_analysis_2_tpu.ops.resample import resample_image as jwarp
    import oai_analysis_2_tpu_torch.examples.full_demo as TFull
    from oai_analysis_2_tpu_torch.core.image import Image as TImage
    from oai_analysis_2_tpu_torch.mesh.ops import map_attributes as tmap
    from oai_analysis_2_tpu_torch.mesh.processing import get_thickness_mesh as tthick
    from oai_analysis_2_tpu_torch.mesh.projection import project_thickness as tproject
    from oai_analysis_2_tpu_torch.mesh.projection import rasterize_thickness as traster
    from oai_analysis_2_tpu_torch.mesh.types import Mesh as TMesh
    from oai_analysis_2_tpu_torch.ops.intensity import _percentiles
    from oai_analysis_2_tpu_torch.ops.resample import DisplacementField as TField
    from oai_analysis_2_tpu_torch.ops.resample import resample_image as twarp

    torch.set_num_threads(args.threads)
    JFull = _load_jax_demo()
    rows = {}

    def emit(name, row):
        rows[name] = row
        print(f"{name}: {json.dumps(row)}", flush=True)

    def t_image(j):
        return TImage(*(torch.from_numpy(np.array(getattr(j, k))) for k in ("data", "origin", "spacing", "direction")))

    def j_image(t):
        return JImage(*(jnp.asarray(getattr(t, k).cpu().numpy()) for k in ("data", "origin", "spacing", "direction")))

    def t_field(j):
        return TField(*(torch.from_numpy(np.array(getattr(j, k))) for k in ("field", "origin", "spacing", "direction")))

    def j_field(t):
        return JField(*(jnp.asarray(getattr(t, k).cpu().numpy()) for k in ("field", "origin", "spacing", "direction")))

    def t_mesh(m):
        return TMesh(m.vertices, m.faces, m.point_data, m.cell_data)

    def jax_chain(tc_w, atlas_tc):
        """JAX's thickness, atlas map, projection and raster of one warped
        TC map: the inner mesh and the mean mapped thickness."""
        inner, _ = JP.get_thickness_mesh(tc_w, mesh_type="TC")
        m, c, _ = JP.rasterize_thickness(*JP.project_thickness(JP.map_attributes(inner, atlas_tc), mesh_type="TC"))
        return inner, float(m[c > 0].mean())

    # the window: each package's phantom setup; JAX's raw knee caught on
    # its way into the window
    raw = {}

    def spy(image, *a, **k):
        raw["jax"] = np.array(image.data)
        return jwin(image, *a, **k)

    t0 = time.perf_counter()
    jwin, JN.percentile_window = JN.percentile_window, spy
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jobj, jknee = JFull._phantom_setup()
        tobj, tknee = TFull._phantom_setup("cpu")
    JN.percentile_window = jwin
    raw["port"] = TFull._phantom_knee(tuple(int(v) for v in args.shape.split(",")))
    assert np.array_equal(raw["jax"], raw["port"]), "the two phantoms differ before the window"
    emit("window", {
        "jax_lo_hi": [float(jnp.percentile(jnp.asarray(raw["jax"]), p)) for p in (0.1, 99.9)],
        "port_lo_hi": _percentiles(torch.from_numpy(raw["port"]), (0.1, 99.9)),
        "max_abs": float(np.abs(np.asarray(jknee.data) - tknee.data.numpy()).max()),
        "seconds": time.perf_counter() - t0})
    # every later stage of the port is fed JAX's output of the stage before
    tknee = t_image(jknee)

    t0 = time.perf_counter()
    jmaps = jobj.segment(jknee)
    tmaps = tobj.segment(tknee)
    emit("segment", {**{t: map_gap(j.data, p.data.numpy()) for t, j, p in zip(("fc", "tc"), jmaps, tmaps)},
                     "jax_fc_equals_tc": bool(np.array_equal(jmaps[0].data, jmaps[1].data)),
                     "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    jphi = jobj.register(jknee)
    tphi = tobj.register(tknee)
    d = np.abs(np.asarray(jphi.field) - tphi.field.numpy())
    emit("register", {"max_abs_mm": float(d.max()), "mean_abs_mm": float(d.mean()),
                      "field_max_mm": float(np.abs(np.asarray(jphi.field)).max()),
                      "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    atlas = jobj.atlas_image
    jw = [jwarp(m, atlas, displacement=jphi) for m in jmaps]
    tw = [twarp(t_image(m), t_image(atlas), displacement=t_field(jphi)) for m in jmaps]
    emit("warp", {**{t: map_gap(j.data, p.data.numpy()) for t, j, p in zip(("fc", "tc"), jw, tw)},
                  "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    jinner = [JP.get_thickness_mesh(w, mesh_type=t)[0] for w, t in zip(jw, ("FC", "TC"))]
    tinner = [tthick(t_image(w), mesh_type=t)[0] for w, t in zip(jw, ("FC", "TC"))]
    emit("thickness", {t.lower(): {"jax": mesh_summary(j), "port": mesh_summary(p)}
                       for t, j, p in zip(("FC", "TC"), jinner, tinner)} | {"seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    jatlas = JFull._atlas_inner_meshes(jobj)
    row = {}
    for k, t in enumerate(("FC", "TC")):
        m, c, _ = JP.rasterize_thickness(*JP.project_thickness(JP.map_attributes(jinner[k], jatlas[k]), mesh_type=t))
        pm, pc, _ = traster(*tproject(tmap(t_mesh(jinner[k]), t_mesh(jatlas[k]), device="cpu"), mesh_type=t))
        row[t.lower()] = {"jax_mm": float(m[c > 0].mean()), "port_mm": float(pm[pc > 0].mean()),
                          "maps_equal": bool(np.array_equal(m, pm) and np.array_equal(c, pc))}
    emit("raster", row | {"seconds": time.perf_counter() - t0})

    # JAX's chain from the warp on, on each mix of the two packages'
    # segment and register outputs
    t0 = time.perf_counter()
    row = {}
    tmaps_j, tphi_j = [j_image(m) for m in tmaps], j_field(tphi)
    for name, maps, phi in (("jax_maps_jax_field", jmaps, jphi), ("port_maps_jax_field", tmaps_j, jphi),
                            ("jax_maps_port_field", jmaps, tphi_j), ("port_maps_port_field", tmaps_j, tphi_j)):
        tc_w = jwarp(maps[1], atlas, displacement=phi)
        inner, mapped = jax_chain(tc_w, jatlas[1])
        row[name] = {"tc_warped": map_gap(jw[1].data, tc_w.data), **mesh_summary(inner), "tc_mapped_mean_mm": mapped}
    emit("attribution", row | {"seconds": time.perf_counter() - t0})
    print(json.dumps({"shape": args.shape, **rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
