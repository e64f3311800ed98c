"""Time every tile of the sm90n conv kernel at the trainers' shapes.

    python3 tools/port_sm90n_tiles.py      # on a machine with an NVIDIA card and nvcc

For each conv of the w24 GradICON's finest stage that takes the sm90n route
(`cuda_conv.conv3d_route`), forward and data gradient, and the segment
UNet's enc0b data gradient (64 -> 32 at 2x32x128x128), it launches
`csrc/conv3d_sm90n.cu` through its C interface at every tile the library is
built for (BKC, BN, n-tiles, MW; N at most a third wider than Cout past one
tile), checks each against the plain conv, and times each with CUDA events
(10 launches after one warm-up; the C call alone, without the wrapper's
weight re-layout and checks). Beside them: the tile that
`cuda_conv.sm90n_tile` chooses, its loads-only build, the wmma build and
cuDNN's forward on the same data, and the bound (`chip_smoke.conv_bounds`).
Prints one line a shape; writes everything to
`chiprun_out/port_sm90n_tiles.json`.
"""

from __future__ import annotations

import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

import chip_smoke as cs  # noqa: E402
from oai_analysis_2_tpu_torch.models.gradicon import _stage_spec  # noqa: E402
from oai_analysis_2_tpu_torch.ops import cuda_build, cuda_conv  # noqa: E402


def shapes() -> list:
    """(name, (B, D, H, W), Cin, Cout) of every sm90n conv of the trainers."""
    out = []
    for name, shape, cin, cout in cs.unet_convs(_stage_spec(cs.REG_WIDTH), (1,) + cs.REG_GRID, "gradicon."):
        if cuda_conv.conv3d_route(cin, cout, torch.bfloat16) == "sm90n":
            out.append((name, shape, cin, cout))
        if cuda_conv.conv3d_route(cout, cin, torch.bfloat16) == "sm90n":
            out.append((name + ":dgrad", shape, cout, cin))
    out.append(("unet.enc0b:dgrad", cs.TRAIN_TILE, 64, 32))
    return out


def candidates(cin: int, cout: int, chosen: tuple) -> list:
    out = []
    for bn in cuda_conv.SM90N_BN:
        nt = -(-cout // bn)
        if nt > 6 or (bn != chosen[1] and nt > 1 and nt * bn > 1.34 * cout):
            continue
        for mw in cuda_conv._SM90N_MW[bn]:
            out += [(bkc, bn, nt, mw) for bkc in (16, 32, 64) if cuda_conv.sm90n_stages(bkc, bn, mw) >= 3]
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("port_sm90n_tiles: needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    fn = cuda_build.load_library("conv3d_sm90n").conv3d_sm90n
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(x, wt, b, out, tile, loads_only=0):
        bb, d, h, w, cin = x.shape
        err = fn(x.data_ptr(), wt.data_ptr(), b.data_ptr(), out.data_ptr(), bb, d, h, w, cin, out.shape[-1], 1, 1,
                 *tile, loads_only, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sm90n tile {tile}: error {err}")

    rows = []
    for name, shape, cin, cout in shapes():
        gen = torch.Generator(device="cuda").manual_seed(cin + cout)
        x = torch.randn(shape + (cin,), device="cuda", generator=gen).to(torch.bfloat16)
        k = (torch.randn((3, 3, 3, cin, cout), device="cuda", generator=gen) / (27 * cin) ** 0.5).to(torch.bfloat16)
        b = torch.randn((cout,), device="cuda", generator=gen) * 0.1
        want = cuda_conv.conv3d_reference(x, k, b, relu=True, out_dtype=torch.float32)
        wt = cuda_conv.sm90_weights(k)
        out = torch.empty(shape + (cout,), device="cuda", dtype=torch.bfloat16)
        chosen = cuda_conv.sm90n_tile(cin, cout, shape)
        tiles = {}
        for tile in candidates(cin, cout, chosen):
            run(x, wt, b, out, tile)
            torch.cuda.synchronize()
            err = float((out.float() - want).abs().max())
            if err > 2e-2 + 2e-2 * float(want.abs().max()):
                raise AssertionError(f"{name} tile {tile}: max abs err {err}")
            tiles[str(tile)] = {"ms": cs.time_ms(torch, lambda: run(x, wt, b, out, tile), 10), "max_abs_err": err}
        x_cl = x.permute(0, 4, 1, 2, 3)
        w_cl = k.permute(4, 3, 0, 1, 2).contiguous(memory_format=torch.channels_last_3d)
        voxels = 1
        for v in shape:
            voxels *= v
        best = min(tiles, key=lambda t: tiles[t]["ms"])
        row = {"name": name, "shape": list(shape), "cin": cin, "cout": cout, "chosen": str(chosen),
               "chosen_ms": tiles[str(chosen)]["ms"], "best": best, "best_ms": tiles[best]["ms"],
               "loads_ms": cs.time_ms(torch, lambda: run(x, wt, b, out, chosen, 1), 10),
               "wmma_ms": cs.time_ms(torch, lambda: cuda_conv.launch(x, k, b, route="wmma", relu=True,
                                                                      out_dtype=torch.bfloat16), 5),
               "library_ms": cs.time_ms(torch, lambda: F.conv3d(x_cl, w_cl, b.to(torch.bfloat16), padding=1), 10),
               "bound_ms": cs.conv_bounds(voxels, cin, cout, 2, 2)[0], "tiles": tiles}
        rows.append(row)
        print(f"{name:24s} {cin:4d}->{cout:4d} chosen {row['chosen']:18s} {row['chosen_ms']:.4f} ms, best "
              f"{best:18s} {row['best_ms']:.4f}, loads {row['loads_ms']:.4f}, wmma {row['wmma_ms']:.4f}, "
              f"cuDNN {row['library_ms']:.4f}, bound {row['bound_ms']:.4f}", flush=True)
        del x, k, b, want, wt, out, x_cl, w_cl
        torch.cuda.empty_cache()
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "port_sm90n_tiles.json").write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
