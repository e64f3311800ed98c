"""What nvcc made of the port's hand-written kernels: registers, spills and
the instruction mix of each kernel's loops.

    python3 tools/port_kernel_report.py [source ...]   # on a machine with nvcc

For each source in `oai_analysis_2_tpu_torch/csrc/` (default: all of them)
it compiles the library with the port's own flags (`ops/cuda_build.py`)
plus `-Xptxas -v` into `build/kernels/report_<name>.so` and prints, per
kernel, what ptxas reports (registers, spill stores and loads, shared
memory). Then it disassembles the library with `cuobjdump -sass` and, for
every loop (a branch back to an earlier address) of every kernel, prints
its length in instructions and the count of each opcode. The output is one
JSON object; the SASS listing goes to `build/kernels/report_<name>.sass`.
"""

from __future__ import annotations

import collections
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from oai_analysis_2_tpu_torch.ops import cuda_build  # noqa: E402

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_FUNC = re.compile(r"Function : (\S+)")


def ptxas_report(log: str) -> dict:
    """{kernel: {"registers": n, "spill_stores": bytes, "spill_loads": bytes, "smem": bytes}}."""
    out, current = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
            out.setdefault(current, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current:
            out[current].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and current:
            out[current]["registers"] = int(m.group(1))
            s = re.search(r"(\d+) bytes smem", line)
            out[current]["smem"] = int(s.group(1)) if s else 0
    return out


def sass_loops(sass: str) -> dict:
    """{kernel: [{"start": addr, "end": addr, "length": n, "opcodes": {op: n}}]},
    one entry per backward branch, innermost (shortest) first."""
    kernels, name, insns, labels = {}, None, [], {}

    def close():
        if name is None:
            return
        loops = []
        for addr, text in insns:
            m = re.search(r"\bBRA\s+(?:`\((\.L_x_\d+)\)|(0x[0-9a-f]+))", text)
            if not m:
                continue
            target = labels.get(m.group(1)) if m.group(1) else int(m.group(2), 16)
            if target is None or target >= addr:
                continue
            body = [t for a, t in insns if target <= a <= addr]
            ops = collections.Counter(t.split()[0] if not t.startswith("@") else t.split()[1] for t in body)
            loops.append({"start": hex(target), "end": hex(addr), "length": len(body), "opcodes": dict(ops.most_common())})
        kernels[name] = sorted(loops, key=lambda lp: lp["length"])

    pending = []
    for line in sass.splitlines():
        m = _FUNC.search(line)
        if m:
            close()
            name, insns, labels, pending = m.group(1), [], {}, []
            continue
        m = _LABEL.match(line)
        if m:
            pending.append(m.group(1))
            continue
        m = _INSN.search(line)
        if m and name is not None:
            addr = int(m.group(1), 16)
            for lab in pending:
                labels[lab] = addr
            pending = []
            insns.append((addr, m.group(2).strip()))
    close()
    return kernels


def report(name: str) -> dict:
    out_dir = cuda_build._BUILD
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"report_{name}.so"
    cmd = [cuda_build._nvcc(), *cuda_build._command(name), "-Xptxas", "-v", "-o", str(lib),
           str(cuda_build._CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stdout}{res.stderr}")
    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    (out_dir / f"report_{name}.sass").write_text(sass)
    return {"flags": cuda_build._command(name), "ptxas": ptxas_report(res.stdout + res.stderr),
            "loops": sass_loops(sass)}


def main(argv) -> int:
    names = argv or list(cuda_build.EXTRA_FLAGS)
    print(json.dumps({name: report(name) for name in names}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
