"""Entry point of the benchmark:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. Prints one JSON result line last on
standard output; exits non-zero with no result line when the card is
missing or the run cannot be judged.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout; the
# port's kernels build into its own build/kernels and build/native there
os.environ["TORCH_EXTENSIONS_DIR"] = str(_ROOT / "build" / "portbench" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(_ROOT / "build" / "portbench" / "triton")
# one process with few threads: the host's share of a knee runs on one
# core, so its pace does not hang on how busy the machine's other cores are
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
