"""PyTorch/CUDA port of the OAI knee-MRI analysis framework.

A second package beside `oai_analysis_2_tpu` (the JAX reference, which it
never imports). Plain tensor code is PyTorch; the two kernels the JAX
package wrote in Pallas for the TPU are CUDA C++ written for Hopper
(`csrc/`), built with nvcc at first use and bound with ctypes.

The layout mirrors the JAX package module for module: `core/`, `ops/`,
`models/`, `engine/`, `mesh/`, `parallel/`, `utils/`. Public functions keep the JAX
package's layouts (NDHWC activations, DHWIO kernels, [z, y, x] volumes,
xyz-ordered origin/spacing/direction). Entry points take `device=None`,
which means "cuda", and raise when no card is present unless the caller
asks for the CPU.

`AnalysisObject` loads lazily, as in the JAX package, so importing the
package builds and loads no kernel library. The JAX package's
`enable_compilation_cache` has no counterpart: the kernel libraries are
cached by content hash in `build/kernels/` (`ops/cuda_build.py`).
"""

from oai_analysis_2_tpu_torch.__about__ import __version__

__all__ = ["__version__", "AnalysisObject"]


def __getattr__(name):
    if name == "AnalysisObject":
        from oai_analysis_2_tpu_torch.analysis_object import AnalysisObject

        return AnalysisObject
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
