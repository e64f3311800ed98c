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
"""

__version__ = "0.1.0"
