"""matryoshka_mm_torch: the PyTorch / CUDA port of matryoshka_mm_tpu for an
NVIDIA H100.

It follows the JAX package's module names (``ops/attention.py``,
``models/llama.py``, ``generate.py``, ...).  Plain tensor code is PyTorch;
the two attention kernels on the single-image inference path are written
by hand in CUDA C++ for Hopper (``csrc/``), built by nvcc at first launch
(``_kernels.py``).  Each kernel has a plain PyTorch version beside it,
which a CPU tensor takes.  The port imports no JAX; it reuses the JAX
package's framework-free modules (constants, kvconfig, conversation,
mm_utils, image_processing).
"""

__version__ = "0.1.0"
