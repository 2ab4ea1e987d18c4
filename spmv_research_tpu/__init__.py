"""spmv_research_tpu — a JAX sparse linear-algebra framework (NVIDIA GPUs).

A JAX/XLA implementation of the capabilities of the SpMV-Research
benchmarking suite (see SURVEY.md): sparse formats with conversion and
feature extraction, SpMV/SpMM/SDDMM through every format's XLA lowering
(+SpGEMM, ILU0/IC0), iterative solvers, a seeded artificial-matrix generator,
a protocol-faithful benchmark harness, and multi-chip/multi-host distribution
over jax.sharding meshes.
"""

__version__ = "0.1.0"

from . import core, io, convert, gen, ops
