"""repro_torch.benchmarks — the paper's figures and the simulator bench on the port.

``fig5``, ``fig6``, ``sim_bench``, ``jobs_bench`` and ``placement_bench`` mirror the JAX
package's ``benchmarks/`` modules (same policies, grids, derived checks and asserts;
the ``name,us_per_call,derived`` CSV stdout contract); ``paper_repro``
mirrors ``examples/paper_repro.py``. They run on CUDA unless the caller
asks for the CPU, import nothing of JAX, and write a file only to a path
the caller names.
"""
