"""repro_torch.examples — the JAX package's user-facing examples on the port.

Each runs as ``python -m repro_torch.examples.<name> [--device cpu]`` (CUDA
unless ``--device cpu``), prints the reference script's table act for act,
and has a ``main(device=None, runs=None)`` that returns the numbers it
prints (``runs=None``: the reference's Monte-Carlo counts):

* ``quickstart`` — GMSA against DATA and RANDOM on the paper's 4-DC day;
* ``staged_jobs`` — stage-aware against stage-oblivious dispatch, then the
  placement controller reshaping the map stage's locality;
* ``adaptive_placement`` — two-timescale placement, then a site lost at noon;
* ``serve_geo`` — GMSA-dispatched serving with real model execution;
* ``train_lm`` — training through a failure and a restart from the last
  checkpoint (``main(device=None, steps=None)`` returns the first and last
  mean losses).

The paper's evaluation is ``repro_torch.benchmarks.paper_repro``.
"""
