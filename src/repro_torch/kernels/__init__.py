"""repro_torch.kernels — hand-written CUDA kernels for Hopper (``sm_90a``).

Each kernel keeps the JAX package's (kernel.py, ops.py, ref.py) triple:

* ``csrc/*.cu`` — the CUDA C++ source, built by ``nvcc`` at first use into
  a shared library with a plain C interface (:mod:`repro_torch.kernels._build`);
* ``kernel.py`` — the ctypes binding that launches it and counts launches;
* ``ref.py``    — the plain PyTorch version, used for CPU tensors, by the
  CPU tests and by ``chip_smoke.py``'s comparisons on the card;
* ``ops.py``    — the public wrapper: CUDA tensors go to the kernel (or it
  raises), CPU tensors to the plain version.

Kernels:

* ``gemm_f32``   — y = x @ W in fp32 as 3xTF32 on the tensor cores (``wgmma``,
  TMA, warp-specialised, persistent); the model's weight products take it
  through ``matmul_f32`` where no gradient is wanted and the shape is large.
* ``gmsa_score`` — the per-slot GMSA dispatch: the (K, N, N) x (N,) cost
  matvec, the drift-plus-penalty score and the per-type argmin.
* ``ssd_scan``   — the Mamba-2 chunked SSD forward from a zero state, one
  block per (b, h) stream with the (P, N) state in shared memory; the
  model's prefill runs every layer's scan through it.
"""
