"""repro_torch.core — the paper's contribution, in PyTorch.

Array conventions (shared by every module here; per-run tensors may carry
leading Monte-Carlo run dimensions):
    N — data centers;  K — job types;  T — time slots;  R — runs.
    Q     (N, K)     queue backlogs
    A     (K,)       arrivals in the current slot
    mu    (N, K)     service rates in the current slot
    omega (N,)       energy-price weight per DC
    pue   (N,)       PUE per DC
    r     (K, N, N)  r[k, i, j] = fraction of type-k tasks executed at DC j
                     when DC i is the global manager (rows sum to 1 over j)
    P     (K,)       per-job IT energy of a type-k job
    f     (N, K)     dispatch fractions (columns sum to 1)
"""
