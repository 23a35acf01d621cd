"""repro_torch.models — the model zoo's dense attention, SSM (Mamba-2), MoE
and hybrid (attention + SSM) families.

* ``layers``    — norms (RMS, Layer), MLPs (SwiGLU, GELU), RoPE, the
  truncated-normal init;
* ``attention`` — GQA attention: naive, blockwise (online softmax), decode;
* ``ssm``       — the plain chunked SSD scan, the decode step, causal convs;
* ``moe``       — top-k routing, sort-based capacity dispatch, the expert
  SwiGLU as batched matmuls, shared experts;
* ``lm``        — param specs, init, forward / prefill / decode with the KV
  ring, param counts;
* ``inputs``    — token batches for prefill and decode, cache specs.
"""

from repro_torch.models import moe
from repro_torch.models.inputs import make_batch
from repro_torch.models.lm import (
    count_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill_step,
)

__all__ = ["init_params", "forward", "prefill_step", "decode_step", "count_params",
           "init_cache", "make_batch", "moe"]
