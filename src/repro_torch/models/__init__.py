"""repro_torch.models — the model zoo: dense attention, SSM (Mamba-2), MoE,
hybrid (attention + SSM), and the frontend backbones (audio encoder,
vision-language decoder).

* ``layers``    — norms (RMS, Layer), MLPs (SwiGLU, GELU), RoPE, the
  truncated-normal init;
* ``attention`` — GQA attention: naive, blockwise (online softmax), decode;
* ``ssm``       — the plain chunked SSD scan, the decode step, causal convs;
* ``moe``       — top-k routing, sort-based capacity dispatch, the expert
  SwiGLU as batched matmuls, shared experts;
* ``frontends`` — the modality stubs' geometry (vision patches, audio frames);
* ``lm``        — param specs, init, forward / prefill (with a frontend's
  prefix embeddings) / decode with the KV ring, param counts;
* ``inputs``    — batches for prefill and decode (token ids, frontend stub
  embeddings), cache specs.
"""

from repro_torch.models import frontends, moe
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
           "init_cache", "make_batch", "frontends", "moe"]
