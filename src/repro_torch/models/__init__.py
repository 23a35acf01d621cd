"""repro_torch.models — the model zoo's SSM (Mamba-2) family.

* ``layers`` — RMSNorm and the truncated-normal init;
* ``ssm``    — the plain chunked SSD scan, the decode step, causal convs;
* ``lm``     — param specs, init, forward / prefill / decode, param counts;
* ``inputs`` — token batches for prefill and decode.
"""

from repro_torch.models.lm import (
    count_params,
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill_step,
)

__all__ = ["count_params", "decode_step", "forward", "init_cache", "init_params",
           "prefill_step"]
