"""Prefill traffic: a closed loop of prompt batches through the serving
path that ``FleetEngine`` executes (``repro_torch.serve.step
.make_local_exec``'s ``prefill_fn``: the whole prompt into a fresh cache
sized for ``gen_len`` more tokens, logits at the last position).

Each batch's prompts are fresh tokens drawn from the seed in set-up. A
batch is issued when the one before has returned its first tokens (the
argmax of its logits, read on the host), as ``_execute_jobs`` issues them;
a prompt's latency is its batch's, from issue to first token. Batches of
their own (``warmup_units``, on one prompt set drawn for them) warm the
shapes up before the window.

The comparison reads a sample of the window's batches drawn from the seed
(``checked_units`` of the first ``sample_span``, and the last batch where
the window ended before one of them): for every prompt of each, its
last-position logits and the cache it filled (per layer the SSM state and
conv tail, and the KV ring where the model attends), against the plain
reference run on the same prompt.

The mix's parameters: ``dtype``, ``rows`` and ``seq_len`` a batch,
``gen_len``, ``zipf``, ``units`` (batches drawn ahead), ``warmup_units``,
``checked_units``, ``sample_span``.
"""

from __future__ import annotations

import random

import torch

from portbench import work
from portbench.inputs import make_tokens, make_weights
from portbench.reference import lm as ref_lm
from portbench.reference.ops import Products, fp32_matmuls

FAULTS = ("unchanged", "half_batch", "altered")


def _cache_slots(model: dict, seq: int, gen_len: int) -> int | None:
    if not model["num_heads"]:
        return None
    window = model["sliding_window"]
    return min(window, seq + gen_len) if window else seq + gen_len


class Traffic:
    kind = "prefill"

    def __init__(self, model_cfg, conf: dict, mix: dict, seed: int, device, fault=None):
        from repro_torch.serve.step import make_local_exec

        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r} for prefill traffic")
        self.model, self.mix, self.seed, self.device = conf["model"], mix, seed, device
        self.family = ref_lm.layer_module(conf["reference"])
        self.dtype = getattr(torch, mix["dtype"])
        self.rows, self.seq = mix["rows"], mix["seq_len"]
        self.fault = fault
        self.params = make_weights(self.model, seed, self.dtype, device, self.family)
        # Unit 0 warms up; the window's batch i takes unit 1 + i.
        self.tokens = make_tokens(self.model, seed, mix["units"] + 1, self.rows, self.seq,
                                  mix["zipf"], device)
        self.prefill_fn, _ = make_local_exec(model_cfg, mix["gen_len"], device=device)
        self.sample = set(random.Random(seed).sample(range(mix["sample_span"]),
                                                     mix["checked_units"]))
        self.kept: dict[int, tuple] = {}
        self.last = None
        self.finite: list = []
        self.unit_tokens = self.rows * self.seq
        self.unit_flops = work.prefill_flops(self.model, self.rows, self.seq, self.family)
        self.flops_dtype = mix["dtype"]

    def ssd_call(self) -> tuple | None:
        """One SSD call's (B, S, H, P, N, Q, dtype): a batch through one layer."""
        if not self.model["ssm_state"]:
            return None
        di = self.model["ssm_expand"] * self.model["d_model"]
        p = self.model["ssm_head_dim"]
        return (self.rows, self.seq, di // p, p, self.model["ssm_state"],
                min(self.model["ssm_chunk"], self.seq), self.mix["dtype"])

    def _unit_tokens(self, i: int):
        return self.tokens[1 + i % (self.tokens.shape[0] - 1)]

    def _prefill(self, tokens):
        if self.fault == "half_batch":
            logits, cache = self.prefill_fn(self.params, tokens[: self.rows // 2])
            twice = lambda t: torch.cat([t, t], dim=1 if t.dim() > 1 else 0)
            return torch.cat([logits, logits]), {
                k: (torch.cat([v, v]) if k == "pos" else twice(v)) for k, v in cache.items()}
        logits, cache = self.prefill_fn(self.params, tokens)
        if self.fault == "unchanged":
            cache = {k: (v if k == "pos" else torch.zeros_like(v)) for k, v in cache.items()}
        if self.fault == "altered":
            logits = logits.clone()
            logits[0, 0, 0] += 1.0
        return logits, cache

    def warmup(self) -> None:
        for _ in range(self.mix["warmup_units"]):
            logits, _ = self._prefill(self.tokens[0])
            logits.argmax(-1).cpu()

    def run_unit(self, i: int) -> None:
        """One batch of the window, ended by its first tokens on the host."""
        out = self._prefill(self._unit_tokens(i))
        out[0].argmax(-1).cpu()
        self.finite.append(torch.isfinite(out[0]).all(dim=-1))
        if i in self.sample:
            self.kept[i] = out
        self.last = (i, out)

    def failed_units(self) -> tuple[int, int]:
        """(attempted, failed): the window's prompts, and those whose logits
        are not finite."""
        if not self.finite:
            return 0, 0
        ok = torch.cat([f.reshape(-1) for f in self.finite])
        return ok.numel(), int((~ok).sum())

    def free_program(self) -> None:
        if self.last is not None and len(self.kept) < self.mix["checked_units"]:
            self.kept.setdefault(*self.last)
        del self.params, self.prefill_fn, self.last

    def outputs(self, mode: str = "fp32"):
        """(unit, logits, cache) of every kept batch; with ``mode`` other
        than the program's, the reference in ``mode`` in its place."""
        if mode == "program":
            return [(i, *self.kept[i]) for i in sorted(self.kept)]
        weights = make_weights(self.model, self.seed, self.dtype, self.device, self.family)
        slots = _cache_slots(self.model, self.seq, self.mix["gen_len"])
        return [(i, *self._reference_batch(weights, self._unit_tokens(i), slots, mode))
                for i in sorted(self.kept)]

    def _reference_batch(self, weights, tokens, slots, mode):
        rows = []
        with fp32_matmuls():
            for r in range(tokens.shape[0]):
                rows.append(ref_lm.prefill_row(self.family, weights, self.model, tokens[r:r + 1],
                                               slots, Products(mode)))
        logits = torch.cat([lg for lg, _ in rows])
        cache = {k: torch.cat([c[k] for _, c in rows], dim=1) for k in rows[0][1]}
        cache["pos"] = torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                                  device=tokens.device)
        return logits, cache

    @staticmethod
    def readings(got: list, want: list) -> dict:
        """The numbers compared, worst over the kept batches: the logits'
        largest gap relative to the reference's largest logit of that batch
        (over the real vocabulary), and each state leaf's largest gap per
        layer relative to the reference's largest entry of that leaf and
        layer; a wrong position count reads infinite."""
        logits_rel = state_rel = 0.0
        for (_, lg, cache), (_, lw, cw) in zip(got, want):
            v = lw.shape[-1]
            lg = lg[..., :v].float()
            logits_rel = max(logits_rel, float((lg - lw).abs().max() / lw.abs().max()))
            if not torch.equal(cache["pos"].long().cpu(), cw["pos"].long().cpu()):
                state_rel = float("inf")
            for name, ref in cw.items():
                if name == "pos":
                    continue
                gap = (cache[name].float() - ref).abs().flatten(1).amax(dim=1)
                top = ref.abs().flatten(1).amax(dim=1).clamp_min(1e-30)
                state_rel = max(state_rel, float((gap / top).max()))
        return {"logits_rel": logits_rel, "state_rel": state_rel}

    def check(self) -> tuple[dict, dict]:
        want = self.outputs("fp32")
        return self.readings(self.outputs("program"), want), {"units": sorted(self.kept)}
