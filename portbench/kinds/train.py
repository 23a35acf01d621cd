"""Training traffic: the program's train step (``repro_torch.train.step
.make_train_step``) on token rows drawn from the seed.

Set-up builds the step, its weights and its AdamW state once, and drives
that same step through its first ``checked_steps`` steps on rows that all
differ, through the same call and feed as the window's. From those it
keeps what the comparison reads: each step's loss, the first gradient as
the optimizer got it (from its first moment after one step and the norm it
clipped by), and each leaf's change after the last checked step. The
window then runs further steps of the same object. Once the window has
closed and the program is freed, the plain reference trains from the same
weights on the same rows for as many steps.

The mix's parameters: ``dtype`` (the weights' and activations' dtype; the
SSD's decay parameters and the optimizer's moments stay fp32), ``rows``
and ``seq_len`` a step, ``microbatches``, ``remat``, ``optimizer`` (AdamW),
``zipf`` (the tokens' law), ``units`` (rows drawn ahead, in steps),
``checked_steps``, ``row_block`` (the reference's rows at a time).
"""

from __future__ import annotations

import statistics

import torch

from portbench import work
from portbench.inputs import leaf_items, make_tokens, make_weights
from portbench.reference import lm as ref_lm
from portbench.reference.ops import Products, fp32_matmuls

FAULTS = ("unchanged", "half_batch")


class Traffic:
    kind = "train"

    def __init__(self, model_cfg, conf: dict, mix: dict, seed: int, device, fault=None):
        from repro_torch.train import AdamWConfig, TrainStepConfig, adamw_init, make_train_step

        if fault not in (None,) + FAULTS:
            raise ValueError(f"unknown fault {fault!r} for training traffic")
        self.model, self.mix, self.seed, self.device = conf["model"], mix, seed, device
        self.family = ref_lm.layer_module(conf["reference"])
        self.dtype = getattr(torch, mix["dtype"])
        self.rows, self.seq = mix["rows"], mix["seq_len"]
        self.fault = fault
        self.params = make_weights(self.model, seed, self.dtype, device, self.family)
        self.tokens = make_tokens(self.model, seed, mix["units"], self.rows, self.seq + 1,
                                  mix["zipf"], device)
        self.mask = torch.ones((self.rows, self.seq), dtype=torch.float32, device=device)
        tcfg = TrainStepConfig(microbatches=mix["microbatches"], remat=mix["remat"],
                               optimizer=AdamWConfig(**mix["optimizer"]))
        self.step, init_efb = make_train_step(model_cfg, tcfg, device=device)
        self.opt = adamw_init(self.params)
        self.efb = init_efb(self.params)
        self.losses: list = []
        self.unit_tokens = self.rows * self.seq
        self.unit_flops = work.train_flops(self.model, self.rows, self.seq, self.family)
        self.flops_dtype = mix["dtype"]

    def ssd_call(self) -> tuple | None:
        """One SSD call's (B, S, H, P, N, Q, dtype) in this traffic: a
        microbatch's rows through one layer."""
        if not self.model["ssm_state"]:
            return None
        di = self.model["ssm_expand"] * self.model["d_model"]
        p = self.model["ssm_head_dim"]
        return (self.rows // self.mix["microbatches"], self.seq, di // p, p,
                self.model["ssm_state"], min(self.model["ssm_chunk"], self.seq), self.mix["dtype"])

    def _batch(self, i: int) -> dict:
        t = self.tokens[i % self.tokens.shape[0]]
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:], "loss_mask": self.mask}
        if self.fault == "half_batch":
            batch = {k: v[: self.rows // 2] for k, v in batch.items()}
        return batch

    def _run(self, i: int) -> dict:
        if self.fault == "unchanged":      # kept on the host: the card has no room
            saved = ({k: v.to("cpu", copy=True) for k, v in leaf_items(self.params)},
                     {k: v.to("cpu", copy=True) for k, v in leaf_items(self.opt)})
        self.params, self.opt, metrics, self.efb = self.step(self.params, self.opt,
                                                              self._batch(i), self.efb)
        if self.fault == "unchanged":
            with torch.no_grad():
                for tree, old in zip((self.params, self.opt), saved):
                    for k, v in leaf_items(tree):
                        v.copy_(old[k])
        return metrics

    def warmup(self) -> None:
        """The checked steps: the first ``checked_steps`` steps of the step
        object the window goes on with, and the readings the comparison
        needs."""
        opt = self.mix["optimizer"]
        self.prog = {"losses": [], "grad_norms": {}, "change_norms": {}}
        for i in range(self.mix["checked_steps"]):
            metrics = self._run(i)
            self.prog["losses"].append(float(metrics["loss"]))
            if i == 0:
                gnorm = float(metrics["grad_norm"])
                scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
                self.prog["grad_norms"] = {
                    k: float(m.norm()) / ((1.0 - opt["b1"]) * scale)
                    for k, m in leaf_items(self.opt["m"])}
        start = dict(leaf_items(make_weights(self.model, self.seed, self.dtype, self.device,
                                             self.family)))
        with torch.no_grad():
            self.prog["change_norms"] = {k: float((p.float() - start[k].float()).norm())
                                         for k, p in leaf_items(self.params)}
        del start

    def run_unit(self, i: int) -> None:
        """One step of the window; its loss is read once the window closes."""
        self.losses.append(self._run(self.mix["checked_steps"] + i)["loss"])

    def failed_units(self) -> tuple[int, int]:
        """(attempted, failed): window steps, and those whose loss is not finite."""
        bad = sum(not torch.isfinite(x).item() for x in self.losses)
        return len(self.losses), bad

    def free_program(self) -> None:
        del self.params, self.opt, self.efb, self.step, self.losses

    def reference_readings(self, mode: str = "fp32") -> dict:
        """The reference's readings: its ``checked_steps`` steps from the same
        weights on the same rows, products in ``mode``."""
        steps = self.mix["checked_steps"]
        batches = [self.tokens[i] for i in range(steps)]
        with fp32_matmuls():
            return ref_lm.train(self.family, self.model, self.mix["optimizer"],
                                lambda: make_weights(self.model, self.seed, self.dtype,
                                                     self.device, self.family),
                                batches, steps, Products(mode), self.mix["row_block"])

    def readings(self, got: dict, want: dict) -> dict:
        """The numbers compared: the worst step's loss gap relative to the
        reference's loss; the gaps of the first gradient's leaf norms,
        summed over the leaves, over the sum of the reference's leaf norms;
        the worst leaf's gap of change norms relative to the reference's
        (that leaf's, or the median leaf's, whichever is larger), leaving
        out leaves whose reference gradient is under a thousandth of the
        median leaf's."""
        loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], want["losses"]))
        g_ref = want["grad_norms"]
        grad = sum(abs(got["grad_norms"][k] - w) for k, w in g_ref.items()) / sum(g_ref.values())
        g_med = statistics.median(g_ref.values())
        moved = [k for k, w in g_ref.items() if w >= 1e-3 * g_med]
        c_med = statistics.median(want["change_norms"][k] for k in moved)
        change = max(abs(got["change_norms"][k] - want["change_norms"][k])
                     / max(want["change_norms"][k], c_med) for k in moved)
        return {"loss_rel": loss, "grad_rel": grad, "update_rel": change}

    def check(self) -> tuple[dict, dict]:
        """(readings, details) of the program's checked steps against the
        reference's."""
        want = self.reference_readings()
        return self.readings(self.prog, want), {"program": self.prog, "reference": want}
