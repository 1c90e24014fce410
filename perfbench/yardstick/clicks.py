"""The offline click feed, plain: the PBM click model of a configuration,
the compact pool's size and a window's draws (queries, clicks, which
lists were clicked).

It draws what the port's ``ClickSimulationFeed`` draws, in its
documented order, from a device generator seeded as the program seeds
it: the click-rate estimate at feed set-up (seed 0x5EED, 4,096 queries),
then per window the pool's query indices and the clicks, through the
Philox stream (the PBM kernel's) or ``torch.rand`` (the click model's
own sampler). The lists that got a click come first, in a stable order,
and the first B of them make each step's batch."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench.yardstick import philox

PBM_EXAM = [0.68, 0.61, 0.48, 0.34, 0.28, 0.20, 0.11, 0.10, 0.08, 0.06]
CLICK_RATE_SEED = 0x5EED
CLICK_RATE_QUERIES = 4096


def click_model_json(cfg: Dict) -> Dict:
    """The configuration's PBM click model in the click-model JSON
    schema: P(click | examined, grade g) = a + 2^g b."""
    cm = cfg["click_model"]
    grades = cm["relevance_grading_num"]
    b = (cm["pos_click_prob"] - cm["neg_click_prob"]) / (2 ** grades - 1)
    a = cm["neg_click_prob"] - b
    return {"model_name": "position_biased_model", "eta": cm["eta"],
            "click_prob": [a + (2 ** g) * b for g in range(grades + 1)],
            "exam_prob": PBM_EXAM}


class ClickDraws:
    """A configuration's click draws over the top-L labels ``[Q, L]`` of
    its lists (L the selection-bias cutoff), on their device."""

    def __init__(self, cfg: Dict, labels: torch.Tensor, philox_clicks: bool):
        model = click_model_json(cfg)
        self.device = labels.device
        self.labels = labels
        self.philox_clicks = philox_clicks
        self.batch = cfg["batch_size"]
        click_prob = torch.tensor(model["click_prob"], dtype=torch.float32,
                                  device=self.device)
        exam = torch.tensor(PBM_EXAM, dtype=torch.float32,
                            device=self.device)
        L = labels.shape[1]
        eta = torch.tensor(float(model["eta"]), device=self.device)
        exam = (exam ** eta)[torch.clamp(torch.arange(L, device=self.device),
                                          max=len(PBM_EXAM) - 1)]
        grades = torch.clamp(labels.to(torch.int64), 0,
                             click_prob.shape[0] - 1)
        self.probs = exam * click_prob[grades]                 # [Q, L]
        self.pool = self._pool_size()

    def _clicks(self, gen: torch.Generator, qs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        probs = self.probs[qs]
        if self.philox_clicks:
            key = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                                generator=gen, device=self.device).tolist()
            u = philox.uniforms(key[0], key[1], probs.numel(),
                                self.device).reshape(probs.shape)
        else:
            u = torch.rand(probs.shape, generator=gen, device=self.device)
        clicks = (u < probs).to(torch.float32)
        return clicks, clicks.sum(dim=-1) > 0

    def _pool_size(self) -> int:
        """B + 4 sqrt(B) expected clicked lists at a 3-sigma-lowered click
        rate, within [B, 9B]."""
        q = self.labels.shape[0]
        n = min(CLICK_RATE_QUERIES, q)
        gen = torch.Generator(device=self.device).manual_seed(
            CLICK_RATE_SEED)
        qs = torch.randint(0, q, (1, n), generator=gen, device=self.device)
        _, valid = self._clicks(gen, qs)
        p = float(valid.float().mean())
        low = max(p - 3.0 * math.sqrt(max(p * (1 - p), 1e-6) / n), p / 2.0,
                  1e-3)
        B = self.batch
        return int(min(max(math.ceil((B + 4.0 * math.sqrt(B)) / low), B),
                       B * 9))

    def window(self, seed: int, steps: int
               ) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """A window's (queries [B], clicks [B, L], clicked [B]) a step,
        drawn from a generator seeded with `seed`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        qs = torch.randint(0, self.labels.shape[0], (steps, self.pool),
                           generator=gen, device=self.device)
        clicks, valid = self._clicks(gen, qs)
        pick = torch.argsort((~valid).to(torch.int8), dim=1,
                             stable=True)[:, :self.batch]
        rows = torch.arange(steps, device=self.device)[:, None]
        qs, clicks, valid = qs[rows, pick], clicks[rows, pick], valid[rows,
                                                                      pick]
        return [(qs[i], clicks[i], valid[i]) for i in range(steps)]
