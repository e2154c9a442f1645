"""SCST, self-critical sequence training, as a task of the train loop
(counterpart of `mico_tpu/train/scst.py`).

One step, for each modality group of the task ('scst%tv' → 'v',
'scst%tva' → 'va'):
  1. rollout, under `no_grad`: the condition features (`compute_features`
     with no train generator: the towers' inference route, K1 on EVA01), a
     KV-cached multinomial sample over the whole softmax (`generate_scst`)
     on a device generator forked from the step's for the group, and the
     greedy baseline (`cached_generate`);
  2. reward, on the host: both decoded, per-sample CIDEr-D against the
     batch's reference captions (`evaluation.metrics.cider_d_scores`), the
     advantage r(sample) − r(greedy) in fp32;
  3. update: REINFORCE, −mean(advantage · Σ_t logp) averaged over the
     groups, its backward and finiteness check, then the optimizer's
     accumulate-clip-update (`train/train_step.py`, `train/optim.py`).
The update scores the rollout's own tokens again (`generate_scst(...,
tokens=)`), where JAX draws them a second time under the same key: the
same trajectory in exact arithmetic, and the only one in any arithmetic.
With `finetune_encoder` the update recomputes the features under grad, so
the towers get a gradient (K1's differentiated route: K3, then K4);
otherwise the rollout's features are constants and the towers get none.
Every pass runs without dropout, as in JAX.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from mico_tpu_torch.config import MiCoConfig
from mico_tpu_torch.evaluation.metrics import cider_d_scores
from mico_tpu_torch.generation import cached_generate, generate_scst
from mico_tpu_torch.ops.layers import fork_generator
from mico_tpu_torch.train.objectives import compute_features
from mico_tpu_torch.train.optim import Optimizer
from mico_tpu_torch.train.train_step import backward_checked


def _groups(task: str) -> List[str]:
    parts = task.split("%")
    if parts[0] != "scst" or len(parts) < 2:
        raise ValueError(f"not an scst task: {task}")
    return [g[1:] for g in parts[1:]]      # 'tv' → 'v', 'tva' → 'va'


class _Stages:
    """Seconds per stage of a step when `timings` is given, each stage
    ending in a device synchronize; nothing otherwise."""

    def __init__(self, timings: Optional[Dict[str, float]], device):
        self.timings, self.device = timings, device
        self.t0 = time.perf_counter()

    def end(self, name: str) -> None:
        if self.timings is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + t - self.t0
        self.t0 = t


def make_scst_step(cfg: MiCoConfig, optimizer: Optimizer, task: str,
                   tokenizer, max_new_tokens: Optional[int] = None,
                   finetune_encoder: bool = False) -> Callable:
    """Returns step(model, batch, generator, raw_captions, draws=None,
    timings=None) → {loss_scst, reward_sample, reward_greedy} (detached).

    raw_captions: the batch's reference captions (strings or lists of
    strings). generator: the step's CPU `torch.Generator`. draws: {group:
    tokens (B, max_new_tokens + 1)} committed as the group's sample instead
    of a draw (a recorded trajectory, as `objectives.Draws` for the train
    step). timings: a dict that takes the seconds of each stage (rollout
    encoder, sample decode, greedy decode, reward, update, optimizer)."""
    mods_list = _groups(task)
    max_new = int(max_new_tokens or cfg.max_caption_len)

    def features(model, batch, mods, cache):
        return compute_features(model, cfg, batch, mods,
                                cache=cache)[f"condition_feats_{mods}"]

    def step(model, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator], raw_captions: Sequence,
             draws: Optional[Dict[str, torch.Tensor]] = None,
             timings: Optional[Dict[str, float]] = None
             ) -> Dict[str, torch.Tensor]:
        refs = [c if isinstance(c, list) else [c] for c in raw_captions]
        dtype = model.compute_dtype
        device = next(model.parameters()).device
        stages = _Stages(timings, device)
        conds, rolled = {}, {}
        with torch.no_grad():
            cache: dict = {}
            for mods in mods_list:
                conds[mods] = features(model, batch, mods, cache)
                stages.end("rollout_encoder")
                sample, _ = generate_scst(
                    model.bert, conds[mods], max_new_tokens=max_new,
                    generator=fork_generator(generator, device),
                    compute_dtype=dtype, use_cache=True,
                    tokens=None if draws is None else draws[mods])
                stages.end("sample_decode")
                greedy = cached_generate(model.bert, conds[mods],
                                         max_new_tokens=max_new,
                                         mode="greedy", compute_dtype=dtype)
                stages.end("greedy_decode")
                rolled[mods] = (sample, greedy)

        advantages = {}
        reward_sample = reward_greedy = 0.0
        for mods, (sample, greedy) in rolled.items():
            r_s = cider_d_scores(tokenizer.batch_decode(sample.cpu().numpy()),
                                 refs)
            r_g = cider_d_scores(tokenizer.batch_decode(greedy.cpu().numpy()),
                                 refs)
            advantages[mods] = torch.as_tensor(
                np.asarray(r_s - r_g, np.float32), device=device)
            reward_sample += float(np.mean(r_s)) / len(mods_list)
            reward_greedy += float(np.mean(r_g)) / len(mods_list)
        stages.end("reward")

        if optimizer.mini_step == 0:
            optimizer.zero_grad()
        total = torch.zeros((), dtype=torch.float32, device=device)
        cache = {}
        for mods in mods_list:
            # the rollout's features re-enter as constants unless the
            # towers are fine-tuned: then a second forward, under grad
            cond = (features(model, batch, mods, cache) if finetune_encoder
                    else conds[mods])
            _, logp = generate_scst(model.bert, cond, max_new_tokens=max_new,
                                    compute_dtype=dtype, use_cache=True,
                                    tokens=rolled[mods][0])
            total = total - torch.mean(advantages[mods] * logp.sum(dim=-1))
        loss = total / len(mods_list)
        backward_checked(optimizer, loss, {"loss_scst": loss})
        stages.end("update")
        optimizer.accumulate()
        stages.end("optimizer")
        return {"loss_scst": loss.detach(),
                "reward_sample": torch.tensor(reward_sample,
                                              dtype=torch.float32),
                "reward_greedy": torch.tensor(reward_greedy,
                                              dtype=torch.float32)}

    return step
