"""Batched serving engine: prefill + greedy or sampled decode over a shared
cache (port of ``repro.serve.engine``).

``Engine.generate`` steps ``Model.decode_step`` over the prompt tokens
(prefill-as-decode: the cache fills one position a step, one code path),
then decodes. At temperature 0 it picks ``argmax``, which like
``jnp.argmax`` returns the first maximal index. Above 0 it samples as the
reference does: one key ``threefry.key(seed)`` a call, and token ``i`` of
the continuation drawn by ``threefry.categorical(fold_in(key, i), logits /
T)``. The division is by ``T`` rounded to the logits' dtype (bf16 0.7 is
0.69921875), as JAX's eager ``logits / T`` divides; a Python scalar would
enter torch's bf16 division as a float32 0.7, and on the card as a
multiply by its reciprocal. Encoder inputs raise: the enc-dec family is
not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.models.model import Model

# Leaves the reference reads in float32 (``mamba.py``'s ``a_log``,
# ``dt_bias`` and Mamba2's ``d_skip``); the engine keeps them so instead of
# casting them to the compute dtype. Mamba1 casts ``d_skip`` to the compute
# dtype where it reads it, which gives the same values either way.
FLOAT32_LEAVES = ("a_log", "dt_bias", "d_skip")


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    max_seq: int = 256
    temperature: float = 0.0     # 0 => greedy
    seed: int = 0


def _cast(tree, device, cd, name=None):
    if isinstance(tree, dict):
        return {k: _cast(v, device, cd, k) for k, v in tree.items()}
    dt = torch.float32 if name in FLOAT32_LEAVES else cd
    return tree.to(device=device, dtype=dt)


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        # Cast every weight to the compute dtype once. These are the bits the
        # JAX package makes with `.astype(cd)` at every use, so results do
        # not change; a bf16 decode step of internlm2-1.8b then reads
        # 3.78 GB of weights instead of casting 7.56 GB of fp32 per step.
        # FLOAT32_LEAVES go to float32, which holds either param dtype.
        self.params = _cast(params, model.device, model.cfg.compute_dtype)

    def _step(self, cache, tokens: torch.Tensor, pos: int):
        """One decode step; subclasses may wrap it to time or record it."""
        return self.model.decode_step(self.params, cache, {"tokens": tokens},
                                      pos)

    def _sample(self, logits: torch.Tensor, key: threefry.Key, i: int):
        t = self.cfg.temperature
        if t <= 0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        # T rounded to the logits' dtype, a tensor on their device: CUDA
        # multiplies by the reciprocal of a host scalar instead of dividing
        temp = torch.full((), t, dtype=logits.dtype, device=logits.device)
        return threefry.categorical(threefry.fold_in(key, i), logits / temp)

    def generate(self, prompts: np.ndarray, enc_embeds=None) -> np.ndarray:
        """prompts: (B, P) int32 token ids (right-aligned, no padding).
        Returns (B, max_new_tokens) generated ids."""
        cfg = self.cfg
        if enc_embeds is not None:
            raise NotImplementedError("encoder inputs: the enc-dec family is "
                                      "not ported (ROADMAP Queue 1)")
        b, p = prompts.shape
        if p < 1 or p + cfg.max_new_tokens > cfg.max_seq:
            raise ValueError(f"prompt length {p} + {cfg.max_new_tokens} new "
                             f"tokens must fit max_seq {cfg.max_seq}")
        dev = self.model.device
        toks = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
        cache = self.model.init_cache(b, cfg.max_seq)
        logits = None
        for t in range(p):
            cache, logits = self._step(cache, toks[:, t:t + 1], t)

        key = threefry.key(cfg.seed)
        out = torch.zeros((b, cfg.max_new_tokens), dtype=torch.int32,
                          device=dev)
        tok = self._sample(logits, key, 0)
        for i in range(cfg.max_new_tokens):
            out[:, i] = tok
            cache, logits = self._step(cache, tok[:, None], p + i)
            tok = self._sample(logits, key, i + 1)
        return out.cpu().numpy()
