"""Batched serving engine: prefill + greedy decode over a shared KV cache
(port of ``repro.serve.engine``).

``Engine.generate`` steps ``Model.decode_step`` over the prompt tokens
(prefill-as-decode: the cache fills one position a step, one code path),
then decodes greedily with ``argmax``, which like ``jnp.argmax`` returns the
first maximal index. Temperature sampling raises ``NotImplementedError``:
the JAX package draws it with ``jax.random.categorical`` from threefry
bits; the port has threefry (``core/threefry.py``) but not the categorical
step yet (ROADMAP Queue 1, LM scaffold item 10.4). So do encoder inputs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.tree import tree_map


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    max_seq: int = 256
    temperature: float = 0.0     # 0 => greedy; sampling is not ported


class Engine:
    def __init__(self, model: Model, params, cfg: ServeConfig):
        self.model = model
        self.cfg = cfg
        # Cast every weight to the compute dtype once. These are the bits the
        # JAX package makes with `.astype(cd)` at every use, so results do
        # not change; a bf16 decode step of internlm2-1.8b then reads
        # 3.78 GB of weights instead of casting 7.56 GB of fp32 per step.
        cd = model.cfg.compute_dtype
        self.params = tree_map(lambda a: a.to(device=model.device, dtype=cd),
                               params)

    def _step(self, cache, tokens: torch.Tensor, pos: int):
        """One decode step; subclasses may wrap it to time or record it."""
        return self.model.decode_step(self.params, cache, {"tokens": tokens},
                                      pos)

    def generate(self, prompts: np.ndarray, enc_embeds=None) -> np.ndarray:
        """prompts: (B, P) int32 token ids (right-aligned, no padding).
        Returns (B, max_new_tokens) generated ids."""
        cfg = self.cfg
        if cfg.temperature > 0:
            raise NotImplementedError(
                "temperature > 0: the JAX package samples with threefry "
                "(jax.random.categorical); the port has threefry but not "
                "the categorical step yet (ROADMAP Queue 1, LM scaffold "
                "item 10.4)")
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

        out = torch.zeros((b, cfg.max_new_tokens), dtype=torch.int32,
                          device=dev)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for i in range(cfg.max_new_tokens):
            out[:, i] = tok
            cache, logits = self._step(cache, tok[:, None], p + i)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return out.cpu().numpy()
