"""Top-level model API for serving and training a dense or MoE decoder, a
Mamba1 stack or a Mamba2 hybrid (port of ``repro.models.model``).

``Model(cfg, device="cuda")`` wraps a ModelConfig with plain functions on
tensors:
  init(generator) -> params                 (nested dict, JAX tree layout)
  forward(params, batch) -> (hidden, aux_loss)
  logits(params, hidden) -> (B, S, V_padded), padded vocab masked
  loss(params, batch) -> scalar             (chunked-vocab CE + MoE aux)
  init_cache(batch_size, max_seq) -> dense and moe {"k", "v"}: (L, B,
      max_seq, KV, dh); MLA {"c_kv": (L, B, max_seq, kv_lora), "k_rope":
      (L, B, max_seq, 1, rope)}, the latent cache; ssm {"conv": (L, B,
      d_conv-1, Di) in the compute dtype, "h":
      (L, B, Di, N) float32}, O(1) in the sequence length; hybrid {"conv":
      (L, B, d_conv-1, Di + 2 G N) in the compute dtype, "h": (L, B, H,
      N, P) float32, "k", "v": (n_sites, B, max_seq, KV, dh)}, one K/V slot
      for each application of the shared attention block
  decode_step(params, cache, inputs, pos) -> (cache, logits (B, V_padded))

The params tree is the JAX package's, leaf for leaf (per-layer leaves
stacked on a leading L axis), so weights move between the packages by
copying leaves (``repro_torch.convert``). Unlike the JAX package,
``decode_step`` writes the new K/V row (or the ssm family's new conv and
scan state) into ``cache`` in place (where JAX uses
``dynamic_update_slice`` or a scan's new arrays) and returns the same dict.
The dense GQA, the ``moe`` (GQA or MLA attention, the FFN an MoE but in
``first_dense`` leading dense layers), the Mamba1 ``ssm`` and the Mamba2
``hybrid`` families are ported; the others wait (ROADMAP Queue 1, LM
scaffold item 10.3). An MLA decode step writes the token's latent and rope
key into the cache in place and attends in the latent space
(``attention.mla_decode_absorbed``: no flash kernel). In the
hybrid family each site ``gi`` of the shared block writes its own K/V slot
``cache["k"][gi]`` with the shared weights and attends through the flash
wrapper, as a dense layer does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, check_supported
from repro_torch.device import resolve_device
from repro_torch.models import attention, layers, mamba, moe
from repro_torch.models.transformer import (apply_decoder_stack,
                                            apply_hybrid_stack,
                                            apply_ssm_stack, decoder_layers,
                                            hybrid_attn_sites, hybrid_groups,
                                            init_decoder_stack,
                                            init_hybrid_stack,
                                            init_ssm_stack, unbind_layers)

STACKS = {"dense": (init_decoder_stack, apply_decoder_stack),
          "moe": (init_decoder_stack, apply_decoder_stack),
          "hybrid": (init_hybrid_stack, apply_hybrid_stack),
          "ssm": (init_ssm_stack, apply_ssm_stack)}


def _attn_decode_layer(lp, x, cfg, pos: int, pos_arr, cache_slices):
    """One decoder layer at decode time: write this token's K/V (MLA: its
    latent and rope key) into the cache slices at ``pos`` (in place),
    attend over the populated prefix (MLA: the whole cache, masked past
    ``pos``, in the latent space), apply the MLP, or the MoE FFN where the
    layer has one (its aux loss dropped, as the reference drops it).
    ``cache_slices``: (k, v), or (c_kv, k_rope) for MLA. Returns x."""
    cd = cfg.compute_dtype
    h = layers.rms_norm(x, lp["ln1"])
    if cfg.mla:
        c_kv_l, k_rope_l = cache_slices
        c_new, kr_new = attention.mla_latent(lp["attn"], h, cfg, pos_arr)
        c_kv_l[:, pos:pos + 1] = c_new.to(c_kv_l.dtype)
        k_rope_l[:, pos:pos + 1] = kr_new.to(k_rope_l.dtype)
        x = x + attention.mla_decode_absorbed(lp["attn"], h, cfg, pos_arr,
                                              c_kv_l, k_rope_l, pos)
    else:
        k_l, v_l = cache_slices
        q, k, v = attention.gqa_project_qkv(lp["attn"], h, cfg, pos_arr)
        k_l[:, pos:pos + 1] = k.to(k_l.dtype)
        v_l[:, pos:pos + 1] = v.to(v_l.dtype)
        o = attention.flash_attention(q, k_l, v_l, causal=True, q_offset=pos,
                                      chunk_kv=cfg.attn_chunk_kv)
        x = x + o.reshape(*h.shape[:2], -1) @ lp["attn"]["wo"].to(cd)
    h = layers.rms_norm(x, lp["ln2"])
    if "moe" in lp:
        return x + moe.moe_apply(lp["moe"], h, cfg)[0]
    return x + layers.mlp_apply(lp["mlp"], h, cd)


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)

    # -- params ------------------------------------------------------------
    def init(self, generator: torch.Generator):
        """Random weights drawn from ``generator``, which must live on the
        model's device (seed it with ``manual_seed``)."""
        cfg = self.cfg
        if generator.device.type != self.device.type:
            raise ValueError(f"generator on {generator.device}, model on "
                             f"{self.device}")
        p = {"stack": STACKS[cfg.family][0](generator, cfg),
             "final_ln": layers.init_rms(generator, cfg.d_model,
                                         cfg.param_dtype)}
        p["embed"] = layers.init_embed(generator, cfg.vocab_padded,
                                       cfg.d_model, cfg.param_dtype)
        if not cfg.tie_embeddings:
            p["out"] = layers.dense_init(generator,
                                         (cfg.d_model, cfg.vocab_padded),
                                         cfg.param_dtype)
        return p

    # -- forward -----------------------------------------------------------
    def _positions(self, b: int, s: int):
        pos = torch.arange(s, dtype=torch.int32, device=self.device)
        return pos[None, :].expand(b, s)

    def _embed_in(self, params, batch):
        return layers.embed_apply(params["embed"], batch["tokens"],
                                  self.cfg.compute_dtype)

    def forward(self, params, batch):
        """batch {"tokens": (B, S) int} -> (hidden (B, S, D), aux_loss)."""
        x = self._embed_in(params, batch)
        b, s = x.shape[:2]
        h, aux = STACKS[self.cfg.family][1](params["stack"], x, self.cfg,
                                            self._positions(b, s))
        return layers.rms_norm(h, params["final_ln"]), aux

    def _unembed(self, params):
        cfg = self.cfg
        w = params["embed"]["tok"].T if cfg.tie_embeddings else params["out"]
        return w.to(cfg.compute_dtype)              # (D, V_padded)

    def _mask_pad_vocab(self, logits):
        cfg = self.cfg
        if cfg.vocab_padded == cfg.vocab:
            return logits
        pad = torch.arange(cfg.vocab_padded, device=logits.device) >= cfg.vocab
        return logits - pad.to(logits.dtype) * 1e9

    def logits(self, params, hidden):
        return self._mask_pad_vocab(hidden @ self._unembed(params))

    def _ce_block(self, hc, lc, w):
        """Summed CE of one block of tokens: hc (chunk, D), lc (chunk,)."""
        logits = self._mask_pad_vocab((hc @ w).to(torch.float32))
        logz = torch.logsumexp(logits, dim=-1)
        mask = lc >= 0
        # A masked label reads column 0 (the reference reads a wrapped
        # column); either is multiplied by 0.
        gold = torch.gather(logits, 1, torch.where(mask, lc, 0).long()[:, None])[:, 0]
        return torch.sum((logz - gold) * mask)

    def loss(self, params, batch):
        """Chunked-vocab causal-LM cross entropy: the (T, V) logits are
        never built; blocks of ``loss_chunk`` tokens go in turn, each
        recomputed in the backward when grad is enabled (the reference's
        ``jax.checkpoint`` over its ``lax.scan``). As the reference, tokens
        past the last whole block are dropped while the mean divides by
        every label >= 0, and labels < 0 are masked. An MoE model adds
        ``aux_loss_weight`` times its layers' mean aux loss."""
        cfg = self.cfg
        hidden, aux = self.forward(params, batch)
        labels = batch["labels"]
        b, s, d = hidden.shape
        t = b * s
        h2 = hidden.reshape(t, d)
        l2 = labels.reshape(t)
        w = self._unembed(params)
        chunk = min(cfg.loss_chunk, t)
        n_chunks = max(t // chunk, 1)
        remat = torch.is_grad_enabled()
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(n_chunks):
            hc, lc = h2[i * chunk:(i + 1) * chunk], l2[i * chunk:(i + 1) * chunk]
            total = total + (checkpoint(self._ce_block, hc, lc, w,
                                        use_reentrant=False)
                             if remat else self._ce_block(hc, lc, w))
        n_tok = torch.clamp(torch.sum(l2 >= 0), min=1)
        ce = total / n_tok
        if cfg.n_experts:
            ce = ce + cfg.aux_loss_weight * aux / max(cfg.n_layers, 1)
        return ce

    # -- serving -----------------------------------------------------------
    def init_cache(self, b: int, max_seq: int):
        cfg = self.cfg
        cd, dev, l, di = cfg.compute_dtype, self.device, cfg.n_layers, cfg.d_inner
        if cfg.family == "ssm":
            return {"conv": torch.zeros((l, b, cfg.d_conv - 1, di), dtype=cd,
                                        device=dev),
                    "h": torch.zeros((l, b, di, cfg.ssm_state),
                                     dtype=torch.float32, device=dev)}
        if cfg.mla:
            return {"c_kv": torch.zeros((l, b, max_seq, cfg.kv_lora), dtype=cd,
                                        device=dev),
                    "k_rope": torch.zeros((l, b, max_seq, 1, cfg.mla_rope_dim),
                                          dtype=cd, device=dev)}
        kv_shape = (cfg.n_layers, b, max_seq, cfg.n_kv, cfg.d_head)
        out = {}
        if cfg.family == "hybrid":
            cw = di + 2 * cfg.n_groups * cfg.ssm_state
            out = {"conv": torch.zeros((l, b, cfg.d_conv - 1, cw), dtype=cd,
                                       device=dev),
                   "h": torch.zeros((l, b, di // cfg.ssm_headdim, cfg.ssm_state,
                                     cfg.ssm_headdim), dtype=torch.float32,
                                    device=dev)}
            kv_shape = (len(hybrid_attn_sites(cfg)),) + kv_shape[1:]
        out["k"] = torch.zeros(kv_shape, dtype=cd, device=dev)
        out["v"] = torch.zeros(kv_shape, dtype=cd, device=dev)
        return out

    def decode_step(self, params, cache, inputs, pos: int):
        """inputs {"tokens": (B, 1)}; ``pos``: the current absolute position
        (a Python int). Writes the token's K/V (or the ssm state) into
        ``cache`` in place and returns (cache, logits (B, V_padded)). A KV
        cache holds ``max_seq`` positions; the ssm state any number."""
        seq = cache.get("k", cache.get("c_kv"))         # a KV or latent cache
        slots = seq.shape[2] if seq is not None else None
        if pos < 0 or (slots is not None and pos >= slots):
            raise ValueError(f"pos {pos} outside the cache's {slots} positions")
        x = self._embed_in(params, inputs)
        if self.cfg.family == "ssm":
            x = self._decode_ssm_stack(params, cache, x)
        else:
            pos_arr = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                                 device=x.device)
            stack = (self._decode_hybrid_stack if self.cfg.family == "hybrid"
                     else self._decode_attn_stack)
            x = stack(params, cache, x, pos, pos_arr)
        h = layers.rms_norm(x, params["final_ln"])
        return cache, self.logits(params, h)[:, 0]

    def _decode_attn_stack(self, params, cache, x, pos: int, pos_arr):
        """Every layer in order, ``first`` then ``layers``, layer ``i``
        with cache slot ``i``."""
        keys = ("c_kv", "k_rope") if self.cfg.mla else ("k", "v")
        for i, (lp, _) in enumerate(decoder_layers(params["stack"], self.cfg)):
            x = _attn_decode_layer(lp, x, self.cfg, pos, pos_arr,
                                   tuple(cache[k][i] for k in keys))
        return x

    def _decode_mamba_layer(self, apply, lp, cache, i: int, x):
        """One pre-norm Mamba layer ``i`` at decode time through ``apply``
        (``mamba1_apply`` or ``mamba2_apply``): its conv and scan state read
        from ``cache`` and written back in place. Returns x."""
        h = layers.rms_norm(x, lp["ln"])
        y, (conv_n, h_n) = apply(lp["mamba"], h, self.cfg,
                                 state=(cache["conv"][i], cache["h"][i]))
        cache["conv"][i].copy_(conv_n)
        cache["h"][i].copy_(h_n)
        return x + y

    def _decode_ssm_stack(self, params, cache, x):
        for i, lp in enumerate(unbind_layers(params["stack"]["layers"])):
            x = self._decode_mamba_layer(mamba.mamba1_apply, lp, cache, i, x)
        return x

    def _decode_hybrid_stack(self, params, cache, x, pos: int, pos_arr):
        """Each group's Mamba2 layers, then the shared block at site ``gi``
        with its own K/V slot ``cache["k"][gi]``."""
        groups, n_sites = hybrid_groups(self.cfg)
        sh = params["stack"]["shared_attn"]
        shared = {"ln1": sh["ln"], "attn": sh["attn"], "ln2": sh["ln2"],
                  "mlp": sh["mlp"]}
        lps = unbind_layers(params["stack"]["layers"])
        for gi, (lo, hi) in enumerate(groups):
            for i in range(lo, hi):
                x = self._decode_mamba_layer(mamba.mamba2_apply, lps[i], cache,
                                             i, x)
            if gi < n_sites:
                x = _attn_decode_layer(shared, x, self.cfg, pos, pos_arr,
                                       (cache["k"][gi], cache["v"][gi]))
        return x
