"""Mamba blocks: Mamba1's selective scan and Mamba2's SSD (port of
``repro.models.mamba``).

Mamba1: the recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t`` (state
``(B, Di, N)``) and ``y_t = C_t . h_t`` run in chunks of ``cfg.ssm_chunk``
steps; the state carried from chunk to chunk bounds the materialised
``(B, Q, Di, N)`` working set, as the reference's outer ``lax.scan`` does.
Inside a chunk ``mode="associative"`` composes the steps with the
reference's log-depth odd/even scan (``_associative_scan``, the algorithm
of ``jax.lax.associative_scan``, which torch lacks; it keeps only the
``b`` half the output needs) and ``"sequential"`` steps them one by one.

Mamba2 (the hybrid family): ``ssd_chunked`` is the reference's chunked SSD
with a scalar decay a head, ``h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T``
(state ``(B, H, N, P)``). Inside a chunk of ``q`` steps the output is a
masked-decay product, ``(C B^T * L) (x dt)`` with ``L = exp(segsum(dt
a))``; the carried state adds ``C h`` decayed to each step. The
chunk-local products of every chunk are batched into one einsum each, and
only the state's recurrence from chunk to chunk is a loop (the same
arithmetic as the reference's ``lax.scan``, one chunk's terms at a time).
B and C are shared by the ``H / G`` heads of a group (``repeat_interleave``
for ``jnp.repeat``).

Both are plain PyTorch ops: the reference reaches no Pallas kernel here.
Dtypes are the reference's: ``a_log`` is float32 whatever
``cfg.param_dtype`` is (Mamba2's ``dt_bias`` too); ``dt``, B and C are
float32 (``dt_bias`` read in float32); the scans run in float32; the
convolution and the gate are in the compute dtype (Mamba1's skip too;
Mamba2 adds its skip ``x * d_skip`` in float32 before the cast, and gates
through its ``rms_norm``). ``jax.nn.softplus`` is ``logaddexp(x, 0)`` with
no threshold (``_softplus``), unlike ``F.softplus``.

Decode carries Mamba1's ``(conv_state (B, d_conv-1, Di), h (B, Di, N))``
and Mamba2's ``(conv_state (B, d_conv-1, Di + 2 G N), h (B, H, N, P))``:
O(1) in the sequence length. At S = 1 the SSD runs one chunk of one step,
as in the reference.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import layers


def init_mamba1(gen: torch.Generator, cfg):
    d = cfg.d_model
    di = cfg.expand * d
    n, dtr, dc = cfg.ssm_state, max(d // 16, 1), cfg.d_conv
    pd, dev = cfg.param_dtype, gen.device
    conv_w = torch.randn((dc, di), generator=gen, device=dev,
                         dtype=torch.float32) / math.sqrt(dc)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=dev)
    return {
        "in_proj": layers.dense_init(gen, (d, 2 * di), pd),
        "conv_w": conv_w.to(pd),
        "conv_b": torch.zeros((di,), dtype=pd, device=dev),
        "x_proj": layers.dense_init(gen, (di, dtr + 2 * n), pd),
        "dt_proj": layers.dense_init(gen, (dtr, di), pd),
        "dt_bias": torch.zeros((di,), dtype=pd, device=dev),
        "a_log": torch.log(a).expand(di, n).contiguous(),
        "d_skip": torch.ones((di,), dtype=pd, device=dev),
        "out_proj": layers.dense_init(gen, (di, d), pd),
    }


def _causal_conv(x, w, b, init_state=None):
    """Depthwise causal conv over seq. x: (B, S, Di), w: (dc, Di).
    Returns (silu(conv + b), the last dc-1 inputs as the next state)."""
    dc = w.shape[0]
    if init_state is None:
        pad = torch.zeros(x.shape[:1] + (dc - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, dc):                # the reference's left-to-right sum
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    new_state = xp[:, -(dc - 1):] if dc > 1 else None
    return F.silu(out + b.to(x.dtype)), new_state


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, with jnp's formula."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _ssm_params(p, xc, cfg):
    """Input-dependent (dt, B, C) projections, float32. xc: (B, S, Di)."""
    cd = cfg.compute_dtype
    n = cfg.ssm_state
    dtr = p["dt_proj"].shape[0]
    proj = xc @ p["x_proj"].to(cd)
    dt = _softplus((proj[..., :dtr] @ p["dt_proj"].to(cd)).to(torch.float32)
                   + p["dt_bias"].to(torch.float32))             # (B,S,Di)
    b_mat = proj[..., dtr:dtr + n].to(torch.float32)              # (B,S,N)
    c_mat = proj[..., dtr + n:].to(torch.float32)
    return dt, b_mat, c_mat


def _associative_scan(a, b):
    """Inclusive scan of ``h -> a_t h + b_t`` from ``h = 0`` along dim 1:
    the ``b`` half of ``jax.lax.associative_scan``'s recursion over the
    composition ``(l, r) -> (l_a r_a, r_a l_b + r_b)``. Neighbours pair up,
    the pairs are scanned, and the even positions are filled in from their
    left neighbour's result; log-depth, O(n) combines. The products of the
    ``a`` halves feed the pairs only: no caller needs the scanned ``a``
    (``selective_scan`` folds the carried state into the first step)."""
    n = a.shape[1]
    if n < 2:
        return b
    a_lo, a_hi, b_lo, b_hi = a[:, 0:-1:2], a[:, 1::2], b[:, 0:-1:2], b[:, 1::2]
    odd = _associative_scan(a_lo * a_hi, torch.addcmul(b_hi, a_hi, b_lo))
    out = torch.empty_like(b)
    out[:, 0] = b[:, 0]
    out[:, 1::2] = odd                      # positions 1, 3, 5, ...
    m = (n - 1) // 2                        # positions 2, 4, ...
    out[:, 2::2] = torch.addcmul(b[:, 2::2], a[:, 2::2], odd[:, :m])
    return out


def selective_scan(dt, b_mat, c_mat, xc, a_log, h0=None, *, chunk: int = 128,
                   mode: str = "associative"):
    """h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t . h_t.

    dt: (B,S,Di) fp32, b/c: (B,S,N), xc: (B,S,Di), a_log: (Di,N).
    Returns (y (B,S,Di) fp32, h_final (B,Di,N)). ``S`` is cut into
    ``max(S // chunk, 1)`` equal chunks; a length they do not tile raises,
    as the reference's reshape does."""
    if mode not in ("associative", "sequential"):
        raise ValueError(f"ssm_scan {mode!r}: associative | sequential")
    bsz, s, di = dt.shape
    n = b_mat.shape[-1]
    a = -torch.exp(a_log)                                         # (Di,N)
    h = h0 if h0 is not None else torch.zeros((bsz, di, n), dtype=torch.float32,
                                              device=dt.device)
    nch = max(s // chunk, 1)
    q = s // nch
    if nch * q != s:
        raise ValueError(f"sequence length {s} is not {nch} chunks of {q} "
                         f"(ssm_chunk {chunk})")
    ys = []
    for c in range(nch):
        sl = slice(c * q, (c + 1) * q)
        dt_c, b_c, c_c = dt[:, sl], b_mat[:, sl], c_mat[:, sl]
        decay = torch.exp(dt_c[..., None] * a)                    # (B,Q,Di,N)
        inp = (dt_c * xc[:, sl].to(torch.float32))[..., None] * b_c[:, :, None, :]
        if mode == "associative":
            # the carried state enters as the first step's input: the
            # reference's aa * h + bb without the scanned aa
            inp[:, 0] = torch.addcmul(inp[:, 0], decay[:, 0], h)
            hs = _associative_scan(decay, inp)                    # (B,Q,Di,N)
        else:
            steps = []
            for t in range(q):
                h = decay[:, t] * h + inp[:, t]
                steps.append(h)
            hs = torch.stack(steps, dim=1)
        # y[b,q,i] = sum_n hs[b,q,i,n] c[b,q,n], as one batched product
        ys.append((hs.flatten(0, 1) @ c_c.flatten(0, 1)[..., None])
                  .reshape(bsz, q, di))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba1_apply(p, x, cfg, *, state=None):
    """x: (B, S, D) -> ((B, S, D), (conv_state, h)). ``state=(conv_state,
    h)`` continues a sequence (decode); None starts one."""
    cd = cfg.compute_dtype
    di = cfg.expand * cfg.d_model
    zx = x @ p["in_proj"].to(cd)
    xin, z = zx[..., :di], zx[..., di:]
    conv_state = state[0] if state is not None else None
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], conv_state)
    dt, b_mat, c_mat = _ssm_params(p, xc, cfg)
    h0 = state[1] if state is not None else None
    y, h_fin = selective_scan(dt, b_mat, c_mat, xc, p["a_log"], h0,
                              chunk=cfg.ssm_chunk, mode=cfg.ssm_scan)
    y = y.to(cd) + xc * p["d_skip"].to(cd)
    y = y * F.silu(z)
    return y @ p["out_proj"].to(cd), (new_conv, h_fin)


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def init_mamba2(gen: torch.Generator, cfg):
    d = cfg.d_model
    di = cfg.expand * d
    n, g, hd = cfg.ssm_state, cfg.n_groups, cfg.ssm_headdim
    nh = di // hd
    dc, cw = cfg.d_conv, di + 2 * g * n
    pd, dev = cfg.param_dtype, gen.device
    # in_proj emits [z (di), x (di), B (g*n), C (g*n), dt (nh)]
    in_proj = layers.dense_init(gen, (d, 2 * di + 2 * g * n + nh), pd)
    conv_w = torch.randn((dc, cw), generator=gen, device=dev,
                         dtype=torch.float32) / math.sqrt(dc)
    return {
        "in_proj": in_proj,
        "conv_w": conv_w.to(pd),
        "conv_b": torch.zeros((cw,), dtype=pd, device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=torch.float32,
                                          device=dev)),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((nh,), dtype=pd, device=dev),
        "norm": layers.init_rms(gen, di, pd),
        "out_proj": layers.dense_init(gen, (di, d), pd),
    }


def _segsum(x):
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums:
    ``out[t, s] = sum_{s < i <= t} x_i``, -inf above the diagonal."""
    q = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(xh, dt, a, b_mat, c_mat, h0, chunk: int):
    """SSD forward. xh: (B,S,H,P), dt: (B,S,H) fp32, a: (H,) negative,
    b/c: (B,S,G,N), h0: (B,H,N,P). Returns (y (B,S,H,P), h_final
    (B,H,N,P)). ``S`` is cut into ``max(S // chunk, 1)`` equal chunks; a
    length they do not tile raises, as the reference's reshape does."""
    bsz, s, h, p_dim = xh.shape
    rep = h // b_mat.shape[2]
    nch = max(s // chunk, 1)
    q = s // nch
    if nch * q != s:
        raise ValueError(f"sequence length {s} is not {nch} chunks of {q} "
                         f"(ssm_chunk {chunk})")

    def rc(t):      # (B,S,...) -> (B,C,Q,...)
        return t.reshape(bsz, nch, q, *t.shape[2:])

    x_c, dt_c = rc(xh), rc(dt)                              # (B,C,Q,H,P), (B,C,Q,H)
    bh = rc(b_mat).repeat_interleave(rep, dim=3)            # (B,C,Q,H,N)
    ch = rc(c_mat).repeat_interleave(rep, dim=3)
    da = dt_c * a                                           # (B,C,Q,H)
    # intra-chunk: the decay matrix L (B,C,H,Q,Q) masks C B^T
    l = torch.exp(_segsum(da.transpose(2, 3)))
    scores = torch.einsum("bcqhn,bcshn->bchqs", ch, bh) * l
    xdt = x_c * dt_c[..., None]                             # (B,C,Q,H,P)
    y_intra = torch.einsum("bchqs,bcshp->bcqhp", scores, xdt)
    # each chunk's own contribution to the state, and its total decay
    cum = torch.cumsum(da, dim=2)                           # (B,C,Q,H)
    decay_tail = torch.exp(cum[:, :, -1:] - cum)
    gain = torch.einsum("bcqhn,bcqhp->bchnp", bh * decay_tail[..., None], xdt)
    decay = torch.exp(cum[:, :, -1])[..., None, None]       # (B,C,H,1,1)
    # the state entering each chunk: the reference's scan carry
    h_in, h_cur = [], h0
    for c in range(nch):
        h_in.append(h_cur)
        h_cur = decay[:, c] * h_cur + gain[:, c]
    hprev = torch.stack(h_in, dim=1)                        # (B,C,H,N,P)
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp", ch, hprev) * torch.exp(cum)[..., None]
    return (y_intra + y_inter).reshape(bsz, s, h, p_dim), h_cur


def mamba2_apply(p, x, cfg, *, state=None):
    """Mamba2/SSD block. x: (B, S, D) -> ((B, S, D), (conv_state, h)).
    ``state=(conv_state, h)`` continues a sequence (decode); None starts
    one."""
    cd = cfg.compute_dtype
    di = cfg.expand * cfg.d_model
    g, n, hd = cfg.n_groups, cfg.ssm_state, cfg.ssm_headdim
    nh = di // hd
    bsz, s, _ = x.shape
    f32 = torch.float32

    zxbcdt = x @ p["in_proj"].to(cd)
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt_in = zxbcdt[..., -nh:]
    conv_state = state[0] if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    xh = xbc[..., :di].reshape(bsz, s, nh, hd)
    b_mat = xbc[..., di:di + g * n].reshape(bsz, s, g, n).to(f32)
    c_mat = xbc[..., di + g * n:].reshape(bsz, s, g, n).to(f32)
    dt = _softplus(dt_in.to(f32) + p["dt_bias"].to(f32))
    a = -torch.exp(p["a_log"])
    h0 = state[1] if state is not None else torch.zeros(
        (bsz, nh, n, hd), dtype=f32, device=x.device)
    y, h_fin = ssd_chunked(xh.to(f32), dt, a, b_mat, c_mat, h0,
                           chunk=cfg.ssm_chunk)
    y = y + xh.to(f32) * p["d_skip"].to(f32)[None, None, :, None]
    y = y.reshape(bsz, s, di).to(cd)
    y = layers.rms_norm(y * F.silu(z), p["norm"])
    return y @ p["out_proj"].to(cd), (new_conv, h_fin)
