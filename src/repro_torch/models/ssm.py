"""Mamba-2 (SSD — state-space duality) block, chunked, with O(1) decode.

The port of the reference's ``models/ssm.py``. The inter-chunk state
recurrence

    h_c = exp(sum_t log a_t) * h_{c-1} + S_c

is a chain of associative operator compositions, evaluated with the
log-depth doubling scan (``repro_torch.core.scan.prefix_scan``).
Within a chunk the SSD quadratic form is three products of compute-dtype
operands accumulated in fp32 (``torch.einsum`` on fp32 copies, with
``exact_matmul_settings()`` in force), as the reference's jnp einsums are;
``w_in`` / ``w_out`` are ``dense`` (K1 on the card).

Shapes follow the Mamba-2 reference: d_inner = expand*d_model, H heads of
size P = ssm_head_dim, G state groups, N = ssm_state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import DTYPES
from repro_torch.configs.base import ArchConfig
from repro_torch.core.scan import prefix_scan
from repro_torch.models.layers import ShardCtx, NO_SHARD, dense, norm
from repro_torch.models.layers import _normal

__all__ = ["init_ssm", "ssm_block", "ssm_decode_step"]


def init_ssm(generator, cfg: ArchConfig):
    pdt = DTYPES[cfg.param_dtype]
    dev = generator.device
    d, di = cfg.d_model, cfg.d_inner
    g, n, h = cfg.ssm_n_groups, cfg.ssm_state, cfg.ssm_n_heads
    conv_dim = di + 2 * g * n
    return {
        # fused in_proj -> [z(di), x(di), B(g*n), C(g*n), dt(h)]
        "w_in": _normal(generator, (d, 2 * di + 2 * g * n + h), pdt,
                        d ** -0.5),
        "conv_w": _normal(generator, (cfg.ssm_conv_width, conv_dim), pdt,
                          cfg.ssm_conv_width ** -0.5),
        "conv_b": torch.zeros((conv_dim,), dtype=pdt, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)).to(pdt),
        "D": torch.ones((h,), dtype=pdt, device=dev),
        "dt_bias": torch.full((h,), math.log(math.expm1(0.01)),
                              dtype=torch.float32, device=dev).to(pdt),
        "norm_w": torch.ones((di,), dtype=pdt, device=dev),
        "w_out": _normal(generator, (di, d), pdt, di ** -0.5),
    }


def _split_proj(cfg: ArchConfig, zxbcdt):
    di, g, n = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di:2 * di]
    b = zxbcdt[..., 2 * di:2 * di + g * n]
    c = zxbcdt[..., 2 * di + g * n:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, x, b, c, dt


def _causal_conv(u, w, bias, state=None):
    """Depthwise causal conv. u: (B,S,C), w: (W,C). state: (B,W-1,C) or
    None. Returns (y, new_state)."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((u.shape[0], width - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = state.to(u.dtype)
    full = torch.cat([pad, u], dim=1)                 # (B, S+W-1, C)
    y = torch.zeros_like(u)
    for i in range(width):
        y = y + full[:, i:i + u.shape[1]] * w[i]
    y = y + bias
    new_state = full[:, -(width - 1):] if width > 1 else None
    return y, new_state


def _f32_einsum(eq, *ops):
    """A product of compute-dtype operands accumulated in fp32 (the
    reference's ``preferred_element_type=jnp.float32``)."""
    return torch.einsum(eq, *(o.float() for o in ops))


def ssm_block(cfg: ArchConfig, p, xin, *, sctx: ShardCtx = NO_SHARD,
              initial_state=None, conv_state=None,
              return_state: bool = False):
    """Full-sequence SSD. xin: (B,S,D) -> (B,S,D).

    Chunked algorithm (chunk Q=cfg.ssm_chunk):
      intra-chunk:  Y_c += ((C_c B_c^T) . L_c) X_c          (quadratic, local)
      chunk states: S_c = (decay-to-end . B_c)^T X_c        (product)
      inter-chunk:  h via log-depth prefix_scan over (decay, S_c)
      readout:      Y_c += (decay-from-start . C_c) h_{c-1} (product)
    """
    bsz, s, _ = xin.shape
    di, g, n, h = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, \
        cfg.ssm_n_heads
    ph = cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, s)
    while s % q:
        q //= 2
    nc = s // q
    cdt = xin.dtype

    zxbcdt = dense(xin, p["w_in"])

    def core(zxbcdt, conv_w, conv_b, a_log, dt_bias, d_skip, norm_w,
             initial_state, conv_state):
        # each rank's batch shard on a mesh
        bsz = zxbcdt.shape[0]
        z, xc, bmat, cmat, dt = _split_proj(cfg, zxbcdt)

        conv_in = torch.cat([xc, bmat, cmat], dim=-1)
        conv_out, new_conv_state = _causal_conv(conv_in, conv_w,
                                                conv_b, state=conv_state)
        conv_out = F.silu(conv_out)
        xc = conv_out[..., :di]
        bmat = conv_out[..., di:di + g * n]
        cmat = conv_out[..., di + g * n:]

        # heads
        x_h = xc.reshape(bsz, s, h, ph)                       # (B,S,H,P)
        rep = h // g
        b_h = torch.repeat_interleave(bmat.reshape(bsz, s, g, n), rep, dim=2)
        c_h = torch.repeat_interleave(cmat.reshape(bsz, s, g, n), rep, dim=2)

        a = -torch.exp(a_log.float())                    # (H,) negative
        dt = F.softplus(dt.float() + dt_bias.float())    # (B,S,H)
        log_decay = dt * a                            # (B,S,H) = log a_t
        xdt = (x_h.float() * dt[..., None]).to(cdt)

        # ---- chunk views (heavy operands in compute dtype, fp32 products)
        xq = xdt.reshape(bsz, nc, q, h, ph)
        bq = b_h.reshape(bsz, nc, q, h, n).to(cdt)
        cq = c_h.reshape(bsz, nc, q, h, n).to(cdt)
        ldq = log_decay.reshape(bsz, nc, q, h)
        cum = torch.cumsum(ldq, dim=2)                        # within-chunk
        chunk_total = cum[:, :, -1]                           # (B,nc,H)

        # ---- intra-chunk quadratic term ----
        # L[i,j] = exp(cum_i - cum_j) for j <= i  (decay from j+1..i)
        li = cum[:, :, :, None, :]                            # (B,nc,q,1,H)
        lj = cum[:, :, None, :, :]                            # (B,nc,1,q,H)
        mask = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                     device=xin.device))
        # The exponent is masked, not the exponential: above the diagonal
        # li - lj > 0 can overflow exp to inf, and a where() after the exp
        # gives that entry the gradient 0 * inf = NaN (the reference's form,
        # which trains Mamba2-130m in bf16 at full depth to a NaN gradient).
        # The values are the same.
        lmat = torch.exp(torch.where(mask[None, None, :, :, None], li - lj,
                                     float("-inf")))
        scores = _f32_einsum("bcihn,bcjhn->bcijh", cq, bq)
        y_intra = _f32_einsum("bcijh,bcjhp->bcihp", (scores * lmat).to(cdt),
                              xq)

        # ---- chunk states: S_c = sum_j decay(j->end) x_j B_j^T ----
        decay_to_end = torch.exp(chunk_total[:, :, None, :] - cum)
        xqd = (xq.float() * decay_to_end[..., None]).to(cdt)
        s_c = _f32_einsum("bcjhn,bcjhp->bchpn", bq, xqd)    # (B,nc,H,P,N)

        # ---- inter-chunk recurrence via the log-depth doubling scan ----
        # operator per chunk: h -> exp(chunk_total) * h + S_c
        decay_c = torch.exp(chunk_total)                           # (B,nc,H)

        def combine(older, newer):
            a1, s1 = older
            a2, s2 = newer
            return a1 * a2, a2[..., None, None] * s1 + s2

        a_scan, h_scan = prefix_scan((decay_c, s_c), combine, axis=1)
        if initial_state is not None:
            h0 = initial_state.float()                             # (B,H,P,N)
            h_scan = h_scan + a_scan[..., None, None] * h0[:, None]
            h_prev = torch.cat([h0[:, None], h_scan[:, :-1]], dim=1)
        else:
            h_prev = torch.cat([torch.zeros_like(h_scan[:, :1]),
                                h_scan[:, :-1]], dim=1)

        # ---- inter-chunk readout ----
        decay_from_start = torch.exp(cum)                          # (B,nc,q,H)
        cqd = (cq.float() * decay_from_start[..., None]).to(cdt)
        y_inter = _f32_einsum("bcihn,bchpn->bcihp", cqd, h_prev.to(cdt))

        y = (y_intra + y_inter).reshape(bsz, s, h, ph)
        y = y + x_h.float() * d_skip.float()[None, None, :, None]
        y = y.reshape(bsz, s, di).to(cdt)

        # gated RMSNorm (mamba2: norm(y * silu(z)))
        y = norm(y * F.silu(z.float()).to(cdt), norm_w, kind="rmsnorm",
                 eps=cfg.norm_eps)
        return y, h_scan[:, -1], new_conv_state

    # On a mesh the scan runs on each rank's batch shard, every head on
    # every tp rank (the in-projection's tp-sharded columns are gathered).
    bat = sctx.axes(bsz, sctx.dp)
    state_spec = None if initial_state is None else (bat, None, None, None)
    conv_spec = None if conv_state is None else (bat, None, None)
    y, h_last, new_conv_state = sctx.local(
        core, (zxbcdt, p["conv_w"], p["conv_b"], p["A_log"], p["dt_bias"],
               p["D"], p["norm_w"], initial_state, conv_state),
        ((bat, None, None), (None, None), (None,), (None,), (None,),
         (None,), (None,), state_spec, conv_spec),
        ((bat, None, None), (bat, None, None, None), (bat, None, None)))
    out = sctx.activation(dense(y, p["w_out"]))
    if return_state:
        return out, (h_last, new_conv_state)                  # (B,H,P,N)
    return out


def ssm_decode_step(cfg: ArchConfig, p, xin, ssm_state, conv_state, *,
                    sctx: ShardCtx = NO_SHARD):
    """O(1) single-token update. xin: (B,1,D); ssm_state: (B,H,P,N) f32;
    conv_state: (B,W-1,conv_dim). Returns (out, new_ssm_state, new_conv)."""
    bsz = xin.shape[0]
    di, g, n, h = cfg.d_inner, cfg.ssm_n_groups, cfg.ssm_state, \
        cfg.ssm_n_heads
    ph = cfg.ssm_head_dim
    cdt = xin.dtype

    zxbcdt = dense(xin, p["w_in"])

    def core(zxbcdt, conv_w, conv_b, a_log, dt_bias, d_skip, norm_w,
             ssm_state, conv_state):
        bsz = zxbcdt.shape[0]                 # the batch shard on a mesh
        z, xc, bmat, cmat, dt = _split_proj(cfg, zxbcdt)
        conv_in = torch.cat([xc, bmat, cmat], dim=-1)         # (B,1,conv)
        conv_out, new_conv = _causal_conv(conv_in, conv_w, conv_b,
                                          state=conv_state)
        conv_out = F.silu(conv_out)
        xc = conv_out[..., :di]
        bmat = conv_out[..., di:di + g * n]
        cmat = conv_out[..., di + g * n:]

        x_h = xc.reshape(bsz, h, ph).float()
        rep = h // g
        b_h = torch.repeat_interleave(bmat.reshape(bsz, g, n), rep,
                                      dim=1).float()
        c_h = torch.repeat_interleave(cmat.reshape(bsz, g, n), rep,
                                      dim=1).float()

        a = -torch.exp(a_log.float())
        dt = F.softplus(dt.reshape(bsz, h).float() + dt_bias.float())
        decay = torch.exp(dt * a)                              # (B,H)

        # state: (B,H,P,N);  h' = decay*h + (dt*x) B^T
        upd = torch.einsum("bhp,bhn->bhpn", x_h * dt[..., None], b_h)
        new_state = ssm_state * decay[..., None, None] + upd
        y = torch.einsum("bhpn,bhn->bhp", new_state, c_h)
        y = y + x_h * d_skip.float()[None, :, None]
        y = y.reshape(bsz, 1, di).to(cdt)

        y = norm(y * F.silu(z.float()).to(cdt), norm_w, kind="rmsnorm",
                 eps=cfg.norm_eps)
        return y, new_state, new_conv

    bat = sctx.axes(bsz, sctx.dp)
    y, new_state, new_conv = sctx.local(
        core, (zxbcdt, p["conv_w"], p["conv_b"], p["A_log"], p["dt_bias"],
               p["D"], p["norm_w"], ssm_state, conv_state),
        ((bat, None, None), (None, None), (None,), (None,), (None,),
         (None,), (None,), (bat, None, None, None), (bat, None, None)),
        ((bat, None, None), (bat, None, None, None), (bat, None, None)))
    if sctx.mesh is not None:            # back to the cache's own placement
        new_state = new_state.redistribute(sctx.mesh, ssm_state.placements)
        new_conv = new_conv.redistribute(sctx.mesh, conv_state.placements)
    return sctx.activation(dense(y, p["w_out"])), new_state, new_conv
