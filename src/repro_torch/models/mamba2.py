"""Mamba-2 (SSD) block: in_proj -> causal conv -> SSD scan -> gated norm ->
out_proj (ports ``repro/models/mamba2.py``).

Prefill runs the chunked SSD: ``kernel`` is the SSD-scan dispatcher (the
CUDA kernel on the card), any other impl the plain chunked version;
``auto`` takes ``kernel`` on ``cuda`` (the reference's ``tpu``) and
``chunked`` elsewhere.  Decode carries a constant-size state (heads x N x P) and the
last ``d_conv - 1`` raw conv inputs.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan, ssd_scan_chunked
from .config import ModelConfig
from .layers import Params, dense_init, rmsnorm


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return s, d_in, d_in // s.head_dim


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
               device=None) -> dict:
    s, d_in, nh = dims(cfg)
    # in_proj emits [z (d_in), x (d_in), B (N), C (N), dt (nh)]
    proj_out = 2 * d_in + 2 * s.d_state + nh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(gen, (cfg.d_model, proj_out), 0, dtype, device),
        "conv": (torch.randn((s.d_conv, d_in), generator=gen, **f32)
                 * 0.1).to(dtype),
        "a_log": torch.zeros((nh,), **f32),        # A = -exp(a_log) in (-1, 0]
        "dt_bias": torch.full((nh,), -2.0, **f32),  # softplus -> small dt
        "d_skip": torch.ones((nh,), **f32),
        "norm": torch.ones((d_in,), dtype=dtype, device=device),
        "w_out": dense_init(gen, (d_in, cfg.d_model), 0, dtype, device),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    s, d_in, nh = dims(cfg)
    n = s.d_state
    return proj.split([d_in, d_in, n, n, nh], dim=-1)   # z, x, B, C, dt


def mamba_forward(params: Params, u: torch.Tensor, cfg: ModelConfig,
                  impl: str = "auto", return_state: bool = False):
    """Full-sequence SSD. u: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns (ssm_state (B, nh, N, P),
    conv_state (B, d_conv-1, d_in)) -- the prefill -> decode hand-off."""
    s_cfg, d_in, nh = dims(cfg)
    b, t, _ = u.shape
    n, hp = s_cfg.d_state, s_cfg.head_dim
    z, x_raw, bmat, cmat, dt = _split_proj(u @ params["w_in"], cfg)

    # causal depthwise conv over time (kernel d_conv)
    pad = F.pad(x_raw, (0, 0, s_cfg.d_conv - 1, 0))
    conv = sum(pad[:, i:i + t] * params["conv"][i]
               for i in range(s_cfg.d_conv))
    x = F.silu(conv.float()).to(u.dtype)

    dt = F.softplus(dt.float() + params["dt_bias"])             # (B, S, nh)
    a = -torch.exp(params["a_log"])                             # (nh,)

    # (B*nh, T, ...) sequences; B and C broadcast over the heads
    xh = x.reshape(b, t, nh, hp).transpose(1, 2).reshape(b * nh, t, hp)
    dth = dt.transpose(1, 2).reshape(b * nh, t, 1)
    ah = a[None, :].expand(b, nh).reshape(b * nh, 1)
    bh = bmat.float()[:, None].expand(b, nh, t, n).reshape(b * nh, t, n)
    ch = cmat.float()[:, None].expand(b, nh, t, n).reshape(b * nh, t, n)

    if impl == "auto":
        impl = "kernel" if u.is_cuda else "chunked"
    # as the reference, every impl other than ``kernel`` (an attention
    # impl of a shared ``impl`` argument) runs the chunked version
    scan = ssd_scan if impl == "kernel" else ssd_scan_chunked
    y, h_fin = scan(xh.float(), dth, ah, bh, ch, chunk=s_cfg.chunk)
    # D skip (per head)
    y = (y.reshape(b, nh, t, hp)
         + params["d_skip"][None, :, None, None] * xh.reshape(b, nh, t, hp))
    y = y.transpose(1, 2).reshape(b, t, d_in).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(u.dtype),
                cfg.norm_eps)
    out = y @ params["w_out"]
    if not return_state:
        return out
    ssm_state = h_fin.reshape(b, nh, n, hp)
    # the last d_conv-1 raw inputs, copied: a view would keep all of
    # ``pad`` alive in the cache (JAX's slices are copies)
    conv_state = pad[:, t:t + s_cfg.d_conv - 1].clone()
    return out, ssm_state, conv_state


def mamba_decode(params: Params, u: torch.Tensor, ssm_state: torch.Tensor,
                 conv_state: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One-token step. u: (B, 1, D); ssm_state (B, nh, N, P) and
    conv_state (B, d_conv-1, d_in) are updated in place.  Returns the
    block output (B, 1, D)."""
    s_cfg, d_in, nh = dims(cfg)
    b = u.shape[0]
    z, x, bmat, cmat, dt = _split_proj(u[:, 0] @ params["w_in"], cfg)

    # conv with the cached tail
    window = torch.cat([conv_state, x[:, None].to(conv_state.dtype)], dim=1)
    conv = torch.einsum("bkd,kd->bd", window.float(), params["conv"].float())
    x = F.silu(conv).to(u.dtype)
    conv_state.copy_(window[:, 1:])

    dt = F.softplus(dt.float() + params["dt_bias"])             # (B, nh)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(a[None] * dt)                             # (B, nh)

    xh = x.reshape(b, nh, s_cfg.head_dim).float()
    inject = dt[..., None, None] * torch.einsum(
        "bn,bhp->bhnp", bmat.float(), xh)
    ssm_state.mul_(decay[..., None, None]).add_(inject)
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), ssm_state)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(b, d_in).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(u.dtype),
                cfg.norm_eps)
    return (y @ params["w_out"])[:, None]
