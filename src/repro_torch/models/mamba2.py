"""Mamba-2 (SSD) block: in_proj -> causal conv -> SSD scan -> gated norm ->
out_proj (ports ``repro/models/mamba2.py``).

Prefill runs the chunked SSD: ``kernel`` is the SSD-scan dispatcher (the
CUDA kernel on the card), any other impl the plain chunked version;
``auto`` takes ``kernel`` on ``cuda`` (the reference's ``tpu``) and
``chunked`` elsewhere.  Decode carries a constant-size state (heads x N x P) and the
last ``d_conv - 1`` raw conv inputs.

Under ``ShardingRules`` the block runs on DTensors, and the causal conv
and the scan run under ``local_map``: each rank convolves and scans the
whole sequence of its batch rows and of its heads (heads over ``model``
when they divide over it), so the kernel and its autograd ``Function``
see local tensors.  The
hidden takes the reference's constraint (sequence-sharded when
training, ff-sharded when serving).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan, ssd_scan_chunked
from .config import ModelConfig
from .layers import (NO_SHARDING, P, Params, ShardingRules, assign,
                     constrain, dense, dense_init, is_dtensor, local_map_on,
                     rmsnorm)


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


def mamba_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, P]:
    return {"w_in": rules.logical("fsdp", "tp"),
            "conv": rules.logical(None, "tp"),
            "a_log": rules.logical(None),
            "dt_bias": rules.logical(None),
            "d_skip": rules.logical(None),
            "norm": rules.logical(None),
            "w_out": rules.logical("tp", "fsdp")}


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    s, d_in, nh = dims(cfg)
    n = s.d_state
    return proj.split([d_in, d_in, n, n, nh], dim=-1)   # z, x, B, C, dt


def _conv_scan(scan, chunk: int, dtype: torch.dtype, x_raw: torch.Tensor,
               conv_w: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               bmat: torch.Tensor, cmat: torch.Tensor):
    """The causal depthwise conv over time (kernel ``d_conv``) and the SSD
    scan of every (batch row, head), over the whole sequence.  x_raw (B,
    T, d_in); conv_w (d_conv, d_in) -> (x (B, T, nh, P) the conv's silu
    in ``dtype``, y (B, nh, T, P) float32, h_final (B, nh, N, P), the last
    ``d_conv - 1`` raw inputs (B, d_conv - 1, d_in))."""
    b, t, d_in = x_raw.shape
    d_conv, nh, n = conv_w.shape[0], dt.shape[-1], bmat.shape[-1]
    hp = d_in // nh
    pad = F.pad(x_raw, (0, 0, d_conv - 1, 0))
    conv = sum(pad[:, i:i + t] * conv_w[i] for i in range(d_conv))
    x = F.silu(conv.float()).to(dtype).reshape(b, t, nh, hp)
    # (B*nh, T, ...) sequences; B and C broadcast over the heads
    xh = x.transpose(1, 2).reshape(b * nh, t, hp)
    dth = dt.transpose(1, 2).reshape(b * nh, t, 1)
    # float32, as the kernel takes it (``a`` is in the weights' dtype)
    ah = a.float()[None, :].expand(b, nh).reshape(b * nh, 1)
    bh = bmat.float()[:, None].expand(b, nh, t, n).reshape(b * nh, t, n)
    ch = cmat.float()[:, None].expand(b, nh, t, n).reshape(b * nh, t, n)
    y, h_fin = scan(xh.float(), dth, ah, bh, ch, chunk=chunk)
    # the last d_conv-1 raw inputs, copied: a view would keep all of
    # ``pad`` alive in the cache (JAX's slices are copies)
    return (x, y.reshape(b, nh, t, hp), h_fin.reshape(b, nh, n, hp),
            pad[:, t:t + d_conv - 1].clone())


def mamba_forward(params: Params, u: torch.Tensor, cfg: ModelConfig,
                  impl: str = "auto", return_state: bool = False,
                  rules: ShardingRules = NO_SHARDING):
    """Full-sequence SSD. u: (B, S, D) -> (B, S, D).

    With ``return_state`` also returns (ssm_state (B, nh, N, P),
    conv_state (B, d_conv-1, d_in)) -- the prefill -> decode hand-off."""
    s_cfg, d_in, nh = dims(cfg)
    b, t, _ = u.shape
    z, x_raw, bmat, cmat, dt = _split_proj(dense(u, params["w_in"]), cfg)
    dt = F.softplus(dt.float() + params["dt_bias"])             # (B, S, nh)
    a = -torch.exp(params["a_log"])                             # (nh,)

    if impl == "auto":
        impl = "kernel" if u.is_cuda else "chunked"
    # as the reference, every impl other than ``kernel`` (an attention
    # impl of a shared ``impl`` argument) runs the chunked version
    scan = ssd_scan if impl == "kernel" else ssd_scan_chunked
    args = (x_raw, params["conv"], dt, a, bmat, cmat)
    if is_dtensor(u):
        hm = "model" if nh % rules.model_size == 0 else None
        lg = rules.logical
        x4, y, ssm_state, conv_state = local_map_on(
            lambda *v: _conv_scan(scan, s_cfg.chunk, u.dtype, *v),
            u.device_mesh,
            (lg("batch", None, hm, None), lg("batch", hm, None, None),
             lg("batch", hm, None, None), lg("batch", None, hm)),
            (lg("batch", None, hm), lg(None, hm), lg("batch", None, hm),
             lg(hm), lg("batch", None, None), lg("batch", None, None)))(
                *args)
    else:
        x4, y, ssm_state, conv_state = _conv_scan(scan, s_cfg.chunk,
                                                  u.dtype, *args)
    # D skip (per head)
    y = y + params["d_skip"][None, :, None, None] * x4.transpose(1, 2)
    y = y.transpose(1, 2).reshape(b, t, d_in).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(u.dtype),
                cfg.norm_eps)
    if rules.tp_weights:       # TP hidden (serving) vs SP hidden (training)
        y = constrain(y, rules, "batch", None, "model")
    else:
        y = constrain(y, rules, "batch", "model", None)
    out = dense(y, params["w_out"])
    if not return_state:
        return out
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
    assign(conv_state, window[:, 1:])

    dt = F.softplus(dt.float() + params["dt_bias"])             # (B, nh)
    a = -torch.exp(params["a_log"])
    decay = torch.exp(a[None] * dt)                             # (B, nh)

    xh = x.reshape(b, nh, s_cfg.head_dim).float()
    inject = dt[..., None, None] * torch.einsum(
        "bn,bhp->bhnp", bmat.float(), xh)
    if is_dtensor(ssm_state):
        assign(ssm_state, ssm_state * decay[..., None, None] + inject)
    else:
        ssm_state.mul_(decay[..., None, None]).add_(inject)
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), ssm_state)
    y = y + params["d_skip"][None, :, None] * xh
    y = y.reshape(b, d_in).to(u.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z.float()).to(u.dtype),
                cfg.norm_eps)
    return (y @ params["w_out"])[:, None]
