"""SSD-scan dispatcher (the kernel on the card, the plain chunked version
on the CPU) and the plain chunked version itself.

The choice follows the tensors alone: CUDA tensors go to the hand-written
kernel (``cuda.py``), which raises if it cannot build or launch, and CPU
tensors to ``ssd_scan_chunked``.  There is no silent fallback between
them.  Both take the chunk length of the JAX wrapper
(``repro/kernels/ssd_scan/ops.py:34-40``): ``min(chunk, round_up(T, 8))``,
with a ragged last chunk acting as if dt = 0 (decay 1, no state update),
because the chunking sets the summation order.

``ssd_scan_chunked`` ports ``ssd_scan_chunked_jnp``, the same chunked
algorithm written with batched einsums: the model's ``chunked`` path, the
CPU path of ``ssd_scan`` and the kernel's plain version on the card.
Both return ``(y, h_final)``; ``h_final`` (BH, N, P) is the state after
the last step, the prefill -> decode hand-off.

On the card ``ssd_scan`` is differentiable through ``SsdScanKernel``, a
``torch.autograd.Function``: its forward is the kernel; its backward
recomputes the same function with ``ssd_scan_chunked`` under autograd and
returns the gradients of x, dt, a, b and c (the JAX package has only the
forward kernel, and differentiates its plain version).
``ssd_scan_backward.launches`` counts those backward passes.

The kernel forward is the PyTorch operator ``torch.ops.repro_torch.
ssd_scan``, whose only implementation is the CUDA wrapper; its fake
implementation gives the outputs' shapes and raises the launch's
``ValueError``s, and ``ssd_counts``' FLOPs are its FLOP formula, so a dry
run over fake card tensors (``launch/dryrun.py``) checks and counts each
call without a card.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from ..common import LaunchCounter, refuse_dtensor, round_up
from .cuda import check_inputs, ssd_scan_cuda

#: counts ``SsdScanKernel``'s backward passes (plain PyTorch, no kernel)
ssd_scan_backward = LaunchCounter()


def ssd_counts(bh: int, t: int, p: int, n: int, chunk: int
               ) -> Tuple[float, int]:
    """(FLOPs, bytes) the SSD scan needs: per chunk of length l, the
    lower triangle of C B^T (l(l+1)/2 N) and of M X (l(l+1)/2 P), C h and
    B^T X (l N P each), two FLOPs per multiply-add; each input read and
    each output written once, float32."""
    ch = min(chunk, round_up(t, 8))
    macs = 0
    for t0 in range(0, t, ch):
        ln = min(ch, t - t0)
        macs += ln * (ln + 1) // 2 * (n + p) + 2 * ln * n * p
    nbytes = 4 * bh * (t * p + t + 1 + 2 * t * n + t * p + n * p)
    return 2.0 * bh * macs, nbytes


@torch.library.custom_op("repro_torch::ssd_scan", mutates_args=(),
                         device_types="cuda")
def ssd_scan_op(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    return ssd_scan_cuda(x, dt, a, b, c, chunk=chunk)


@ssd_scan_op.register_fake
def _ssd_scan_fake(x, dt, a, b, c, chunk):
    check_inputs(x, dt, a, b, c, chunk)
    bh, _, p = x.shape
    return torch.empty_like(x), x.new_empty((bh, b.shape[-1], p))


@register_flop_formula(torch.ops.repro_torch.ssd_scan)
def _ssd_scan_flops(x, dt, a, b, c, chunk, out_shape=None, **kw):
    bh, t, p = x
    return ssd_counts(bh, t, p, b[-1], chunk)[0]


class SsdScanKernel(torch.autograd.Function):
    """The SSD scan on the card with a gradient: the CUDA kernel forward,
    a backward through ``ssd_scan_chunked``'s recomputation."""

    @staticmethod
    def forward(ctx, x, dt, a, b, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, b, c)
        ctx.chunk = chunk
        return ssd_scan_op(x, dt, a, b, c, chunk)

    @staticmethod
    def backward(ctx, gy, gh):
        ssd_scan_backward._count()
        need = ctx.needs_input_grad[:5]
        if not any(need) or (gy is None and gh is None):
            return (None,) * 6
        ins = [v.detach().requires_grad_(n)
               for v, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            outs = ssd_scan_chunked(*ins, chunk=ctx.chunk)
        used = [(o, g) for o, g in zip(outs, (gy, gh)) if g is not None]
        got = iter(torch.autograd.grad(
            [o for o, _ in used], [v for v in ins if v.requires_grad],
            [g for _, g in used], allow_unused=True))
        return tuple(next(got) if n else None for n in need) + (None,)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan; x: (BH, T, P); dt: (BH, T, 1); a: (BH, 1); b, c:
    (BH, T, N).  Returns (y: (BH, T, P), h_final: (BH, N, P))."""
    refuse_dtensor("ssd_scan", x, dt, a, b, c)
    t = x.shape[1]
    if t == 0:
        raise ValueError("ssd_scan needs at least one time step")
    ch = min(chunk, round_up(t, 8))
    if x.is_cuda:
        return SsdScanKernel.apply(
            *(v.contiguous() for v in (x, dt, a, b, c)), ch)
    if x.device.type != "cpu":
        raise ValueError(f"ssd_scan runs on cuda or cpu, got {x.device}")
    return ssd_scan_chunked(x, dt, a, b, c, chunk=ch)


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, c: torch.Tensor, chunk: int = 128
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in plain PyTorch (same math as the kernel)."""
    bh, t, p = x.shape
    n = b.shape[-1]
    ch = min(chunk, t)
    t_pad = round_up(t, ch)
    if t_pad != t:
        # dt = 0 padding is inert: decay 1, no state update, y discarded
        x, dt, b, c = (F.pad(v, (0, 0, 0, t_pad - t)) for v in (x, dt, b, c))
    nc = t_pad // ch

    xc = x.reshape(bh, nc, ch, p).float()
    dtc = dt.reshape(bh, nc, ch, 1).float()
    bc = b.reshape(bh, nc, ch, n).float()
    cc = c.reshape(bh, nc, ch, n).float()

    adt = a.float().reshape(bh, 1, 1, 1) * dtc
    cum = torch.cumsum(adt, dim=2)                       # (BH, NC, L, 1)
    seg = cum - cum.transpose(2, 3)                      # (BH, NC, L, L)
    mask = torch.ones((ch, ch), dtype=torch.bool, device=x.device).tril()
    decay = torch.where(mask, torch.exp(torch.where(mask, seg, 0.0)), 0.0)
    scores = torch.einsum("zntk,znsk->znts", cc, bc)
    y_intra = torch.einsum("znts,znsp->zntp", scores * decay, xc * dtc)

    total = cum[:, :, -1:, :]                            # (BH, NC, 1, 1)
    w = dtc * torch.exp(total - cum)                     # (BH, NC, L, 1)
    h_in = torch.einsum("znsk,znsp->znkp", bc * w, xc)   # per-chunk injection
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    starts = []
    for i in range(nc):
        starts.append(h)
        h = torch.exp(total[:, i, 0, 0])[:, None, None] * h + h_in[:, i]
    h_starts = torch.stack(starts, dim=1)                # (BH, NC, N, P)
    y_inter = torch.exp(cum) * torch.einsum("zntk,znkp->zntp", cc, h_starts)

    y = (y_intra + y_inter).reshape(bh, t_pad, p)[:, :t]
    return y.to(x.dtype), h
