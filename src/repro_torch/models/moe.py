"""Mixture-of-Experts: token->expert dispatch as a hash partition with
capacity (ports ``repro/models/moe.py``).

Token->expert dispatch is the dataframe shuffle's bucketize: each (token,
choice) row takes its stable rank within its expert's bucket, rows past
the expert's static capacity are dropped, and the kept rows fill a
``(G, E, C, D)`` expert buffer.  The reference ranks rows with a stable
``argsort`` and ``searchsorted``; the port takes the ranks from
``kernels.radix_partition`` (the hand-written kernel on a CUDA tensor,
the plain version on a CPU tensor), the same kernel that bucketizes the
dataframe shuffle, with no sort and no inverse permutation.

Three dispatchers, as the reference:

* ``moe_apply_grouped`` (the one ``moe_apply`` takes) -- the grouped
  capacity dispatch, each batch row one group;
* ``moe_apply_shuffle`` -- the dispatch through the dataframe engine's
  shuffle, over ``model_size`` ranks stacked on one device;
* ``moe_apply_einsum`` -- the GShard one-hot oracle, for small shapes.

Router: softmax top-k with renormalisation, the Switch load-balancing
auxiliary loss, shared (always-on) experts.  The reference's
``moe_specs`` waits for the sharding of ROADMAP item 13.6.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..comm import get_communicator
from ..dataframe.shuffle import shuffle as df_shuffle
from ..dataframe.table import Table, gather_rows, scatter_rows
from ..kernels import radix_partition
from .config import ModelConfig
from .layers import Params, dense_init, mlp, mlp_init


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
             device=None) -> Dict[str, Any]:
    """``router`` float32 (d, E); ``experts.{w_gate, w_up}`` (E, d, f) and
    ``experts.w_down`` (E, f, d) in ``dtype``; ``shared`` when the config
    has shared experts."""
    m = cfg.moe
    d, ff, e = cfg.d_model, m.d_ff_expert, m.num_experts
    p: Dict[str, Any] = {
        "router": dense_init(gen, (d, e), 0, torch.float32, device),
        "experts": {
            "w_gate": dense_init(gen, (e, d, ff), 1, dtype, device),
            "w_up": dense_init(gen, (e, d, ff), 1, dtype, device),
            "w_down": dense_init(gen, (e, ff, d), 1, dtype, device),
        },
    }
    if m.num_shared:
        p["shared"] = mlp_init(gen, d, ff * m.num_shared, dtype, device)
    return p


def _route(params: Params, x: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (topv, topi, aux_loss).  x: (..., D)."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    logits = x.float() @ params["router"]                      # (..., E)
    probs = torch.softmax(logits, dim=-1)
    # the order of the k choices sets the flat index token * k + choice and
    # so every rank; ties in probability are where torch.topk and
    # jax.lax.top_k (lower index first) may order two choices apart
    topv, topi = torch.topk(probs, k, dim=-1, sorted=True)     # (..., k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux loss (Switch): E * mean(frac_tokens * frac_probs)
    onehot_all = F.one_hot(topi.reshape(-1, k), e).float()     # (T, k, E)
    frac_tokens = onehot_all.sum(1).mean(0)
    frac_probs = probs.reshape(-1, e).mean(0)
    aux = m.router_aux_weight * e * torch.sum(frac_tokens * frac_probs)
    return topv, topi, aux


def expert_capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    m = cfg.moe
    cap = int(m.capacity_factor * tokens_per_group * m.top_k / m.num_experts)
    return max(8, -(-max(cap, m.top_k) // 8) * 8)


def dispatch_slots(flat_e: torch.Tensor, num_experts: int, cap: int
                   ) -> torch.Tensor:
    """Each (token, choice) row's slot in the ``(E * cap)`` expert buffer
    of its group: ``e * cap + rank``, its stable rank within expert ``e``
    from ``radix_partition``, or the trash slot ``E * cap`` past the
    capacity.  flat_e: (G, n) int32 expert ids -> (G, n) int64."""
    rank, _ = radix_partition(flat_e, num_experts)
    return torch.where(rank < cap, flat_e.long() * cap + rank,
                       num_experts * cap)


def _experts(w: Params, ex_in: torch.Tensor) -> torch.Tensor:
    """The gated expert FFN, batched over the expert axis: ex_in (..., E,
    C, D) -> (..., E, C, D).  As the reference: silu in float32, then
    back to the input's dtype.  (Written without named intermediates, so
    that outside autograd each (..., E, C, F) product is freed as soon as
    it is used.)"""
    h = F.silu(torch.einsum("...ecd,edf->...ecf", ex_in,
                            w["w_gate"]).float()).to(ex_in.dtype)
    h = h * torch.einsum("...ecd,edf->...ecf", ex_in, w["w_up"])
    return torch.einsum("...ecf,efd->...ecd", h, w["w_down"])


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE layer dispatcher.  x: (B, S, D) -> (y, aux).

    The reference sends the dispatch through the dataframe shuffle
    (``moe_apply_shuffle``) under sequence-parallel ``ShardingRules`` and
    takes the grouped dispatch elsewhere, as under ``NO_SHARDING``.  The
    port has no ``ShardingRules`` yet (ROADMAP item 13.6), so it always
    takes ``moe_apply_grouped``.
    """
    return moe_apply_grouped(params, x, cfg)


def moe_apply_grouped(params: Params, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped capacity dispatch, each batch row a dispatch group.

    The (B, E, C, D) expert buffer holds row ``token`` of ``x`` at the slot
    ``dispatch_slots`` gives each (token, choice); the combine reads each
    (token, choice)'s own slot back (a dropped one reads a zero row) and
    weighs it by its renormalised router probability.
    """
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = expert_capacity(cfg, s)
    topv, topi, aux = _route(params, x, cfg)                   # (B, S, k)

    # --- bucketize (the dataframe-shuffle algorithm, per group) --------- #
    slot = dispatch_slots(topi.reshape(b, s * k).to(torch.int32), e, cap)
    token_of = (torch.arange(s * k, device=x.device) // k).expand(b, s * k)
    # send buffer: buf_src[slot] = source token (sentinel s -> a zero row)
    buf_src = torch.full((b, e * cap + 1), s, dtype=torch.int64,
                         device=x.device)
    buf_src = buf_src.scatter_(1, slot, token_of)[:, :e * cap]
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    ex_in = gather_rows(x_pad, buf_src).reshape(b, e, cap, d)
    ex_out = _experts(params["experts"], ex_in)

    # --- combine: each (token, choice) reads its own slot ---------------- #
    out_pad = torch.cat([ex_out.reshape(b, e * cap, d),
                         ex_out.new_zeros((b, 1, d))], dim=1)
    vals = gather_rows(out_pad, slot)                          # (B, S*k, D)
    y = (vals.reshape(b, s, k, d)
         * topv.reshape(b, s, k, 1).to(vals.dtype)).sum(dim=2)
    if m.num_shared:
        y = y + mlp(params["shared"], x, act="silu")
    return y, aux


def moe_apply_shuffle(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      model_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token dispatch through the dataframe engine's shuffle, over
    ``model_size`` ranks stacked on one device.

    The paper's mechanism on the model's critical path.  Rank ``r`` owns
    sequence slice ``r`` of every batch row (the reference's ``in_specs``
    ``P(batch, model, None)`` with the data axis whole) and experts
    ``[r * E / ms, (r + 1) * E / ms)``.  It routes its (token-vector,
    local-expert, provenance) rows to the expert-owning ranks with
    ``dataframe.shuffle`` over ``cfg.moe.communicator`` (``xla``, ``ring``
    or ``bruck``), groups them by local expert (ranks from
    ``radix_partition``), runs the expert FFN, and shuffles the results
    back by provenance.  The aux loss is the reference's global formula.

    ``moe_apply`` does not take this path: the reference picks it under
    sharding rules, which arrive with ROADMAP item 13.6.
    """
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    ms = model_size
    if e % ms or s % ms:
        raise ValueError(f"moe_apply_shuffle: {e} experts and {s} positions "
                         f"must both divide over {ms} ranks")
    e_loc, s_l = e // ms, s // ms
    t, tk = b * s_l, b * s_l * k
    comm = get_communicator(m.communicator, ms)
    dev = x.device
    xt = x.reshape(b, ms, s_l, d).transpose(0, 1).reshape(ms, t, d)

    # --- route (each rank's tokens) -------------------------------------- #
    probs = torch.softmax(xt.float() @ params["router"], dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1, sorted=True)     # (ms, t, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # global load-balance aux: the sums over every rank's tokens
    tok_sum = F.one_hot(topi.reshape(-1), e).float().sum(0)
    prob_sum = probs.reshape(-1, e).sum(0)
    n_tok = float(ms * t)
    aux = m.router_aux_weight * e * torch.sum(
        (tok_sum / (n_tok * k)) * (prob_sum / n_tok)) * k

    # --- outbound shuffle: rows = (x-vector, local expert, provenance) -- #
    flat_e = topi.reshape(ms, tk).to(torch.int32)
    ranks = torch.arange(ms, dtype=torch.int32, device=dev)
    rows = Table({
        "x": xt.repeat_interleave(k, dim=1),                   # (ms, tk, d)
        "eloc": flat_e % e_loc,
        "srcslot": torch.arange(tk, dtype=torch.int32,
                                device=dev).expand(ms, tk),
        "src": ranks[:, None].expand(ms, tk),
    }, torch.full((ms,), tk, dtype=torch.int32, device=dev))
    cap_send = max(8, -(-int(m.capacity_factor * tk) // (8 * ms)) * 8)
    recv, _ = df_shuffle(rows, comm, dest=flat_e // e_loc,
                         bucket_capacity=cap_send,
                         out_capacity=ms * cap_send)
    del rows

    # --- core local operator: group by local expert, batched FFN ------- #
    rcap = ms * cap_send
    valid = recv.valid_mask()
    eloc = torch.where(valid, recv.col("eloc"), e_loc)
    rank, _ = radix_partition(eloc, e_loc + 1)
    # per-local-expert capacity: 2x the balanced share, never more than
    # the total rows that can arrive (tight when e_loc == 1)
    cap2 = min(max(8, -(-int(rcap * 2) // (8 * e_loc)) * 8),
               -(-rcap // 8) * 8)
    slot = torch.where((eloc < e_loc) & (rank < cap2),
                       eloc.long() * cap2 + rank, e_loc * cap2)
    buf = scatter_rows(e_loc * cap2, slot, recv.col("x"))
    recv = recv.select(("srcslot", "src"))      # the rows' vectors are in buf
    # rank r's experts are rows [r * e_loc, (r + 1) * e_loc) of the weights
    ex_out = _experts(params["experts"], buf.reshape(e, cap2, d))
    del buf
    # un-group: each received row reads its slot (dropped -> a zero row)
    out_pad = torch.cat([ex_out.reshape(ms, e_loc * cap2, d),
                         ex_out.new_zeros((ms, 1, d))], dim=1)
    del ex_out
    vals = gather_rows(out_pad, slot)                          # recv order
    del out_pad

    # --- return shuffle by provenance ------------------------------------ #
    back, _ = df_shuffle(Table({"y": vals, "srcslot": recv.col("srcslot")},
                               recv.row_count), comm,
                         dest=torch.where(valid, recv.col("src"), ms),
                         bucket_capacity=cap_send, out_capacity=tk)
    del recv, vals

    # --- combine at the source ------------------------------------------- #
    bslot = torch.where(back.valid_mask(), back.col("srcslot").long(), tk)
    y_rows = scatter_rows(tk, bslot, back.col("y").to(x.dtype))
    y = (y_rows.reshape(ms, t, k, d)
         * topv.reshape(ms, t, k, 1).to(x.dtype)).sum(dim=2)
    y = y.reshape(ms, b, s_l, d).transpose(0, 1).reshape(b, s, d)
    if m.num_shared:
        y = y + mlp(params["shared"], x, act="silu")
    return y, aux


def moe_apply_einsum(params: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GShard one-hot einsum dispatch (oracle for small shapes).

    Capacity ranks are computed per batch-row group so drop behaviour
    matches ``moe_apply`` exactly.
    """
    m = cfg.moe
    b, t, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = expert_capacity(cfg, t)
    topv, topi, aux = _route(params, x, cfg)                   # (B, S, k)

    flat_e = topi.reshape(b, t * k)
    oh = F.one_hot(flat_e, e)                                  # (B, T*k, E)
    # stable rank of each (token, choice) within its expert queue
    rank = torch.gather(torch.cumsum(oh, dim=1) - oh, 2,
                        flat_e[..., None])[..., 0]
    slot_oh = F.one_hot(torch.where(rank < cap, rank, cap),
                        cap + 1)[..., :cap].to(x.dtype)
    exp_oh = F.one_hot(flat_e, e).to(x.dtype)
    disp_tk = exp_oh[..., None] * slot_oh[..., None, :]        # (B,T*k,E,C)
    disp = disp_tk.reshape(b, t, k, e, cap).sum(2)             # (B,T,E,C)
    comb = (disp_tk * topv.reshape(b, t * k)[..., None, None]
            ).reshape(b, t, k, e, cap).sum(2)

    ex_in = torch.einsum("btec,btd->becd", disp, x)
    ex_out = _experts(params["experts"], ex_in)
    y = torch.einsum("btec,becd->btd", comb, ex_out)
    if m.num_shared:
        y = y + mlp(params["shared"], x, act="silu")
    return y, aux
