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

Three dispatchers, as the reference; ``moe_apply`` picks the first two
as the reference picks them:

* ``moe_apply_shuffle`` under sequence-parallel training rules (a model
  axis, not ``tp_weights``, experts and positions dividing over it) --
  the dispatch through the dataframe engine's shuffle.  On a mesh it runs
  under ``local_map`` with the reference's ``in_specs`` / ``out_specs``,
  its shuffles over the mesh's ``model`` process group; with no mesh,
  over ``rules.model_size`` ranks stacked on one device (the in-process
  counterpart of ``shard_map`` over host devices);
* ``moe_apply_grouped`` elsewhere (no rules, serving rules) -- the
  grouped capacity dispatch, each batch row one group; on a mesh the
  bucketize and the combine run under ``local_map`` (the radix kernel
  takes local tensors) and the expert buffer is resharded onto the
  expert axis between them, the reference's all-to-all;
* ``moe_apply_einsum`` -- the GShard one-hot oracle, for small shapes.

Router: softmax top-k with renormalisation, the Switch load-balancing
auxiliary loss (on a mesh, the global formula over partial sums reduced
over every sharded axis), shared (always-on) experts.
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
from .layers import (NO_SHARDING, P, Params, ShardingRules, batch_axes,
                     constrain, dense_init, is_dtensor, local_map_on, mlp,
                     mlp_init, mlp_specs, partial_over)


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


def moe_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, Any]:
    """Experts over ``model`` (the shuffle dispatch's ``in_specs``), the
    router over ``fsdp``."""
    s: Dict[str, Any] = {
        "router": rules.logical("fsdp", None),
        "experts": {"w_gate": rules.logical("model", None, None),
                    "w_up": rules.logical("model", None, None),
                    "w_down": rules.logical("model", None, None)}}
    if cfg.moe.num_shared:
        s["shared"] = mlp_specs(rules)
    return s


def _router(router: torch.Tensor, x: torch.Tensor, k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(probs, topv, topi): softmax router probabilities over the
    experts and the renormalised top-k.  x: (..., D)."""
    probs = torch.softmax(x.float() @ router, dim=-1)          # (..., E)
    # the order of the k choices sets the flat index token * k + choice and
    # so every rank; ties in probability are where torch.topk and
    # jax.lax.top_k (lower index first) may order two choices apart
    topv, topi = torch.topk(probs, k, dim=-1, sorted=True)     # (..., k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return probs, topv, topi


def _route(params: Params, x: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (topv, topi, aux_loss).  x: (..., D)."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    probs, topv, topi = _router(params["router"], x, k)
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


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              rules: ShardingRules = NO_SHARDING
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE layer dispatcher.  x: (B, S, D) -> (y, aux).

    As the reference: under sequence-parallel training rules the token
    trip runs through the dataframe shuffle (``moe_apply_shuffle``),
    explicit all-to-alls of exactly the dispatched rows; elsewhere (no
    rules, TP serving) the grouped dispatch."""
    m = cfg.moe
    s = x.shape[1]
    if (rules.model is not None and not rules.tp_weights
            and m.num_experts % rules.model_size == 0
            and s % rules.model_size == 0):
        return moe_apply_shuffle(params, x, cfg, rules)
    return moe_apply_grouped(params, x, cfg, rules)


def _bucketize(x: torch.Tensor, topi: torch.Tensor, num_experts: int,
               cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ex_in (G, E, cap, D), slot (G, S*k)): each group's expert buffer
    holding row ``token`` of ``x`` (G, S, D) at the slot
    ``dispatch_slots`` gives each (token, choice) of ``topi`` (G, S, k)."""
    b, s, d = x.shape
    k = topi.shape[-1]
    e = num_experts
    slot = dispatch_slots(topi.reshape(b, s * k).to(torch.int32), e, cap)
    token_of = (torch.arange(s * k, device=x.device) // k).expand(b, s * k)
    # send buffer: buf_src[slot] = source token (sentinel s -> a zero row)
    buf_src = torch.full((b, e * cap + 1), s, dtype=torch.int64,
                         device=x.device)
    buf_src = buf_src.scatter_(1, slot, token_of)[:, :e * cap]
    x_pad = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)
    return gather_rows(x_pad, buf_src).reshape(b, e, cap, d), slot


def _combine(ex_out: torch.Tensor, slot: torch.Tensor, topv: torch.Tensor
             ) -> torch.Tensor:
    """Each (token, choice) reads its own slot of ``ex_out`` (G, E, cap,
    D) back (a dropped one reads a zero row), weighed by its router
    probability: (G, S, D)."""
    b, e, cap, d = ex_out.shape
    s, k = topv.shape[1], topv.shape[2]
    out_pad = torch.cat([ex_out.reshape(b, e * cap, d),
                         ex_out.new_zeros((b, 1, d))], dim=1)
    vals = gather_rows(out_pad, slot)                          # (B, S*k, D)
    return (vals.reshape(b, s, k, d)
            * topv.reshape(b, s, k, 1).to(vals.dtype)).sum(dim=2)


def _aux_from_sums(cfg: ModelConfig, tok_sum, prob_sum, n_tok: float,
                   mesh=None):
    """The reference's global load-balancing loss from the sums, over
    every token, of the top-k one-hots and of the router probabilities.
    On a mesh the sums arrive as partial sums and are reduced first."""
    m = cfg.moe
    if mesh is not None:
        from torch.distributed.tensor import Replicate
        rep = [Replicate()] * mesh.ndim
        tok_sum = tok_sum.redistribute(mesh, rep)
        prob_sum = prob_sum.redistribute(mesh, rep)
    e, k = m.num_experts, m.top_k
    return m.router_aux_weight * e * torch.sum(
        (tok_sum / (n_tok * k)) * (prob_sum / n_tok)) * k


def moe_apply_grouped(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      rules: ShardingRules = NO_SHARDING
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped capacity dispatch, each batch row a dispatch group.

    The (B, E, C, D) expert buffer holds row ``token`` of ``x`` at the slot
    ``dispatch_slots`` gives each (token, choice); the combine reads each
    (token, choice)'s own slot back (a dropped one reads a zero row) and
    weighs it by its renormalised router probability.  On a mesh the
    buffer goes from the batch-sharded groups to the expert-sharded
    layout and back (the reference's constraints), and the aux loss is
    the global formula over partial sums.
    """
    m = cfg.moe
    b, s, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = expert_capacity(cfg, s)
    x = constrain(x, rules, "batch", None, None)
    if not is_dtensor(x):
        topv, topi, aux = _route(params, x, cfg)               # (B, S, k)
        ex_in, slot = _bucketize(x, topi, e, cap)
        y = _combine(_experts(params["experts"], ex_in), slot, topv)
    else:
        mesh = x.device_mesh
        bspec = rules.logical("batch", None, None)
        part = partial_over(batch_axes(rules), mesh)

        def dispatch(xl, router):
            probs, topv, topi = _router(router, xl, k)
            ex_in, slot = _bucketize(xl, topi, e, cap)
            return (ex_in, slot, topv,
                    F.one_hot(topi.reshape(-1), e).float().sum(0),
                    probs.reshape(-1, e).sum(0))
        ex_in, slot, topv, tok_sum, prob_sum = local_map_on(
            dispatch, mesh,
            (rules.logical("batch", None, None, None),
             rules.logical("batch", None), bspec, part, part),
            (bspec, P(None, None)))(x, params["router"])
        aux = _aux_from_sums(cfg, tok_sum, prob_sum, float(b * s), mesh)
        # group -> expert resharding: the reference's all-to-all
        ex_in = constrain(ex_in, rules, "batch", "model", None, None)
        ex_out = constrain(_experts(params["experts"], ex_in), rules,
                           "batch", "model", None, None)
        y = local_map_on(_combine, mesh, bspec,
                         (rules.logical("batch", None, None, None),
                          rules.logical("batch", None), bspec))(
            ex_out, slot, topv)
    y = constrain(y, rules, "batch", None, None)
    if m.num_shared:
        y = y + mlp(params["shared"], x, act="silu", rules=rules)
    return y, aux


def _shuffle_dispatch(router: torch.Tensor, wg: torch.Tensor,
                      wu: torch.Tensor, wd: torch.Tensor, xt: torch.Tensor,
                      comm, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The shuffle dispatch of the ``h`` ranks ``comm`` holds here (all
    ``ms`` stacked, or one over a process group): xt (h, t, D), rank
    ``r``'s tokens; wg / wu / wd the experts of the ranks held, rank r's
    at rows ``[r * E / ms, (r + 1) * E / ms)``.  Returns (y (h, t, D), the
    sums over these ranks' tokens of the top-k one-hots (E,) and of the
    router probabilities (E,))."""
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    ms, h = comm.size(), comm.ranks_held()
    e_loc = e // ms
    t, d = xt.shape[1], xt.shape[2]
    tk = t * k
    dev = xt.device

    # --- route (each rank's tokens) -------------------------------------- #
    probs = torch.softmax(xt.float() @ router, dim=-1)
    topv, topi = torch.topk(probs, k, dim=-1, sorted=True)     # (h, t, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    tok_sum = F.one_hot(topi.reshape(-1), e).float().sum(0)
    prob_sum = probs.reshape(-1, e).sum(0)

    # --- outbound shuffle: rows = (x-vector, local expert, provenance) -- #
    flat_e = topi.reshape(h, tk).to(torch.int32)
    ranks = comm.rank(dev)                                     # (h,)
    rows = Table({
        "x": xt.repeat_interleave(k, dim=1),                   # (h, tk, d)
        "eloc": flat_e % e_loc,
        "srcslot": torch.arange(tk, dtype=torch.int32,
                                device=dev).expand(h, tk),
        "src": ranks[:, None].expand(h, tk),
    }, torch.full((h,), tk, dtype=torch.int32, device=dev))
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
    ex_out = _experts({"w_gate": wg, "w_up": wu, "w_down": wd},
                      buf.reshape(h * e_loc, cap2, d))
    del buf
    # un-group: each received row reads its slot (dropped -> a zero row)
    out_pad = torch.cat([ex_out.reshape(h, e_loc * cap2, d),
                         ex_out.new_zeros((h, 1, d))], dim=1)
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
    y_rows = scatter_rows(tk, bslot, back.col("y").to(xt.dtype))
    y = (y_rows.reshape(h, t, k, d)
         * topv.reshape(h, t, k, 1).to(xt.dtype)).sum(dim=2)
    return y, tok_sum, prob_sum


def moe_apply_shuffle(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      rules: ShardingRules
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token dispatch through the dataframe engine's shuffle.

    The paper's mechanism on the model's critical path.  Each (data,
    model) rank owns its sequence slice of its batch rows (the
    reference's ``in_specs`` ``P(batch, model, None)``) and experts
    ``[r * E / ms, (r + 1) * E / ms)`` of model rank ``r``.  It routes its
    (token-vector, local-expert, provenance) rows to the expert-owning
    ranks with ``dataframe.shuffle`` over ``cfg.moe.communicator``
    (``xla``, ``ring`` or ``bruck``), groups them by local expert (ranks
    from ``radix_partition``), runs the expert FFN, and shuffles the
    results back by provenance.  The aux loss is the reference's global
    formula.

    On a mesh (``x`` a DTensor) the body runs under ``local_map`` and the
    shuffles go over the mesh's ``model`` process group; with no mesh,
    over ``rules.model_size`` ranks stacked on one device (every batch
    row on each)."""
    m = cfg.moe
    b, s, d = x.shape
    e = m.num_experts
    ms = rules.model_size
    if e % ms or s % ms:
        raise ValueError(f"moe_apply_shuffle: {e} experts and {s} positions "
                         f"must both divide over {ms} ranks")
    w = params["experts"]
    x = constrain(x, rules, "batch", "model", None)
    if not is_dtensor(x):
        s_l = s // ms
        comm = get_communicator(m.communicator, ms)
        xt = x.reshape(b, ms, s_l, d).transpose(0, 1).reshape(ms, b * s_l, d)
        y, tok_sum, prob_sum = _shuffle_dispatch(
            params["router"], w["w_gate"], w["w_up"], w["w_down"], xt, comm,
            cfg)
        y = y.reshape(ms, b, s_l, d).transpose(0, 1).reshape(b, s, d)
        aux = _aux_from_sums(cfg, tok_sum, prob_sum, float(b * s))
    else:
        mesh = x.device_mesh
        comm = get_communicator(m.communicator, ms,
                                group=mesh.get_group(rules.model))

        def body(xl, router, wg, wu, wd):
            b_l, s_l, _ = xl.shape
            y, tok_sum, prob_sum = _shuffle_dispatch(
                router, wg, wu, wd, xl.reshape(1, b_l * s_l, d), comm, cfg)
            return y.reshape(b_l, s_l, d), tok_sum, prob_sum
        xspec = rules.logical("batch", "model", None)
        espec = rules.logical("model", None, None)
        part = partial_over(batch_axes(rules) + (rules.model,), mesh)
        y, tok_sum, prob_sum = local_map_on(
            body, mesh, (xspec, part, part),
            (xspec, P(), espec, espec, espec))(
                x, params["router"], w["w_gate"], w["w_up"], w["w_down"])
        aux = _aux_from_sums(cfg, tok_sum, prob_sum, float(b * s), mesh)
    if m.num_shared:
        y = y + mlp(params["shared"], x, act="silu", rules=rules)
    return y, aux


def moe_apply_einsum(params: Params, x: torch.Tensor, cfg: ModelConfig,
                     rules: ShardingRules = NO_SHARDING
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
    ex_in = constrain(ex_in, rules, "batch", "model", None, None)
    ex_out = _experts(params["experts"], ex_in)
    y = torch.einsum("btec,becd->btd", comb, ex_out)
    if m.num_shared:
        y = y + mlp(params["shared"], x, act="silu", rules=rules)
    return y, aux
