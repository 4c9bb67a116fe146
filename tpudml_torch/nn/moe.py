"""Mixture-of-Experts FFN: the port of ``tpudml/nn/moe.py`` (one card).

Top-k routing (k=1 Switch, k>1 GShard) with a static expert capacity C;
choice-priority slot assignment in f32; three dispatches over the same
routing:

- ``"gather"``: each (token, choice) gets a flat slot in [0, E·C)
  (sentinel E·C when capacity drops it); dispatch and combine are row
  gathers whose backwards are the INVERSE gathers (no scatter-add);
- ``"einsum"``: the GShard one-hot formulation of the same slot
  assignment, kept as the parity oracle;
- ``"ragged"``: DROPLESS — (token, choice) pairs sorted by expert run the
  expert FFN over contiguous row slabs (``ops.moe_kernel``); no capacity,
  no drops. ``ragged_dw="grouped"`` takes dW1/dW2 from the grouped-dW
  kernel (``ragged_ffn``), ``"stock"`` leaves them to autograd through the
  per-slab matmuls (the A/B arm; no kernel).

The expert FFN is relu (the dense model's FFN is gelu). The router runs
in f32 on the tokens (promoted, as JAX does with bf16 tokens and an f32
router kernel); gates are f32; the combine result is cast to the tokens'
dtype. ``forward`` returns ``(y, aux)``: the Switch load-balancing term of
this call (differentiable through the router's probabilities).

Parameters keep the JAX layouts and names: ``router.kernel`` [d, E] and
``experts.{w1 [E, d, h], b1 [E, h], w2 [E, h, d], b2 [E, d]}``. With
``compute_dtype`` the experts' parameters are cast to it where used and the
router stays f32 (JAX's ``keep_f32``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpudml_torch.nn.layers import cast, uniform_fan_in
from tpudml_torch.ops.moe_kernel import ragged_ffn, ragged_matmul

DISPATCHES = ("gather", "einsum", "ragged")
RAGGED_DW = ("grouped", "stock")
EP_NOT_PORTED = ("expert parallelism (axis_name) is not ported yet (ROADMAP.md "
                 "queue 1 item 5, EP, the next slice)")


def _pad0(rows: torch.Tensor) -> torch.Tensor:
    """Append one zero row: the landing pad for sentinel indices."""
    return torch.cat([rows, rows.new_zeros((1, rows.shape[-1]))])


def _switch_aux(frac, probs, num_experts: int):
    """Switch/GShard load-balance loss E · Σ_e frac_e · p̄_e (=1 uniform)."""
    return num_experts * torch.sum(frac * probs.mean(dim=0))


class _PermuteRows(torch.autograd.Function):
    """Dispatch gather ``out[s] = tokens_pad[token_src[s]]``; the slot map
    is injective, so the backward is the inverse gather over ``flat_dst``
    [G, k] (sentinel S rides the appended zero row)."""

    @staticmethod
    def forward(ctx, tokens_pad, token_src, flat_dst):
        ctx.save_for_backward(flat_dst)
        ctx.n_pad = tokens_pad.shape[0]
        return tokens_pad[token_src]

    @staticmethod
    def backward(ctx, dy):
        (flat_dst,) = ctx.saved_tensors
        d_tok = _pad0(dy)[flat_dst].sum(dim=1)
        d_pad = dy.new_zeros((ctx.n_pad - d_tok.shape[0], dy.shape[-1]))
        return torch.cat([d_tok, d_pad]), None, None


class _CombineRows(torch.autograd.Function):
    """Combine gather ``y[g] = Σ_j w[g, j] · expert_flat[flat_dst[g, j]]``;
    the backward wrt ``expert_flat`` is again the inverse gather (each
    slot's gate from a [S] scalar scatter, then one row gather)."""

    @staticmethod
    def forward(ctx, expert_flat, w, flat_dst, token_src):
        ctx.save_for_backward(expert_flat, w, flat_dst, token_src)
        rows = _pad0(expert_flat)[flat_dst]  # [G, k, d]
        return torch.einsum("gk,gkd->gd", w, rows.to(w.dtype))

    @staticmethod
    def backward(ctx, dy):
        expert_flat, w, flat_dst, token_src = ctx.saved_tensors
        s_total = expert_flat.shape[0]
        rows = _pad0(expert_flat)[flat_dst]  # re-gathered, not kept
        dw = torch.einsum("gd,gkd->gk", dy, rows.to(dy.dtype)).to(w.dtype)
        # Gate seen by each slot (collisions only on the sliced-off sentinel).
        w_src = w.new_zeros((s_total + 1,))
        w_src[flat_dst.reshape(-1)] = w.reshape(-1)
        dy_tok = _pad0(dy)[token_src]  # [S, d]
        d_expert = (w_src[:s_total, None] * dy_tok).to(expert_flat.dtype)
        return d_expert, dw, None, None


class _Router(nn.Module):
    def __init__(self, d: int, e: int, generator):
        super().__init__()
        self.kernel = nn.Parameter(uniform_fan_in((d, e), d, generator))


class _Experts(nn.Module):
    def __init__(self, d: int, e: int, h: int, generator):
        super().__init__()
        self.w1 = nn.Parameter(uniform_fan_in((e, d, h), d, generator))
        self.b1 = nn.Parameter(uniform_fan_in((e, h), d, generator))
        self.w2 = nn.Parameter(uniform_fan_in((e, h, d), h, generator))
        self.b2 = nn.Parameter(uniform_fan_in((e, d), h, generator))


class MoELayer(nn.Module):
    """Top-k mixture-of-experts FFN over [..., embed_dim] inputs (module
    docstring). ``top_k=1`` gates with the raw top-1 probability (Switch);
    ``top_k>1`` renormalizes the chosen k (GShard), scales capacity by k,
    and choice 0 claims buffer slots before choice 1. Ties in the router's
    probabilities go to the lower expert index, as ``lax.top_k``'s do.
    ``axis_name`` (expert parallelism) is not ported and raises."""

    def __init__(self, embed_dim: int, num_experts: int, mlp_ratio: int = 4,
                 capacity_factor: float = 1.25, top_k: int = 1,
                 axis_name: str | None = None, dispatch: str = "gather",
                 ragged_dw: str = "grouped", *,
                 compute_dtype: torch.dtype | None = None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} must be in [1, num_experts={num_experts}]")
        if dispatch not in DISPATCHES:
            raise ValueError(f"dispatch must be 'gather', 'einsum', or 'ragged', got "
                             f"{dispatch!r}")
        if ragged_dw not in RAGGED_DW:
            raise ValueError(f"ragged_dw must be 'grouped' or 'stock', got {ragged_dw!r}")
        if axis_name is not None:
            raise NotImplementedError(EP_NOT_PORTED)
        self.embed_dim = embed_dim
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.top_k = top_k
        self.dispatch = dispatch
        self.ragged_dw = ragged_dw
        self.compute_dtype = compute_dtype
        self.router = _Router(embed_dim, num_experts, generator)
        self.experts = _Experts(embed_dim, num_experts, mlp_ratio * embed_dim, generator)

    def _capacity(self, n_tokens: int) -> int:
        return max(1, int(n_tokens * self.top_k * self.capacity_factor / self.num_experts
                          + 0.5))

    def _route(self, tokens):
        """(probs [G, E] f32-or-wider, topv, topi [G, k]): the router in the
        promoted dtype, top-k with ties to the lower expert index."""
        kernel = self.router.kernel
        ct = torch.promote_types(tokens.dtype, kernel.dtype)
        probs = torch.softmax(tokens.to(ct) @ kernel.to(ct), dim=-1)
        # A stable descending sort keeps equal probabilities in index order.
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        return probs, vals[:, :self.top_k], idx[:, :self.top_k]

    def _expert_params(self):
        w = self.experts
        return tuple(cast(p, self.compute_dtype) for p in (w.w1, w.b1, w.w2, w.b2))

    def forward(self, x: torch.Tensor):
        shape = x.shape
        d, e, k = self.embed_dim, self.num_experts, self.top_k
        tokens = x.reshape(-1, d)
        g = tokens.shape[0]
        cap = self._capacity(g)
        probs, topv, topi = self._route(tokens)
        gates = topv if k == 1 else topv / (topv.sum(dim=-1, keepdim=True) + 1e-9)

        if self.dispatch == "ragged":
            y = self._ragged(tokens, topi, gates)
            frac = F.one_hot(topi, e).float().sum(dim=1).mean(dim=0) / k
            return y.reshape(shape), _switch_aux(frac, probs, e)

        s_total = e * cap
        flat_dst, kept, choice_sum = self._assign_slots(topi, cap)
        w_eff = gates * kept.to(gates.dtype)

        if self.dispatch == "gather":
            # Invert the injective (token, choice) -> slot map; collisions
            # land only on the sentinel entry, which the slice drops.
            token_src = torch.full((s_total + 1,), g, dtype=torch.long, device=x.device)
            token_src[flat_dst.reshape(-1)] = torch.arange(
                g, device=x.device).repeat_interleave(k)
            token_src = token_src[:s_total]
            expert_in = _PermuteRows.apply(_pad0(tokens), token_src, flat_dst)
            expert_in = expert_in.reshape(e, cap, d)
        else:
            oh = F.one_hot(flat_dst, s_total + 1).float()[:, :, :s_total]
            disp = oh.sum(dim=1).reshape(g, e, cap)
            combine = torch.einsum("gks,gk->gs", oh, w_eff).reshape(g, e, cap)
            expert_in = torch.einsum("gec,gd->ecd", disp.to(tokens.dtype), tokens)
        w1, b1, w2, b2 = self._expert_params()
        ct = torch.promote_types(expert_in.dtype, w1.dtype)  # as einsum promotes
        expert_in, w1, b1, w2, b2 = (t.to(ct) for t in (expert_in, w1, b1, w2, b2))
        hidden = F.relu(torch.bmm(expert_in, w1) + b1[:, None, :])
        expert_out = torch.bmm(hidden, w2) + b2[:, None, :]
        if self.dispatch == "gather":
            y = _CombineRows.apply(expert_out.reshape(s_total, d), w_eff, flat_dst,
                                   token_src).to(tokens.dtype)
        else:
            y = torch.einsum("gec,ecd->gd", combine.to(expert_out.dtype), expert_out)
        frac = choice_sum.mean(dim=0) / k
        return y.reshape(shape), _switch_aux(frac, probs, e)

    def _assign_slots(self, topi, cap: int):
        """Choice-priority slot assignment: choice 0 claims buffer slots for
        all tokens, in token order, before choice 1 sees what is left.
        Bookkeeping in f32 (bf16 holds integers exactly only to 256).
        Returns flat_dst [G, k] (e·cap + slot, sentinel E·cap when
        dropped), kept [G, k] in {0, 1} and choice_sum [G, E] (Σ_j
        onehot_j, for the aux loss)."""
        g = topi.shape[0]
        e = self.num_experts
        counts = torch.zeros((e,), dtype=torch.float32, device=topi.device)
        choice_sum = torch.zeros((g, e), dtype=torch.float32, device=topi.device)
        flat_dst, kept_flags = [], []
        for j in range(self.top_k):
            onehot = F.one_hot(topi[:, j], e).float()
            choice_sum = choice_sum + onehot
            pos = counts[None, :] + torch.cumsum(onehot, dim=0) - onehot
            kept = onehot * (pos < cap)
            slot = (pos * onehot).sum(dim=-1).long()
            kept_g = kept.sum(dim=-1)
            flat_dst.append(torch.where(kept_g > 0, topi[:, j] * cap + slot, e * cap))
            kept_flags.append(kept_g)
            counts = counts + kept.sum(dim=0)
        return torch.stack(flat_dst, dim=1), torch.stack(kept_flags, dim=1), choice_sum

    def _ragged(self, tokens, topi, gates):
        """Dropless expert FFN over (token, choice) pairs sorted by expert."""
        g = tokens.shape[0]
        e, k = self.num_experts, self.top_k
        p = g * k
        eids = topi.reshape(p)
        order = torch.argsort(eids, stable=True)  # same-expert pairs in token order
        inv = torch.empty_like(order)
        inv[order] = torch.arange(p, device=tokens.device)
        group_sizes = torch.bincount(eids, minlength=e).to(torch.int32)
        token_src = order // k
        flat_dst = inv.reshape(g, k)
        x_sorted = _PermuteRows.apply(_pad0(tokens), token_src, flat_dst)
        w1, b1, w2, b2 = self._expert_params()
        ct = torch.promote_types(x_sorted.dtype, w1.dtype)
        onehot = F.one_hot(eids[order], e).to(ct)
        x_sorted, w1, b1, w2, b2 = (t.to(ct) for t in (x_sorted, w1, b1, w2, b2))
        if self.ragged_dw == "grouped":
            out_sorted = ragged_ffn(x_sorted, w1, b1, w2, b2, onehot, group_sizes)
        else:  # "stock": autograd through the per-slab matmuls
            sizes = group_sizes.tolist()
            hidden = F.relu(ragged_matmul(x_sorted, w1, sizes) + onehot @ b1)
            out_sorted = ragged_matmul(hidden, w2, sizes) + onehot @ b2
        return _CombineRows.apply(out_sorted, gates, flat_dst, token_src).to(tokens.dtype)


def load_balancing_loss(params: dict, x: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss E · Σ_e fraction_e · mean_prob_e over
    ``x`` routed by ``params["router"]["kernel"]`` (argmax choice)."""
    tokens = x.reshape(-1, x.shape[-1])
    probs = torch.softmax(tokens @ params["router"]["kernel"], dim=-1)
    frac = F.one_hot(torch.argmax(probs, dim=-1), num_experts).to(probs.dtype).mean(dim=0)
    return _switch_aux(frac, probs, num_experts)
