"""Mixture-of-experts MLP, ported from the JAX package's ``models/moe.py``
with the experts replicated (no expert parallelism: ROADMAP.md queue A item
6.4 part 2).

GShard/Switch routing as JAX writes it, einsums and not gathers:

- Tokens route within fixed-size groups: each group is the largest divisor
  of the token count that is at most ``group_size``, and each expert takes
  ``C = min(group, ceil(k·group·capacity_factor / E))`` tokens a group.
- The router runs in f32 (softmax over the expert logits, top-k with ties
  to the lower index); with k = 2 the two gates are renormalized.
- Slots come from a cumulative count in choice-major order (every token's
  first choice before any second choice), taken in f32: bf16 counts go
  wrong past 256. Tokens past an expert's capacity get an all-zero one-hot
  row and so contribute nothing (the residual carries them).
- Dispatch and combine are one-hot einsums in the model dtype; the experts'
  MLPs are batched einsums over (E, d, h) and (E, h, d).
- The load-balancing loss is Switch eq. 4, ``E · Σ_e f_e · P_e`` over all
  tokens (f_e: the share of first choices on e; P_e: the mean router
  probability). JAX sows it into ``intermediates``; here each layer hands it
  to the innermost :func:`collect_aux` context, and ``SigLIP.forward``
  returns the mean of every layer's as ``loss_params["moe_aux"]``.

``EP_AXIS`` keeps JAX's axis name; nothing shards over it in the port.
"""

from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_sigmoid_loss_tpu_torch.models.transformer import checkpoint_name
from distributed_sigmoid_loss_tpu_torch.ops import quant as quant_ops

__all__ = [
    "MoeMlp",
    "EP_AXIS",
    "router_topk",
    "build_dispatch",
    "expert_apply",
    "moe_capacity",
    "moe_group",
    "collect_aux",
]

EP_AXIS = "ep"

_AUX = contextvars.ContextVar("moe_aux", default=None)


@contextlib.contextmanager
def collect_aux():
    """Collect the router aux losses of the MoE layers run inside: yields the
    list they are appended to. Outside such a context (a recompute in the
    backward, serving) a layer's aux goes nowhere."""
    auxes: list[torch.Tensor] = []
    token = _AUX.set(auxes)
    try:
        yield auxes
    finally:
        _AUX.reset(token)


def router_topk(xg: torch.Tensor, wr: torch.Tensor, k: int):
    """Router in f32: ``(probs, gates, idx)`` for grouped tokens (n, g, d)
    and router weights (d, E). The top k by a stable descending sort, so
    ties take the lower expert, as ``lax.top_k``."""
    logits = torch.einsum("ntd,de->nte", xg.float(), wr.float())
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[..., :k], idx[..., :k]
    if k > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    return probs, gates, idx


def moe_capacity(group: int, e: int, k: int, capacity_factor: float) -> int:
    """Static per-expert buffer: ``min(group, ceil(k·group·cf / E))``."""
    return min(group, max(1, int(-(-k * group * capacity_factor // e))))


def moe_group(tokens: int, group_size: int) -> int:
    """The routing group: the largest divisor of ``tokens`` at most
    ``group_size``."""
    return max(g for g in range(1, min(group_size, tokens) + 1) if tokens % g == 0)


def _one_hot(index: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an all-zero row where ``index`` is out of [0, n)."""
    inside = (index >= 0) & (index < n)
    hot = F.one_hot(torch.where(inside, index, n).long(), n + 1)[..., :n]
    return hot.to(dtype)


def build_dispatch(gates: torch.Tensor, idx: torch.Tensor, e: int, capacity: int,
                   dtype=torch.float32):
    """One-hot dispatch and combine tensors (n, g, E, C) from the router's
    top-k choices, in ``dtype``; the slot arithmetic in f32."""
    n_groups, group, k = idx.shape
    choice = _one_hot(idx.movedim(-1, 1), e, torch.float32)            # (n, k, g, E)
    position = (torch.cumsum(choice.reshape(n_groups, k * group, e), dim=1)
                - 1.0).reshape(n_groups, k, group, e)
    slot = (position * choice).sum(dim=-1).to(torch.int32)           # (n, k, g)
    choice_onehot = choice.to(dtype)
    slot_onehot = _one_hot(slot, capacity, dtype)                    # (n, k, g, C)
    if k == 1:
        dispatch = torch.einsum("nte,ntc->ntec", choice_onehot[:, 0], slot_onehot[:, 0])
        combine = dispatch * gates.to(dtype)[..., 0][:, :, None, None]
        return dispatch, combine
    per_choice = torch.einsum("nkte,nktc->nktec", choice_onehot, slot_onehot)
    combine = torch.einsum("ntk,nktec->ntec", gates.to(dtype), per_choice)
    return per_choice.sum(dim=1), combine


def expert_apply(xg, dispatch, combine, wi, wo, dtype, quant: str = ""):
    """Dispatch einsum, each expert's MLP (tanh GELU), combine einsum, in the
    model dtype. ``quant``: ``"int8"`` runs the two expert products through
    :func:`~distributed_sigmoid_loss_tpu_torch.ops.quant.int8_expert_matmul`
    (inference), ``"int8_ste"`` through its straight-through twin; the
    one-hot einsums stay in the model dtype. The hidden activation carries
    the ``mlp_hidden`` tag, as the dense MLP's."""
    expert_in = torch.einsum("ntec,ntd->encd", dispatch.to(dtype), xg.to(dtype))
    if quant:
        if quant == "int8_ste":
            def matmul(a, b):
                return quant_ops.Int8ExpertMatmulSTE.apply(a, b, dtype)
        else:
            def matmul(a, b):
                return quant_ops.int8_expert_matmul(a, b, dtype)
        with checkpoint_name("mlp_hidden"):
            hidden = matmul(expert_in, wi)
        h = F.gelu(hidden, approximate="tanh")
        return torch.einsum("ntec,encd->ntd", combine.to(dtype), matmul(h, wo))
    wi_d, wo_d = wi.to(dtype), wo.to(dtype)
    with checkpoint_name("mlp_hidden"):
        hidden = torch.einsum("encd,edh->ench", expert_in, wi_d)
    h = F.gelu(hidden, approximate="tanh")
    expert_out = torch.einsum("ench,ehd->encd", h, wo_d)
    return torch.einsum("ntec,encd->ntd", combine.to(dtype), expert_out)


class MoeMlp(nn.Module):
    """Drop-in MoE replacement for the dense ``Mlp``: ``router`` (d, E),
    ``wi`` (E, d, h) and ``wo`` (E, h, d) in JAX's layout (f32 parameters;
    the expert products in ``dtype``, the router in f32). ``num_selected``:
    k (1 = Switch, 2 = renormalized top-2); ``group_size``: the routing
    group's target; ``quant``: "" | "int8" | "int8_ste"."""

    def __init__(self, width: int, mlp_ratio, num_experts: int, dtype, *,
                 num_selected: int = 1, capacity_factor: float = 1.25, group_size: int = 512,
                 quant: str = "", device=None, generator=None):
        super().__init__()
        if num_selected not in (1, 2):
            raise ValueError(f"num_selected must be 1 or 2, got {num_selected}")
        if num_experts < 2:
            raise ValueError(f"num_experts must be >= 2, got {num_experts}")
        if group_size < 1:
            raise ValueError(f"group_size must be >= 1, got {group_size}")
        self.width, self.num_experts, self.dtype = width, num_experts, dtype
        self.num_selected, self.capacity_factor = num_selected, capacity_factor
        self.group_size, self.quant = group_size, quant
        hidden = int(round(width * mlp_ratio))
        e = num_experts
        self.router = nn.Parameter(torch.empty(width, e, device=device))
        self.wi = nn.Parameter(torch.empty(e, width, hidden, device=device))
        self.wo = nn.Parameter(torch.empty(e, hidden, width, device=device))
        if generator is not None:
            self.router.data.normal_(0.0, 0.02, generator=generator)
            # flax xavier_uniform over (E, in, out): the expert axis is the
            # receptive field.
            for t, fan_in, fan_out in ((self.wi, width, hidden), (self.wo, hidden, width)):
                bound = math.sqrt(6.0 / (e * (fan_in + fan_out)))
                t.data.uniform_(-bound, bound, generator=generator)

    def forward(self, x):
        d, e, k = self.width, self.num_experts, self.num_selected
        *lead, d_in = x.shape
        if d_in != d:
            raise ValueError(f"input dim {d_in} != width {d}")
        tokens = math.prod(lead)
        group = moe_group(tokens, self.group_size)
        xg = x.reshape(tokens // group, group, d)
        probs, gates, idx = router_topk(xg, self.router, k)
        capacity = moe_capacity(group, e, k, self.capacity_factor)
        dispatch, combine = build_dispatch(gates, idx, e, capacity, dtype=self.dtype)
        # Taken in every call: a recompute under selective checkpointing must
        # run the forward's ops in the forward's order.
        first = _one_hot(idx[..., 0], e, torch.float32)
        aux = e * (first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1))).sum()
        auxes = _AUX.get()
        if auxes is not None:
            auxes.append(aux)
        y = expert_apply(xg, dispatch, combine, self.wi, self.wo, self.dtype, quant=self.quant)
        return y.reshape(*lead, d)
