"""Mixture-of-experts MLP, ported from the JAX package's ``models/moe.py``,
with the experts replicated or sharded over an ``ep`` axis.

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

Expert parallelism (:func:`shard_experts`): JAX shards the stacked expert
weights (E, d, h) over the ``ep`` mesh axis and leaves GSPMD to insert the
all-to-alls. The port makes them explicit over the ``ep`` axis of the
ambient process grid (``EP_AXIS``). The ranks of an ep group hold the same
rows (the batch is split over dp only, as JAX's step shards it), and rank j
holds experts ``[j·E/ep, (j+1)·E/ep)``:

- every rank routes all of its tokens (the router and the aux loss are
  replicated, so the aux loss is taken over the same tokens as at ep = 1);
- the groups are split over the ranks (padded with empty groups to a
  multiple of ep), each rank dispatches its groups' token slots, and one
  differentiable ``all_to_all`` takes each expert's slots to the rank that
  holds it;
- each rank runs its experts on the slots of every rank's groups, a second
  ``all_to_all`` brings the outputs back, each rank combines its groups,
  and ``seq_gather`` joins the groups on every rank.

Entering by ``seq_scatter`` and leaving by ``seq_gather`` counts the
replicated part's gradient once, so every rank's gradient of the router and
of the layers around is JAX's global one, and an expert's gradient is the
sum over the slots of the whole ep group.
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
from distributed_sigmoid_loss_tpu_torch.parallel.collectives import (
    all_to_all,
    seq_gather,
    seq_scatter,
)
from distributed_sigmoid_loss_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    expert_axis,
)

__all__ = [
    "MoeMlp",
    "EP_AXIS",
    "router_topk",
    "build_dispatch",
    "expert_apply",
    "moe_capacity",
    "moe_group",
    "collect_aux",
    "shard_experts",
    "expert_params",
]

EP_AXIS = expert_axis

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


def _experts(expert_in, wi, wo, dtype, quant: str):
    """Each expert's MLP on its slots (E, n, C, d) → (E, n, C, d)."""
    if quant:
        if quant == "int8_ste":
            def matmul(a, b):
                return quant_ops.Int8ExpertMatmulSTE.apply(a, b, dtype)
        else:
            def matmul(a, b):
                return quant_ops.int8_expert_matmul(a, b, dtype)
        with checkpoint_name("mlp_hidden"):
            hidden = matmul(expert_in, wi)
        return matmul(F.gelu(hidden, approximate="tanh"), wo)
    with checkpoint_name("mlp_hidden"):
        hidden = torch.einsum("encd,edh->ench", expert_in, wi.to(dtype))
    return torch.einsum("ench,ehd->encd", F.gelu(hidden, approximate="tanh"), wo.to(dtype))


def expert_apply(xg, dispatch, combine, wi, wo, dtype, quant: str = "", ep_axis=None):
    """Dispatch einsum, each expert's MLP (tanh GELU), combine einsum, in the
    model dtype. ``quant``: ``"int8"`` runs the two expert products through
    :func:`~distributed_sigmoid_loss_tpu_torch.ops.quant.int8_expert_matmul`
    (inference), ``"int8_ste"`` through its straight-through twin; the
    one-hot einsums stay in the model dtype. The hidden activation carries
    the ``mlp_hidden`` tag, as the dense MLP's.

    With ``ep_axis``, ``wi`` and ``wo`` are this rank's experts and the
    slots travel by all-to-all (see the module docstring; over an axis of
    one rank the collectives are identities); ``xg``, ``dispatch`` and
    ``combine`` are the same on every rank of the axis, and so is the
    result."""
    if ep_axis is None:
        expert_in = torch.einsum("ntec,ntd->encd", dispatch.to(dtype), xg.to(dtype))
        expert_out = _experts(expert_in, wi, wo, dtype, quant)
        return torch.einsum("ntec,encd->ntd", combine.to(dtype), expert_out)
    group = axis_group(ep_axis)
    ep = axis_size(group)
    n = xg.shape[0]
    pad = -n % ep

    def mine(t):  # this rank's groups of a replicated (n, ...) tensor
        t = F.pad(t, (0, 0) * (t.dim() - 1) + (0, pad)) if pad else t
        return seq_scatter(t, ep_axis, dim=0, group=group)

    expert_in = torch.einsum("ntec,ntd->encd", mine(dispatch.to(dtype)), mine(xg.to(dtype)))
    # (E, n/ep, C, d) -> this rank's E/ep experts over every rank's groups.
    expert_in = all_to_all(expert_in, ep_axis, split_axis=0, concat_axis=1, group=group)
    expert_out = _experts(expert_in, wi, wo, dtype, quant)
    expert_out = all_to_all(expert_out, ep_axis, split_axis=1, concat_axis=0, group=group)
    y = torch.einsum("ntec,encd->ntd", mine(combine.to(dtype)), expert_out)
    return seq_gather(y, ep_axis, dim=0, group=group)[:n]


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
        self.ep_axis = None  # set by shard_experts
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
        y = expert_apply(xg, dispatch, combine, self.wi, self.wo, self.dtype, quant=self.quant,
                         ep_axis=self.ep_axis)
        return y.reshape(*lead, d)


def shard_experts(model: nn.Module, axis_name: str = EP_AXIS, group=None) -> nn.Module:
    """Keep this rank's experts of every MoE layer of ``model``, in place:
    rank j of the axis keeps experts ``[j·E/ep, (j+1)·E/ep)`` of ``wi`` and
    ``wo``, and the layers route through the axis. Every rank must hold the
    same whole model before (as :func:`~distributed_sigmoid_loss_tpu_torch.train.create_train_state`
    makes it). Returns ``model``."""
    group = axis_group(axis_name, group)
    ep, j = axis_size(group), axis_index(group)
    for layer in model.modules():
        if not isinstance(layer, MoeMlp):
            continue
        if layer.ep_axis is not None:
            raise ValueError("the experts are already sharded")
        if layer.num_experts % ep:
            raise ValueError(
                f"--ep {ep} must divide --moe-experts {layer.num_experts} "
                f"(expert kernels are stacked (E, ...) and sharded over ep)"
            )
        per = layer.num_experts // ep
        for name in ("wi", "wo"):
            whole = getattr(layer, name)
            setattr(layer, name, nn.Parameter(whole.detach()[j * per:(j + 1) * per].clone()))
        layer.ep_axis = axis_name
    return model


def expert_params(model: nn.Module) -> set[str]:
    """The names of ``model``'s parameters sharded over ep by
    :func:`shard_experts`."""
    return {f"{mod_name}.{p}" for mod_name, layer in model.named_modules()
            if isinstance(layer, MoeMlp) and layer.ep_axis is not None for p in ("wi", "wo")}
