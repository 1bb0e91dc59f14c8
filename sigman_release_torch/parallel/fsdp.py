"""FSDP2 over 'data' and tensor parallelism over 'model' for the DiT (port
of the JAX package's ``DiTTrainer.fsdp_shardings``,
``training/dit_trainer.py``).

The JAX package shards every leaf of the parameters and the optimizer state
over 'data' (ZeRO / FSDP under GSPMD) and, on a mesh with a 'model' axis,
splits the transformer blocks Megatron-style: the q / k / v and FFN-in
kernels and biases by output features, the attention-out and FFN-out
kernels by input features. Here:

* 'model': ``parallelize_module`` with ``ColwiseParallel`` on
  ``attn1.to_q / to_k / to_v`` and ``ff.net.0.proj`` and ``RowwiseParallel``
  on ``attn1.to_out.0`` and ``ff.net.2`` of each block
  (:func:`tensor_parallel_plan`), so each rank holds ``heads / model``
  heads and ``4 d / model`` FFN features, and each sublayer ends in one
  all-reduce. The per-head q / k norms then see only this rank's heads:
  they become :class:`SplitHeadsNorm`, which sums their weights' gradients
  over 'model' in the backward.
* 'data': ``fully_shard`` on each transformer block and on the root. Each
  parameter, its gradient and its AdamW moments live as a DTensor shard
  on dim 0 (padded to a multiple of the data size). JAX shards a Flax
  kernel [in, out] on its first divisible dim; an ``nn.Linear`` weight is
  [out, in]: the layouts differ, the arithmetic does not.

:func:`full_state_dict` / :func:`load_full_state_dict` carry the whole
tensors in and out of a sharded trainer, so that its state file is the one
a single process writes. They gather with :func:`full` (one classic
``all_reduce``) and cut with :func:`shard_like` (no communication), not
with ``torch.distributed.checkpoint``'s state-dict functions or
``DTensor.full_tensor``: those all-gather through DTensor's functional
collectives, and the functional all-gather kills the rank over gloo on
CUDA tensors in torch 2.11, the layout ``chip_smoke.py`` runs two ranks
on one card with.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from sigman_release_torch.models.dit import RMSNormPerHead

# the blocks' submodules split by output (column) features; the others of
# ATTENTION and the FFN's ff.net.2 by input (row) features
COLUMN = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "ff.net.0.proj")
ATTENTION = ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0")
# f32 bytes per parameter element: the weight and AdamW's two moments
STATE_BYTES = 12


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def tensor_parallel_plan(model: nn.Module, n_model: int) -> Dict[str, object]:
    """{submodule name: ParallelStyle} of the DiT's blocks over a 'model'
    axis of ``n_model``: the attention's four linears where the head count
    divides by it, the FFN's two where its width does (the JAX package's
    ``% n_model`` tests); nothing else is split."""
    from torch.distributed.tensor.parallel import (
        ColwiseParallel,
        RowwiseParallel,
    )

    plan: Dict[str, object] = {}
    if n_model <= 1:
        return plan
    for i, block in enumerate(model.transformer_blocks):
        split = []
        if block.attn1.heads % n_model == 0:
            split += ATTENTION
        if block.ff.net[0].proj.out_features % n_model == 0:
            split += ("ff.net.0.proj", "ff.net.2")
        for name in split:
            style = ColwiseParallel() if name in COLUMN else RowwiseParallel()
            # every rank holds the same weights: cut them, scatter nothing
            style.src_data_rank = None
            plan[f"transformer_blocks.{i}.{name}"] = style
    return plan


def shard_dit(model: nn.Module, mesh) -> nn.Module:
    """``model`` (a whole ``DiTModel``, the same weights on every rank)
    sharded in place over ``mesh`` (``parallel/mesh.py``): tensor
    parallelism over 'model' first, then ``fully_shard`` of each
    transformer block and of the root over 'data'."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor.parallel import parallelize_module

    device_type = next(model.parameters()).device.type
    dmesh = mesh.device_mesh(device_type)
    plan = tensor_parallel_plan(model, mesh.model_size)
    if plan:
        parallelize_module(model, dmesh["model"], plan)
        group = mesh.group("model")
        for block in model.transformer_blocks:
            attn = block.attn1
            if attn.heads % mesh.model_size == 0:
                attn.norm_q = SplitHeadsNorm(attn.norm_q, group)
                attn.norm_k = SplitHeadsNorm(attn.norm_k, group)
    data = dmesh["data"]
    for block in model.transformer_blocks:
        fully_shard(block, mesh=data)
    fully_shard(model, mesh=data)
    return model


class SumGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class SplitHeadsNorm(RMSNormPerHead):
    """An ``RMSNormPerHead`` (its weight, the same on every rank of
    ``group``) over this rank's share of the heads: the weight's gradient
    is summed over ``group`` in the backward."""

    def __init__(self, norm: RMSNormPerHead, group):
        super().__init__(norm.weight.numel(), norm.eps)
        self.weight, self.group = norm.weight, group

    def applied_weight(self) -> torch.Tensor:
        return SumGrad.apply(self.weight, self.group)


def shards(t) -> int:
    """How many distinct pieces a DTensor is cut into (1 for a plain
    tensor)."""
    if not is_sharded(t):
        return 1
    return math.prod(t.device_mesh.size(i)
                     for i, p in enumerate(t.placements)
                     if not (p.is_replicate() or p.is_partial()))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all ``grads`` together. Sharded (DTensor) gradients
    count each element once over the world: each rank sums the squares of
    its local pieces, each weighted by 1 / (the ranks holding that piece),
    and one all-reduce adds the ranks' sums."""
    local = [g.to_local() for g in grads]
    world = dist.get_world_size()
    norms = torch._foreach_norm(local)
    weights = torch.tensor([shards(g) / world for g in grads],
                           device=norms[0].device)
    sq = (torch.stack(norms).float().square() * weights).sum()
    dist.all_reduce(sq)
    return sq.sqrt()


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local piece (a plain tensor itself)."""
    return t.to_local() if is_sharded(t) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor, on every rank (a collective over the
    world: every rank calls it in the same order), or a plain tensor
    itself. One holder of each piece (on rank 0's copy of the DTensor's
    mesh, at index 0 of each replicated mesh dim) writes it into zeros,
    and one ``all_reduce`` adds them: exact, and on the classic
    collectives (DTensor's own all-gather rides a functional collective
    that crashes over gloo on CUDA tensors in torch 2.11)."""
    if not is_sharded(t):
        return t
    mesh = t.device_mesh
    piece = t.to_local()
    out = torch.zeros(t.shape, dtype=t.dtype, device=piece.device)
    holder = bool((mesh.mesh == 0).any()) and all(
        mesh.get_local_rank(i) == 0
        for i, p in enumerate(t.placements) if p.is_replicate())
    if holder:
        out[_slices(t)] = piece
    dist.all_reduce(out)
    return out


def _slices(like) -> tuple:
    """The index of this rank's piece of DTensor ``like`` in the whole."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset,
    )

    shape, offset = compute_local_shape_and_global_offset(
        like.shape, like.device_mesh, like.placements)
    return tuple(slice(o, o + s) for s, o in zip(shape, offset))


def shard_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The whole tensor ``value`` cut as ``like`` is: this rank's piece of
    it as a DTensor of ``like``'s mesh and placements (no communication),
    or ``value`` on ``like``'s device and dtype for a plain ``like``."""
    if not is_sharded(like):
        return value.to(like.device, like.dtype)
    from torch.distributed.tensor import DTensor

    piece = value[_slices(like)].to(like.device, like.dtype)
    return DTensor.from_local(piece.contiguous(), like.device_mesh,
                              like.placements, run_check=False,
                              shape=like.shape, stride=like.stride())


def sharded_state_bytes(model: nn.Module,
                        opt: torch.optim.Optimizer) -> Dict[str, float]:
    """This rank's bytes of parameter pieces, of AdamW's moments (their
    pieces) and of its step counts, and the analytic model of the first
    two: the sum over the parameters of numel x 12 B / (pieces of that
    parameter)."""
    params = list(model.parameters())
    state = [t for p in params for t in opt.state.get(p, {}).values()
             if torch.is_tensor(t)]

    def nbytes(ts):
        return sum(local(t).numel() * local(t).element_size() for t in ts)

    return {"params": nbytes(params),
            "moments": nbytes(t for t in state if t.dim()),
            "steps": nbytes(t for t in state if not t.dim()),
            "analytic": sum(p.numel() * STATE_BYTES / shards(p)
                            for p in params)}


def full_state_dict(model: nn.Module, opt: torch.optim.Optimizer,
                    grads: Optional[List[Optional[torch.Tensor]]] = None):
    """(model state_dict, optimizer state_dict, gradients) as whole tensors
    on the CPU, keyed as a single process keys them (the optimizer by
    parameter index): on rank 0; the other ranks get (None, None, None).
    Every rank calls it (it gathers)."""
    rank0 = dist.get_rank() == 0

    def whole(t):
        t = full(t)
        return t.cpu() if rank0 else None

    model_sd = {n: whole(p.detach()) for n, p in model.named_parameters()}
    osd = opt.state_dict()
    params = [p for group in opt.param_groups for p in group["params"]]
    state = {i: {k: whole(v) if is_sharded(v) else v.cpu()
                 for k, v in osd["state"][i].items()}
             for i in range(len(params)) if i in osd["state"]}
    grads = None if grads is None else [
        None if g is None else whole(g) for g in grads]
    if not rank0:
        return None, None, None
    return model_sd, {"state": state,
                      "param_groups": osd["param_groups"]}, grads


def load_full_state_dict(model: nn.Module, model_sd: Dict[str, torch.Tensor],
                         opt: Optional[torch.optim.Optimizer] = None,
                         opt_sd: Optional[dict] = None):
    """Load whole tensors into a sharded ``model`` (every name) and, with
    ``opt_sd`` (keyed by parameter index, as a single process saves it),
    into ``opt``: each rank keeps its pieces; no communication."""
    with torch.no_grad():
        for n, p in model.named_parameters():
            local(p).copy_(local(shard_like(model_sd[n], p)))
    if opt_sd is None:
        return
    params = [p for group in opt.param_groups for p in group["params"]]
    opt.load_state_dict({
        "state": {i: {k: shard_like(v, params[i]) if v.dim() else v
                      for k, v in s.items()}
                  for i, s in opt_sd["state"].items()},
        "param_groups": opt_sd["param_groups"]})
