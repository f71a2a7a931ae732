"""Message-passing GNN for atomistic property regression and its
data-parallel train step (the port of ``ddstore_tpu/models/gnn.py``).

Edge-conditioned message passing with residual node updates and a
masked mean readout, over batches packed into fixed node/edge budgets
(:func:`ddstore_tpu_torch.data.graphs.pack_graph_batch`). Numerics follow
the flax reference:

* the dense layers keep f32 parameters and compute in ``compute_dtype``
  (bf16 by default), input, kernel and bias all cast, as flax
  ``Dense(dtype=...)`` does; the readout MLP is f32;
* messages are summed per destination node in ``compute_dtype`` (as
  ``jax.ops.segment_sum`` on bf16 input does), with ``index_add``;
* ``ln{l}`` runs in f32 with eps 1e-6 and is cast back.

The reference ``vmap``-s the per-slot model over the batch's leading
slot axis. Here the D slots are flattened into one graph: node indices
are offset by ``d * NB`` and graph segments by ``d * (G + 1)``, so a
batch is one gather, one scatter and a few matmuls a layer, not D loops.
Padding edges point at node 0 and are zeroed by ``edge_mask`` before the
scatter; padding nodes are zeroed after every layer and land in each
slot's trash segment G, which the readout drops.

The submodules carry the flax names (``embed``, ``msg{l}_{0,1}``,
``upd{l}_{0,1}``, ``ln{l}``, ``readout_{0,1}``), so
:mod:`ddstore_tpu_torch.weights` maps the trees one to one.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.nn import functional as F
from torch.nn.parallel import DistributedDataParallel

from .._device import resolve_device
from ..data.graphs import GraphBatch
from . import transformer
from .transformer import LN_EPS, TrainState, _dense, _layer_norm
from .vae import _allreduce_sum, _fsdp_state, place_fsdp

__all__ = ["GraphBatch", "MPNN", "apply_batch", "loss_fn",
           "create_train_state", "make_train_step", "make_eval_step"]


class MPNN(nn.Module):
    """``forward(nodes, edge_src, edge_dst, edge_attr, edge_mask, node_seg,
    node_mask)`` on a batch of D packed slots (the :class:`GraphBatch`
    fields, leading axis D) -> (D, n_graphs, out_dim) f32 predictions.
    ``fn``/``fe`` are the node and edge feature widths (flax infers them
    at init). ``device`` defaults to the card."""

    def __init__(self, hidden: int = 64, layers: int = 3, out_dim: int = 1,
                 n_graphs: int = 8, fn: int = 8, fe: int = 4,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        self.hidden, self.layers, self.out_dim = hidden, layers, out_dim
        self.n_graphs = n_graphs
        self.compute_dtype = compute_dtype
        self.embed = nn.Linear(fn, hidden, device=device)
        for l in range(layers):
            self.add_module(f"msg{l}_0", nn.Linear(2 * hidden + fe, hidden,
                                                   device=device))
            self.add_module(f"msg{l}_1", nn.Linear(hidden, hidden,
                                                   device=device))
            self.add_module(f"upd{l}_0", nn.Linear(2 * hidden, hidden,
                                                   device=device))
            self.add_module(f"upd{l}_1", nn.Linear(hidden, hidden,
                                                   device=device))
            self.add_module(f"ln{l}", nn.LayerNorm(hidden, eps=LN_EPS,
                                                   device=device))
        self.readout_0 = nn.Linear(hidden, hidden, device=device)
        self.readout_1 = nn.Linear(hidden, out_dim, device=device)

    @property
    def device(self) -> torch.device:
        return self.embed.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "MPNN":
        """Random weights from ``generator`` (on the generator's device):
        kernels ~ N(0, 1/fan_in), biases 0, LayerNorm scale 1."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)
            else:
                r = torch.randn(p.shape, generator=generator,
                                device=generator.device)
                p.copy_(r / math.sqrt(p.shape[1]))
        return self

    def _mlp(self, name: str, x: torch.Tensor, dt: torch.dtype
             ) -> torch.Tensor:
        x = F.relu(_dense(getattr(self, f"{name}_0"), x, dt))
        return _dense(getattr(self, f"{name}_1"), x, dt)

    def forward(self, nodes, edge_src, edge_dst, edge_attr, edge_mask,
                node_seg, node_mask) -> torch.Tensor:
        D, nb = nodes.shape[:2]
        G, dt = self.n_graphs, self.compute_dtype
        dev = nodes.device
        node_off = (torch.arange(D, device=dev) * nb)[:, None]
        src = (edge_src.long() + node_off).reshape(-1)
        dst = (edge_dst.long() + node_off).reshape(-1)
        seg = (node_seg.long()
               + (torch.arange(D, device=dev) * (G + 1))[:, None]
               ).reshape(-1)
        emask = edge_mask.reshape(-1, 1)
        nmask = node_mask.reshape(-1, 1)
        n = D * nb

        h = _dense(self.embed, nodes.reshape(n, -1), dt)
        e = edge_attr.reshape(src.shape[0], -1).to(dt)
        for l in range(self.layers):
            msg_in = torch.cat([h.index_select(0, src),
                                h.index_select(0, dst), e], dim=-1)
            msg = torch.where(emask, self._mlp(f"msg{l}", msg_in, dt), 0)
            agg = msg.new_zeros(n, self.hidden).index_add(0, dst, msg)
            upd = self._mlp(f"upd{l}", torch.cat([h, agg], dim=-1), dt)
            h = _layer_norm(getattr(self, f"ln{l}"), h + upd).to(dt)
            h = torch.where(nmask, h, 0)
        # Masked mean readout per graph; padding nodes carry node_seg == G,
        # landing in each slot's trash segment, which is sliced off.
        ns = D * (G + 1)
        g_sum = h.new_zeros(ns, self.hidden, dtype=torch.float32).index_add(
            0, seg, h.float())
        counts = h.new_zeros(ns, dtype=torch.float32).index_add(
            0, seg, node_mask.reshape(-1).float())
        g_sum = g_sum.reshape(D, G + 1, self.hidden)[:, :G]
        counts = counts.reshape(D, G + 1)[:, :G]
        g = g_sum / torch.clamp(counts[..., None], min=1.0)
        return self._mlp("readout", g, torch.float32)  # (D, G, out_dim)


def apply_batch(model: nn.Module, batch: GraphBatch) -> torch.Tensor:
    """The model on a :class:`GraphBatch` of tensors -> (D, G, out_dim)."""
    return model(batch.nodes, batch.edge_src, batch.edge_dst,
                 batch.edge_attr, batch.edge_mask, batch.node_seg,
                 batch.node_mask)


def _masked_se(pred: torch.Tensor, y: torch.Tensor,
               graph_mask: torch.Tensor) -> torch.Tensor:
    se = torch.sum((pred - y) ** 2, dim=-1)
    return torch.where(graph_mask, se, 0.0).sum()


def loss_fn(pred: torch.Tensor, y: torch.Tensor,
            graph_mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE, averaged over real graphs."""
    return _masked_se(pred, y, graph_mask) / torch.clamp(
        graph_mask.sum(), min=1)


def create_train_state(model: MPNN, lr: float = 1e-3, mesh=None
                       ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Adam over the model's parameters at ``lr`` with optax's defaults,
    as ``optax.adam(lr)``; returns (state, opt). With a ``mesh`` whose
    ``fsdp`` axis is larger than 1 (the reference's ZeRO-3 for the GNN,
    ``gnn.py:108-131``) the parameters are first placed by FSDP2
    (``vae.place_fsdp``)."""
    return place_fsdp(model, lr, mesh)


def _global_se_and_count(se: torch.Tensor, graph_mask: torch.Tensor,
                         group) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed squared error and the number of real graphs (at least
    1), each summed over ``group`` in one all-reduce."""
    stats = torch.stack([se.detach(), graph_mask.sum().to(se.dtype)])
    if group is not None:
        dist.all_reduce(stats, group=group)
    return stats[0], torch.clamp(stats[1], min=1.0)


def make_train_step(model: MPNN, opt: torch.optim.Optimizer, group=None,
                    state: Optional[TrainState] = None
                    ) -> Callable[[GraphBatch], torch.Tensor]:
    """The train step ``step(batch) -> loss`` on a :class:`GraphBatch` of
    tensors: the masked MSE, its gradients, one ``opt`` update; the
    parameters and optimizer state change in place. Returns the loss,
    detached.

    ``group`` (a ``torch.distributed`` process group) makes the step
    data-parallel, as the reference's step over a ``dp`` mesh is: the
    model is wrapped in ``DistributedDataParallel`` with a hook that sums
    the gradients, and each rank divides its summed squared error by the
    group's count of real graphs (all-reduced with the summed error,
    between the forward and the backward), so the summed gradients are
    those of the loss over the global batch for any split of real graphs
    between the ranks. The loss returned is that global loss. Every rank
    must call the step the same number of times.

    With a ZeRO-3 ``state`` (:func:`create_train_state` over an ``fsdp``
    mesh) the step runs without DDP over the data ranks (``dp`` and
    ``fsdp``): FSDP2 sums the gradients, the count of real graphs is
    all-reduced over them as above, and each rank passes its slots of
    the global batch."""
    net = model
    zero3 = _fsdp_state(state)
    if zero3 is not None:
        group = zero3[0]
    elif group is not None:
        dev = model.device
        net = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=group)
        net.register_comm_hook(group, _allreduce_sum)

    def step(batch: GraphBatch) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        se = _masked_se(apply_batch(net, batch), batch.y, batch.graph_mask)
        se_all, n = _global_se_and_count(se, batch.graph_mask, group)
        (se / n).backward()
        if zero3 is not None:
            transformer.all_reduce_gradients(zero3[1], 1, zero3[0])
        opt.step()
        if state is not None:
            state.step += 1
        return se_all / n

    return step


def make_eval_step(model: MPNN, group=None
                   ) -> Callable[[GraphBatch], torch.Tensor]:
    """``step(batch) -> loss`` without gradients: the masked MSE of the
    batch, over the global batch of ``group`` when one is given."""

    @torch.no_grad()
    def step(batch: GraphBatch) -> torch.Tensor:
        se = _masked_se(apply_batch(model, batch), batch.y, batch.graph_mask)
        se_all, n = _global_se_and_count(se, batch.graph_mask, group)
        return se_all / n

    return step
