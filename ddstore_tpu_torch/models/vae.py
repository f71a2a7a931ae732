"""The MNIST-scale VAE and its data-parallel train step (the port of
``ddstore_tpu/models/vae.py``).

784 -> 400 -> (mu, logvar: 20, 20) -> 400 -> 784. Numerics follow the flax
reference: parameters are f32, the hidden layers compute in
``compute_dtype`` (bf16 by default) and the mu/logvar and logits heads in
f32; the loss is the binary cross-entropy with logits, summed, plus the
KL term; the optimizer is Adam 1e-3 with optax's defaults.

The reference's step differentiates the loss summed over the global
batch. :func:`make_train_step` with a ``torch.distributed`` group wraps
the model in ``DistributedDataParallel`` with a communication hook that
all-reduces the gradients as a sum (DDP's own averages them), so each
rank's gradient is that of the summed loss over the concatenated global
batch, and the returned loss is the all-reduced sum of the ranks' sums.
The reference draws ``eps`` from one key for the global batch; here each
rank draws its own from a ``torch.Generator``, or takes it as an
argument (its rows of the global ``eps``).

Over a mesh with an ``fsdp`` axis (the reference's ZeRO-3 for the VAE,
``vae.py:101-121``) the parameters and Adam's moments are sharded by FSDP2
(``parallel.fsdp.place_zero3``), its gradient reduction a sum, and the
step takes this rank's rows of the batch sharded over the data axes.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.parallel import DistributedDataParallel

from .._device import resolve_device
from ..parallel.mesh import axes_group, axis_size
from . import transformer
from .transformer import TrainState, _dense

__all__ = ["IMAGE_DIM", "HIDDEN", "LATENT", "Encoder", "Decoder", "VAE",
           "loss_fn", "create_train_state", "make_train_step",
           "make_eval_step"]

IMAGE_DIM = 784
HIDDEN = 400
LATENT = 20


class Encoder(nn.Module):
    def __init__(self, hidden: int = HIDDEN, latent: int = LATENT,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc = nn.Linear(IMAGE_DIM, hidden, device=device)
        self.fc_mu = nn.Linear(hidden, latent, device=device)
        self.fc_logvar = nn.Linear(hidden, latent, device=device)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        h = F.relu(_dense(self.fc, x, self.compute_dtype))
        return (_dense(self.fc_mu, h, torch.float32),
                _dense(self.fc_logvar, h, torch.float32))


class Decoder(nn.Module):
    def __init__(self, hidden: int = HIDDEN, out: int = IMAGE_DIM,
                 latent: int = LATENT,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.fc = nn.Linear(latent, hidden, device=device)
        self.fc_out = nn.Linear(hidden, out, device=device)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = F.relu(_dense(self.fc, z, self.compute_dtype))
        return _dense(self.fc_out, h, torch.float32)


class VAE(nn.Module):
    """``forward(x, eps=None, generator=None)`` on (B, ...) images in
    [0, 1] -> (logits (B, 784), mu, logvar (B, 20)), all f32. ``eps`` is
    the (B, 20) reparameterisation noise, drawn from ``generator`` when
    not given. ``device`` defaults to the card."""

    def __init__(self, hidden: int = HIDDEN, latent: int = LATENT,
                 out: int = IMAGE_DIM,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.encoder = Encoder(hidden, latent, compute_dtype, device)
        self.decoder = Decoder(hidden, out, latent, compute_dtype, device)

    @property
    def device(self) -> torch.device:
        return self.decoder.fc_out.weight.device

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VAE":
        """Random weights from ``generator`` (on the generator's device):
        kernels ~ N(0, 1/fan_in), biases 0 (flax's lecun-normal scale)."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                r = torch.randn(p.shape, generator=generator,
                                device=generator.device)
                p.copy_(r / math.sqrt(p.shape[1]))
        return self

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        mu, logvar = self.encoder(x.reshape(x.shape[0], -1))
        std = torch.exp(0.5 * logvar)
        if eps is None:
            eps = torch.randn(mu.shape, generator=generator,
                              device=mu.device, dtype=mu.dtype)
        logits = self.decoder(mu + eps * std)
        return logits, mu, logvar

    def generate(self, z: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.decoder(z))


def loss_fn(logits: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
            logvar: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy with logits, summed, plus the KL term, in
    optax's form: ``relu(l) - l x + log1p(exp(-|l|))``."""
    x = x.reshape(x.shape[0], -1)
    bce = (F.relu(logits) - logits * x
           + torch.log1p(torch.exp(-logits.abs()))).sum()
    kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
    return bce + kld


def _dequantize(batch: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> f32 in [0, 1] on the batch's device, by true
    division by 255 (what torchvision's ToTensor computes); anything else
    passes through."""
    if batch.dtype == torch.uint8:
        return batch.float() / 255.0
    return batch


def create_train_state(model: VAE, lr: float = 1e-3, mesh=None
                       ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """Adam over the model's parameters at ``lr`` with optax's defaults,
    as ``optax.adam(lr)``; returns (state, opt). With a ``mesh`` whose
    ``fsdp`` axis is larger than 1, the parameters (the same on every
    rank) are first placed ZeRO-3 (:func:`place_fsdp`)."""
    return place_fsdp(model, lr, mesh)


def place_fsdp(model: nn.Module, lr: float, mesh
               ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """The VAE's and the GNN's state: ZeRO-3 over a mesh with an ``fsdp``
    axis (``parallel.fsdp.place_zero3`` with ``fsdp_rules``; the
    reduce-scatter sums, as the reference's summed gradients do), else
    unplaced (DDP replicates)."""
    if mesh is None or axis_size(mesh, "fsdp") == 1:
        state, opt = transformer.create_train_state(model, lr)
        state.mesh = mesh
        return state, opt
    from ..parallel.fsdp import place_zero3

    transformer._check_replicas(model)
    place_zero3(model, mesh, divide_factor=1.0)
    opt = transformer.adam(model.parameters(), lr)
    return TrainState(model, opt, mesh=mesh), opt


def _fsdp_state(state: Optional[TrainState]):
    """The data group and the gradients to reduce by hand (the ones FSDP
    left whole) of a ZeRO-3 state, or None."""
    if state is None or axis_size(state.mesh, "fsdp") == 1:
        return None
    group = axes_group(state.mesh, ("dp", "fsdp"))
    return group, [p for p in state.model.parameters()
                   if not transformer._fsdp_managed(p)]


def _allreduce_sum(group, bucket):
    """DDP communication hook: the bucket's gradients summed over the
    group (DDP's default divides by the world size)."""
    fut = dist.all_reduce(bucket.buffer(), group=group,
                          async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def make_train_step(model: VAE, opt: torch.optim.Optimizer,
                    group=None, state: Optional[TrainState] = None
                    ) -> Callable[..., torch.Tensor]:
    """The train step ``step(batch, eps=None, generator=None) -> loss``:
    the batch (uint8 pixels or floats in [0, 1]) is dequantized on its
    device, the summed loss differentiated, and ``opt`` applied; the
    parameters and optimizer state change in place. Returns the loss,
    detached.

    ``group`` (a ``torch.distributed`` process group, e.g.
    ``torch.distributed.group.WORLD``) makes the step data-parallel: the
    model is wrapped in ``DistributedDataParallel`` (which broadcasts
    rank 0's parameters once), gradients are summed over the group, and
    the loss returned is the sum over the group's batches. Every rank
    must call the step the same number of times.

    With a ZeRO-3 ``state`` (:func:`create_train_state` over an ``fsdp``
    mesh) the step runs without DDP: FSDP2 sums the gradients over the
    data ranks (``dp`` and ``fsdp``), each rank passes its rows of the
    global batch, and the loss returned is the sum over them."""
    net = model
    zero3 = _fsdp_state(state)
    if zero3 is not None:
        group = None
    if group is not None:
        dev = model.device
        net = DistributedDataParallel(
            model, device_ids=[dev.index] if dev.type == "cuda" else None,
            process_group=group)
        net.register_comm_hook(group, _allreduce_sum)

    def step(batch: torch.Tensor, eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _dequantize(batch)
        opt.zero_grad(set_to_none=True)
        logits, mu, logvar = net(x, eps=eps, generator=generator)
        loss = loss_fn(logits, x, mu, logvar)
        loss.backward()
        if zero3 is not None:
            transformer.all_reduce_gradients(zero3[1], 1, zero3[0])
        opt.step()
        loss = loss.detach()
        if group is not None:
            dist.all_reduce(loss, group=group)
        elif zero3 is not None and zero3[0] is not None:
            dist.all_reduce(loss, group=zero3[0])
        if state is not None:
            state.step += 1
        return loss

    return step


def make_eval_step(model: VAE, group=None) -> Callable[..., torch.Tensor]:
    """``step(batch, eps=None, generator=None) -> loss`` without
    gradients: the summed loss of the batch, summed over ``group`` when
    one is given."""

    @torch.no_grad()
    def step(batch: torch.Tensor, eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _dequantize(batch)
        logits, mu, logvar = model(x, eps=eps, generator=generator)
        loss = loss_fn(logits, x, mu, logvar)
        if group is not None:
            dist.all_reduce(loss, group=group)
        return loss

    return step
