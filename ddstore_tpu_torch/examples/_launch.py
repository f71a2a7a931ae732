"""Process start-up shared by the examples: pick the card, join the
store's group and, with more than one rank, a ``torch.distributed`` job
for the gradients."""

from __future__ import annotations

import os


def launch(device: str):
    """Returns ``(group, ddp_group, dev)``: the store's process group, the
    ``torch.distributed`` group for DDP (None for one rank) and the
    device this rank computes on. ``device`` is ``"cuda"`` or ``"cpu"``.

    Under a scheduler (``DDSTORE_COORDINATOR``/``DDSTORE_NUM_PROCESSES``/
    ``DDSTORE_PROCESS_ID``, SLURM, LSF, or ``DDSTORE_POD_AUTODETECT=1``
    with torchrun's environment) ``pod_bootstrap`` brings up
    torch.distributed; otherwise ranks of a file rendezvous
    (``DDSTORE_RDV_DIR``) start one through the same directory."""
    import torch
    import torch.distributed as dist

    from ddstore_tpu_torch.rendezvous import (FileGroup, auto_group,
                                              detect_pod_env, pod_bootstrap)

    cuda = device == "cuda"
    if cuda:
        # before any CUDA call: one card per process where there are enough
        rank_hint = int(os.environ.get(
            "LOCAL_RANK", os.environ.get("DDSTORE_RANK", "0")))
        torch.cuda.set_device(rank_hint % torch.cuda.device_count())
    scheduled = detect_pod_env() is not None or \
        os.environ.get("DDSTORE_POD_AUTODETECT") == "1"
    group = pod_bootstrap() if scheduled else auto_group()
    world, rank = group.size, group.rank
    # NCCL takes one card per rank; ranks that share a card use gloo
    backend = "nccl" if cuda and world <= torch.cuda.device_count() \
        else "gloo"
    if world > 1 and not dist.is_initialized():
        if not isinstance(group, FileGroup):
            raise RuntimeError(f"no torch.distributed job for the "
                               f"{type(group).__name__} of {world}")
        # the store's file rendezvous directory carries the job's as well
        dist.init_process_group(
            backend, init_method=f"file://{group.root}/torch_pg",
            rank=rank, world_size=world)
    ddp_group = dist.group.WORLD if world > 1 else None
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda \
        else torch.device("cpu")
    return group, ddp_group, dev


def one_process_group(dev) -> None:
    """A ``torch.distributed`` group of this process alone (NCCL on the
    card, gloo on the CPU), for a one-rank run of a path that exchanges
    through a group. Left by :func:`finish`."""
    import socket

    import torch.distributed as dist

    if dist.is_initialized():
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)


def finish(store) -> None:
    """Close the store and leave the ``torch.distributed`` job."""
    import torch.distributed as dist

    store.close()
    if dist.is_initialized():
        dist.destroy_process_group()
