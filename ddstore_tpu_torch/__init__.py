"""ddstore_tpu_torch: the PyTorch/CUDA port of ``ddstore_tpu``.

The modules keep the JAX package's names (``store``, ``data.dataset``,
``data.loader``, ``ops.attention``, ``models.transformer``,
``models.decode``, ...), so each has an obvious counterpart. The port
imports torch and numpy only, never jax or ``ddstore_tpu``. Entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``; on the card, every kernel the TPU package wrote in
Pallas is a CUDA kernel under ``ops/csrc/``, built at first use.
"""

from .rendezvous import ProcessGroup, SingleGroup
from .store import DDStore, DDStoreError

__all__ = ["DDStore", "DDStoreError", "ProcessGroup", "SingleGroup"]
