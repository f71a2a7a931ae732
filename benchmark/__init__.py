"""The benchmark of ``ddstore_tpu_torch``, the PyTorch and CUDA port:
store-fed training of GPT block LMs at published widths
on H100 cards. ``python3 -m benchmark.run --help`` runs one cell; the
folder's layout is in :mod:`benchmark.registry`. Nothing here imports
JAX or the JAX package."""
