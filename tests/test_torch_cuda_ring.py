"""Tests of the port's ring attention that need a CUDA card: two rank
processes on card 0 in a gloo world (NCCL takes one card per rank), the
ring against the whole sequence in one ``flash_attention`` call on the
card, the kernels' launches per rank, and a remat step against a plain
one over the ring. Elsewhere they skip.

On the card (the repository's conftest imports jax, which that machine
need not have, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda_ring.py

Tolerances: bf16 out, dq, dk and dv within 2e-2 of each row's L2 norm
of the one call's, lse 1e-2 (``chip_smoke.py`` holds the ring at full
size against the f32 result instead); remat against no remat in f32
1e-6 (the same kernels and products recomputed)."""

import pytest
import torch

from torch_workers import ring_cuda, spawn

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return spawn(2, ring_cuda, str(tmp_path_factory.mktemp("ring_cuda")))


def test_ring_on_card_matches_whole_sequence(ranks):
    for r in ranks:
        assert r["lse"] <= 1e-2
        assert all(e <= 2e-2 for e in r["rel"].values()), r["rel"]


def test_ring_launches_per_rank(ranks):
    # rank i runs i + 1 live steps; a chunk in its future launches nothing
    for i, r in enumerate(ranks):
        assert r["launches"] == [i + 1] * 3


def test_remat_step_matches_plain_step(ranks):
    for r in ranks:
        assert r["remat_max_diff"] <= 1e-6
