"""Tests of the port's pipeline schedules that need a CUDA card: a small
f32 LM over pp 2, two rank processes on card 0 (gloo: NCCL takes one card
per rank), one step under each of the four schedules against one
process's step on the CPU (the plain attention). Elsewhere they skip.

On the card (the repository's conftest imports jax, which that machine
need not have, hence ``--noconftest``)::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_cuda_pipeline.py

Tolerances as ``tests/test_torch_cuda_layouts.py``'s: the loss 1e-5
relative, the parameters after one Adam step (lr 1e-3) at rtol 5e-3, atol
5e-4."""

import pytest
import torch

from ddstore_tpu_torch.models import transformer as ttr

from torch_pp_workers import pipeline_cuda
from torch_workers import spawn

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return spawn(2, pipeline_cuda, str(tmp_path_factory.mktemp("ppcuda")),
                 timeout=400)


@pytest.mark.parametrize("schedule", ttr.PP_SCHEDULES)
def test_pp_step_on_card_matches_one_process(ranks, schedule):
    r0, r1 = ranks[0][schedule], ranks[1][schedule]
    assert r0["loss"] == r1["loss"]
    assert abs(r0["loss"] - r0["cpu_loss"]) <= 1e-5 * abs(r0["cpu_loss"])
    assert r0["worst"] <= 5e-4, r0["worst"]
    # each rank's stage ran the forward kernel: 2 layers x 2 microbatches
    assert r0["launches"] == r1["launches"] == 4
