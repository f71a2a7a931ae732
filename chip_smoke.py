#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ddstore_tpu_torch``) on one GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --ab PARENT   # kernel A/B against another tree

Run from the root of a checkout, on a machine with one CUDA card and the
CUDA toolkit (``nvcc`` under ``$CUDA_HOME``, default ``/usr/local/cuda``).
It needs no network and imports nothing of JAX or of ``ddstore_tpu``.

Phases; any failure raises and ends the run with a non-zero exit:

1. device: the card's name and power limit, TF32 off for matmuls and
   convolutions (the plain versions are then exact f32 references);
2. build: every CUDA kernel of the port, from the sources in the
   checkout (one ``nvcc`` per source, all started together); the ptxas
   report must show no register spills and no advisory of ptxas about
   ``wgmma`` (a serialised product, or a wait it injected: C75xx).
   Beside them, the store's native
   core (one ``g++`` per translation unit, all started together);
3. kernels: each kernel (flash forward, dq, dk/dv) against its plain
   PyTorch version on the card, at the main path's shapes and at edge
   cases (ragged tiles, fewer queries than a tile, offsets, fully-masked
   rows, keys no query sees, lse cotangents), dq and dk/dv also
   bit-identical over two launches, with timings of the kernel, the plain
   version and one library call (yardstick only);
4. small reference check: a small model on the card (kernels) against
   the same model on the CPU (plain versions): logits, loss, greedy
   tokens, every parameter's gradient, and the parameters after one
   Adam step;
5. serving slice, at the full width of the repo's LM config (vocab 32768,
   dim 1024, 16 heads, 8 layers; ``bench.py:3169``): 4096 token windows
   of 2048 in the store -> sampler -> loader -> card -> eval loss on 4
   batches of (8, 2048) -> greedy generation of 32 tokens after 8
   prompts of 2048. Launch counts are zeroed just before and read just
   after; the flash forward must have run 8 layers x 5 forwards = 40
   times, the backward kernels never. After the counted run, the prefill
   is timed over 5 repeats and one prefill and 4 decode steps run under
   torch.profiler;
6. training slice, same model width and the same windows: store ->
   sampler -> loader -> ``make_train_step`` (Adam, lr 1e-3) for 8 steps
   of (8, 2048), then one step with ``accum_steps=2``. Counts zeroed just
   before and read just after: each of the three kernels must have run
   8 x 8 + 2 x 8 = 80 times; losses finite and falling. After the counted
   run, the fused cross-entropy head is timed alone (its products on the
   bf16 tensor cores: 4 a vocab block, ``xent_tensor_core_products``),
   then held at both benchmark train cells' head shapes to its
   widened-f32 route, the one the CPU takes, and one more step runs
   under torch.profiler;
7. VAE DDP slice (``examples/vae_mnist.py`` at its defaults): a VAE step
   on the card against the same step on the CPU; then 2 rank processes
   (``spawn``), both on the one card, form a ``TorchGroup`` over gloo and
   a ``DDStore(backend="tcp")`` over it, register the two halves of
   ``synthetic_mnist(60000)`` (uint8, 47 MB), and train the VAE under
   ``DistributedDataParallel`` for one epoch at a global batch of 128 (468
   steps of 64 a rank) with an eval pass after it; the gradient
   all-reduce goes over gloo (NCCL refuses two ranks on one device).
   Checked: finite losses whose last 20 average below the first 20, both
   ranks' parameters bit-identical (a checksum gathered through the
   group), about half the rows read from the other rank, one staged
   batch equal to ``data[idx] / 255``, no attention kernel launched.
   After the counted epoch, both ranks read the same epoch through the
   host path again, untimed, for a digest of its batches, then train it
   through epoch-window readahead (2 windows of 8 batches): every staged
   batch's bytes must equal the host path's (the digest, taken after the
   epoch's clock stops), nothing may fall back, and no async read may
   stay in flight, nor after a readahead epoch cancelled after 10
   batches. Then 20 more steps run
   under torch.profiler on rank 0. Then a third epoch, of a fresh VAE,
   through the device-collective fetch: both ranks draw the same global
   batches of 128 (``DistributedSampler(n, 1, 0)``), each reads only the
   rows it owns and one ``all_to_all_single`` over the gloo group (on
   CUDA tensors) delivers each rank its 64. Checked: no fallback, one
   exchange per batch, no byte over TCP, the ranks' local reads summing
   to the epoch's bytes, about half of each rank's rows sent to the
   other, losses falling, parameters bit-identical, no attention launch,
   and (untimed, after the epoch's clock stops) the digest of the
   batches equal to ``get_batch`` of the same slices. Last, a one-process
   NCCL group runs 5 DDP steps, which must equal the same steps without
   DDP;
8. GNN DDP slice (``examples/gnn_molecules.py``: the MPNN at hidden 64,
   3 layers, bf16 dense layers, 8 graphs a slot, Adam lr 3e-3): an MPNN
   step on the card against the same step on the CPU in f32; in bf16,
   steps on the card (its atomic scatter, as the main path) and on the
   CPU, each against the CPU's f32 step, the card's error held within
   a factor of the CPU's;
   then 2 rank processes on the one card, as in phase 7, each register
   half of 133,885 QM9-shaped synthetic graphs (QM9's molecule count) as
   ragged variables and train the MPNN under DistributedDataParallel for
   1,024 steps of one slot a rank, then an eval pass of 64 batches.
   Checked: finite losses whose last 100 average below the first 100,
   both ranks' parameters bit-identical, about half the graphs read from
   the other rank (``owner_of_rows``), the first staged ``GraphBatch``
   equal field by field to ``pack_graph_batch`` of the same graphs read
   one at a time, no attention kernel launched. Then 20 profiled steps on
   rank 0, the step's parts timed alone, and 5 DDP steps in a
   one-process NCCL group held to the same steps without DDP (with
   PyTorch's deterministic algorithms: the scatter's atomics otherwise
   sum in a varying order);
9. device-collective fetch and shuffles: in a one-process NCCL group
   over a world-1 store, 20 loader batches through the collective path
   (exchange on the card) byte-equal to ``get_batch``, and
   ``global_shuffle_epoch``/``permute_rows`` on the card; the A/B of
   ``device_fetch_batch`` against ``get_batch`` + the copy to the card
   at the reference bench's geometry (32,768 x 64 f32, batches of 2,048,
   16 batches; every batch equal before it is timed) in that group and
   over phase 7's two gloo ranks; ``device_fetch_ragged_batch`` of the
   GNN's nodes in phase 8's ranks against ``get_ragged_batch`` +
   ``pad_ragged``; and last, in phase 7's ranks, ``host_global_shuffle``
   of the VAE variable, whose shards must be the plain seeded
   permutation of the rows, their multiset unchanged. The two-rank
   checks run in phases 7 and 8's rank processes after their counted
   epochs, so no other process is spawned;
10. elastic: 4 rank processes on the one card (``spawn``) over a
   ``FileGroup`` and the TCP store (read timeout 5 s, connect 3 s,
   barrier 60 s, ``DDSTORE_CMA=0``), each registering a quarter of
   ``synthetic_mnist(60000)`` and of a 10,000-row eval split. First the
   services: a 4 MiB quota for tenant "eval" on every rank, the split
   added under the tenant and a larger variable refused with
   ``ERR_QUOTA``; each rank reads the whole split through a
   ``gateway_session`` and a loader onto the card (its bytes equal to
   the handle's ``get_batch``, digest for digest) and computes the VAE's
   eval loss, with native tracing on; rank 0 merges the four trace dumps
   into Chrome JSON under ``chiprun_out/elastic/`` and pulls every
   rank's metric cells. Then every rank checkpoints its shard
   (``save_shard``) and trains its own VAE (full width, bf16 hidden
   layers, Adam 1e-3, local batch 64, no DDP) through a loader, saving
   model and Adam state asynchronously every 50 steps. Once rank 2 is
   past 100 steps with its step-100 save complete it is SIGKILLed; the
   survivors' loaders raise ``ERR_PEER_LOST`` and they call
   ``elastic_recover``; rank 2 is relaunched to ``elastic_rejoin`` from
   its shard file and ``restore_train_state`` onto the card, and a fresh
   process retakes its first step from the same checkpoint and batch.
   All four train 100 steps more, rank 0's last 20 under
   ``utils.profile.trace``. Checked: the refusal code, the session's
   bytes, the rejoined shard against its file, a fixed index set over
   every shard equal before and after, the restored parameters against
   the digest written at that save, every restored Adam state tensor
   (the 0-dim step counts included) on the device and in the dtype the
   saved optimizer had it, the first step bit for bit, losses
   falling on every rank, at least 20 ``ddstore:fetch`` and 20
   ``ddstore:stage`` ranges beside CUDA kernels in the trace, no
   attention launch. Any failed rank, or the phase deadline, kills
   every child. Before the phase, the main process times
   ``utils.profile.annotate`` alone, the span the loaders open around
   every fetch and stage, with no trace active.

11. long context (``lm_long_bench``'s configuration, ``bench.py:3247``:
   the LM above at B = 2, S = 8192): 2 rank processes on the one card
   over gloo, on a dp 1 x sp 2 mesh (``make_mesh``). First ring
   attention at (2, 16, 8192, 64) bf16 and (1, 2, 512, 64) f32, causal,
   each rank on its sequence chunk, forward and the gradients of
   sum(out * do), against the whole sequence in one call on the card
   (the forward kernel in bf16, ``mha_reference`` in f32), with the
   launches per rank (rank i runs i + 1 of each kernel: a chunk in its
   future launches nothing). Then 4,096 windows of 8,193 tokens (tokens
   and next tokens) in a TCP store, read through ``DeviceLoader(spec=
   ("dp", "sp"))`` (each rank stages its half of every row): the first
   step's loss and all-reduced gradients against one process's sp 1
   loss and gradients of the same weights and batch on rank 0; then the
   dp x sp train step with remat off, on, and
   ``dots_with_no_batch_dims_saveable``, 2 warm-up and 4 counted steps
   each (launch counts zeroed just before and read just after; rank 0's
   counted steps of the first under torch.profiler), the ranks' losses
   and parameter digests equal, remat's peak lower; the gradient
   all-reduce and one ring shift timed alone; ``generate`` with
   ``prefill_mesh`` on 2 prompts of 8,192 tokens (its first-token
   logits against the mesh-free ``generate`` on rank 0) and on a small
   f32 model (tokens equal to the mesh-free ones). In the main process,
   the same model at sp 1 without a mesh and in a one-process NCCL group
   (remat off and on), and each kernel at the ring's two chunk shapes
   (the diagonal chunk and the unmasked past chunk) against its plain
   version and SDPA.

12. MoE, expert and tensor parallelism, ZeRO-3 (ROADMAP items 13 and
   14): (a) in the main process, the LM above with 8 experts and top-2
   routing (638 M parameters) fed from phase 5's windows: its first
   step's loss against the same weights in f32 through the plain
   attention, and a padded ``generate`` with ``prompt_lengths`` on the
   f32 model (routing and tokens unchanged by the padding); then 2
   warm-up and 4 counted Adam steps of (8, 2048) (launches zeroed just
   before, read just after), tokens routed to each expert, the drop share
   and the aux of every layer, ``generate`` on 8 prompts of 2048 + 32
   (the first token equal to the full forward's argmax), and the decode
   step's MoE at batch 8 both ways (every expert, or a gather of each
   token's 2), timed in turns. (b) two rank processes on the card over
   gloo, each registering half of the windows in a TCP store, run the
   layouts ``ep2`` (the MoE LM), ``tp2`` and ``fsdp2`` (the dense LM) at
   B 2, S 2048 through ``DeviceLoader(spec=...)``: 1 warm-up and 3
   counted steps each; the first step's loss, gathered gradients and
   gathered parameters against one process's step from the same weights
   and batch on rank 0 (phase 11's tolerances; a bias that starts at 0
   by the share of its elements moved the other way), the ranks' losses
   equal, peak memory per rank beside one process's, the collectives'
   calls and bytes of a step and each layout's collective timed alone.
   Then each kernel at tp 2's heads, (2, 8, 2048, 64), against its plain
   version and SDPA.

13. pipeline parallelism (ROADMAP item 15): two rank processes on the
   card over gloo, each registering half of the windows in a TCP store,
   fed by ``DeviceLoader`` (dp 1, both stages read the same rows), run the
   LM above over pp 2 (``create_pp_train_state``, ``make_pp_train_step``)
   under ``gpipe`` and ``1f1b`` at M 4 x 2 x 2048 and ``interleaved`` and
   ``interleaved_1f1b`` at V 2: 1 warm-up and 3 counted steps each
   (launches zeroed just before, read just after: each rank's 4 layers x
   4 microbatches x 4 steps of every kernel), one more under
   torch.profiler on rank 0 for its busy share. The first step's loss,
   gathered gradients and updated parameters against one process's
   ``make_train_step`` on the same weights and batch (phase 11's
   tolerances, phase 12's rule for leaves that start at 0), the ranks'
   losses equal; median step, tokens/s, MFU, peak per rank, one hand-off
   (2, 2048, 1024) bf16 timed alone and the expected bubble printed. Then
   ``lm_from_stages`` and ``generate`` on rank 0 (the first token equal to
   the full forward's argmax); GPipe and 1F1B at M 8 (1F1B's peak below
   GPipe's on both ranks); and the MoE LM under 1F1B over pp 2, 1 warm-up
   and 2 steps, held to one process's pp 1 1F1B over the same
   microbatches.

14. MoE and fsdp over a split sequence (ROADMAP item 20): (a) two rank
   processes on the card over gloo, fed as phase 11 (B 2, S 8192 through
   ``DeviceLoader(spec=("dp", "sp"))``), run phase 12's MoE LM over dp 1 x
   sp 2, its layers routing both ranks' sequence chunks in the global
   token order: the first step's loss and gradients against one
   process's on the same weights and batch (phase 11's tolerances), each
   layer's global per-expert counts and drop share beside one process's;
   2 warm-up and 4 counted steps (launches zeroed just before, read just
   after: rank r's ring runs r + 1 chunks of every kernel a layer), the
   routing all-gather timed alone; ``generate`` with the MoE ring prefill,
   its first-token logits against the mesh-free prefill's. The host's
   ``diag.capability_report()`` is printed first. (b) four rank processes
   on the card run the dense LM over sp 2 x fsdp 2 at B 2, S 4096 through
   ``DeviceLoader(spec=("fsdp", "sp"))``: 1 warm-up and 3 counted steps,
   the first step's loss, gathered gradients and parameters against one
   process's step (phase 12's rules), peak memory per rank.

15. head dims (the reference's kernels take any head dim): each kernel
   against its plain version at head dims 8, 16, 20, 32, 40, 96, 136,
   160, 200, 248 and 256 on a bf16 causal case with ragged tiles, a
   bf16 case with q_offset 192 and kv_offset 64, and an f32 non-causal
   one, with an lse cotangent (dq and dk/dv bit-identical over two
   launches, the launch counters moved by each case); each kernel at H D
   = 1024 with head dims 32, 128 and 256 (and 10 heads of 96) on the
   LM's (8, 2048) in its qkv-view layout, held row by row against its
   plain version and timed against it and SDPA; the three kernels at the
   example's ring chunks (below, head dim 32) against their plain
   versions; the LM above at 32 heads (head dim 32) and 4 (256), eval
   loss, 3 Adam steps and ``generate`` of 8 tokens (launches zeroed just
   before, read just after), the first step's loss against the same step
   under the plain attention; then the port's
   ``examples/lm_longcontext.py`` ``main`` at the reference's defaults
   (head dim 32) over dp 2 x sp 2, four rank processes on the card
   (gloo), one epoch: finite losses equal on every rank, every kernel
   launched on every rank.

16. fp16 and head dims past 256 (the reference's kernels take any float
   dtype and any head dim): each kernel against its plain version on
   phase 15's three cases (ragged causal, global offsets, full; an lse
   cotangent; dq and dk/dv bit-identical over two launches; the launch
   counters moved by each case, and the plain versions and SDPA made to
   raise while the kernels run) in fp16 at phase 15's head dims, and in
   bf16, fp16 and f32 at 264, 300, 320, 512, 1000 and 1024 (chunks of 256
   features), the fp16 tolerances a fifth of bf16's; each kernel at (8,
   2048) in the LM's qkv views in fp16 at hd 64, 128 and 256, in f32 at
   hd 64, 128 and 256, and in bf16, fp16 and f32 at hd 512 (2 heads),
   against its plain version and SDPA (and which SDPA backend takes hd
   512); the LM above in fp16 (16
   heads), in bf16 at 2 heads (hd 512) and in f32 (16 heads), store-fed:
   eval loss, 3 Adam steps and ``generate`` of 8 tokens (launches zeroed
   just before and read just after), the first step's loss within 2e-2 of
   the same step under the plain attention.

17. launch grids past 65,535 blocks on an axis CUDA caps at that (the
   reference's grid folds B*H into one axis; every kernel here puts
   batch, heads and tile blocks on grid x): the three kernels against
   their plain versions as in phase 15 at a batch of 65,536 (H 1, S 8,
   d 64) in bf16, fp16 and f32, at d 520 (chunks of 256, bf16), and at
   65,536 heads in f32, all causal, and at a batch of 1,024 in f32 (the
   f32 cases without an lse cotangent, so that each head's first query,
   which sees one key, has a dq row that cancels to a few millionths,
   held at 1e-4 a row; each case's worst f32 dq row printed beside the
   card); and each chunked kernel's tile blocks past
   65,535 at d 1024: the forward and dq over 2**21 queries, dk/dv over
   2**21 keys, the plain versions taken 2**17 queries or keys at a time.
18. Moonlight (DeepSeek-V3's block at the Moonlight cell's widths, one
   rank of 8-way expert parallelism) at the cell's step of 2 x 8,192:
   latent attention's (192, 128) route of ``flash_attention`` (v
   zero-padded to 192 for the kernels, out and dv cut back) against the
   plain f32 attention, and the held-expert layer (the row kernels of
   ``ops/csrc/held_rows.cu`` and ``torch._grouped_mm``) over 16,384 tokens
   against the plain f32 expert layer written here, each output and
   gradient within 2e-2 of its L2 norm, its forward and backward again
   under ``torch.cuda.set_sync_debug_mode("error")`` (nothing may wait on
   the host); each row kernel against its plain version; the grouped
   products with an expert of no token (its gradient exactly 0) and NaN
   rows past the last group; then the model at 3 layers (1 dense, 2
   expert) over 3 Adam steps of (1, 1024) on the card in bf16 against
   its own plain paths on the CPU in f32, on the same weights: losses
   within 1e-3, the assignment counts within 5 %, and a step's operations
   that wait on the host listed.

Then it prints the kernel table as one JSON line (each row names its
design: ``wgmma+tma``, the 16-bit path of all three kernels at every head
dim, ``, chunks of 256`` past 256), the card's
name and power limit, and as the last line ``{"ok": true, "device":
{...}}``.
Without a card, or outside a checkout, it exits non-zero and prints no
result.

With ``--ab PARENT`` it runs none of the phases: it times the three
kernels of the tree at PARENT (another checkout of this repository, say
the parent commit's ``git archive``) and of this checkout at AB_TIMED's
(dtype, head dim), each in a process of its own, in the order parent,
change, change, parent (each process builds its tree's kernels and runs
that tree's ``head_dim_timing``, which also holds every kernel to its
plain version, then its ``head_dim_lm`` at each of AB_LMS' (dtype,
heads) over AB_LM_STEPS steps), and prints each kernel's times and the
LM's median step from both trees on lines before the last.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import itertools
import json
import math
import multiprocessing as mp
import os
import queue
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from ddstore_tpu_torch import _build as native_build
from ddstore_tpu_torch import (binding, diag, elastic_recover,
                               elastic_rejoin, obs)
from ddstore_tpu_torch.data.dataset import (DistributedSampler,
                                            ShardedDataset, nsplit)
from ddstore_tpu_torch.data.device_fetch import (device_fetch_batch,
                                                 device_fetch_ragged_batch,
                                                 exchange_device,
                                                 host_bytes_over_dcn,
                                                 plan_device_fetch)
from ddstore_tpu_torch.data.formats import synthetic_mnist
from ddstore_tpu_torch.data.graphs import (GraphBatch, GraphSample,
                                           GraphShardedDataset,
                                           pack_graph_batch,
                                           synthetic_graphs)
from ddstore_tpu_torch.data.loader import DeviceLoader
from ddstore_tpu_torch.data.permute import seeded_perm_slice
from ddstore_tpu_torch.data.ragged import pad_ragged
from ddstore_tpu_torch.models import decode as tdec
from ddstore_tpu_torch.models import gnn as tgnn
from ddstore_tpu_torch.models import transformer as ttr
from ddstore_tpu_torch.models import vae as tvae
from ddstore_tpu_torch.models.transformer import param_digest
from ddstore_tpu_torch.ops import _build, attention, xent
from ddstore_tpu_torch.ops.xent import fused_linear_xent
from ddstore_tpu_torch.parallel import (collectives, data_axes,
                                        global_shuffle_epoch,
                                        host_global_shuffle, make_mesh,
                                        permute_rows, ring_attention)
from ddstore_tpu_torch.parallel.collectives import collective_stats
from ddstore_tpu_torch.parallel.ring_attention import _shift as _ring_shift
from ddstore_tpu_torch.parallel.ring_attention import ring_shift_stats
from ddstore_tpu_torch.rendezvous import FileGroup, TorchGroup
from ddstore_tpu_torch.store import DDStore, DDStoreError
from ddstore_tpu_torch.utils import checkpoint, profile as uprofile
from ddstore_tpu_torch.weights import to_flax

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): the bound of
# a kernel is max(bytes / memory rate, operations / peak rate).
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# fp16 runs on the tensor cores at the bf16 rate; f32 on the tensor cores
# as TF32 (all three f32 kernels: three TF32 products an f32 product,
# tf32_bound; but dq's dP on the FP64 tensor cores, 67 TFLOP/s on the data
# sheet), with the CUDA cores' bound beside it (67 TFLOP/s outside the
# tensor cores on the data sheet)
PEAK_FLOPS = {"bfloat16": PEAK_BF16_FLOPS, "float16": PEAK_BF16_FLOPS,
              "float32": 67e12, "tf32": 495e12, "float64": 67e12}

# The repo's LM config (bench.py:3169) and the slices' traffic.
VOCAB, DIM, HEADS, LAYERS = 32768, 1024, 16, 8
WINDOWS, SEQ, BATCH = 4096, 2048, 8
# The fused head's check: the head shapes (tokens, d, vocab) of the
# benchmark's train cells, and its tolerances against the widened-f32
# route. Both routes form the same exact products of bf16 operands and sum
# them in f32, in other orders: nll (about 14 at these shapes, an f32 ulp
# 9.5e-7) moves by a few ulps of the lse's and the target logit's sums, so
# 1e-4 absolute; dx and dw are sums over 50,257 vocab columns and over the
# tokens, and a logit that moves by an ulp can flip a dlogit's bf16
# rounding (2**-8 of it), so each is held to 1e-3 of its largest value.
HEAD_SHAPES = (("gpt2-medium", 65536, 1024, 50257),
               ("pythia-1.4b", 24576, 2048, 50304))
HEAD_NLL_TOL, HEAD_GRAD_REL = 1e-4, 1e-3
LOSS_BATCHES, NEW_TOKENS = 4, 32
TRAIN_STEPS, TRAIN_LR, WARMUP_STEPS = 8, 1e-3, 2  # lm_longcontext.py:56
# The VAE slice: the MNIST train set's size, the global batch of
# examples/vae_mnist.py:38, two rank processes on the one card; a step on
# the card is held to the CPU step at tests/test_torch_vae.py's bf16
# tolerances (loss rtol, each gradient leaf relative to its largest).
VAE_SAMPLES, VAE_RANKS, VAE_BATCH = 60000, 2, 128
VAE_PROFILE_STEPS, VAE_NCCL_STEPS, VAE_TREND = 20, 5, 20
VAE_LOSS_RTOL, VAE_GRAD_TOL = 5e-3, 2e-2
# After the counted epoch, the same epoch through readahead.
VAE_RA_WINDOWS, VAE_RA_WINDOW_BATCHES = 2, 8
# The device-collective fetch: phase 7's third epoch (the global batch
# staged by its owners, one all_to_all_single delivering each rank its
# 64 rows), phase 9's 20 batches in a one-process NCCL group, and the A/B
# of device_fetch_batch against get_batch + the copy to the card at the
# reference bench's geometry (bench.py:616: 32,768 rows of 64 f32,
# batches of 2,048, 16 batches); the GNN's ragged nodes padded to 32.
COLL_NCCL_BATCHES = 20
AB_ROWS, AB_DIM, AB_BATCH, AB_BATCHES = 32768, 64, 2048, 16
RAGGED_MAX_LEN = 32
# The GNN slice: the repo's one GNN configuration (MPNN hidden 64, 3
# layers, bf16 dense layers; examples/gnn_molecules.py: 8 graphs a slot,
# Adam lr 3e-3) over QM9's 133,885 molecules as QM9-shaped synthetic
# graphs, split between two rank processes on the one card, one slot a
# rank. One step (Adam at lr 1e-3, as the tests) on the card is held to
# the CPU's f32 step from the same weights: the loss (relative), each
# gradient leaf (L2 error over the leaf's L2 norm) and the parameters
# after the step. In f32 directly, at the tests' loss and gradient
# tolerances and the step at lr / 10, because Adam's first update
# -lr g / (|g| + 1e-8) turns a gradient difference d into a weight
# difference of up to lr d / 1e-8 where |g| is near 1e-8 (3.1e-6 to
# 1.5e-5 over four runs on an H100 at 700 W). In bf16 the card and the
# CPU round differently, so both are held to the f32 step and the
# card's error, over GNN_BF16_RUNS steps with the main path's atomic
# scatter, to at most GNN_BF16_FACTOR times the CPU's: in the loss (or
# one bf16 rounding, 2**-8, if that is larger), the worst gradient
# leaf, and the share of weights that the step moves the other way
# from the f32 step's (Adam's first update is about +-lr wherever the
# gradient is not near 0, so the sign is what a step can get wrong).
GNN_GRAPHS, GNN_RANKS, GNN_G, GNN_LR = 133885, 2, 8, 3e-3
GNN_STEPS, GNN_EVAL_BATCHES, GNN_TREND = 1024, 64, 100
GNN_PROFILE_STEPS, GNN_NCCL_STEPS = 20, 5
GNN_F32_TOL = (1e-5, 1e-4, 1e-4)
GNN_BF16_RUNS, GNN_BF16_FACTOR = 8, 3.0
# The elastic phase (10): four rank processes on the one card over a
# FileGroup and the TCP store, in the environment of
# tests/test_elastic.py (DDSTORE_CMA=0 as phases 7-8: the other ranks'
# rows cross TCP). synthetic_mnist(60000) as uint8, 15,000 rows a rank,
# and a 10,000-row eval split (2,500 a rank) under tenant "eval", whose
# per-rank quota (4 MiB) holds the split's 1.96 MB but not 3,000 rows
# more. Each rank trains its own VAE (full width, bf16 hidden layers,
# Adam 1e-3) on local batches of 64, with no DDP (a torch.distributed
# group does not survive a member's death; examples/elastic_train.py
# trains the same way), and saves its model and Adam state every 50
# steps. Rank 2 is SIGKILLed once past 100 steps; the survivors recover,
# it rejoins from its checkpoints, and all four train 100 steps more, the
# last 20 of rank 0's under the profiler.
EL_RANKS, EL_VICTIM, EL_BATCH, EL_VAR = 4, 2, 64, "mnist"
EL_EVAL_SAMPLES, EL_EVAL_BATCH, EL_EVAL_SEED = 10000, 128, 7
EL_QUOTA, EL_OVER_ROWS, EL_FIXED = 4 << 20, 3000, 1024
EL_SAVE_EVERY, EL_KILL_AFTER, EL_AFTER, EL_PROFILE_STEPS = 50, 100, 100, 20
EL_TREND, EL_DEADLINE_S, EL_OUT = 20, 420, os.path.join("chiprun_out",
                                                         "elastic")
EL_ENV = {"DDSTORE_READ_TIMEOUT_S": "5", "DDSTORE_CONNECT_TIMEOUT_S": "3",
          "DDSTORE_BARRIER_TIMEOUT_S": "60", "DDSTORE_CMA": "0",
          "DDSTORE_HOST": "127.0.0.1"}
# The long-context phase (11): lm_long_bench's configuration
# (bench.py:3247-3283: the LM above at B = 2, S = 8192) over a dp 1 x sp 2
# mesh of two rank processes on the one card (gloo; DDSTORE_CMA=0 as
# phases 7-8), fed from 4,096 windows of 8,193 tokens (tokens and next
# tokens) in a TCP store; remat off, on, and selective, each 2 warm-up
# steps and 4 counted, Adam lr 1e-3 (lm_longcontext.py:56). Checks: the
# ring against the whole sequence's f32 result (bf16: beside one call of
# the kernels, RING_ROW_FACTOR; f32: the kernel tolerances below); each
# kernel against its plain version at the ring's chunk shapes with an lse
# cotangent, per row; the first step's loss against one process
# at sp 1 at the small model's bf16 loss tolerance, each gradient's L2
# error over its L2 norm at the kernels' bf16 per-row tolerance (the ring
# rounds the K/V gradient to bf16 once more when it sums the two ranks'
# parts); the ring prefill's first-token logits at the same per-row
# tolerance.
LONG_SEQ, LONG_BATCH, LONG_WINDOWS, LONG_SP = 8192, 2, 4096, 2
LONG_WARMUP, LONG_STEPS, LONG_LR, LONG_NEW_TOKENS = 2, 4, 1e-3, 8
LONG_REMAT = (("off", {}), ("remat", {"remat": True}),
              ("selective", {"remat": True, "remat_policy":
                             "dots_with_no_batch_dims_saveable"}))
LONG_RING_CASES = (("bf16", (2, 16, 8192, 64), torch.bfloat16),
                   ("f32", (1, 2, 512, 64), torch.float32))
LONG_LOSS_TOL, LONG_GRAD_TOL = 2e-2, 2e-2
# The ring's bf16 out and gradients are held against the f32 result of
# the whole sequence (mha_reference and autograd, f32_attention) beside
# one whole-sequence call of the kernels on the same inputs, on this
# rank's rows: in each band of LONG_BAND positions the ring's L2 error
# over the band within RING_BAND_FACTOR times the one call's (a wrong
# band of rows fails), and the ring's worst row within RING_ROW_FACTOR
# times the one call's worst row (a row far off fails). The ring's
# backward runs each live step's dq and dk/dv kernels on the caller's do
# with the final lse and c, as the one call does across its key blocks,
# so it rounds where the one call rounds but for each step's bf16 dq and
# dk/dv, summed over the steps. Differentiated through _combine instead
# (as the reference's jax.grad is), each step's share of do, w_i * do,
# would be rounded to bf16 before it enters dp = do_i v, and where the
# few queries of a key near the sequence end give dp - c that nearly
# cancel, that rounding dominates the key's dk row: `python -m
# ddstore_tpu_torch.examples.ring_precision --seeds 16` ((1, 2, 8192, 64)
# on the CPU, the plain versions) puts that ring's worst dk row at
# 1.29-11.66x the one call's, and the final-lse backward's near 1x. The
# one call is not held to f32 at a fixed tolerance: where a row's
# attention sits on one key, dp - c cancels and c comes from the bf16
# out, so such rows carry large relative errors in the plain version too
# (0.19 in dq on an H100); the kernel checks hold it to its plain version.
RING_BAND_FACTOR, RING_ROW_FACTOR = 2.0, 2.0
# The MoE and model-parallel phase (12): (a) the LM above with 8 experts
# and top-2 routing (the reference's MoE block, models/moe.py), one
# process at (8, 2048), 2 warm-up and 4 counted Adam steps (lr 1e-3), the
# first step's loss against the same step in f32 through the plain
# attention at the small model's bf16 loss tolerance (phase 4); (b) two
# rank processes on the one card over gloo (DDSTORE_CMA=0 as phases
# 7-11), each layout at B 2, 1 warm-up and 3 counted steps, held to one
# process's step at phase 11's tolerances: the loss, each gradient's L2
# error over its norm, and each updated parameter's; a leaf that is zero
# before the step (a bias) holds Adam's first update, +-lr wherever its
# gradient is not near 0, so it is held by the share of its elements
# that the step moves the other way from one process's (bf16 rounds the
# gradients near 0 to either sign: 0.29 % at tp 2 on an H100 at 700 W).
MOE_EXPERTS, MOE_TOP_K, MOE_WARMUP, MOE_STEPS = 8, 2, 2, 4
MOE_LOSS_TOL = 2e-2
LAYOUT_RANKS, LAYOUT_BATCH, LAYOUT_WARMUP, LAYOUT_STEPS = 2, 2, 1, 3
LAYOUT_FLIP_TOL = 0.02
LAYOUTS = (("ep2", {"ep": 2}, True), ("tp2", {"tp": 2}, False),
           ("fsdp2", {"fsdp": 2}, False))
LONG_BAND = 256
LONG_REF_BLOCK = 1024  # queries per block of the f32 reference
# The pipeline phase (13): the LM above over pp 2, two rank processes on
# the one card over gloo (DDSTORE_CMA=0 as phases 7-12), each registering
# half of phase 5's windows in a TCP store, fed by DeviceLoader (dp 1:
# both stages read the same rows). Each schedule: M 4 microbatches of 2 x
# 2048 (interleaved: V 2), 1 warm-up and 3 counted Adam steps (lr 1e-3),
# the first step held to one process's make_train_step on the same weights
# and batch at phase 11's tolerances (phase 12's rule for leaves that
# start at 0); then GPipe and 1F1B at M 8 with remat off, 1F1B's peak
# below GPipe's; the MoE LM of phase 12 under 1F1B, 1 warm-up and 2 steps,
# held to one process running the same schedule at pp 1; generate on the
# stages reassembled on rank 0.
PP_RANKS, PP_M, PP_MB, PP_V, PP_WARMUP, PP_STEPS = 2, 4, 2, 2, 1, 3
PP_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", PP_V),
                ("interleaved_1f1b", PP_V))
PP_MEM_M, PP_MOE_STEPS, PP_NEW_TOKENS = 8, 2, 8
# The split-sequence phase (14): (a) phase 12's MoE LM over a dp 1 x sp 2
# mesh, two rank processes on the one card over gloo (DDSTORE_CMA=0 as
# phases 7-13), fed as phase 11 (B 2, S 8192, DeviceLoader(spec=("dp",
# "sp"))), its layers routing both ranks' chunks in the global token
# order; 2 warm-up and 4 counted Adam steps (lr 1e-3); the first step's
# loss and gradients against one process's on the same weights and batch
# at phase 11's tolerances, each layer's global routing beside one
# process's; generate with the MoE ring prefill, its first-token logits
# against the mesh-free prefill's at phase 11's ROW_REL_TOL. (b) the dense
# LM over sp 2 x fsdp 2, four rank processes on the one card, B 2, S 4096
# (phase 11's corpus at that width), 1 warm-up and 3 counted steps (lr
# 1e-3), the first step held to one process's at phase 12's tolerances;
# then the three kernels at (b)'s ring chunks, (1, 16, 2048, 64) bf16,
# against their plain versions. The steps' gradient all-reduces over sp
# are timed alone after the counted runs.
MSP_SP, MSP_WARMUP, MSP_STEPS = 2, 2, 4
FSP_RANKS, FSP_SEQ, FSP_WARMUP, FSP_STEPS = 4, 4096, 1, 3
# The head-dims phase (15): the three kernels at head dims below, inside
# and above the 64 and 128 tiles, one not a multiple of 8 (20) and the
# 256 tile's edge, each on a bf16 causal case with ragged last tiles, a
# bf16 case with global offsets and an f32 non-causal one, with an lse
# cotangent (kernel tolerances as above); each kernel at (8, 2048) with
# DIM // d heads of each head dim d in HD_TIMED (H D = 960 at 96) in the
# LM's qkv-view layout, held to its plain version and timed; the kernels
# at the example's ring chunks, (2, 4, 1024, 32) (HD_EX_CHUNK); the
# LM above at HD_LM_HEADS heads (head dims 32 and 256), its first step's
# loss held to the same step under the plain attention at MOE_LOSS_TOL;
# the long-context example at its own defaults over dp 2 x sp 2 (four
# ranks on the card, gloo), one epoch of HD_EX_WINDOWS windows a rank.
# (136, 200 and 248: the 256 tile of all three kernels zero-filled past
# d, with ragged 64-key and 64-query tiles)
HD_DIMS = (8, 16, 20, 32, 40, 96, 136, 160, 200, 248, 256)
HD_CASES = (("bf16_causal_ragged", (1, 4, 200, 200), torch.bfloat16, True,
             0, 0),
            ("bf16_offsets", (2, 4, 256, 256), torch.bfloat16, True, 192,
             64),
            ("f32_full", (1, 4, 136, 136), torch.float32, False, 0, 0))
HD_TIMED = (32, 96, 128, 256)
HD_LM_HEADS = (32, 4)
HD_STEPS, HD_NEW_TOKENS = 3, 8
HD_EX_RANKS, HD_EX_WINDOWS, HD_EX_DEADLINE_S = 4, 64, 240
# the example's ring chunk at its defaults over dp 2 x sp 2: (a dp slot's
# 2 rows, heads 128 // 32, seq 2048 / sp, head dim 32)
HD_EX_CHUNK = (2, 4, 1024, 32)
# The fp16 and wide phase (16): the three kernels against their plain
# versions on HD_CASES' shapes, flags and offsets (with an lse cotangent),
# in fp16 at HD_DIMS and in each of FW_DTYPES at the head dims FW_DIMS
# past 256 (chunks of 256; 300 and 1000 padded to a multiple of 8), the
# fp16 tolerances beside TOL; each kernel at the LM's (8, 2048) in its
# qkv views at FW_TIMED (dtype, head dim), H = DIM // d, against its
# plain version and SDPA (and SDPA's route past 256; the f32 kernels at
# 64, 128 and 256 too, their launches the f32 LM's at 64, else phase 15's
# f32 cases); the LM above in fp16 at 16 heads, in bf16 at 2 heads (hd
# 512) and in f32 at 16 heads, store-fed: eval loss, HD_STEPS Adam steps
# and generate of HD_NEW_TOKENS, the first step's loss held to the same
# step under the plain attention at MOE_LOSS_TOL.
FW_DIMS = (264, 300, 320, 512, 1000, 1024)
FW_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
FW_TIMED = ((torch.float16, 64), (torch.float16, 128), (torch.float16, 256),
            (torch.float32, 64), (torch.float32, 128), (torch.float32, 256),
            (torch.bfloat16, 512), (torch.float16, 512),
            (torch.float32, 512))
# launches a timing round (the f32 kernels take several ms a launch)
FW_ITERS = {"bfloat16": 20, "float16": 20, "float32": 10}
FW_LMS = (("fp16", torch.float16, HEADS), ("hd512", torch.bfloat16, 2),
          ("f32", torch.float32, HEADS))
# Phase 17, launch grids past 65,535 blocks on an axis CUDA caps at that
# (y and z; every kernel folds batch, heads and tile blocks onto x, as the
# reference's grid folds B*H into one axis): GRID_CASES as phase 15's
# cases (an lse cotangent, dq and dk/dv bit-identical over two
# launches, the launch counters; out held by row at ROW_REL_TOL and lse
# at TOL, but not by out's largest error: a row of S 8 can reach |out|
# 4, where one bf16 unit is 0.031, past TOL's 2e-2), the batch past
# 65,535 in each dtype (at a tile width, and at d 520 in chunks of 256)
# and the heads past 65,535 in f32 (the f32 backward had them on y);
# GRID_LONG, each chunked kernel's tile blocks past 65,535 at d
# GRID_LONG_D (4 chunks), causal, held to the plain versions
# GRID_PLAIN_CHUNK queries (forward, dq) or keys (dk/dv) at a time, so
# that their f32 copies stay near 0.5 GiB.
# (name, (b, h, sq, sk), d, dtype, causal). The f32 cases run without an
# lse cotangent: each head's first query then sees one key and its dq row
# is p (dP - c) k with dP equal to c up to rounding, a few millionths of
# the largest row, which the check holds at 1e-4 of a thousandth of it.
# The f32 dq kernel forms dP exactly on the FP64 tensor cores and rounds
# dP - c once, as the plain version does (one f32 fma chain missed by
# 6.4e-4 at rows_f32's shape).
GRID_CASES = (("batch_bf16", (65536, 1, 8, 8), 64, torch.bfloat16, True),
              ("batch_fp16", (65536, 1, 8, 8), 64, torch.float16, True),
              ("batch_f32", (65536, 1, 8, 8), 64, torch.float32, True),
              ("heads_f32", (1, 65536, 8, 8), 64, torch.float32, True),
              ("rows_f32", (1024, 1, 8, 8), 64, torch.float32, True),
              ("batch_chunked", (65536, 1, 8, 8), 520, torch.bfloat16,
               True))
# (name, sq, sk, q_offset, kernels held): 2**21 queries (the chunked
# forward's 65,536 tile blocks, dq's 131,072) over 64 keys, and 64
# queries over 2**21 keys (dk/dv's 131,072), the queries last so that
# every key is seen
GRID_LONG = (("long_queries", 1 << 21, 64, 0,
              ("flash_fwd", "flash_bwd_dq")),
             ("long_keys", 64, 1 << 21, (1 << 21) - 64, ("flash_bwd_dkv",)))
GRID_LONG_D = 1024
GRID_PLAIN_CHUNK = 1 << 17
# The kernel A/B (--ab): the (dtype, head dim) each tree's kernels are
# timed at, H = DIM // d at (8, 2048) (bf16 at 64, the main path's shape;
# d 256, where dq and dk/dv split their features, and the chunked forward
# at two to four chunks; f32 at the LM's 64, at 256, one block of dQ's
# (dK's, dV's) columns, and at 512, two).
AB_TIMED = (("bfloat16", 64), ("bfloat16", 256), ("float16", 256),
            ("bfloat16", 264), ("float16", 264), ("bfloat16", 512),
            ("float16", 512), ("bfloat16", 1024), ("float16", 1024),
            ("float32", 64), ("float32", 256), ("float32", 512))
# launches a timing round of the A/B, by dtype (at the LM's hd 64 a
# forward takes about 0.23 ms)
AB_ITERS = {"bfloat16": 100, "float16": 100, "float32": 20}
# and the LM above at these (dtype, heads) (bf16 at head dims 256 and 512,
# f32 at 64), store-fed, its train step timed over AB_LM_STEPS steps (the
# first one not counted)
AB_LMS, AB_LM_STEPS = (("bfloat16", 4), ("bfloat16", 2),
                       ("float32", HEADS)), 10
AB_DEADLINE_S = 600

# Kernel against plain version: bf16 out / lse, f32 out and lse (max abs
# error), and the largest error of a live row of out relative to that
# row of the plain version (L2 norms over the head dim): bf16 rounds out
# and P at 2**-8 relative, so an exact kernel stays below about 5e-3.
# The backward kernels are held to the same per-row relative error for
# dq, dk and dv (see row_errors): bf16 rounds P and dS to bf16 at 2**-8
# before their products, f32 only sums in another order.
# fp16 (phase 16) rounds 8x finer than bf16 (2**-11 against 2**-8): its
# tolerances are about a fifth of bf16's, which leaves room for the
# summation order.
TOL = {"bfloat16": (2e-2, 1e-2), "float32": (1e-4, 1e-4),
       "float16": (4e-3, 2e-3)}
ROW_REL_TOL = {"bfloat16": 2e-2, "float32": 1e-4, "float16": 4e-3}

# Kernel cases: name, (b, h, sq, sk, d), dtype, causal, q_offset,
# kv_offset; the lm_* cases take the main path's layout (qkv_views).
CASES = [
    ("lm_causal", (BATCH, HEADS, SEQ, SEQ, DIM // HEADS),
     torch.bfloat16, True, 0, 0),
    ("lm_full", (BATCH, HEADS, SEQ, SEQ, DIM // HEADS),
     torch.bfloat16, False, 0, 0),
    ("f32_causal", (2, 4, 512, 512, 64), torch.float32, True, 0, 0),
    ("f32_d128", (1, 4, 256, 256, 128), torch.float32, False, 0, 0),
    ("d128", (2, 8, 1024, 1024, 128), torch.bfloat16, True, 0, 0),
    ("s640", (2, 8, 640, 640, 64), torch.bfloat16, True, 0, 0),
    ("s640_d128_f32", (1, 4, 640, 640, 128), torch.float32, True, 0, 0),
    ("kv_ahead_masked_rows", (1, 4, 256, 256, 64), torch.bfloat16,
     True, 0, 128),
    ("kv_ahead_masked_rows_f32", (1, 4, 256, 256, 64), torch.float32,
     True, 0, 136),
    ("q_offset", (2, 4, 256, 256, 64), torch.bfloat16, True, 192, 64),
    ("cross_len", (1, 4, 136, 520, 64), torch.bfloat16, True, 384, 0),
    # keys 136..519 lie beyond the last query: no query sees them
    ("cross_len_dead_tail", (1, 4, 136, 520, 64), torch.bfloat16, True, 0,
     0),
    # fewer queries than one consumer warpgroup's 64 rows
    ("short_causal", (1, 4, 40, 40, 64), torch.bfloat16, True, 0, 0),
    # head dim 128 with a ragged last tile of 128 queries and of 128 keys
    ("d128_ragged", (1, 4, 200, 200, 128), torch.bfloat16, True, 0, 0),
]
# Backward cases that carry an lse cotangent (dlse != 0).
DLSE_CASES = {"f32_causal", "s640", "kv_ahead_masked_rows", "q_offset",
              "cross_len", "cross_len_dead_tail", "d128_ragged"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def live_pairs(sq, sk, causal, q_offset, kv_offset):
    """Score pairs (query, key) the causal mask leaves live: row i sees
    keys j with kv_offset + j <= q_offset + i."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, q_offset + i - kv_offset + 1))
               for i in range(sq))


def attention_work(b, h, sq, sk, d, itemsize, causal, q_offset, kv_offset,
                   kind="fwd"):
    """(flops, bytes) a kernel needs on these inputs: its products over the
    live score pairs (2*d FLOP each: the forward's s and pv, dq's s, dp
    and dq, dk/dv's s, dp, dv and dk), each input read once and each
    output written once. The forward reads q, k, v and writes out and the
    f32 lse; dq reads q, k, v, do and the f32 lse and c and writes dq;
    dk/dv reads the same and writes dk and dv."""
    pairs = live_pairs(sq, sk, causal, q_offset, kv_offset)
    products, rows_q, rows_k, f32_rows = {
        "fwd": (2, 2 * sq, 2 * sk, sq),
        "dq": (3, 3 * sq, 2 * sk, 2 * sq),
        "dkv": (4, 2 * sq, 4 * sk, 2 * sq)}[kind]
    flops = 2.0 * products * b * h * d * pairs
    nbytes = b * h * ((rows_q + rows_k) * d * itemsize + f32_rows * 4)
    return flops, nbytes


def bound_of(flops, nbytes, dname="bfloat16"):
    """(bound ms, what bounds it) on the H100 SXM's published peaks, the
    operations at the peak of dtype ``dname``."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dname], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def tf32_bound(flops, nbytes, kind="fwd"):
    """The f32 kernels' bound: each f32 product three TF32 products on the
    tensor cores at 495 TFLOP/s, but dq's dP (a third of dq's FLOP) in f64
    on the FP64 tensor cores at 67; the two times add, as both run on the
    tensor cores."""
    f64 = flops / 3 if kind == "dq" else 0.0
    t_ops = (3 * (flops - f64) / PEAK_FLOPS["tf32"]
             + f64 / PEAK_FLOPS["float64"])
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def qkv_views(g, dev, b, h, s, d, dt):
    """q, k, v as ``Block.qkv_heads`` gives them to the kernel: (B, H, S,
    D) views of one (B, S, 3 * H * D) projection (row stride 3 * H * D)."""
    dim = h * d
    qkv = torch.randn((b, s, 3 * dim), generator=g, device=dev).to(dt)
    return tuple(t.reshape(b, s, h, d).transpose(1, 2)
                 for t in qkv.split(dim, dim=-1))


def case_inputs(g, dev, name, shape, dt):
    """q, k, v of a kernel case: the main path's views for the lm_* cases,
    separate tensors otherwise."""
    b, h, sq, sk, d = shape
    if name.startswith("lm_"):
        return qkv_views(g, dev, b, h, sq, d, dt)
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dt)
    k, v = (torch.randn((b, h, sk, d), generator=g, device=dev).to(dt)
            for _ in range(2))
    return q, k, v


def phase_kernels(dev):
    """Kernel vs plain version on the card; timings at the LM shape."""
    g = torch.Generator(device=dev).manual_seed(1234)
    errs, rel_errs = {}, {}
    for name, (b, h, sq, sk, d), dt, causal, qo, ko in CASES:
        q, k, v = case_inputs(g, dev, name, (b, h, sq, sk, d), dt)
        with torch.no_grad():
            out, lse = attention.flash_attention(
                q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
            ref_out, ref_lse = attention.mha_reference(
                q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
        torch.cuda.synchronize()
        check(out.shape == q.shape and out.dtype == dt and
              lse.shape == (b, h, sq) and lse.dtype == torch.float32,
              f"{name}: output shapes/dtypes")
        live = torch.isfinite(ref_lse)
        check(not torch.isnan(out).any() and not torch.isnan(lse).any(),
              f"{name}: NaN in the kernel's output")
        check(bool((torch.isfinite(lse) == live).all()),
              f"{name}: fully-masked rows differ")
        dead = ~live
        check(bool((out[dead] == 0).all()) and
              bool((lse[dead] == -math.inf).all()),
              f"{name}: a fully-masked row is not out 0 / lse -inf")
        diff = out.float() - ref_out.float()
        e_out = float(diff.abs().max())
        e_lse = float((lse[live] - ref_lse[live]).abs().max()) \
            if live.any() else 0.0
        e_rel = float((diff.norm(dim=-1)[live] / ref_out.float()
                       .norm(dim=-1)[live].clamp_min(1e-6)).max()) \
            if live.any() else 0.0
        dname = str(dt).split(".")[-1]
        t_out, t_lse = TOL[dname]
        print(f"kernel flash_fwd {name}: b,h,sq,sk,d={b},{h},{sq},{sk},{d} "
              f"{dname} causal={causal} q_offset={qo} kv_offset={ko} "
              f"strides q={q.stride()} masked_rows={int(dead.sum())} "
              f"max_abs_err out={e_out:.3e} (tol {t_out}) "
              f"lse={e_lse:.3e} (tol {t_lse}) max_row_rel_err "
              f"out={e_rel:.3e} (tol {ROW_REL_TOL[dname]})", flush=True)
        check(e_out <= t_out and e_lse <= t_lse and
              e_rel <= ROW_REL_TOL[dname],
              f"{name}: kernel disagrees with the plain version")
        errs[name] = max(e_out, e_lse)
        rel_errs[name] = e_rel
        del q, k, v, out, lse, ref_out, ref_lse, diff

    # Timings at the shape and layout the slice's prefill and loss give
    # the kernel.
    b, h, s, d = BATCH, HEADS, SEQ, DIM // HEADS
    q, k, v = qkv_views(g, dev, b, h, s, d, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def kernel():
        attention.flash_attention(q, k, v, causal=True)

    def plain():
        attention.mha_reference(q, k, v, causal=True)

    def library():
        sdpa(q, k, v, is_causal=True)

    with torch.no_grad():
        # in turns: kernel, plain, library, library, plain, kernel
        t = {"kernel": [], "plain": [], "library": []}
        for order in (("kernel", "plain", "library"),
                      ("library", "plain", "kernel")):
            for which in order:
                fn, iters = {"kernel": (kernel, 20), "plain": (plain, 4),
                             "library": (library, 20)}[which]
                t[which].append(time_ms(fn, iters))
    flops, nbytes = attention_work(b, h, s, s, d, 2, True, 0, 0)
    bound, bound_by = bound_of(flops, nbytes)
    ms = {k2: sum(v2) / len(v2) for k2, v2 in t.items()}
    print(f"kernel flash_fwd timing at (B,H,S,D)=({b},{h},{s},{d}) bf16 "
          f"causal: kernel_ms={ms['kernel']:.4f} plain_ms={ms['plain']:.4f}"
          f" library_ms(sdpa)={ms['library']:.4f} bound_ms={bound:.4f} "
          f"({bound_by}: {flops:.4e} FLOP, {nbytes:.4e} B) "
          f"rounds={json.dumps(t)} achieved_TFLOPs="
          f"{flops / ms['kernel'] / 1e9:.1f}", flush=True)
    return {"errs": errs, "rel_errs": rel_errs, "ms": ms, "bound_ms": bound,
            "bound_by": bound_by}


def row_errors(got, want, dead):
    """(max abs error, largest error of a row (L2 over the head dim)
    relative to the plain version's row, rows no live score pair reaches
    (``dead``, (..., S) bool) that the kernel leaves not exactly 0). A row
    smaller than a thousandth of the largest row is held relative to that
    thousandth instead: such a row is the difference of two rounded sums
    (the first query's dq is p (dp - c) k with dp = c up to rounding)."""
    rel = row_rel(got, want)[~dead]
    return (float((got.float() - want.float()).abs().max()),
            float(rel.max()) if rel.numel() else 0.0,
            int((got[dead] != 0).any(dim=-1).sum()))


def row_rel(got, want):
    """Each row's error (L2 over the head dim) relative to the row of
    ``want``, or to a thousandth of ``want``'s largest row where the row
    is smaller (row_errors)."""
    got, want = got.float(), want.float()
    norm = want.norm(dim=-1)
    floor = 1e-3 * float(norm.max()) if norm.numel() else 0.0
    return (got - want).norm(dim=-1) / norm.clamp_min(max(floor, 1e-30))


def dead_keys(b, h, sq, sk, causal, q_offset, kv_offset, dev):
    """(B, H, Sk) bool: keys no query sees (causal, kv_offset + j beyond
    the last query q_offset + sq - 1)."""
    kpos = kv_offset + torch.arange(sk, device=dev)
    dead = kpos > q_offset + sq - 1 if causal else torch.zeros_like(
        kpos, dtype=torch.bool)
    return dead.expand(b, h, sk)


def phase_bwd_kernels(dev):
    """dq and dk/dv kernels vs their plain versions on the card, over the
    forward's cases (several with an lse cotangent); timings at the LM
    shape against the backward of one SDPA call."""
    g = torch.Generator(device=dev).manual_seed(4321)
    errs = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    rel_errs = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for name, (b, h, sq, sk, d), dt, causal, qo, ko in CASES:
        q, k, v = case_inputs(g, dev, name, (b, h, sq, sk, d), dt)
        # do as autograd hands it over: the gradient of a (B, H, S, D)
        # view of a (B, S, H, D) buffer
        do = torch.randn((b, sq, h, d), generator=g, device=dev).to(dt) \
            .transpose(1, 2)
        dlse = torch.randn((b, h, sq), generator=g, device=dev) \
            if name in DLSE_CASES else None
        kw = dict(causal=causal, q_offset=qo, kv_offset=ko, scale=d ** -0.5)
        with torch.no_grad():
            out, lse = attention.flash_attention(
                q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
            c = attention.flash_bwd_prep(do, out, dlse)
            got = {"dq": attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                      **kw)}
            got["dk"], got["dv"] = attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, c, **kw)
            again = {"dq": attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                        **kw)}
            again["dk"], again["dv"] = attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, c, **kw)
            torch.cuda.synchronize()
            want = {"dq": attention.flash_bwd_dq_reference(q, k, v, do, lse,
                                                           c, **kw)}
            want["dk"], want["dv"] = attention.flash_bwd_dkv_reference(
                q, k, v, do, lse, c, **kw)
        dname = str(dt).split(".")[-1]
        tol = ROW_REL_TOL[dname]
        dead = {"dq": ~torch.isfinite(lse),
                "dk": dead_keys(b, h, sq, sk, causal, qo, ko, dev)}
        dead["dv"] = dead["dk"]
        line = []
        for which, kern in (("dq", "flash_bwd_dq"), ("dk", "flash_bwd_dkv"),
                            ("dv", "flash_bwd_dkv")):
            t = got[which]
            check(t.shape == want[which].shape and t.dtype == dt and
                  not torch.isnan(t).any(), f"{name}: {which} shape/NaN")
            e_abs, e_rel, nonzero_dead = row_errors(t, want[which],
                                                    dead[which])
            line.append(f"{which} max_abs_err={e_abs:.3e} "
                        f"max_row_rel_err={e_rel:.3e}")
            check(nonzero_dead == 0,
                  f"{name}: {nonzero_dead} {which} rows that no live pair "
                  f"reaches are not 0")
            check(e_rel <= tol, f"{name}: {which} disagrees with the plain "
                  f"version ({e_rel:.3e} > {tol})")
            errs[kern][name] = max(errs[kern].get(name, 0.0), e_abs)
            rel_errs[kern][name] = max(rel_errs[kern].get(name, 0.0), e_rel)
        # no atomics: a second launch on the same inputs gives the same bits
        for kern, which in (("dq", ("dq",)), ("dk/dv", ("dk", "dv"))):
            same = all(torch.equal(again[x], got[x]) for x in which)
            check(same, f"{name}: {kern} differs between two launches")
            line.append(f"{kern} bit-identical over two launches {same}")
        dead_q, dead_k = int(dead["dq"].sum()), int(dead["dk"].sum())
        print(f"kernel flash_bwd {name}: b,h,sq,sk,d={b},{h},{sq},{sk},{d} "
              f"{dname} causal={causal} q_offset={qo} kv_offset={ko} "
              f"dlse={'yes' if dlse is not None else 'no'} masked_rows="
              f"{dead_q} dead_keys={dead_k} {'; '.join(line)} (tol per "
              f"row {tol})", flush=True)
        del q, k, v, do, out, lse, c, got, want, again

    # Timings at the LM shape, on the main path's layout.
    b, h, s, d = BATCH, HEADS, SEQ, DIM // HEADS
    dim = h * d
    base = torch.randn((b, s, 3 * dim), generator=g, device=dev) \
        .to(torch.bfloat16).requires_grad_()
    ql, kl, vl = (t.reshape(b, s, h, d).transpose(1, 2)
                  for t in base.split(dim, dim=-1))
    q, k, v = (t.detach() for t in (ql, kl, vl))
    do = torch.randn((b, s, h, d), generator=g, device=dev) \
        .to(torch.bfloat16).transpose(1, 2)
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, causal=True)
        c = attention.flash_bwd_prep(do, out)
    # The library yardstick: the backward of one SDPA call (dq, dk and dv
    # together), its forward done before the timed span.
    sd_out = torch.nn.functional.scaled_dot_product_attention(
        ql, kl, vl, is_causal=True)
    fns = {
        "dq": (lambda: attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                    **kw), 20),
        "dkv": (lambda: attention._flash_bwd_dkv_cuda(q, k, v, do, lse, c,
                                                      **kw), 20),
        "dq_plain": (lambda: attention.flash_bwd_dq_reference(
            q, k, v, do, lse, c, **kw), 3),
        "dkv_plain": (lambda: attention.flash_bwd_dkv_reference(
            q, k, v, do, lse, c, **kw), 3),
        "sdpa_backward": (lambda: torch.autograd.grad(
            sd_out, (ql, kl, vl), do, retain_graph=True), 20),
    }
    t = {n: [] for n in fns}
    # in turns: kernels, plain, library, then the reverse
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            fn, iters = fns[n]
            if n == "sdpa_backward":
                t[n].append(time_ms(fn, iters))
            else:
                with torch.no_grad():
                    t[n].append(time_ms(fn, iters))
    ms = {n: sum(x) / len(x) for n, x in t.items()}
    res = {"errs": errs, "rel_errs": rel_errs, "rounds": t, "ms": ms}
    for kern, kind in (("flash_bwd_dq", "dq"), ("flash_bwd_dkv", "dkv")):
        flops, nbytes = attention_work(b, h, s, s, d, 2, True, 0, 0, kind)
        bound, bound_by = bound_of(flops, nbytes)
        res[kern] = {"ms": ms[kind], "plain_ms": ms[kind + "_plain"],
                     "bound_ms": bound, "bound_by": bound_by}
        print(f"kernel {kern} timing at (B,H,S,D)=({b},{h},{s},{d}) bf16 "
              f"causal: kernel_ms={ms[kind]:.4f} plain_ms="
              f"{ms[kind + '_plain']:.4f} bound_ms={bound:.4f} "
              f"({bound_by}: {flops:.4e} FLOP, {nbytes:.4e} B) "
              f"achieved_TFLOPs={flops / ms[kind] / 1e9:.1f}", flush=True)
    print(f"kernel flash_bwd timing: dq + dkv = "
          f"{ms['dq'] + ms['dkv']:.4f} ms against library_ms(sdpa "
          f"backward, dq dk dv in one call)={ms['sdpa_backward']:.4f}; "
          f"rounds={json.dumps(t)}", flush=True)
    return res


COUNTERS = ("flash_fwd_launches", "flash_bwd_dq_launches",
            "flash_bwd_dkv_launches")


def launch_counts():
    return {n[:-len("_launches")]: getattr(attention, n) for n in COUNTERS}


def zero_launch_counts():
    for n in COUNTERS:
        setattr(attention, n, 0)


def small_reference_check(dev, seed):
    """A small model on the card (kernels) against the same model on the
    CPU (plain versions): f32 logits atol 1e-4, f32 loss atol 1e-5,
    greedy tokens equal after a 60-token prompt (padded to 64 for the
    kernel, one launch per layer); bf16 loss atol 2e-2. Then, in f32,
    every parameter's gradient through the fused cross-entropy head to
    1e-4 of that gradient's largest magnitude on the CPU (the card sums
    in other orders), one dq and one dk/dv launch per layer, and the
    parameters after one Adam step (lr 1e-3) at rtol 5e-3, atol 5e-4
    (Adam divides by sqrt(nu), which amplifies summation-order noise in
    near-zero gradients, as ``tests/test_decode.py:134`` holds it)."""
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        gpu = ttr.TransformerLM(vocab=512, dim=256, heads=4, layers=2,
                                compute_dtype=dt, device=dev)
        gpu.init_weights(torch.Generator(device=dev).manual_seed(seed))
        cpu = ttr.TransformerLM(vocab=512, dim=256, heads=4, layers=2,
                                compute_dtype=dt, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        rng = np.random.default_rng(seed)
        tok = torch.from_numpy(rng.integers(0, 512, (2, 128),
                                            dtype=np.int32))
        tgt = torch.from_numpy(rng.integers(0, 512, (2, 128),
                                            dtype=np.int32))
        pos = torch.arange(128, dtype=torch.int32).expand(2, 128)
        args_cpu = (tok, tgt, pos)
        args_gpu = tuple(a.to(dev) for a in args_cpu)
        with torch.no_grad():
            l_gpu = float(ttr.lm_loss(gpu, *args_gpu))
            l_cpu = float(ttr.lm_loss(cpu, *args_cpu))
        msg = (f"small {str(dt).split('.')[-1]} model, card vs CPU: loss "
               f"{l_gpu:.6f} vs {l_cpu:.6f}")
        if dt == torch.float32:
            with torch.no_grad():
                lg_gpu = gpu(args_gpu[0], args_gpu[2]).cpu()
                lg_cpu = cpu(tok, pos)
            e = float((lg_gpu - lg_cpu).abs().max())
            before = attention.flash_fwd_launches
            g_gpu = tdec.generate(gpu, args_gpu[0][:, :60], 8).cpu()
            n = attention.flash_fwd_launches - before
            g_cpu = tdec.generate(cpu, tok[:, :60], 8)
            msg += f", logits max_abs_err {e:.3e}, greedy tokens equal " \
                   f"{bool(torch.equal(g_gpu, g_cpu))}, prefill of 60 " \
                   f"tokens launched flash_fwd {n} times"
            check(e <= 1e-4, msg)
            check(torch.equal(g_gpu, g_cpu), msg)
            check(n == gpu.layers, msg)
            msg += "; " + small_train_check(gpu, cpu, args_gpu, args_cpu)
        print(msg, flush=True)
        check(math.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= tol, msg)


def small_train_check(gpu, cpu, args_gpu, args_cpu):
    """Gradients and one Adam step, card against CPU (see
    :func:`small_reference_check`); returns the line it prints."""
    before = launch_counts()
    ttr.lm_loss(gpu, *args_gpu, fused_xent=True).backward()
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in launch_counts().items()}
    ttr.lm_loss(cpu, *args_cpu, fused_xent=True).backward()
    worst, worst_name = 0.0, ""
    for (name, pg), pc in zip(gpu.named_parameters(), cpu.parameters()):
        err = float((pg.grad.cpu() - pc.grad).abs().max()) / \
            max(float(pc.grad.abs().max()), 1e-30)
        if err > worst:
            worst, worst_name = err, name
    msg = (f"gradients of {sum(1 for _ in gpu.parameters())} parameters: "
           f"largest error {worst:.3e} of the gradient's scale "
           f"({worst_name}); backward launches {n}")
    check(worst <= 1e-4, msg)
    check(n == {"flash_fwd": gpu.layers, "flash_bwd_dq": gpu.layers,
                "flash_bwd_dkv": gpu.layers}, msg)
    losses = []
    for model, args in ((gpu, args_gpu), (cpu, args_cpu)):
        _, opt = ttr.create_train_state(model, lr=TRAIN_LR)
        losses.append(float(ttr.make_train_step(model, opt,
                                                fused_xent=True)(*args)))
    worst = 0.0
    for pg, pc in zip(gpu.parameters(), cpu.parameters()):
        excess = (pg.detach().cpu() - pc.detach()).abs() - \
            5e-3 * pc.detach().abs()
        worst = max(worst, float(excess.max()))
    msg += (f"; one Adam step: loss {losses[0]:.6f} vs {losses[1]:.6f}, "
            f"parameters' largest |card - CPU| - 5e-3 |CPU| = {worst:.3e} "
            f"(tol 5e-4)")
    check(abs(losses[0] - losses[1]) <= 1e-5 and worst <= 5e-4, msg)
    return msg


def make_store(seed):
    """The slices' data: 4096 windows of 2048 tokens and their next-token
    targets in the store, from a repeated-pattern corpus built as
    ``examples/lm_longcontext.py:133-143`` builds it."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    base = rng.integers(0, VOCAB, size=64)
    corpus = np.tile(base, WINDOWS * SEQ // 64 + 2)
    starts = rng.integers(0, len(corpus) - SEQ - 1, size=WINDOWS)
    at = starts[:, None] + np.arange(SEQ)
    windows = corpus[at].astype(np.int32)
    nexts = corpus[at + 1].astype(np.int32)
    store = DDStore()
    ds = ShardedDataset(store, windows, nexts)
    data_mib = sum(store.row_nbytes(v) * store.total_rows(v)
                   for v in store.variables()) / 2**20
    print(f"store: {data_mib:.1f} MiB in {len(store.variables())} "
          f"variables, {time.perf_counter() - t0:.2f} s", flush=True)
    return store, ds


def full_width_model(dev, seed):
    model = ttr.TransformerLM(vocab=VOCAB, dim=DIM, heads=HEADS,
                              layers=LAYERS, compute_dtype=torch.bfloat16,
                              device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed))
    print(f"model: {sum(p.numel() for p in model.parameters()) / 1e6:.1f} "
          f"M params", flush=True)
    return model


def phase_slice(dev, seed, ds):
    """The serving slice (phase 5)."""
    loader = DeviceLoader(ds, DistributedSampler(WINDOWS, 1, 0, seed=seed),
                          BATCH, device=dev)
    model = full_width_model(dev, seed)
    positions = torch.arange(SEQ, dtype=torch.int32,
                             device=dev).expand(BATCH, SEQ)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    t_start = time.perf_counter()
    batches = iter(loader)
    losses, loss_s = [], []
    for _ in range(LOSS_BATCHES):
        tok, tgt = next(batches)
        check(tok.device == torch.device(dev) and
              tok.shape == (BATCH, SEQ), "loader batch")
        t1 = time.perf_counter()
        with torch.no_grad():
            loss = float(ttr.lm_loss(model, tok, tgt, positions))  # syncs
        loss_s.append(time.perf_counter() - t1)
        losses.append(loss)
    prompts = next(batches)[0]
    batches.close()
    stats = {}
    out = tdec.generate(model, prompts, NEW_TOKENS, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    want = {"flash_fwd": LAYERS * (LOSS_BATCHES + 1), "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0}
    print(f"slice: eval losses {losses} (s each: {loss_s}); generate "
          f"out {tuple(out.shape)}; prefill {stats['prefill_s']:.4f} s = "
          f"{BATCH * SEQ / stats['prefill_s']:.1f} tokens/s (one sample, "
          f"cache allocation included); decode "
          f"{stats['decode_s'] / stats['decode_steps'] * 1e3:.3f} ms per "
          f"step ({BATCH} sequences, one token each, "
          f"{stats['decode_steps']} steps); input_pipeline_efficiency "
          f"{loader.metrics.efficiency:.4f}; loader "
          f"{json.dumps(loader.metrics.summary())}; peak memory "
          f"{peak_gib:.3f} GiB; wall {wall:.3f} s; launches {launches} "
          f"(want {want})", flush=True)
    check(all(math.isfinite(x) and 0 < x < 30 for x in losses),
          f"eval losses not finite/plausible: {losses}")
    check(out.shape == (BATCH, SEQ + NEW_TOKENS), "generate shape")
    check(bool(torch.equal(out[:, :SEQ], prompts)),
          "generate changed the prompt")
    check(bool(((out >= 0) & (out < VOCAB)).all()),
          "generated tokens out of range")
    check(launches == want, f"serving launches {launches} != {want}")
    time_prefill(model, prompts, positions, stats["prefill_s"])
    profile_breakdown(model, prompts, positions)
    return {"launches": launches}


def time_prefill(model, prompts, positions, one_shot_s, repeats=5):
    """The prefill forward (8 prompts of 2048, K/V into the cache) over
    ``repeats`` runs, with the cache made outside the timed span; printed
    beside ``generate``'s one-shot figure, which includes allocating the
    cache."""
    cache = tdec.init_cache(model, BATCH, SEQ + NEW_TOKENS)
    times = []
    with torch.no_grad():
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, kvs = model(prompts, positions, return_features=True,
                           return_kv=True)
            for i, (k, v) in enumerate(kvs):
                cache["k"][i, :, :, :SEQ] = k
                cache["v"][i, :, :, :SEQ] = v
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"prefill: median {med * 1e3:.3f} ms over {repeats} repeats = "
          f"{BATCH * SEQ / med:.1f} tokens/s (ms each: "
          f"{[round(x * 1e3, 3) for x in times]}); generate's one-shot "
          f"prefill {one_shot_s * 1e3:.3f} ms", flush=True)


def device_profile(name, fn):
    """Run ``fn`` once under torch.profiler (after one warm call) and
    print the busy share of the window and its largest kernels. Busy is
    the union of the device's kernel and copy intervals over the
    window's host wall time; the profiler's user annotations on the
    device track (``DistributedDataParallel.forward``, ``Optimizer.step``,
    ``gloo:all_reduce``: ranges that span kernels and the gaps between
    them) are left out, as is any device event named like a host one."""
    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy, by_name = device_busy(prof)
    rows = sorted(by_name.items(), key=lambda r: -r[1][0])
    top = "; ".join(f"{k[:60]} {ms:.3f} ms x{n}"
                    for k, (ms, n) in rows[:10])
    print(f"profile {name}: host wall {wall_ms:.3f} ms, device busy "
          f"{busy:.3f} ms ({busy / wall_ms:.1%}; kernels and copies sum "
          f"{sum(ms for ms, _ in by_name.values()):.3f} ms); top: "
          f"{top or 'no device time captured'}", flush=True)
    return wall_ms, busy


def device_busy(prof):
    """(busy ms, {kernel or copy name: (ms, count)}) of a profile: busy is
    the union of the device's kernel and copy intervals (see
    :func:`device_profile` for what is left out)."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    host = {e.name for e in events if e.device_type != cuda}
    work = [e for e in events if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in host]
    by_name = {}
    for e in work:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy, end = 0.0, None  # the union of the intervals
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in work):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3, by_name


def profile_breakdown(model, prompts, positions):
    """Where the device time goes, after the counted serving run: one
    prefill forward and 4 decode steps."""
    def prefill():
        with torch.no_grad():
            model(prompts, positions, return_features=True, return_kv=True)

    cache = tdec.init_cache(model, BATCH, SEQ + 4)

    def decode():
        for s in range(SEQ, SEQ + 4):
            tdec.decode_step(model, cache, s, prompts[:, -1:])

    device_profile("prefill", prefill)
    device_profile("decode x4", decode)


def lm_flops_per_step(vocab, dim, layers, b, s):
    """Model FLOPs of one train step, counted as ``bench.py:3004`` counts
    them: the matmuls (qkv 6Td^2, proj 2Td^2, MLP 16Td^2 a layer, head
    2TdV) and causal attention (2bs^2d a layer), backward = 2x forward."""
    t = b * s
    fwd = layers * (24 * t * dim * dim + 2 * b * s * s * dim) \
        + 2 * t * dim * vocab
    return 3 * fwd


def phase_train(dev, seed, ds):
    """The training slice (phase 6)."""
    loader = DeviceLoader(ds, DistributedSampler(WINDOWS, 1, 0,
                                                 seed=seed + 1),
                          BATCH, device=dev)
    model = full_width_model(dev, seed + 1)
    state, opt = ttr.create_train_state(model, lr=TRAIN_LR)
    step = ttr.make_train_step(model, opt, state=state)
    step_accum = ttr.make_train_step(model, opt, accum_steps=2, state=state)
    positions = torch.arange(SEQ, dtype=torch.int32,
                             device=dev).expand(BATCH, SEQ)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    t_start = time.perf_counter()
    batches = iter(loader)
    losses, step_s = [], []
    for _ in range(TRAIN_STEPS):
        tok, tgt = next(batches)
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, positions)))  # syncs
        step_s.append(time.perf_counter() - t1)
    tok, tgt = next(batches)
    t1 = time.perf_counter()
    loss_accum = float(step_accum(tok, tgt, positions))
    accum_s = time.perf_counter() - t1
    batches.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30

    per = LAYERS * (TRAIN_STEPS + 2)
    want = {"flash_fwd": per, "flash_bwd_dq": per, "flash_bwd_dkv": per}
    med = float(np.median(step_s[WARMUP_STEPS:]))
    flops = lm_flops_per_step(VOCAB, DIM, LAYERS, BATCH, SEQ)
    print(f"train: {TRAIN_STEPS} steps of ({BATCH}, {SEQ}) at lr "
          f"{TRAIN_LR}, losses {losses}; accum_steps=2 step loss "
          f"{loss_accum} ({accum_s * 1e3:.3f} ms); step ms "
          f"{[round(x * 1e3, 3) for x in step_s]}; median after "
          f"{WARMUP_STEPS} warm-up steps {med * 1e3:.3f} ms = "
          f"{BATCH * SEQ / med:.1f} tokens/s; model FLOPs {flops:.4e} a "
          f"step, utilisation {flops / med / PEAK_BF16_FLOPS:.4f} of "
          f"{PEAK_BF16_FLOPS:.3e}; input_pipeline_efficiency "
          f"{loader.metrics.efficiency:.4f}; loader "
          f"{json.dumps(loader.metrics.summary())}; peak memory "
          f"{peak_gib:.3f} GiB; wall {wall:.3f} s; launches {launches} "
          f"(want {want})", flush=True)
    check(all(math.isfinite(x) for x in losses + [loss_accum]),
          f"train losses not finite: {losses}, {loss_accum}")
    check(losses[-1] < losses[0], f"train loss did not fall: {losses}")
    check(state.step == TRAIN_STEPS + 1, f"state.step {state.step}")
    check(launches == want, f"train launches {launches} != {want}")

    time_head(dev, model, tgt, med)
    device_profile("train step", lambda: float(step(tok, tgt, positions)))
    return {"launches": launches}


def time_head(dev, model, targets, step_s):
    """The fused cross-entropy head alone at the train step's shape:
    forward and backward of ``fused_linear_xent`` on (8 x 2048, 1024)
    bf16 features and the f32 head, its 4 products a vocab block (the
    forward, the backward's recompute, dx and dw, each 2 x 16384 x 1024 x
    8192 FLOP) on the bf16 tensor cores with f32 sums, the reference's
    preferred_element_type=f32; then ``head_route_check``."""
    g = torch.Generator(device=dev).manual_seed(7)
    feats = torch.randn((BATCH * SEQ, DIM), generator=g, device=dev) \
        .to(torch.bfloat16).requires_grad_()
    w = model.lmhead.head.weight.t()
    tgt = targets.reshape(-1)

    def head():
        nll = fused_linear_xent(feats, w, tgt, 8192, torch.bfloat16)
        torch.autograd.grad(nll.mean(), (feats, w))

    xent.xent_tensor_core_products = 0
    head()
    products = xent.xent_tensor_core_products
    want = 4 * math.ceil(VOCAB / 8192)
    ms = time_ms(head, 3, warmup=1)
    flops = 4 * 2.0 * BATCH * SEQ * DIM * VOCAB
    print(f"train head: fused cross-entropy forward + backward "
          f"{ms:.3f} ms = {ms / (step_s * 1e3):.1%} of the median step, "
          f"{flops:.4e} FLOP on the bf16 tensor cores = "
          f"{flops / ms / 1e9:.1f} TFLOP/s against the bound "
          f"{flops / PEAK_BF16_FLOPS * 1e3:.3f} ms at "
          f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s; xent_tensor_core_products "
          f"{products} (want {want})", flush=True)
    check(products == want, f"head products {products} != {want}")
    head_route_check(dev)


@contextlib.contextmanager
def widened_head():
    """Inside, ``fused_linear_xent`` takes its widened-f32 route (the one
    the CPU takes: operands rounded to bf16, widened to f32, f32
    products) on the card too."""
    route = xent._on_tensor_cores
    xent._on_tensor_cores = lambda x, dt: False
    try:
        yield
    finally:
        xent._on_tensor_cores = route


def head_route_check(dev):
    """At each benchmark train cell's head shape, ``fused_linear_xent``'s
    nll, dx and dw (bf16 compute dtype) on the tensor cores against its
    widened-f32 route, both timed; f32 features, so that dx comes back in
    f32 and the gap is the summation order's alone (HEAD_NLL_TOL,
    HEAD_GRAD_REL). Then the f32 compute dtype, which must run no
    tensor-core product."""
    for name, t, d, v in HEAD_SHAPES:
        g = torch.Generator(device=dev).manual_seed(11)
        feats = torch.randn((t, d), generator=g, device=dev) \
            .requires_grad_()
        w = (torch.randn((v, d), generator=g, device=dev) * 0.02) \
            .requires_grad_()
        tgt = torch.randint(0, v, (t,), generator=g, device=dev)

        def head():
            nll = fused_linear_xent(feats, w.t(), tgt, 8192, torch.bfloat16)
            return (nll.detach(),) + torch.autograd.grad(nll.mean(),
                                                         (feats, w))

        xent.xent_tensor_core_products = 0
        got = head()
        products = xent.xent_tensor_core_products
        ms = time_ms(head, 3, warmup=0)
        with widened_head():
            want = head()
            widened_ms = time_ms(head, 1, warmup=0)
        flops = 4 * 2.0 * t * d * v
        gaps = {k: float((a - b).abs().max()) for k, a, b in
                zip(("nll", "dx", "dw"), got, want)}
        scale = {k: float(b.abs().max()) for k, b in
                 zip(("nll", "dx", "dw"), want)}
        n_blocks = math.ceil(v / 8192)
        print(f"head route {name} ({t} x {d} x {v}): tensor cores "
              f"{ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s of the "
              f"products, bound {flops / PEAK_BF16_FLOPS * 1e3:.3f} ms), "
              f"widened f32 {widened_ms:.3f} ms; xent_tensor_core_products "
              f"{products} (want {4 * n_blocks}); largest gap nll "
              f"{gaps['nll']:.3e} (tol {HEAD_NLL_TOL:.0e}), dx "
              f"{gaps['dx']:.3e} of max {scale['dx']:.3e}, dw "
              f"{gaps['dw']:.3e} of max {scale['dw']:.3e} (tol "
              f"{HEAD_GRAD_REL:.0e} of max)", flush=True)
        check(products == 4 * n_blocks,
              f"head route {name}: products {products} != {4 * n_blocks}")
        check(gaps["nll"] <= HEAD_NLL_TOL,
              f"head route {name}: nll gap {gaps['nll']}")
        for k in ("dx", "dw"):
            check(gaps[k] <= HEAD_GRAD_REL * scale[k],
                  f"head route {name}: {k} gap {gaps[k]} of {scale[k]}")
        del feats, w, got, want
        torch.cuda.empty_cache()
    xent.xent_tensor_core_products = 0
    x = torch.randn((512, 64), device=dev, requires_grad=True)
    w = torch.randn((64, 1001), device=dev, requires_grad=True)
    fused_linear_xent(x, w, torch.randint(0, 1001, (512,), device=dev),
                      256, torch.float32).mean().backward()
    print(f"head route f32: xent_tensor_core_products "
          f"{xent.xent_tensor_core_products} (want 0)", flush=True)
    check(xent.xent_tensor_core_products == 0,
          "the f32 compute dtype ran tensor-core products")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def vae_card_vs_cpu(dev, seed):
    """One VAE step (loss and gradients, bf16 hidden layers) on the card
    against the same step on the CPU: same weights, batch and eps."""
    cpu = tvae.VAE(device="cpu").init_weights(
        torch.Generator().manual_seed(seed))
    card = tvae.VAE(device=dev)
    card.load_state_dict(cpu.state_dict())
    per_rank = VAE_BATCH // VAE_RANKS
    raw = torch.from_numpy(synthetic_mnist(per_rank, seed)[0])
    eps = torch.randn((per_rank, tvae.LATENT),
                      generator=torch.Generator().manual_seed(seed + 1))
    res = []
    for model, d in ((cpu, torch.device("cpu")), (card, dev)):
        x = tvae._dequantize(raw.to(d))
        logits, mu, logvar = model(x, eps=eps.to(d))
        loss = tvae.loss_fn(logits, x, mu, logvar)
        loss.backward()
        res.append((loss.item(), {n: p.grad.cpu() for n, p in
                                  model.named_parameters()}))
    (lc, gc), (lg, gg) = res
    worst = max(float((gg[n] - gc[n]).abs().max() / gc[n].abs().max())
                for n in gc)
    msg = (f"vae card vs cpu: loss {lg} vs {lc} (relative "
           f"{abs(lg - lc) / abs(lc):.3e}, tol {VAE_LOSS_RTOL}); worst "
           f"gradient leaf error {worst:.3e} of its largest (tol "
           f"{VAE_GRAD_TOL})")
    print(msg, flush=True)
    check(abs(lg - lc) <= VAE_LOSS_RTOL * abs(lc) and worst <= VAE_GRAD_TOL,
          msg)


def store_rank(phase, rank, world, port, seed, q):
    """One rank of a multi-process phase (``phase``: "vae" or "gnn"), in a
    spawned process; its result (or its traceback) goes to ``q``."""
    try:
        q.put((rank, True, _store_rank(phase, rank, world, port, seed)))
    except Exception:  # noqa: BLE001 — the parent fails the run
        q.put((rank, False, traceback.format_exc()))


def _store_rank(phase, rank, world, port, seed):
    torch.cuda.set_device(0)  # the ranks share the card; before any use
    os.environ["DDSTORE_HOST"] = "127.0.0.1"
    os.environ["DDSTORE_CMA"] = "0"  # the other rank's rows come over TCP
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    group = TorchGroup()
    store = DDStore(group, backend="tcp")
    try:
        train = {"vae": _vae_train, "gnn": _gnn_train,
                 "long": _long_rank, "layouts": _layouts_rank,
                 "pp": _pp_rank, "moesp": _moesp_rank,
                 "fsdpsp": _fsdpsp_rank}[phase]
        out = train(rank, group, store, torch.device("cuda", 0), seed)
        out["transport"] = store.transport_facts()
        out["cma_ops"] = store.cma_ops
        return out
    finally:
        store.close()
        dist.destroy_process_group()


def _vae_train(rank, group, store, dev, seed):
    t0 = time.perf_counter()
    data = synthetic_mnist(VAE_SAMPLES, seed)[0]
    ds = ShardedDataset(store, data)
    setup_s = time.perf_counter() - t0
    per_rank = VAE_BATCH // VAE_RANKS
    model = tvae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    _, opt = tvae.create_train_state(model)
    step = tvae.make_train_step(model, opt, group=dist.group.WORLD)
    sampler = DistributedSampler(len(ds), VAE_RANKS, rank, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + rank)
    loader = DeviceLoader(ds, sampler, per_rank, device=dev)
    first = sampler.epoch_indices()[:per_rank]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    losses, step_s = [], []
    t_start = time.perf_counter()
    for i, xb in enumerate(loader):
        if i == 0:
            want = torch.from_numpy(data[first]).to(dev).float() / 255.0
            check(bool(torch.equal(tvae._dequantize(xb), want)),
                  "staged batch != data[idx] / 255")
        t1 = time.perf_counter()
        losses.append(float(step(xb, generator=gen)))  # syncs
        step_s.append(time.perf_counter() - t1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    summary = loader.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)

    ev = tvae.make_eval_step(model, group=dist.group.WORLD)
    t1 = time.perf_counter()
    ev_loss = sum(float(ev(xb, generator=gen)) for xb in DeviceLoader(
        ds, DistributedSampler(len(ds), VAE_RANKS, rank, shuffle=False),
        per_rank, device=dev))
    eval_s = time.perf_counter() - t1

    # the counted epoch's batches again, untimed: what readahead must stage
    host_digest = batches_digest(DeviceLoader(ds, sampler, per_rank,
                                              device=dev))
    readahead = vae_readahead_epochs(store, ds, sampler, step, gen, dev,
                                     host_digest)

    # more steps, under the profiler on rank 0 (every rank runs the same
    # number: each one is a collective)
    sampler.set_epoch(1)
    batches = iter(DeviceLoader(ds, sampler, per_rank, device=dev))

    def steps():
        for _ in range(VAE_PROFILE_STEPS):
            float(step(next(batches), generator=gen))

    if rank == 0:
        prof = device_profile(f"vae ddp {VAE_PROFILE_STEPS} steps, rank 0",
                              steps)
    else:
        steps()
        steps()
        prof = None
    xb = next(batches)
    batches.close()
    local = tvae.VAE(device=dev)
    local.load_state_dict(model.state_dict())
    local_step = tvae.make_train_step(local,
                                      tvae.create_train_state(local)[1])
    out = {"breakdown": step_breakdown(
               model, lambda: local_step(xb, generator=gen), dev),
           "losses": losses, "step_s": step_s, "wall_s": wall,
           "setup_s": setup_s, "eval_loss": ev_loss, "eval_s": eval_s,
           "launches": launches, "summary": summary, "peak_bytes": peak,
           "readahead": readahead, "rows": len(step_s) * per_rank,
           "row_bytes": store.row_nbytes(ds.data_var), "profile": prof,
           "checksums": group.allgather(param_digest(model))}
    # after the counted epochs: the collective epoch, then phase 9's
    # checks that need two ranks (the shuffle last: it rewrites shards)
    out["collective"] = vae_collective_epoch(rank, group, ds, dev, seed)
    out["ab"] = fetch_ab(store, dev, seed)
    out["shuffle"] = shuffle_check(store, ds, data, group, seed)
    return out


def vae_collective_epoch(rank, group, ds, dev, seed):
    """Phase 7's third epoch: a fresh VAE trained under DDP for one epoch
    whose batches come through the device-collective fetch (every rank
    draws the same global batches of 128, reads the rows it owns, and one
    all_to_all_single over the gloo group delivers its 64). Launch counts
    zeroed just before, read just after; then, untimed, this rank's
    slices of the same global batches read with get_batch, for the
    digest of what the exchange must have delivered."""
    model = tvae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    _, opt = tvae.create_train_state(model)
    step = tvae.make_train_step(model, opt, group=dist.group.WORLD)
    sampler = DistributedSampler(len(ds), 1, 0, seed=seed)  # global
    gen = torch.Generator(device=dev).manual_seed(seed + 1 + rank)
    loader = DeviceLoader(ds, sampler, VAE_BATCH, device=dev,
                          device_collective=True)
    check(loader._collective_ready,
          f"collective fetch unusable: {loader.collective_fallback_reason}")
    torch.cuda.synchronize()
    zero_launch_counts()
    staged, losses, step_s = [], [], []
    t0 = time.perf_counter()
    for xb in loader:
        t1 = time.perf_counter()
        losses.append(float(step(xb, generator=gen)))
        step_s.append(time.perf_counter() - t1)
        staged.append(xb)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    summary = loader.metrics.summary()
    idx, per = sampler.epoch_indices(), VAE_BATCH // VAE_RANKS
    want = hashlib.sha256()
    for b in range(len(staged)):
        lo = b * VAE_BATCH + rank * per
        want.update(ds.fetch(idx[lo:lo + per]).tobytes())
    return {"losses": losses, "step_s": step_s, "wall_s": wall,
            "summary": summary, "launches": launches,
            "batches": len(staged),
            "digest_equal": batches_digest(staged) == want.hexdigest(),
            "fallback": loader.collective_fallback_reason,
            "checksums": group.allgather(param_digest(model))}


def fetch_ab(store, dev, seed):
    """device_fetch_batch against get_batch + the copy to the card (a
    pinned buffer, as the loader stages) at the reference bench's
    geometry, over the store's ranks (a collective: every rank runs the
    same batches in the same order). Every batch is checked equal first,
    then each path is timed per batch, host clock around work that ends
    in a synchronize."""
    rank, world = store.rank, store.world
    counts = nsplit(AB_ROWS, world)
    lo = sum(counts[:rank])
    full = np.random.default_rng(seed + 7).standard_normal(
        (AB_ROWS, AB_DIM), dtype=np.float32)
    store.add("ab", full[lo:lo + counts[rank]])
    rng = np.random.default_rng(seed + 8)
    batches = [rng.integers(0, AB_ROWS, AB_BATCH)
               for _ in range(AB_BATCHES)]
    per = AB_BATCH // world
    buf = torch.empty((per, AB_DIM), pin_memory=True)

    def host(idx):
        store.get_batch("ab", idx[rank * per:(rank + 1) * per],
                        out=buf.numpy())
        return buf.to(dev, non_blocking=True)

    def collective(idx):
        return device_fetch_batch(store, "ab", idx, device=dev)

    for idx in batches:
        check(torch.equal(host(idx), collective(idx)),
              "device_fetch_batch != get_batch of this rank's slice")
    times = {"host": [], "collective": []}
    for idx in batches:
        for name, fn in (("host", host), ("collective", collective),
                         ("collective", collective), ("host", host)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(idx)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
    plans = [plan_device_fetch(store.row_starts("ab"), idx, world)
             for idx in batches]
    row_bytes = store.row_nbytes("ab")
    out = {"host_ms": float(np.median(times["host"])) * 1e3,
           "collective_ms": float(np.median(times["collective"])) * 1e3,
           "host_dcn_bytes": sum(host_bytes_over_dcn(
               store, "ab", idx[rank * per:(rank + 1) * per])
               for idx in batches) // AB_BATCHES,
           "ledger": {k: v // AB_BATCHES for k, v in _sum_ledgers(
               p.rank_ledger(row_bytes, rank) for p in plans).items()},
           "exchange_device": str(exchange_device(None, dev)),
           "world": world}
    store.free("ab")
    return out


def _sum_ledgers(ledgers):
    total = {}
    for led in ledgers:
        for k, v in led.items():
            total[k] = total.get(k, 0) + v
    return total


def _multiset(rows: np.ndarray) -> int:
    """An order-free digest of a set of uint8 rows: the wrapping sum of
    per-row polynomial hashes."""
    words = rows.reshape(len(rows), -1).view(np.uint64)
    mult = np.random.default_rng(12345).integers(
        1, 1 << 62, words.shape[1], dtype=np.uint64) | np.uint64(1)
    with np.errstate(over="ignore"):
        return int(((words * mult).sum(axis=1, dtype=np.uint64) ** 3).sum(
            dtype=np.uint64))


def shuffle_check(store, ds, data, group, seed):
    """host_global_shuffle of the VAE variable over the ranks: this
    rank's shard afterwards must be the plain permutation of the rows
    before it (``data`` by ``seeded_perm_slice``), and the multiset of
    all rows must not change."""
    var = ds.data_var
    total = store.total_rows(var)
    begin, end = store.my_row_range(var)
    t0 = time.perf_counter()
    host_global_shuffle(store, var, seed + 9)
    shuffle_s = time.perf_counter() - t0
    shard = store.get_batch(var, np.arange(begin, end))
    want = data[seeded_perm_slice(total, begin, end, seed + 9)]
    sums = group.allgather(_multiset(shard))
    return {"equal": bool(np.array_equal(shard, want)),
            "multiset_equal": sum(sums) % (1 << 64) == _multiset(data),
            "shuffle_s": shuffle_s, "rows": end - begin}


def batches_digest(batches) -> str:
    digest = hashlib.sha256()
    for xb in batches:
        digest.update(xb.cpu().numpy().tobytes())
    return digest.hexdigest()


def vae_readahead_epochs(store, ds, sampler, step, gen, dev, want_digest):
    """The counted epoch again (same sampler epoch), read through
    epoch-window readahead, with a train step per batch as in the counted
    run: every staged batch's bytes must equal the host path's (their
    digest, taken after the epoch's clock stops), nothing may fall back,
    and no async read may stay in flight; then an epoch cancelled after
    10 batches, which must leave none in flight either."""
    loader = DeviceLoader(ds, sampler, VAE_BATCH // VAE_RANKS, device=dev,
                          readahead_windows=VAE_RA_WINDOWS,
                          readahead_window_batches=VAE_RA_WINDOW_BATCHES)
    staged, step_s = [], []
    t0 = time.perf_counter()
    for xb in loader:
        t1 = time.perf_counter()
        float(step(xb, generator=gen))
        step_s.append(time.perf_counter() - t1)
        staged.append(xb)
    wall = time.perf_counter() - t0
    summary = loader.metrics.summary()
    check(batches_digest(staged) == want_digest,
          "readahead epoch's batches differ from the host path's")
    check(loader.readahead_fallback_reason is None,
          f"readahead fell back: {loader.readahead_fallback_reason}")
    pending = [store.async_pending()]
    batches = iter(loader)
    for _ in range(10):
        next(batches)
    batches.close()
    pending.append(store.async_pending())
    check(pending == [0, 0], f"async reads left in flight: {pending}")
    return {"summary": summary, "step_s": step_s, "wall_s": wall,
            "pending": pending}


def median_ms(fn, n=VAE_PROFILE_STEPS):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def step_breakdown(model, local_step, dev):
    """Parts of a DDP step timed alone (median ms of VAE_PROFILE_STEPS,
    after the counted run; every rank runs the same collectives): the
    gloo all-reduce of the gradients' size on the card and on the host,
    the loss's all-reduce, and ``local_step``, the step of a copy of the
    model without DDP."""
    grads = torch.zeros(sum(p.numel() for p in model.parameters()),
                        device=dev)
    host = grads.cpu()
    scalar = torch.zeros((), device=dev)
    return {"allreduce_grads_card_ms": median_ms(
                lambda: dist.all_reduce(grads)),
            "allreduce_grads_host_ms": median_ms(
                lambda: dist.all_reduce(host)),
            "allreduce_loss_ms": median_ms(lambda: dist.all_reduce(scalar)),
            "step_without_ddp_ms": median_ms(
                lambda: float(local_step())),
            "grad_elements": grads.numel()}


def run_ranks(phase, world, seed):
    """Spawn the rank processes of ``phase`` and collect their results;
    any rank that fails, or dies without a result, fails the run."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=store_rank,
                         args=(phase, r, world, port, seed, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    deadline = time.monotonic() + 900
    try:
        # the first failure ends the phase: its peers may wait on it in a
        # collective or a store barrier until their timeouts
        while len(results) + len(errors) < world and not errors:
            try:
                rank, ok, value = q.get(timeout=5)
                (results if ok else errors)[rank] = value
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs) if p.exitcode not in
                    (None, 0) and r not in results and r not in errors]
            check(not dead, f"{phase} rank(s) {dead} died with exit codes "
                            f"{[procs[r].exitcode for r in dead]}")
            check(time.monotonic() < deadline, f"{phase} ranks timed out")
    finally:
        for p in procs:
            p.join(timeout=5 if errors else 60)
            if p.is_alive():
                p.kill()
                p.join()
    check(not errors, f"{phase} rank failures: {errors}")
    return [results[r] for r in range(world)]


@torch.no_grad()
def _largest_difference(a, b) -> float:
    return max(float((x - y).abs().max())
               for x, y in zip(a.parameters(), b.parameters()))


def nccl_vs_plain(name, models, make_step, inputs, card):
    """A one-process NCCL group: DDP steps of ``models[0]`` on each of
    ``inputs`` (``(args, kwargs)`` of a step), held to the same steps of
    ``models[1]`` without DDP (a sum over one rank)."""
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        check(dist.get_backend() == "nccl", "not an NCCL group")
        steps = [make_step(m, g)
                 for m, g in zip(models, (dist.group.WORLD, None))]
        got = [[float(s(*a, **k)) for s in steps] for a, k in inputs]
        diff = _largest_difference(*models)
        print(f"{name} nccl (one process, NCCL group of 1) | {card}: "
              f"{len(inputs)} DDP steps, losses (ddp, plain) {got}; "
              f"largest parameter difference {diff:.3e}", flush=True)
        check(all(math.isfinite(a) and abs(a - b) <= 1e-6 * abs(b)
                  for a, b in got), f"{name} nccl ddp steps {got}")
        check(diff <= 1e-6, f"{name} nccl ddp parameters differ by {diff}")
    finally:
        dist.destroy_process_group()


def vae_nccl(dev, seed, card):
    """VAE_NCCL_STEPS DDP steps of the VAE in a one-process NCCL group."""
    per_rank = VAE_BATCH // VAE_RANKS
    models = [tvae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed)) for _ in "ab"]
    raw = torch.from_numpy(synthetic_mnist(
        VAE_NCCL_STEPS * per_rank, seed + 2)[0]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    inputs = [((raw[i * per_rank:(i + 1) * per_rank],),
               {"eps": torch.randn((per_rank, tvae.LATENT), generator=gen,
                                   device=dev)})
              for i in range(VAE_NCCL_STEPS)]
    nccl_vs_plain("vae", models, lambda m, g: tvae.make_train_step(
        m, tvae.create_train_state(m)[1], group=g), inputs, card)


def phase_vae(dev, seed, card):
    """The VAE DDP slice (phase 7)."""
    vae_card_vs_cpu(dev, seed)
    print(f"vae ddp: {VAE_RANKS} rank processes on cuda:0, gradients "
          f"all-reduced over gloo (NCCL refuses two ranks on one "
          f"device); the store's remote rows over TCP (DDSTORE_CMA=0)",
          flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks("vae", VAE_RANKS, seed)
    wall = time.perf_counter() - t0
    per_rank = VAE_BATCH // VAE_RANKS
    steps_want = (VAE_SAMPLES // VAE_RANKS) // per_rank
    for r, res in enumerate(ranks):
        losses, m = res["losses"], res["summary"]
        med = float(np.median(res["step_s"]))
        moved = m.get("bytes_moved", {}).get("bytes_over_dcn", 0)
        remote = moved / (res["rows"] * res["row_bytes"])
        print(f"vae ddp rank {r} | {card}: {len(losses)} steps of "
              f"{per_rank}; median step {med * 1e3:.3f} ms = "
              f"{per_rank / med:.1f} samples/s; epoch wall "
              f"{res['wall_s']:.3f} s = {res['rows'] / res['wall_s']:.1f} "
              f"samples/s; input_pipeline_efficiency "
              f"{m['input_pipeline_efficiency']:.4f}; fetch (get_batch of "
              f"{per_rank} rows, about half remote) p50 "
              f"{m['host_fetch']['p50_s'] * 1e3:.3f} ms p99 "
              f"{m['host_fetch']['p99_s'] * 1e3:.3f} ms; bytes over the "
              f"wire per epoch {moved} ({remote:.4f} of the rows); peak "
              f"device memory {res['peak_bytes'] / 2**20:.1f} MiB; store "
              f"set-up {res['setup_s']:.3f} s; eval loss per sample "
              f"{res['eval_loss'] / VAE_SAMPLES:.3f} in "
              f"{res['eval_s']:.3f} s; transport {res['transport']}, CMA "
              f"ops {res['cma_ops']}; launches {res['launches']}; "
              f"scheduler {json.dumps(m.get('sched'))}", flush=True)
        check(len(losses) == steps_want, f"rank {r}: {len(losses)} steps")
        check(all(math.isfinite(x) for x in losses), "vae loss not finite")
        first = float(np.mean(losses[:VAE_TREND]))
        last = float(np.mean(losses[-VAE_TREND:]))
        check(last < first, f"vae loss did not fall: first {VAE_TREND} "
                            f"{first}, last {last}")
        check(moved > 0 and 0.45 <= remote <= 0.55,
              f"rank {r}: {remote} of the rows were remote")
        check(not any(res["launches"].values()),
              f"attention kernels launched on the VAE path: "
              f"{res['launches']}")
        check(len(set(res["checksums"])) == 1,
              f"ranks' parameters differ: {res['checksums']}")
        ra = res["readahead"]
        rm = ra["summary"]
        print(f"vae ddp rank {r} readahead epoch | {card}: "
              f"readahead_windows={VAE_RA_WINDOWS}, "
              f"window_batches={VAE_RA_WINDOW_BATCHES}, the counted "
              f"epoch's batches byte for byte; median step "
              f"{float(np.median(ra['step_s'])) * 1e3:.3f} ms; epoch wall "
              f"{ra['wall_s']:.3f} s; input_pipeline_efficiency "
              f"{rm['input_pipeline_efficiency']:.4f} (host path "
              f"{m['input_pipeline_efficiency']:.4f}); fetch p50 "
              f"{rm['host_fetch']['p50_s'] * 1e3:.3f} ms p99 "
              f"{rm['host_fetch']['p99_s'] * 1e3:.3f} ms (host path "
              f"{m['host_fetch']['p50_s'] * 1e3:.3f} / "
              f"{m['host_fetch']['p99_s'] * 1e3:.3f} ms); bytes over the "
              f"wire {rm.get('bytes_moved', {}).get('bytes_over_dcn', 0)}; "
              f"async reads pending after the epoch and after a "
              f"cancelled one {ra['pending']}; readahead_summary "
              f"{json.dumps(rm['readahead'])}", flush=True)
    check(ranks[0]["losses"] == ranks[1]["losses"],
          "the ranks' all-reduced losses differ")
    vae_collective_report(ranks, card, steps_want)
    meds = [float(np.median(res["step_s"])) for res in ranks]
    total = sum(per_rank / x for x in meds)
    wall_ms, busy_ms = ranks[0]["profile"]
    print(f"vae ddp total | {card}: {total:.1f} samples/s at the ranks' "
          f"median steps ({VAE_BATCH / max(meds):.1f} samples/s by the "
          f"slower rank); losses {ranks[0]['losses'][0]:.1f} -> "
          f"{ranks[0]['losses'][-1]:.1f} (sum over the global batch); "
          f"device busy over {VAE_PROFILE_STEPS} profiled steps "
          f"{busy_ms:.3f} of {wall_ms:.3f} ms ({busy_ms / wall_ms:.1%}); "
          f"phase wall {wall:.1f} s (spawn included)", flush=True)
    br = ranks[0]["breakdown"]
    print(f"vae ddp step breakdown, rank 0 | {card}: median step "
          f"{meds[0] * 1e3:.3f} ms; alone: the same step without DDP "
          f"{br['step_without_ddp_ms']:.3f} ms, gloo all-reduce of the "
          f"{br['grad_elements']} f32 gradients on the card "
          f"{br['allreduce_grads_card_ms']:.3f} ms (on the host "
          f"{br['allreduce_grads_host_ms']:.3f} ms), of the loss "
          f"{br['allreduce_loss_ms']:.3f} ms", flush=True)
    vae_nccl(dev, seed, card)
    return {"launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in ranks[0]["launches"]},
            "collective_launches": {
                k: sum(r["collective"]["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]},
            "wall_s": time.perf_counter() - t0,
            "ab": [r["ab"] for r in ranks],
            "shuffle": [r["shuffle"] for r in ranks]}


def vae_collective_report(ranks, card, steps_want):
    """Phase 7's third epoch: the device-collective fetch's checks and
    numbers, rank by rank."""
    per_rank = VAE_BATCH // VAE_RANKS
    local = 0
    for r, res in enumerate(ranks):
        c = res["collective"]
        m = c["summary"]
        moved, coll = m["bytes_moved"], m["collective"]
        med = float(np.median(c["step_s"]))
        padded_rows = moved["bytes_over_ici"] / res["row_bytes"]
        print(f"vae ddp rank {r} collective epoch | {card}: {c['batches']} "
              f"global batches of {VAE_BATCH}, {per_rank} rows a rank, "
              f"each rank reading only its own rows and one "
              f"all_to_all_single over gloo delivering them (exchange on "
              f"{coll['exchange_device']}); median step {med * 1e3:.3f} ms "
              f"= {per_rank / med:.1f} samples/s; epoch wall "
              f"{c['wall_s']:.3f} s; input_pipeline_efficiency "
              f"{m['input_pipeline_efficiency']:.4f}; staging (plan, local "
              f"get_batch, send buffer, copy to the card) p50 "
              f"{m['host_fetch']['p50_s'] * 1e3:.3f} ms p99 "
              f"{m['host_fetch']['p99_s'] * 1e3:.3f} ms; exchange "
              f"(all_to_all_single + index_select) p50 "
              f"{m['device_put']['p50_s'] * 1e3:.3f} ms p99 "
              f"{m['device_put']['p99_s'] * 1e3:.3f} ms; exchanges "
              f"{coll['exchanges']}; ledger {json.dumps(moved)}; padding "
              f"share of the rows sent "
              f"{1 - moved['rows_over_ici'] / padded_rows:.4f}; losses "
              f"{c['losses'][0]:.1f} -> {c['losses'][-1]:.1f}; launches "
              f"{c['launches']}; fallbacks "
              f"{m['faults']['collective_batch_fallbacks']}", flush=True)
        check(c["fallback"] is None, f"collective fell back: {c['fallback']}")
        check(m["faults"]["collective_batch_fallbacks"] == 0,
              "collective batches fell back to the host path")
        check(c["batches"] == steps_want and
              coll["exchanges"] == c["batches"],
              f"rank {r}: {coll['exchanges']} exchanges for "
              f"{c['batches']} batches")
        check(moved["bytes_over_dcn"] == 0, "collective rows crossed TCP")
        share = moved["rows_over_ici"] / (c["batches"] * per_rank)
        check(0.45 <= share <= 0.55,
              f"rank {r}: {share} of its rows sent to the other rank")
        check(c["digest_equal"], "collective epoch's batches differ from "
                                 "get_batch of the same slices")
        check(all(math.isfinite(x) for x in c["losses"]),
              "collective epoch loss not finite")
        check(np.mean(c["losses"][-VAE_TREND:]) <
              np.mean(c["losses"][:VAE_TREND]),
              "collective epoch's loss did not fall")
        check(not any(c["launches"].values()),
              f"attention kernels launched: {c['launches']}")
        check(len(set(c["checksums"])) == 1,
              f"collective epoch's parameters differ: {c['checksums']}")
        local += moved["bytes_local_get"]
    want = steps_want * VAE_BATCH * ranks[0]["row_bytes"]
    check(local == want, f"ranks' local reads {local} != epoch bytes {want}")
    check(ranks[0]["collective"]["losses"] ==
          ranks[1]["collective"]["losses"],
          "the ranks' collective-epoch losses differ")


def gnn_batch_on(batch, dev):
    return GraphBatch(*(torch.from_numpy(np.asarray(f)).to(dev)
                        for f in batch))


def _mpnn_step(weights, dtype, dev, host):
    """One MPNN train step (Adam at lr 1e-3) from ``weights`` on ``dev``:
    the loss, and each parameter's gradient and value after the step, on
    the CPU."""
    model = tgnn.MPNN(n_graphs=GNN_G, compute_dtype=dtype, device=dev)
    model.load_state_dict(weights)
    loss = float(tgnn.make_train_step(
        model, tgnn.create_train_state(model)[1])(gnn_batch_on(host, dev)))
    return (loss, {n: p.grad.cpu() for n, p in model.named_parameters()},
            {n: p.detach().cpu() for n, p in model.named_parameters()})


def _step_errors(run, ref, weights):
    """A step against the reference step from the same ``weights``: the
    loss's relative error, the worst gradient leaf's L2 error over its
    L2 norm, the parameters' largest difference after the step, and the
    share of weights the step moved another way than the reference."""
    (loss, grads, after), (rloss, rgrads, rafter) = run, ref
    flips = sum(int((torch.sign(after[n] - w)
                     != torch.sign(rafter[n] - w)).sum())
                for n, w in weights.items())
    return (abs(loss - rloss) / abs(rloss),
            max(float((grads[n] - g).norm() / g.norm())
                for n, g in rgrads.items()),
            max(float((after[n] - a).abs().max()) for n, a in rafter.items()),
            flips / sum(w.numel() for w in weights.values()))


def gnn_card_vs_cpu(dev, seed, card):
    """One MPNN train step (the repo's GNN at full width, one slot of
    GNN_G graphs) on the card against the CPU's f32 step from the same
    weights. f32 directly, at GNN_F32_TOL. In bf16 the card (cuBLAS
    products, the scatter's bf16 atomics in a varying order) and the CPU
    round differently, so both bf16 steps are held to the f32 step, and
    the card's error in each of GNN_BF16_RUNS steps to at most
    GNN_BF16_FACTOR times the CPU's."""
    graphs = synthetic_graphs(np.random.default_rng(seed), GNN_G)
    host = pack_graph_batch(graphs, 1, GNN_G, GNN_G * 12, GNN_G * 36)
    weights = tgnn.MPNN(n_graphs=GNN_G, device="cpu").init_weights(
        torch.Generator().manual_seed(seed)).state_dict()
    ref = _mpnn_step(weights, torch.float32, "cpu", host)

    loss_err, grad_err, step_err, _ = _step_errors(
        _mpnn_step(weights, torch.float32, dev, host), ref, weights)
    loss_rtol, grad_tol, step_atol = GNN_F32_TOL
    msg = (f"gnn card vs cpu (float32) | {card}: loss relative error "
           f"{loss_err:.3e} (tol {loss_rtol}); worst gradient leaf error "
           f"{grad_err:.3e} of its L2 norm (tol {grad_tol}); parameters "
           f"after one Adam step differ by at most {step_err:.3e} (tol "
           f"{step_atol})")
    print(msg, flush=True)
    check(loss_err <= loss_rtol and grad_err <= grad_tol
          and step_err <= step_atol, msg)

    cpu = _step_errors(_mpnn_step(weights, torch.bfloat16, "cpu", host),
                       ref, weights)
    runs = [_mpnn_step(weights, torch.bfloat16, dev, host)
            for _ in range(GNN_BF16_RUNS)]
    errs = [_step_errors(r, ref, weights) for r in runs]
    # the card's steps among themselves: the atomics' varying order
    spread = max(_step_errors(r, runs[0], weights)[1] for r in runs[1:])
    limits = (max(GNN_BF16_FACTOR * cpu[0], 2.0 ** -8),
              GNN_BF16_FACTOR * cpu[1], GNN_BF16_FACTOR * cpu[3])
    worst = tuple(max(e[i] for e in errs) for i in (0, 1, 3))
    msg = (f"gnn card vs cpu (bfloat16), each against the CPU's f32 step "
           f"| {card}: CPU loss error {cpu[0]:.3e}, worst gradient leaf "
           f"{cpu[1]:.3e} of its L2 norm, steps moved another way "
           f"{cpu[3]:.4%}, parameters {cpu[2]:.3e}; card over "
           f"{GNN_BF16_RUNS} steps: loss {min(e[0] for e in errs):.3e}"
           f"-{worst[0]:.3e} (limit {limits[0]:.3e}), gradient "
           f"{min(e[1] for e in errs):.3e}-{worst[1]:.3e} (limit "
           f"{limits[1]:.3e}), steps moved another way "
           f"{min(e[3] for e in errs):.4%}-{worst[2]:.4%} (limit "
           f"{limits[2]:.4%}), parameters up to "
           f"{max(e[2] for e in errs):.3e}; the card's steps among "
           f"themselves: worst gradient leaf {spread:.3e} of its L2 norm")
    print(msg, flush=True)
    check(all(w <= lim for w, lim in zip(worst, limits)), msg)


def _gnn_train(rank, group, store, dev, seed):
    t0 = time.perf_counter()
    graphs = synthetic_graphs(np.random.default_rng(seed + rank),
                              nsplit(GNN_GRAPHS, GNN_RANKS)[rank])
    gen_s = time.perf_counter() - t0
    ds = GraphShardedDataset(store, graphs, graphs_per_slot=GNN_G)
    setup_s = time.perf_counter() - t0
    graph_bytes = sum(store.row_nbytes(v) * store.total_rows(v)
                      for v in store.variables())
    model = tgnn.MPNN(n_graphs=GNN_G, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed))
    _, opt = tgnn.create_train_state(model, lr=GNN_LR)
    step = tgnn.make_train_step(model, opt, group=dist.group.WORLD)
    sampler = DistributedSampler(len(ds), GNN_RANKS, rank, seed=seed)
    idx = sampler.epoch_indices()[:GNN_STEPS * GNN_G]
    loader = DeviceLoader(ds, sampler, GNN_G, device=dev)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    losses, step_s = [], []
    batches = iter(loader)
    t_start = time.perf_counter()
    for i in range(GNN_STEPS):
        gb = next(batches)
        if i == 0:
            staged = [f.cpu().numpy() for f in gb]
        t1 = time.perf_counter()
        losses.append(float(step(gb)))  # syncs
        step_s.append(time.perf_counter() - t1)
    batches.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    summary = loader.metrics.summary()
    peak = torch.cuda.max_memory_allocated(dev)

    # the first staged batch against the same graphs read one at a time
    one = [GraphSample(*(store.get_ragged(f"graphs/{v}", int(i))
                         for v in ("nodes", "edge_index", "edge_attr")),
                       store.get("graphs/y", int(i))[0])
           for i in idx[:GNN_G]]
    want = pack_graph_batch(one, 1, GNN_G, ds.node_budget, ds.edge_budget)
    for name, a, b in zip(GraphBatch._fields, staged, want):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"staged GraphBatch.{name} != pack_graph_batch of get_ragged")
    remote = float(np.mean(store.owner_of_rows("graphs/nodes/index", idx)
                           != rank))

    ev = tgnn.make_eval_step(model, group=dist.group.WORLD)
    eval_loader = DeviceLoader(
        ds, DistributedSampler(len(ds), GNN_RANKS, rank, shuffle=False),
        GNN_G, device=dev)
    t1 = time.perf_counter()
    eval_losses = [float(ev(gb)) for gb in
                   itertools.islice(eval_loader, GNN_EVAL_BATCHES)]
    eval_s = time.perf_counter() - t1

    # more steps, under the profiler on rank 0 (every rank runs the same
    # number: each one is a collective)
    sampler.set_epoch(1)
    batches = iter(DeviceLoader(ds, sampler, GNN_G, device=dev))

    def steps():
        for _ in range(GNN_PROFILE_STEPS):
            float(step(next(batches)))

    if rank == 0:
        prof = device_profile(f"gnn ddp {GNN_PROFILE_STEPS} steps, rank 0",
                              steps)
    else:
        steps()
        steps()
        prof = None
    gb = next(batches)
    batches.close()
    local = tgnn.MPNN(n_graphs=GNN_G, device=dev)
    local.load_state_dict(model.state_dict())
    local_step = tgnn.make_train_step(
        local, tgnn.create_train_state(local, lr=GNN_LR)[1])
    ragged = ragged_fetch_check(store, rank, dev, seed)
    return {"breakdown": step_breakdown(model, lambda: local_step(gb), dev),
            "ragged": ragged,
            "losses": losses, "step_s": step_s, "wall_s": wall,
            "gen_s": gen_s, "setup_s": setup_s, "graph_bytes": graph_bytes,
            "eval_losses": eval_losses, "eval_s": eval_s,
            "launches": launches, "summary": summary, "peak_bytes": peak,
            "remote": remote, "profile": prof,
            "budgets": (ds.node_budget, ds.edge_budget),
            "checksums": group.allgather(param_digest(model))}


def ragged_fetch_check(store, rank, dev, seed):
    """Phase 9's ragged check, in phase 8's ranks after their counted
    run: device_fetch_ragged_batch of one global batch of the GNN's
    ``nodes`` against get_ragged_batch + pad_ragged of this rank's
    slice."""
    name = "graphs/nodes"
    idx = np.random.default_rng(seed + 5).integers(
        0, store.ragged_total(name), 4 * GNN_G * GNN_RANKS)
    per = len(idx) // GNN_RANKS
    t0 = time.perf_counter()
    padded, lens = device_fetch_ragged_batch(store, name, idx,
                                             RAGGED_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    fetch_s = time.perf_counter() - t0
    values, want_lens = store.get_ragged_batch(
        name, idx[rank * per:(rank + 1) * per])
    want, _ = pad_ragged(values, want_lens, RAGGED_MAX_LEN)
    return {"equal": bool(padded.is_cuda and np.array_equal(lens, want_lens)
                          and padded.cpu().numpy().tobytes()
                          == want.tobytes()),
            "shape": list(padded.shape), "fetch_s": fetch_s}


def phase_gnn(dev, seed, card):
    """The GNN DDP slice (phase 8)."""
    gnn_card_vs_cpu(dev, seed, card)
    print(f"gnn ddp: {GNN_RANKS} rank processes on cuda:0, gradients "
          f"all-reduced over gloo; the store's remote graphs over TCP "
          f"(DDSTORE_CMA=0)", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks("gnn", GNN_RANKS, seed)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        losses, m = res["losses"], res["summary"]
        med = float(np.median(res["step_s"]))
        print(f"gnn ddp rank {r} | {card}: {len(losses)} steps of "
              f"{GNN_G} graphs (budgets {res['budgets']}); median step "
              f"{med * 1e3:.3f} ms = {GNN_G / med:.1f} graphs/s; run wall "
              f"{res['wall_s']:.3f} s = "
              f"{len(losses) * GNN_G / res['wall_s']:.1f} graphs/s; "
              f"input_pipeline_efficiency "
              f"{m['input_pipeline_efficiency']:.4f}; fetch (three ragged "
              f"reads and one fixed of {GNN_G} graphs, packed) p50 "
              f"{m['host_fetch']['p50_s'] * 1e3:.3f} ms p99 "
              f"{m['host_fetch']['p99_s'] * 1e3:.3f} ms; {res['remote']:.4f}"
              f" of the graphs read from the other rank; peak device "
              f"memory {res['peak_bytes'] / 2**20:.1f} MiB; graphs made in "
              f"{res['gen_s']:.3f} s, store set-up {res['setup_s']:.3f} s, "
              f"{res['graph_bytes'] / 1e6:.1f} MB in the store; eval "
              f"{len(res['eval_losses'])} batches in {res['eval_s']:.3f} s,"
              f" mean loss {np.mean(res['eval_losses']):.5f}; transport "
              f"{res['transport']}, CMA ops {res['cma_ops']}; launches "
              f"{res['launches']}; scheduler {json.dumps(m.get('sched'))}",
              flush=True)
        check(len(losses) == GNN_STEPS, f"rank {r}: {len(losses)} steps")
        check(all(math.isfinite(x) for x in losses + res["eval_losses"]),
              "gnn loss not finite")
        first = float(np.mean(losses[:GNN_TREND]))
        last = float(np.mean(losses[-GNN_TREND:]))
        check(last < first, f"gnn loss did not fall: first {GNN_TREND} "
                            f"{first}, last {last}")
        check(0.45 <= res["remote"] <= 0.55,
              f"rank {r}: {res['remote']} of the graphs were remote")
        check(not any(res["launches"].values()),
              f"attention kernels launched on the GNN path: "
              f"{res['launches']}")
        check(len(set(res["checksums"])) == 1,
              f"ranks' parameters differ: {res['checksums']}")
    check(ranks[0]["losses"] == ranks[1]["losses"],
          "the ranks' all-reduced losses differ")
    meds = [float(np.median(res["step_s"])) for res in ranks]
    wall_ms, busy_ms = ranks[0]["profile"]
    print(f"gnn ddp total | {card}: {sum(GNN_G / x for x in meds):.1f} "
          f"graphs/s at the ranks' median steps, "
          f"{sum(len(r['losses']) * GNN_G / r['wall_s'] for r in ranks):.1f}"
          f" over the runs' walls; losses (mean of the first and last "
          f"{GNN_TREND}) {np.mean(ranks[0]['losses'][:GNN_TREND]):.5f} -> "
          f"{np.mean(ranks[0]['losses'][-GNN_TREND:]):.5f}; device busy "
          f"over {GNN_PROFILE_STEPS} profiled steps {busy_ms:.3f} of "
          f"{wall_ms:.3f} ms ({busy_ms / wall_ms:.1%}); phase wall "
          f"{wall:.1f} s (spawn included)", flush=True)
    br = ranks[0]["breakdown"]
    print(f"gnn ddp step breakdown, rank 0 | {card}: median step "
          f"{meds[0] * 1e3:.3f} ms; alone: the same step without DDP "
          f"{br['step_without_ddp_ms']:.3f} ms, gloo all-reduce of the "
          f"{br['grad_elements']} f32 gradients on the card "
          f"{br['allreduce_grads_card_ms']:.3f} ms (on the host "
          f"{br['allreduce_grads_host_ms']:.3f} ms), of the loss "
          f"{br['allreduce_loss_ms']:.3f} ms", flush=True)
    gnn_nccl(dev, seed, card)
    return {"launches": {k: sum(r["launches"][k] for r in ranks)
                         for k in ranks[0]["launches"]},
            "ragged": [r["ragged"] for r in ranks]}


def gnn_nccl(dev, seed, card):
    """GNN_NCCL_STEPS DDP steps of the MPNN in a one-process NCCL group,
    with PyTorch's deterministic algorithms: the scatter's atomics would
    otherwise sum in a different order in the two models."""
    models = [tgnn.MPNN(n_graphs=GNN_G, device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed)) for _ in "ab"]
    graphs = synthetic_graphs(np.random.default_rng(seed + 2),
                              GNN_NCCL_STEPS * GNN_G)
    inputs = [((gnn_batch_on(pack_graph_batch(
        graphs[i * GNN_G:(i + 1) * GNN_G], 1, GNN_G, GNN_G * 12,
        GNN_G * 36), dev),), {}) for i in range(GNN_NCCL_STEPS)]
    torch.use_deterministic_algorithms(True)
    try:
        nccl_vs_plain("gnn", models, lambda m, g: tgnn.make_train_step(
            m, tgnn.create_train_state(m, lr=GNN_LR)[1], group=g), inputs,
            card)
    finally:
        torch.use_deterministic_algorithms(False)


def phase_collective(dev, seed, card, va, gn):
    """Phase 9: the device-collective fetch and the shuffles beyond phase
    7's epoch. Here, in a one-process NCCL group over a world-1 store:
    20 batches of the loader's collective path against the host path,
    the A/B at the bench geometry, global_shuffle_epoch and
    permute_rows on the card. Then the checks phases 7 and 8 ran in
    their rank processes: the A/B over gloo, the ragged fetch of the
    GNN's nodes, and host_global_shuffle of the VAE variable."""
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    store = DDStore()
    try:
        check(dist.get_backend() == "nccl", "not an NCCL group")
        data = synthetic_mnist(VAE_SAMPLES, seed)[0]
        ds = ShardedDataset(store, data)
        sampler = DistributedSampler(len(ds), 1, 0, seed=seed)
        loader = DeviceLoader(ds, sampler, VAE_BATCH, device=dev,
                              device_collective=True)
        check(loader._collective_ready,
              f"collective unusable: {loader.collective_fallback_reason}")
        zero_launch_counts()
        batches = iter(loader)
        staged = [next(batches) for _ in range(COLL_NCCL_BATCHES)]
        batches.close()
        launches = launch_counts()
        m = loader.metrics.summary()
        idx = sampler.epoch_indices()
        want = hashlib.sha256()
        for b in range(COLL_NCCL_BATCHES):
            want.update(ds.fetch(
                idx[b * VAE_BATCH:(b + 1) * VAE_BATCH]).tobytes())
        coll = m["collective"]
        print(f"collective nccl (one process, NCCL group of 1) | {card}: "
              f"{COLL_NCCL_BATCHES} batches of {VAE_BATCH}, exchange on "
              f"{coll['exchange_device']}, exchanges {coll['exchanges']}; "
              f"staging p50 {m['host_fetch']['p50_s'] * 1e3:.3f} ms, "
              f"exchange p50 {m['device_put']['p50_s'] * 1e3:.3f} ms; "
              f"launches {launches}", flush=True)
        check(all(x.is_cuda for x in staged), "batches not on the card")
        check(batches_digest(staged) == want.hexdigest(),
              "NCCL collective batches differ from get_batch")
        check(coll["exchange_device"].startswith("cuda"),
              f"NCCL exchange on {coll['exchange_device']}")
        check(coll["exchanges"] == COLL_NCCL_BATCHES,
              f"{coll['exchanges']} exchanges for {COLL_NCCL_BATCHES}")
        check(loader.collective_fallback_reason is None and
              m["faults"]["collective_batch_fallbacks"] == 0,
              "the NCCL collective fell back")
        check(not any(launches.values()), f"attention launched {launches}")
        ab = [fetch_ab(store, dev, seed)] + va["ab"]
        x = torch.from_numpy(data[:8192]).to(dev)
        t1 = time.perf_counter()
        y = global_shuffle_epoch(x, seed)
        torch.cuda.synchronize()
        shuffle_ms = (time.perf_counter() - t1) * 1e3
        perm = np.random.default_rng(seed + 3).permutation(len(x))
        t1 = time.perf_counter()
        z = permute_rows(x, perm)
        torch.cuda.synchronize()
        permute_ms = (time.perf_counter() - t1) * 1e3
        check(y.is_cuda and torch.equal(y, global_shuffle_epoch(x, seed))
              and _multiset(y.cpu().numpy()) == _multiset(data[:8192])
              and not torch.equal(y, x),
              "global_shuffle_epoch is not a seeded permutation")
        check(torch.equal(z, x[torch.from_numpy(perm).to(dev)]),
              "permute_rows != x[perm]")
        print(f"shuffles nccl | {card}: global_shuffle_epoch of "
              f"{tuple(x.shape)} uint8 {shuffle_ms:.3f} ms, permute_rows "
              f"{permute_ms:.3f} ms (first calls, one rank)", flush=True)
    finally:
        store.close()
        dist.destroy_process_group()
    for a in ab:
        print(f"device_fetch A/B ({a['world']} rank(s), "
              f"{'NCCL' if a['world'] == 1 else 'gloo'}, exchange on "
              f"{a['exchange_device']}) | {card}: {AB_BATCHES} batches of "
              f"{AB_BATCH} from {AB_ROWS} x {AB_DIM} f32, every batch equal "
              f"first; median per batch: get_batch + copy to the card "
              f"{a['host_ms']:.3f} ms, device_fetch_batch "
              f"{a['collective_ms']:.3f} ms; per batch and rank the host "
              f"path pulls {a['host_dcn_bytes']} bytes over TCP, the "
              f"collective {json.dumps(a['ledger'])}", flush=True)
    for r, (g, sh) in enumerate(zip(gn["ragged"], va["shuffle"])):
        print(f"rank {r} | {card}: device_fetch_ragged_batch of "
              f"graphs/nodes {g['shape']} equal {g['equal']} "
              f"({g['fetch_s'] * 1e3:.3f} ms, first call); "
              f"host_global_shuffle of the VAE variable ({sh['rows']} rows "
              f"a rank) {sh['shuffle_s']:.3f} s, shard = plain "
              f"permutation {sh['equal']}, multiset kept "
              f"{sh['multiset_equal']}", flush=True)
        check(g["equal"], "device_fetch_ragged_batch != get_ragged_batch")
        check(sh["equal"] and sh["multiset_equal"],
              "host_global_shuffle is not the seeded permutation")
    wall = time.perf_counter() - t0
    print(f"phase 9 wall {wall:.1f} s (phase 7 {va['wall_s']:.1f} s, its "
          f"rank processes holding the two-rank checks)", flush=True)
    return {"launches": launches}


class VarRows:
    """One registered store variable as a loader dataset (a rejoined
    rank holds its restored shard, which ShardedDataset would register
    again). ``reader`` serves the reads: the store by default, a gateway
    session for the eval split."""

    label_var = None

    def __init__(self, store, var, reader=None):
        self.store, self.data_var = store, var
        self.reader = store if reader is None else reader

    def __len__(self):
        return self.store.total_rows(self.data_var)

    def specs(self):
        return [self.store.sample_spec(self.data_var)]

    def fetch(self, idx, out=None):
        return self.reader.get_batch(
            self.data_var, np.ascontiguousarray(idx, np.int64), out=out)


def _write_json(path, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def _el_dirs(work):
    return {k: os.path.join(work, k) for k in
            ("rdv", "elastic", "ckpt", "trace")}


def _fixed_digest(store, seed):
    """Digest of one get_batch of a fixed index set, which must cover
    every rank's shard."""
    n = store.total_rows(EL_VAR)
    idx = np.sort(np.random.default_rng(seed + 5).choice(
        n, EL_FIXED, replace=False))
    owners = set(store.owner_of_rows(EL_VAR, idx).tolist())
    check(owners == set(range(EL_RANKS)), f"fixed set owners {owners}")
    return hashlib.sha256(store.get_batch(EL_VAR, idx).tobytes()).hexdigest()


class ElasticTrainer:
    """One rank's VAE, its Adam, its loader over the store, its progress
    log (a line per step: the step and the loss) and its checkpoints:
    every EL_SAVE_EVERY steps an async save of the model and the Adam
    state, step-stamped, with the parameters' digest and the device and
    dtype of every Adam state tensor beside it."""

    def __init__(self, store, rank, work, seed, dev, log_tag):
        self.rank, self.seed, self.dev = rank, seed, dev
        self.ckpt = _el_dirs(work)["ckpt"]
        self.model = tvae.VAE(device=dev).init_weights(
            torch.Generator(device=dev).manual_seed(seed + 10 + rank))
        _, self.opt = tvae.create_train_state(self.model)
        self.step_fn = tvae.make_train_step(self.model, self.opt)
        self.gen = torch.Generator(device=dev).manual_seed(seed + 20 + rank)
        self.sampler = DistributedSampler(store.total_rows(EL_VAR), EL_RANKS,
                                          rank, seed=seed)
        self.loader = DeviceLoader(VarRows(store, EL_VAR), self.sampler,
                                   EL_BATCH, device=dev)
        self.t, self.epoch, self.losses = 0, 0, []
        self.step_s, self.step_s_saving = [], []
        self.pending, self.saved = None, []
        self.log = open(os.path.join(work, f"log.{log_tag}.r{rank}"), "a")

    def state(self):
        return {"model": self.model.state_dict(),
                "opt": self.opt.state_dict(), "step": self.t}

    def placement(self):
        """Each Adam state tensor's parameter index, key, device and
        dtype, 0-dim ones (the step counts) included."""
        return [[i, k, str(v.device), str(v.dtype)]
                for i, p in enumerate(self.model.parameters())
                for k, v in sorted(self.opt.state[p].items())]

    def batches(self):
        """Batches epoch after epoch; each epoch a new loader iterator."""
        while True:
            self.sampler.set_epoch(self.epoch)
            self.epoch += 1
            yield from self.loader

    def train(self, xb) -> float:
        saving = self.pending is not None and not self.pending.done()
        t0 = time.perf_counter()
        loss = float(self.step_fn(xb, generator=self.gen))  # syncs
        (self.step_s_saving if saving else self.step_s).append(
            time.perf_counter() - t0)
        self.t += 1
        self.losses.append(loss)
        self.log.write(f"{self.t} {loss!r}\n")
        self.log.flush()
        if self.t % EL_SAVE_EVERY == 0:
            self.save()
        return loss

    def save(self) -> None:
        if self.pending is not None:
            self.pending.wait()  # one write at a time
            for old in self.saved[:-1]:  # keep the last complete one
                os.unlink(old)
            self.saved = self.saved[-1:]
        path = os.path.join(self.ckpt, f"state.r{self.rank}.s{self.t:06d}")
        with open(path + ".digest", "w") as f:
            f.write(param_digest(self.model))
        _write_json(path + ".place", self.placement())
        self.pending = checkpoint.save_train_state_async(path + ".pt",
                                                         self.state())
        self.saved.append(path + ".pt")

    def restore(self):
        """The newest complete checkpoint of this rank (a save cut by
        the kill leaves only its digest): its path and step, the
        parameters checked against the digest written at that save."""
        done = sorted(f for f in os.listdir(self.ckpt)
                      if f.startswith(f"state.r{self.rank}.s")
                      and f.endswith(".pt"))
        check(bool(done), f"rank {self.rank}: no train-state checkpoint")
        path = os.path.join(self.ckpt, done[-1])
        got = checkpoint.restore_train_state(path, self.state())
        self.model.load_state_dict(got["model"])
        self.opt.load_state_dict(got["opt"])
        self.t = int(got["step"])
        with open(path[:-3] + ".digest") as f:
            want = f.read()
        check(param_digest(self.model) == want,
              f"rank {self.rank}: restored parameters != the digest "
              f"written at step {self.t}")
        with open(path[:-3] + ".place") as f:
            want = json.load(f)
        check(any(k == "step" for _, k, _, _ in want)
              and all(d == ("cpu" if k == "step" else str(self.dev))
                      for _, k, d, _ in want),
              f"rank {self.rank}: the saved Adam state is not placed as "
              f"Adam places it: {want[:3]}")
        check(self.placement() == want,
              f"rank {self.rank}: the restored Adam state is placed "
              f"otherwise than the saved one")
        return path

    def finish(self):
        if self.pending is not None:
            self.pending.wait()
        self.log.close()
        return {"losses": self.losses, "steps": self.t,
                "step_ms": float(np.median(self.step_s)) * 1e3,
                "step_saving_ms": float(np.median(self.step_s_saving)) * 1e3
                if self.step_s_saving else None,
                "steps_saving": len(self.step_s_saving)}


def _el_services(store, rank, work, seed, dev):
    """Phase 10 A, before training: the eval split under tenant "eval"
    (a quota, an over-quota add refused), read whole by a gateway
    session through a loader onto the card with native tracing on, the
    VAE's eval loss; the trace dumps, the store's summaries."""
    data = synthetic_mnist(EL_EVAL_SAMPLES, seed + EL_EVAL_SEED)[0]
    counts = nsplit(len(data), EL_RANKS)
    begin = sum(counts[:rank])
    # the quota is each rank's native ledger: with it on rank 0 alone, an
    # over-quota add would be refused there and strand the others in the
    # add's barrier
    store.set_tenant_quota("eval", EL_QUOTA)
    h = store.attach("eval")
    h.add("eval", data[begin:begin + counts[rank]])
    try:
        h.add("eval_over", np.zeros((EL_OVER_ROWS, tvae.IMAGE_DIM),
                                    np.uint8))
        refused = None
    except DDStoreError as e:
        refused = e.code
    check(refused == binding.ERR_QUOTA,
          f"rank {rank}: over-quota add gave {refused}, not ERR_QUOTA")
    store.gateway_configure(enabled=1)
    binding.trace_configure(1)
    binding.trace_reset()
    model = tvae.VAE(device=dev).init_weights(
        torch.Generator(device=dev).manual_seed(seed + 10 + rank))
    ev = tvae.make_eval_step(model)
    gen = torch.Generator(device=dev).manual_seed(seed + 40 + rank)
    sess = store.gateway_session(tenant="eval")
    loader = DeviceLoader(VarRows(h, "eval", reader=sess),
                          DistributedSampler(EL_EVAL_SAMPLES, 1, 0,
                                             shuffle=False),
                          EL_EVAL_BATCH, device=dev, drop_last=False)
    got, loss, nb = hashlib.sha256(), 0.0, 0
    t0 = time.perf_counter()
    for xb in loader:
        check(xb.device == dev, f"eval batch on {xb.device}")
        loss += float(ev(xb, generator=gen))
        got.update(xb.cpu().numpy().tobytes())
        nb += 1
    eval_s = time.perf_counter() - t0
    summary = loader.metrics.summary()
    trace_summary = store.trace_summary()
    sess_stats = sess.stats()
    sess.close()
    dump = os.path.join(_el_dirs(work)["trace"], f"r{rank}.npy")
    obs.save_dump(dump, store.trace_dump())
    binding.trace_configure(0)
    want = hashlib.sha256()
    for b in range(0, EL_EVAL_SAMPLES, EL_EVAL_BATCH):
        want.update(h.get_batch("eval", np.arange(
            b, min(EL_EVAL_SAMPLES, b + EL_EVAL_BATCH))).tobytes())
    check(got.hexdigest() == want.hexdigest(),
          f"rank {rank}: the session's eval bytes != the handle's")
    out = {"eval_loss": loss / EL_EVAL_SAMPLES, "eval_s": eval_s,
           "eval_batches": nb, "refused": refused,
           "session": sess_stats, "tenant_stats": store.tenant_stats(),
           "loader_tenants": summary.get("tenants"),
           "loader_trace_captured": summary.get("trace", {}).get(
               "captured"),
           "trace_summary": trace_summary,
           "metrics_summary": store.metrics_summary()}
    store.barrier()  # every dump written, every eval read done
    if rank == 0:
        merged = obs.merge(obs.load_dump(os.path.join(
            _el_dirs(work)["trace"], f"r{r}.npy")) for r in range(EL_RANKS))
        os.makedirs(EL_OUT, exist_ok=True)
        with open(os.path.join(EL_OUT, "store_trace.json"), "w") as f:
            json.dump(obs.chrome_trace(merged), f)
        cells, dead = store.cluster_metrics()
        out.update(events=len(merged), span_latency=obs.span_latency(merged),
                   cluster_dead=dead, cluster=obs.latency_table(cells))
    store.barrier()  # rank 0 pulled every rank's cells
    # the elastic rebuild restores the default namespace only
    h.free("eval")
    return out


def _el_initial(rank, work, seed, dev):
    dirs = _el_dirs(work)
    store = DDStore(FileGroup(dirs["rdv"], rank, EL_RANKS), backend="tcp")
    data = synthetic_mnist(VAE_SAMPLES, seed)[0]
    counts = nsplit(len(data), EL_RANKS)
    begin = sum(counts[:rank])
    store.add(EL_VAR, data[begin:begin + counts[rank]])
    del data
    out = {"services": _el_services(store, rank, work, seed, dev)}
    checkpoint.save_shard(store, EL_VAR, dirs["ckpt"])
    out["fixed_before"] = _fixed_digest(store, seed)
    store.barrier()
    tr = ElasticTrainer(store, rank, work, seed, dev, "initial")
    try:
        for xb in tr.batches():  # until the victim's death surfaces
            tr.train(xb)
    except DDStoreError as e:
        out["t_detect"] = time.time()
        out["error"] = str(e)[:200]
        out["error_code"] = e.code
    out["steps_before"] = tr.t
    t0 = time.perf_counter()
    elastic_recover(store, dirs["elastic"], timeout=180)
    out["recover_s"] = time.perf_counter() - t0
    out.update(_el_after(store, tr, rank, seed))
    out["train"] = tr.finish()
    out["launches"] = launch_counts()
    store.barrier()
    store.close()
    return out


def _el_after(store, tr, rank, seed):
    """After the recovery, on every rank: the fixed rows again, EL_AFTER
    steps (counting the steps the caller took since), the last
    EL_PROFILE_STEPS of rank 0's on a new loader iterator under
    utils.profile.trace."""
    out = {"fixed_after": _fixed_digest(store, seed), "t_after": tr.t}
    batches = tr.batches()
    while tr.t < out["t_after"] + EL_AFTER - EL_PROFILE_STEPS:
        tr.train(next(batches))
    batches.close()
    logdir = os.path.join(EL_OUT, "profile")
    batches = tr.batches()
    if rank == 0:
        with uprofile.trace(logdir):
            for _ in range(EL_PROFILE_STEPS):
                tr.train(next(batches))
        out["profile"] = _profile_counts(logdir)
    else:
        for _ in range(EL_PROFILE_STEPS):
            tr.train(next(batches))
    batches.close()
    return out


def _profile_counts(logdir):
    """Ranges, kernels and size of the trace utils.profile.trace wrote."""
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)
             if f.endswith(".pt.trace.json")]
    check(len(files) == 1, f"profile files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name") for e in events
             if e.get("cat") == "user_annotation"]
    return {"fetch": names.count("ddstore:fetch"),
            "stage": names.count("ddstore:stage"),
            "kernels": sum(e.get("cat") == "kernel" for e in events),
            "bytes": os.path.getsize(files[0]), "path": files[0]}


def _el_rejoin(rank, work, seed, dev):
    dirs = _el_dirs(work)
    t_start = time.time()
    store = elastic_rejoin(dirs["elastic"], rank, EL_RANKS, dirs["ckpt"],
                           timeout=180)
    t_ready = time.time()
    begin, end = store.my_row_range(EL_VAR)
    with open(os.path.join(dirs["ckpt"], f"{EL_VAR}.r{rank}.bin"),
              "rb") as f:
        check(store.get(EL_VAR, begin, end - begin).tobytes() == f.read(),
              "the rejoined shard != its checkpoint file")
    tr = ElasticTrainer(store, rank, work, seed, dev, "rejoin")
    t_trainer = time.time()
    path = tr.restore()
    restored, t_restored = tr.t, time.time()
    # the first step after the restore, recorded for the fresh process
    tr.gen = torch.Generator(device=dev).manual_seed(seed + 30 + rank)
    tr.sampler.set_epoch(tr.epoch)
    idx = tr.sampler.epoch_indices()[:EL_BATCH]
    batches = tr.batches()
    xb = next(batches)
    t_batch = time.time()
    check(xb.cpu().numpy().tobytes() == store.get_batch(EL_VAR, idx)
          .tobytes(), "the rejoiner's first batch != get_batch")
    loss = tr.train(xb)
    t_first = time.time()
    _write_json(os.path.join(work, "first_step.json"), {
        "ckpt": path, "indices": idx.tolist(), "gen_seed": seed + 30 + rank,
        "loss": loss.hex(), "digest": param_digest(tr.model)})
    batches.close()
    out = {"t_start": t_start, "t_ready": t_ready, "t_trainer": t_trainer,
           "t_restored": t_restored, "t_batch": t_batch, "t_first": t_first,
           "restored_step": restored}
    out.update(_el_after(store, tr, rank, seed))
    out["train"] = tr.finish()
    out["launches"] = launch_counts()
    store.barrier()
    store.close()
    return out


def _el_check(rank, work, seed, dev):
    """The fresh process: the rejoiner's first step again, from the same
    checkpoint, batch and generator seed; bit for bit."""
    path = os.path.join(work, "first_step.json")
    deadline = time.monotonic() + EL_DEADLINE_S
    while not os.path.exists(path):
        check(time.monotonic() < deadline, "no first step to check")
        time.sleep(0.1)
    with open(path) as f:
        rec = json.load(f)
    model = tvae.VAE(device=dev)
    _, opt = tvae.create_train_state(model)
    got = checkpoint.restore_train_state(
        rec["ckpt"], {"model": model.state_dict(),
                      "opt": opt.state_dict(), "step": 0})
    model.load_state_dict(got["model"])
    opt.load_state_dict(got["opt"])
    data = synthetic_mnist(VAE_SAMPLES, seed)[0]
    xb = torch.from_numpy(data[np.asarray(rec["indices"])]).to(dev)
    gen = torch.Generator(device=dev).manual_seed(rec["gen_seed"])
    loss = float(tvae.make_train_step(model, opt)(xb, generator=gen))
    digest = param_digest(model)
    return {"loss": loss.hex(), "want_loss": rec["loss"],
            "loss_gap": abs(loss - float.fromhex(rec["loss"])),
            "equal": loss.hex() == rec["loss"] and digest == rec["digest"],
            "params_equal": digest == rec["digest"]}


def elastic_rank(rank, mode, work, seed):
    """One process of phase 10. ``mode``: "initial" (a rank from the
    start), "rejoin" (the victim relaunched) or "check" (the fresh
    process that retakes the rejoiner's first step). The result, or the
    traceback, goes to a file in ``work``; a failure exits non-zero."""
    try:
        os.environ.update(EL_ENV)
        check(torch.cuda.is_available(), f"rank {rank}: no CUDA device")
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        zero_launch_counts()
        fn = {"initial": _el_initial, "rejoin": _el_rejoin,
              "check": _el_check}[mode]
        res = fn(rank, work, seed, torch.device("cuda", 0))
        _write_json(os.path.join(work, f"result.{mode}.r{rank}.json"), res)
    except BaseException:  # noqa: BLE001 — the supervisor reports it
        with open(os.path.join(work, f"error.{mode}.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        sys.exit(1)


def _el_steps(work, tag, rank):
    """Steps a rank has logged, with their losses."""
    try:
        with open(os.path.join(work, f"log.{tag}.r{rank}")) as f:
            lines = [ln.split() for ln in f.read().splitlines()]
    except FileNotFoundError:
        return []
    return [float(v) for t, v in lines]


def _el_supervise(seed, work):
    """Start the four ranks and the fresh checking process (it waits for
    the rejoiner's first step), SIGKILL the victim once it is past
    EL_KILL_AFTER steps, relaunch it as a rejoiner, and wait for
    everyone; any failure, or the phase deadline, kills every child."""
    ctx = mp.get_context("spawn")
    procs, times = {}, {}

    def start(mode, rank):
        p = ctx.Process(target=elastic_rank, args=(rank, mode, work, seed))
        p.start()
        procs[(mode, rank)] = p

    def failed():
        for (mode, rank), p in procs.items():
            if p.exitcode not in (None, 0) and not (
                    mode == "initial" and rank == EL_VICTIM
                    and "t_kill" in times):
                err = os.path.join(work, f"error.{mode}.r{rank}.txt")
                tb = open(err).read() if os.path.exists(err) else ""
                return f"{mode} rank {rank} exited {p.exitcode}: {tb}"
        return None

    deadline = time.monotonic() + EL_DEADLINE_S
    try:
        for r in range(EL_RANKS):
            start("initial", r)
        start("check", EL_VICTIM)
        # once past EL_KILL_AFTER steps, with that step's checkpoint
        # complete (the async save renames its file into place)
        saved = os.path.join(_el_dirs(work)["ckpt"],
                             f"state.r{EL_VICTIM}.s{EL_KILL_AFTER:06d}.pt")
        while len(_el_steps(work, "initial", EL_VICTIM)) <= EL_KILL_AFTER \
                or not os.path.exists(saved):
            why = failed()
            check(why is None, f"elastic: {why}")
            check(time.monotonic() < deadline, "elastic: victim never "
                  f"passed {EL_KILL_AFTER} steps")
            time.sleep(0.02)
        victim = procs[("initial", EL_VICTIM)]
        victim.kill()  # SIGKILL
        times["t_kill"] = time.time()
        victim.join()
        times["victim_steps"] = len(_el_steps(work, "initial", EL_VICTIM))
        time.sleep(1.0)  # a beat, as the reference's supervisor
        times["t_launch"] = time.time()
        start("rejoin", EL_VICTIM)
        while any(p.exitcode is None for p in procs.values()):
            why = failed()
            check(why is None, f"elastic: {why}")
            check(time.monotonic() < deadline, "elastic: phase deadline "
                  f"({EL_DEADLINE_S} s) passed")
            time.sleep(0.1)
        why = failed()
        check(why is None, f"elastic: {why}")
    finally:
        for p in procs.values():
            if p.is_alive():
                p.kill()
            p.join()
    res = {}
    for (mode, rank) in procs:
        if (mode, rank) != ("initial", EL_VICTIM):
            with open(os.path.join(work, f"result.{mode}.r{rank}.json")) \
                    as f:
                res[(mode, rank)] = json.load(f)
    return res, times


def annotate_cost(card, n=100_000):
    """What ``utils.profile.annotate`` costs per span in this process,
    which uses the card, with no trace active: as the loaders run it (no
    NVTX tool attached), with its NVTX range forced on (what an attached
    tool adds before its own cost), and an empty ``with`` block. Best of
    three runs of ``n`` spans each, in ns."""
    import contextlib

    def per_span(make):
        best = math.inf
        for _ in range(3):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                with make("ddstore:fetch"):
                    pass
            best = min(best, (time.perf_counter_ns() - t0) / n)
        return best

    check(torch.cuda.is_initialized(), "annotate cost: the card is unused")
    default = per_span(uprofile.annotate)
    tool, uprofile._NVTX_TOOL = uprofile._NVTX_TOOL, True
    try:
        nvtx = per_span(uprofile.annotate)
    finally:
        uprofile._NVTX_TOOL = tool
    empty = per_span(lambda name: contextlib.nullcontext())
    print(f"annotate cost | {card}: {default:.1f} ns a span with no trace "
          f"and no NVTX tool attached (as the loaders run; NVTX tool "
          f"{'attached' if tool else 'absent'}), {nvtx:.1f} ns with its "
          f"NVTX range forced on, {empty:.1f} ns an empty with-block; "
          f"best of 3 x {n} spans", flush=True)
    return {"default_ns": default, "nvtx_ns": nvtx, "empty_ns": empty}


def guard_cost(card, n=20_000):
    """What ``NativeStore``'s guard of calls in flight adds to a call: a
    one-row ``dds_get_batch`` on a local-backend store made through
    ``NativeStore._call`` against the same foreign call on the bare
    handle, best of 3 x ``n`` each; then ``close()`` from this thread
    while four threads read the store: it must wait out their reads and
    leave each thread with ``ERR_CLOSED``."""
    store = DDStore(backend="local")
    store.add("v", np.arange(64 * 64, dtype=np.float32).reshape(64, 64))
    nat = store._native
    out = np.empty((1, 64), np.float32)
    starts = np.zeros(1, np.int64)
    args = (b"v", out.ctypes.data, binding._as_i64p(starts), 1, b"")

    def per_call(fn):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter_ns()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter_ns() - t0) / n)
        return best

    guarded = per_call(lambda: nat._call(nat._lib.dds_get_batch, *args))
    bare = per_call(lambda: nat._lib.dds_get_batch(nat._h, *args))
    reads, codes = [0] * 4, [None] * 4

    def reader(i):
        buf = np.empty((8, 64), np.float32)
        idx = np.arange(8) + 8 * i
        while True:
            try:
                nat.get_batch("v", buf, idx)
            except DDStoreError as e:
                codes[i] = e.code
                return
            check(bool((buf[:, 0] == idx * 64).all()), "guard: wrong rows")
            reads[i] += 1

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    while min(reads) < 100:
        time.sleep(0.001)
    t0 = time.perf_counter()
    nat.close()
    close_ms = (time.perf_counter() - t0) * 1e3
    for t in threads:
        t.join(30)
    store.close()
    msg = (f"store close guard | {card}: a one-row get_batch through the "
           f"guard {guarded:.1f} ns, on the bare handle {bare:.1f} ns (the "
           f"guard {guarded - bare:.1f} ns a call; best of 3 x {n}); close() "
           f"under four reading threads {close_ms:.3f} ms, their reads "
           f"before it {reads}, their codes after {codes}")
    print(msg, flush=True)
    check(codes == [binding.ERR_CLOSED] * 4, msg)
    return {"guarded_ns": guarded, "bare_ns": bare, "close_ms": close_ms}


def phase_elastic(seed, card):
    """Phase 10: four store-fed VAE ranks with tenants, a gateway
    session and tracing, checkpoints, a SIGKILLed rank, its recovery and
    rejoin, and a profile."""
    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
    for d in ("ckpt", "trace"):
        os.makedirs(_el_dirs(work)[d])
    shutil.rmtree(EL_OUT, ignore_errors=True)
    os.makedirs(EL_OUT)
    try:
        res, times = _el_supervise(seed, work)
        pre_kill = _el_steps(work, "initial", EL_VICTIM)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    wall = time.perf_counter() - t0
    ranks = {r: res[("rejoin" if r == EL_VICTIM else "initial", r)]
             for r in range(EL_RANKS)}
    survivors = [r for r in range(EL_RANKS) if r != EL_VICTIM]
    # A. services
    for r in survivors:
        sv = ranks[r]["services"]
        print(f"elastic services rank {r} | {card}: eval split read whole "
              f"through a gateway session ({sv['eval_batches']} batches of "
              f"{EL_EVAL_BATCH}, bytes = the handle's) in "
              f"{sv['eval_s']:.3f} s, eval loss per sample "
              f"{sv['eval_loss']:.3f}; over-quota add refused with code "
              f"{sv['refused']}; session {json.dumps(sv['session'])}; "
              f"tenant_stats {json.dumps(sv['tenant_stats'])}; loader "
              f"tenants {json.dumps(sv['loader_tenants'])}", flush=True)
        check(sv["loader_tenants"] and "eval" in sv["loader_tenants"],
              f"rank {r}: no tenants section in the loader's summary")
        check(sv["session"]["admission_giveups"] == 0 and
              not sv["session"]["expired"], f"rank {r}: session {sv}")
    s0 = ranks[0]["services"]
    print(f"elastic trace | {card}: {s0['events']} native events from "
          f"{EL_RANKS} ranks merged into {EL_OUT}/store_trace.json; "
          f"span latency (class|route|peer: count, p50, p99 ms) "
          + "; ".join(f"{k}: {v['count']}, {v['p50_ms']}, {v['p99_ms']}"
                      for k, v in sorted(s0["span_latency"].items())),
          flush=True)
    counters = {k: v for k, v in s0["trace_summary"].items()
                if k != "span_latency"}
    print(f"elastic metrics | {card}: rank 0 metrics_summary "
          f"{json.dumps(s0['metrics_summary'])}; cluster_metrics over "
          f"{EL_RANKS} ranks (dead {s0['cluster_dead']}): "
          f"{json.dumps(s0['cluster'])}; trace_summary "
          f"{json.dumps(counters)}", flush=True)
    check(s0["cluster_dead"] == [] and s0["events"] > 0 and
          s0["span_latency"], "elastic: trace or cluster metrics empty")
    # B. the elastic run
    rj, chk = ranks[EL_VICTIM], res[("check", EL_VICTIM)]
    lost = times["victim_steps"] - rj["restored_step"]
    for r in survivors:
        x = ranks[r]
        detect = x["t_detect"] - times["t_kill"]
        print(f"elastic rank {r} | {card}: {x['steps_before']} steps before "
              f"the death; kill -> error {detect:.3f} s ({x['error_code']}: "
              f"{x['error'][:80]}); recover {x['recover_s']:.3f} s",
              flush=True)
    for r in range(EL_RANKS):
        t = ranks[r]["train"]
        saving = (f"{t['step_saving_ms']:.3f} ms over {t['steps_saving']} "
                  f"steps" if t["step_saving_ms"] is not None
                  else "no step overlapped a save")
        print(f"elastic rank {r} train | {card}: {t['steps']} steps, median "
              f"step {t['step_ms']:.3f} ms without a save in flight, "
              f"{saving} with one; launches {ranks[r]['launches']}",
              flush=True)
    since = {k: rj[k] - times["t_launch"] for k in
             ("t_start", "t_ready", "t_trainer", "t_restored", "t_batch",
              "t_first")}
    print(f"elastic rejoin | {card}: victim killed after "
          f"{times['victim_steps']} steps, restored its step "
          f"{rj['restored_step']} checkpoint ({lost} steps lost); launch -> "
          f"process up {since['t_start']:.3f} s -> store ready "
          f"{since['t_ready']:.3f} s -> model, optimizer, loader made "
          f"{since['t_trainer']:.3f} s -> train state restored "
          f"{since['t_restored']:.3f} s -> first batch "
          f"{since['t_batch']:.3f} s -> first step {since['t_first']:.3f} "
          f"s; fresh-process first step equal {chk['equal']} (loss gap "
          f"{chk['loss_gap']}, parameters equal {chk['params_equal']})",
          flush=True)
    prof = ranks[0]["profile"]
    print(f"elastic profile rank 0 | {card}: {EL_PROFILE_STEPS} steps under "
          f"utils.profile.trace: ddstore:fetch {prof['fetch']}, "
          f"ddstore:stage {prof['stage']}, CUDA kernels {prof['kernels']}; "
          f"{prof['bytes']} bytes at {prof['path']}; phase wall "
          f"{wall:.1f} s", flush=True)
    for r in survivors:
        check(ranks[r]["error_code"] == binding.ERR_PEER_LOST,
              f"rank {r}: error {ranks[r]['error_code']}")
    for r in range(EL_RANKS):
        x = ranks[r]
        check(x["fixed_after"] == ranks[0]["fixed_after"] ==
              res[("initial", 0)]["fixed_before"],
              f"rank {r}: fixed rows changed across the recovery")
        losses = (pre_kill + x["train"]["losses"] if r == EL_VICTIM
                  else x["train"]["losses"])
        first = float(np.mean(losses[:EL_TREND]))
        last = float(np.mean(losses[-EL_TREND:]))
        check(all(math.isfinite(v) for v in losses) and last < first,
              f"rank {r}: losses {first} -> {last}")
        check(x["train"]["steps"] - x["t_after"] == EL_AFTER,
              f"rank {r}: {x['train']['steps'] - x['t_after']} steps after")
        check(not any(x["launches"].values()),
              f"rank {r}: attention launched {x['launches']}")
    for r in survivors:
        check(res[("initial", r)]["fixed_before"] ==
              res[("initial", 0)]["fixed_before"], "fixed rows differ")
    check(rj["restored_step"] >= EL_KILL_AFTER and
          0 <= lost < 2 * EL_SAVE_EVERY,
          f"restored step {rj['restored_step']} of {times['victim_steps']}")
    check(chk["equal"], f"the rejoiner's first step differs from a fresh "
                        f"process's: loss {chk['loss']} vs "
                        f"{chk['want_loss']}, parameters equal "
                        f"{chk['params_equal']}")
    check(prof["fetch"] >= EL_PROFILE_STEPS and
          prof["stage"] >= EL_PROFILE_STEPS and prof["kernels"] > 0,
          f"profile: {prof}")
    with open(os.path.join(EL_OUT, "ranks.json"), "w") as f:
        json.dump({"times": times, "ranks": {str(k): v for k, v in
                                             ranks.items()}}, f)
    return {"launches": {k: sum(ranks[r]["launches"][k]
                                for r in range(EL_RANKS))
                         for k in ranks[0]["launches"]}, "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 11: the long-context slice (ring attention, remat, the dp x sp step
# and the ring prefill; bench.py:3247 lm_long_bench's configuration).


def _long_corpus(seed):
    """The repeated-pattern corpus of ``make_store`` (period 64) and the
    start of each of the LONG_WINDOWS windows in it."""
    rng = np.random.default_rng(seed + 21)
    base = rng.integers(0, VOCAB, size=64)
    return base, rng.integers(0, 64, size=LONG_WINDOWS)


def _long_windows(base, starts, seq=LONG_SEQ):
    """Windows of ``seq`` + 1 tokens at ``starts``: (tokens, next
    tokens), each (n, seq) int32."""
    w = base[(starts[:, None] + np.arange(seq + 1)) % 64] \
        .astype(np.int32)
    return np.ascontiguousarray(w[:, :-1]), np.ascontiguousarray(w[:, 1:])


def long_store(store, rank, seed, seq=LONG_SEQ):
    """This rank's share of the 4,096 windows of ``seq`` + 1 tokens
    (tokens and next tokens as two variables) in the TCP store."""
    base, starts = _long_corpus(seed)
    counts = nsplit(LONG_WINDOWS, store.world)
    lo = sum(counts[:rank])
    tok, nxt = _long_windows(base, starts[lo:lo + counts[rank]], seq)
    return ShardedDataset(store, tok, nxt, pre_sharded=True)


def long_model(dev, seed, mesh=None, **kw):
    model = ttr.TransformerLM(vocab=VOCAB, dim=DIM, heads=HEADS,
                              layers=LAYERS, compute_dtype=torch.bfloat16,
                              device=dev, mesh=mesh, **kw)
    return model.init_weights(torch.Generator(device=dev).manual_seed(seed))


def long_loader(ds, mesh, dev, seed):
    """The dp slot's rows (dp = 1: every row), this rank's sequence
    chunk of each."""
    sampler = DistributedSampler(len(ds), 1, 0, seed=seed)
    return sampler, DeviceLoader(ds, sampler, LONG_BATCH, device=dev,
                                 mesh=mesh, spec=("dp", "sp"))


def rel_l2(got, want) -> float:
    got, want = got.float(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def band_l2(got, want):
    """(S / LONG_BAND,): the L2 error of each band of LONG_BAND positions
    (over batch, heads and the head dim) over the band's L2 norm."""
    def per_band(t):
        return t.float().pow(2).sum(dim=(0, 1, 3)).reshape(
            -1, LONG_BAND).sum(-1).sqrt()

    return per_band(got.float() - want) / per_band(want).clamp_min(1e-30)


def f32_attention(q, k, v, do):
    """Causal attention over the whole sequence in f32 (mha_reference) and
    the gradients of sum(out * do) by autograd, LONG_REF_BLOCK queries at
    a time against the keys up to the block's last query (the scores of a
    block fit): {"out", "lse", "dq", "dk", "dv"}."""
    s = q.shape[2]
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    outs, lses = [], []
    for lo in range(0, s, LONG_REF_BLOCK):
        hi = min(lo + LONG_REF_BLOCK, s)
        o, lse = attention.mha_reference(qf[:, :, lo:hi], kf[:, :, :hi],
                                         vf[:, :, :hi], causal=True,
                                         q_offset=lo)
        (o * do[:, :, lo:hi].float()).sum().backward()
        outs.append(o.detach())
        lses.append(lse.detach())
    return {"out": torch.cat(outs, 2), "lse": torch.cat(lses, 2),
            "dq": qf.grad, "dk": kf.grad, "dv": vf.grad}


def ring_shifts_want(steps, b, c, replay=1, sp=LONG_SP):
    """The ring shifts one rank makes in ``steps`` train steps of the LM
    over ``sp`` ranks with chunks of ``c`` positions and ``b`` sequences:
    per layer and step, sp - 1 forward shifts of the packed bf16 K/V (each
    ``replay`` times: remat replays the forward) and sp - 1 backward shifts
    of their gradients in the same dtype, whatever the backward computes."""
    fwd = LAYERS * steps * (sp - 1) * replay
    bwd = LAYERS * steps * (sp - 1)
    one = 2 * b * HEADS * c * (DIM // HEADS) * 2
    return {"forward": fwd, "backward": bwd, "bytes": (fwd + bwd) * one}


def long_ring_check(rank, mesh, dev, seed):
    """Ring attention over the two ranks against the whole sequence's f32
    result (f32_attention): out, lse and the gradients of sum(out * do)
    on this rank's chunk, and the launches of the ring's forward and
    backward. In bf16 one whole-sequence call of the kernels on the same
    inputs is held to the same result beside it (RING_ROW_FACTOR)."""
    res = {}
    for name, (b, h, s, d), dt in LONG_RING_CASES:
        g = torch.Generator(device=dev).manual_seed(seed + 11)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g, device=dev)
                       .to(dt) for _ in range(4))
        c = s // LONG_SP
        lo, hi = rank * c, (rank + 1) * c
        ql, kl, vl = (t[:, :, lo:hi].clone().requires_grad_()
                      for t in (q, k, v))
        torch.cuda.synchronize()
        zero_launch_counts()
        out, lse = ring_attention(ql, kl, vl, mesh=mesh, causal=True)
        (out.float() * do[:, :, lo:hi].float()).sum().backward()
        torch.cuda.synchronize()
        launches = launch_counts()
        got = {"out": out.detach(), "dq": ql.grad, "dk": kl.grad,
               "dv": vl.grad}
        ref = {key: t[:, :, lo:hi] for key, t in
               f32_attention(q, k, v, do).items()}
        none = torch.zeros((b, h, c), dtype=torch.bool, device=dev)
        errs = {"lse_abs": float((lse.detach() - ref["lse"]).abs().max())}
        for key, t in got.items():
            errs[key + "_abs"], errs[key], _ = row_errors(t, ref[key], none)
        want_n = {"flash_fwd": rank + 1, "flash_bwd_dq": rank + 1,
                  "flash_bwd_dkv": rank + 1}
        if dt == torch.bfloat16:
            qf, kf, vf = (t.clone().requires_grad_() for t in (q, k, v))
            one_out, one_lse = attention.flash_attention(qf, kf, vf,
                                                         causal=True)
            (one_out.float() * do.float()).sum().backward()
            one = {"out": one_out.detach(), "dq": qf.grad, "dk": kf.grad,
                   "dv": vf.grad}
            errs["one_lse_abs"] = float((one_lse.detach()[:, :, lo:hi]
                                         - ref["lse"]).abs().max())
            for key, t in one.items():
                t = t[:, :, lo:hi]
                errs["one_" + key] = row_errors(t, ref[key], none)[1]
                errs["row_ratio_" + key] = errs[key] / max(
                    errs["one_" + key], 1e-30)
                errs["ring_vs_one_" + key] = row_errors(got[key], t,
                                                        none)[1]
                band = {w: band_l2(x, ref[key]) for w, x in
                        (("ring", got[key]), ("one", t))}
                ratio = band["ring"] / band["one"]
                errs["band_ratio_" + key] = float(ratio.max())
                errs["worst_band_" + key] = lo + LONG_BAND * int(
                    ratio.argmax())
                errs["worst_row_" + key] = {
                    w: lo + int(row_rel(x, ref[key]).amax(dim=(0, 1))
                                .argmax())
                    for w, x in (("ring", got[key]), ("one", t))}
            del qf, kf, vf, one_out, one_lse, one
            ok = all(errs["band_ratio_" + key] <= RING_BAND_FACTOR and
                     errs[key] <= RING_ROW_FACTOR * errs["one_" + key]
                     for key in got)
            rule = (f"against f32, the ring's L2 error in each band of "
                    f"{LONG_BAND} positions within {RING_BAND_FACTOR}x the "
                    f"one call's, its worst row within {RING_ROW_FACTOR}x "
                    f"the one call's")
        else:
            ok = all(errs[key + "_abs"] <= TOL["float32"][0] for key in got)
            rule = f"max abs against f32 {TOL['float32'][0]}"
        lse_tol = TOL[str(dt).split(".")[-1]][1]
        msg = (f"ring {name} rank {rank}: errors {errs} ({rule}; lse "
               f"{lse_tol}); launches {launches} (want {want_n})")
        check(ok and errs["lse_abs"] <= lse_tol, msg)
        check(launches == want_n, msg)
        res[name] = {"errs": errs, "launches": launches}
        if name == "bf16":
            def fwd():
                with torch.no_grad():
                    ring_attention(ql, kl, vl, mesh=mesh, causal=True)

            def fwd_bwd():
                o, _ = ring_attention(ql, kl, vl, mesh=mesh, causal=True)
                torch.autograd.grad(o, (ql, kl, vl), do[:, :, lo:hi])

            res[name]["ring_fwd_ms"] = median_ms(fwd, 5)
            res[name]["ring_fwd_bwd_ms"] = median_ms(fwd_bwd, 5)
        del q, k, v, do, ql, kl, vl, out, lse, got, ref
    torch.cuda.empty_cache()
    return res


def long_first_step(rank, mesh, ds, dev, seed):
    """The first step's loss and all-reduced gradients over the ring,
    held on rank 0 against one process's sp = 1 loss and gradients of the
    same weights and batch on the card; the loader's first chunk against
    the store's rows."""
    model = long_model(dev, seed, mesh)
    ttr.create_train_state(model, mesh=mesh)  # the replicas' digest check
    sampler, loader = long_loader(ds, mesh, dev, seed)
    batches = iter(loader)
    tok, tgt = next(batches)
    batches.close()
    pos = loader.seq_positions(LONG_BATCH)
    loss = ttr.lm_loss(model, tok, tgt, pos)
    loss.backward()
    ttr.all_reduce_gradients(list(model.parameters()), LONG_SP)
    ring_loss = loss.detach().float().clone()
    dist.all_reduce(ring_loss)
    ring_loss = float(ring_loss) / LONG_SP
    idx = sampler.epoch_indices()[:LONG_BATCH]
    full_tok, full_tgt = (torch.from_numpy(a).to(dev) for a in ds.fetch(idx))
    lo, hi = loader.seq_range
    check(torch.equal(tok, full_tok[:, lo:hi]) and
          torch.equal(tgt, full_tgt[:, lo:hi]),
          "the loader's chunk is not the store's rows' chunk")
    out = {"ring_loss": ring_loss, "seq_range": [lo, hi]}
    if rank == 0:
        ref = long_model(dev, seed)
        full_pos = torch.arange(LONG_SEQ, dtype=torch.int32,
                                device=dev).expand(LONG_BATCH, LONG_SEQ)
        ref_loss = ttr.lm_loss(ref, full_tok, full_tgt, full_pos)
        ref_loss.backward()
        worst, worst_name = 0.0, ""
        for (n, p), pr in zip(model.named_parameters(), ref.parameters()):
            e = rel_l2(p.grad, pr.grad)
            if e > worst:
                worst, worst_name = e, n
        out.update(ref_loss=float(ref_loss), worst_grad=worst,
                   worst_grad_name=worst_name)
        del ref
    del model
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def long_train(rank, group, mesh, ds, dev, seed, kw, profiled):
    """LONG_WARMUP + LONG_STEPS dp x sp steps of a fresh model from the
    seed (the counts zeroed just before, read just after); with
    ``profiled`` the counted steps run under torch.profiler on rank 0."""
    model = long_model(dev, seed, mesh, **kw)
    state, opt = ttr.create_train_state(model, lr=LONG_LR, mesh=mesh)
    step = ttr.make_train_step(model, opt, state=state, mesh=mesh)
    _, loader = long_loader(ds, mesh, dev, seed)
    pos = loader.seq_positions(LONG_BATCH)
    losses, step_s = [], []
    prof = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    for key in ring_shift_stats:
        ring_shift_stats[key] = 0
    t_start = time.perf_counter()
    batches = iter(loader)
    for i in range(LONG_WARMUP + LONG_STEPS):
        tok, tgt = next(batches)
        if i == LONG_WARMUP and profiled and rank == 0:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            t_prof = time.perf_counter()
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, pos)))  # syncs
        step_s.append(time.perf_counter() - t1)
    busy = None
    if prof is not None:
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t_prof) * 1e3
        prof.__exit__(None, None, None)
        busy_ms, by_name = device_busy(prof)
        top = sorted(by_name.items(), key=lambda r: -r[1][0])[:8]
        busy = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                "share": busy_ms / wall_ms,
                "top": [(k[:60], round(ms, 3), n) for k, (ms, n) in top]}
    batches.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    out = {"losses": losses, "step_s": step_s, "wall_s": wall,
           "launches": launch_counts(), "shifts": dict(ring_shift_stats),
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "efficiency": loader.metrics.efficiency,
           "fetch_p50_ms": loader.metrics.summary()["host_fetch"]["p50_s"]
           * 1e3, "busy": busy, "steps": state.step,
           "digests": group.allgather(param_digest(model))}
    del model, opt, state, step
    torch.cuda.empty_cache()
    return out


def long_alone(rank, mesh, dev):
    """The step's gradient all-reduce (168 M f32 on the card, over gloo)
    and one ring shift (K and V of a layer's chunk, bf16) timed alone."""
    n = sum(p.numel() for p in ttr.TransformerLM(
        vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
        device="meta").parameters())
    flat = torch.zeros(n, device=dev)
    kv = torch.zeros((2, LONG_BATCH, HEADS, LONG_SEQ // LONG_SP,
                      DIM // HEADS), dtype=torch.bfloat16, device=dev)
    group = mesh.get_group("sp")
    out = {"allreduce_grads_ms": median_ms(lambda: dist.all_reduce(flat), 5),
           "ring_shift_ms": median_ms(lambda: _ring_shift(
               kv, group, LONG_SP, rank, 1, 0x5200), 10),
           "grad_elements": n,
           "shift_bytes": kv.numel() * kv.element_size()}
    del flat, kv
    torch.cuda.empty_cache()
    return out


def long_prefill(rank, mesh, ds, dev, seed):
    """generate(prefill_mesh=...) over sp at full width (2 prompts of
    LONG_SEQ, LONG_NEW_TOKENS new tokens): its first-token logits against
    the mesh-free generate on rank 0; then a small f32 model whose ring
    prefill must give the mesh-free tokens exactly."""
    model = long_model(dev, seed + 5)
    rows = np.arange(LONG_BATCH) * 7
    prompts = torch.from_numpy(ds.fetch(rows)[0]).to(dev).long()
    zero_launch_counts()
    st = {}
    got = tdec.generate(model, prompts, LONG_NEW_TOKENS, stats=st,
                        prefill_mesh=mesh)
    torch.cuda.synchronize()
    out = {"launches": launch_counts(), "prefill_s": st["prefill_s"],
           "decode_ms": st["decode_s"] / st["decode_steps"] * 1e3}
    check(got.shape == (LONG_BATCH, LONG_SEQ + LONG_NEW_TOKENS) and
          torch.equal(got[:, :LONG_SEQ], prompts), "ring generate shape")
    if rank == 0:
        st0 = {}
        want = tdec.generate(model, prompts, LONG_NEW_TOKENS, stats=st0)
        out.update(
            first_logits_rel=max(rel_l2(a, b) for a, b in zip(
                st["first_logits"], st0["first_logits"])),
            first_logits_abs=float((st["first_logits"]
                                    - st0["first_logits"]).abs().max()),
            equal_share=float((got[:, LONG_SEQ:] == want[:, LONG_SEQ:])
                              .float().mean()),
            meshfree_prefill_s=st0["prefill_s"])
    del model
    torch.cuda.empty_cache()
    small = ttr.TransformerLM(vocab=512, dim=256, heads=4, layers=2,
                              compute_dtype=torch.float32, device=dev)
    small.init_weights(torch.Generator(device=dev).manual_seed(seed + 6))
    p = torch.from_numpy(np.random.default_rng(seed + 6).integers(
        0, 512, (2, 64))).to(dev)
    ring_toks = tdec.generate(small, p, LONG_NEW_TOKENS, prefill_mesh=mesh)
    plain = tdec.generate(small, p, LONG_NEW_TOKENS)
    out["small_equal"] = bool(torch.equal(ring_toks, plain))
    dist.barrier()
    return out


def _long_rank(rank, group, store, dev, seed):
    mesh = make_mesh({"dp": 1, "sp": LONG_SP})
    check(mesh.get_local_rank("sp") == rank, "mesh position")
    out = {"ring": long_ring_check(rank, mesh, dev, seed)}
    t0 = time.perf_counter()
    ds = long_store(store, rank, seed)
    out["setup_s"] = time.perf_counter() - t0
    out["first_step"] = long_first_step(rank, mesh, ds, dev, seed)
    out["train"] = {name: long_train(rank, group, mesh, ds, dev, seed, kw,
                                     name == "off")
                    for name, kw in LONG_REMAT}
    out["alone"] = long_alone(rank, mesh, dev)
    out["prefill"] = long_prefill(rank, mesh, ds, dev, seed)
    return out


def long_single(dev, seed, card):
    """The same model in one process at sp = 1 (B = 2, S = 8192;
    lm_long_bench's configuration): without a mesh, then in a one-process
    NCCL group (the step's gradient all-reduce on NCCL), remat off and
    on. Batches from the phase's corpus."""
    base, starts = _long_corpus(seed)
    runs = {}
    for name, use_mesh, kw in (("plain", False, {}),
                               ("nccl", True, {}),
                               ("nccl_remat", True, {"remat": True})):
        if use_mesh:
            dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                                    f"{free_port()}", rank=0, world_size=1)
        try:
            mesh = make_mesh({"dp": 1, "sp": 1}) if use_mesh else None
            model = long_model(dev, seed, mesh, **kw)
            state, opt = ttr.create_train_state(model, lr=LONG_LR, mesh=mesh)
            step = ttr.make_train_step(model, opt, state=state, mesh=mesh)
            pos = torch.arange(LONG_SEQ, dtype=torch.int32,
                               device=dev).expand(LONG_BATCH, LONG_SEQ)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            zero_launch_counts()
            losses, step_s = [], []
            for i in range(LONG_WARMUP + LONG_STEPS):
                tok, tgt = (torch.from_numpy(a).to(dev) for a in
                            _long_windows(base, starts[i * LONG_BATCH:
                                                       (i + 1) * LONG_BATCH]))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                losses.append(float(step(tok, tgt, pos)))
                step_s.append(time.perf_counter() - t1)
            runs[name] = {
                "losses": losses, "step_s": step_s,
                "median_ms": float(np.median(step_s[LONG_WARMUP:])) * 1e3,
                "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
                "launches": launch_counts(),
                "backend": dist.get_backend() if use_mesh else None}
            del model, opt, state, step
            torch.cuda.empty_cache()
        finally:
            if use_mesh:
                dist.destroy_process_group()
    flops = lm_flops_per_step(VOCAB, DIM, LAYERS, LONG_BATCH, LONG_SEQ)
    for name, r in runs.items():
        med = r["median_ms"] / 1e3
        r["tokens_per_s"] = LONG_BATCH * LONG_SEQ / med
        r["mfu"] = flops / med / PEAK_BF16_FLOPS
        print(f"long single-process {name} (sp 1, B {LONG_BATCH}, S "
              f"{LONG_SEQ}, backend {r['backend']}) | {card}: losses "
              f"{[round(x, 4) for x in r['losses']]}; step ms "
              f"{[round(x * 1e3, 3) for x in r['step_s']]}; median after "
              f"{LONG_WARMUP} warm-up {r['median_ms']:.3f} ms = "
              f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f}; peak "
              f"{r['peak_gib']:.3f} GiB; launches {r['launches']}",
              flush=True)
        check(all(math.isfinite(x) for x in r["losses"]),
              f"long single-process {name}: losses {r['losses']}")
        per = LAYERS * (LONG_WARMUP + LONG_STEPS)
        want = {"flash_fwd": per * (2 if "remat" in name else 1),
                "flash_bwd_dq": per, "flash_bwd_dkv": per}
        check(r["launches"] == want, f"long single-process {name}: "
              f"launches {r['launches']} != {want}")
    check(runs["nccl"]["losses"][0] == runs["plain"]["losses"][0],
          "one-process NCCL step's first loss differs from the plain one")
    check(runs["nccl_remat"]["peak_gib"] < runs["nccl"]["peak_gib"],
          "remat did not lower the one-process peak")
    return runs


def long_chunk_kernels(dev, b=LONG_BATCH, h=HEADS, c=LONG_SEQ // LONG_SP,
                       chunks=None, label="the ring's", d=DIM // HEADS):
    """The three kernels at the ring's chunk shapes ((2, 16, 4096, 64)
    bf16 on the main path's layout): the diagonal chunk (causal) and the
    past chunk (q_offset 4096, kv_offset 0: every pair live, no block
    masked), each held row by row against its plain version on the same
    inputs with a random lse cotangent, as the ring's steps get one;
    timed against the plain versions and SDPA at the same mask (is_causal
    True and False), with their bounds. ``b``, ``h``, ``c`` and
    ``chunks`` ((name, q_offset, SDPA's is_causal) each) give other
    shapes: tensor parallelism's ``H / tp`` heads at the whole
    sequence; ``d`` another head dim."""
    g = torch.Generator(device=dev).manual_seed(99)
    dim = h * d
    base = torch.randn((b, c, 3 * dim), generator=g, device=dev) \
        .to(torch.bfloat16).requires_grad_()
    ql, kl, vl = (t.reshape(b, c, h, d).transpose(1, 2)
                  for t in base.split(dim, dim=-1))
    q, k, v = (t.detach() for t in (ql, kl, vl))
    do = torch.randn((b, c, h, d), generator=g, device=dev) \
        .to(torch.bfloat16).transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    which_of = {"fwd": ("out",), "dq": ("dq",), "dkv": ("dk", "dv")}
    res = {}
    tol = ROW_REL_TOL["bfloat16"]
    for chunk, qo, causal_sdpa in chunks or (("diagonal", 0, True),
                                             ("past", c, False)):
        kw = dict(causal=True, q_offset=qo, kv_offset=0, scale=d ** -0.5)
        # the lse cotangent every ring step's backward gets
        dlse = torch.randn((b, h, c), generator=g, device=dev)
        with torch.no_grad():
            out, lse = attention.flash_attention(q, k, v, causal=True,
                                                 q_offset=qo)
            cc = attention.flash_bwd_prep(do, out, dlse)
            got = {"out": out,
                   "dq": attention._flash_bwd_dq_cuda(q, k, v, do, lse, cc,
                                                      **kw)}
            got["dk"], got["dv"] = attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, cc, **kw)
            want_out, want_lse = attention.mha_reference(
                q, k, v, causal=True, q_offset=qo)
            want = {"out": want_out,
                    "dq": attention.flash_bwd_dq_reference(q, k, v, do, lse,
                                                           cc, **kw)}
            want["dk"], want["dv"] = attention.flash_bwd_dkv_reference(
                q, k, v, do, lse, cc, **kw)
        none = torch.zeros((b, h, c), dtype=torch.bool, device=dev)
        dead = {"out": none, "dq": none,
                "dk": dead_keys(b, h, c, c, True, qo, 0, dev)}
        dead["dv"] = dead["dk"]
        errs = {"lse_abs": float((lse - want_lse).abs().max())}
        for which in got:
            e_abs, e_rel, nonzero_dead = row_errors(got[which], want[which],
                                                    dead[which])
            errs[which + "_abs"], errs[which] = e_abs, e_rel
            check(nonzero_dead == 0 and e_rel <= tol,
                  f"{label} {chunk}: {which} disagrees with the plain "
                  f"version ({e_rel:.3e} per row > {tol}, or {nonzero_dead} "
                  f"dead rows not 0)")
        check(errs["lse_abs"] <= TOL["bfloat16"][1],
              f"{label} {chunk}: lse {errs['lse_abs']:.3e}")
        del got, want, want_out, want_lse
        sd_out = sdpa(ql, kl, vl, is_causal=causal_sdpa)
        fns = {
            "fwd": (lambda: attention.flash_attention(
                q, k, v, causal=True, q_offset=qo), 20),
            "fwd_plain": (lambda: attention.mha_reference(
                q, k, v, causal=True, q_offset=qo), 3),
            "fwd_library": (lambda: sdpa(q, k, v, is_causal=causal_sdpa), 20),
            "dq": (lambda: attention._flash_bwd_dq_cuda(
                q, k, v, do, lse, cc, **kw), 20),
            "dkv": (lambda: attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, cc, **kw), 20),
            "dq_plain": (lambda: attention.flash_bwd_dq_reference(
                q, k, v, do, lse, cc, **kw), 3),
            "dkv_plain": (lambda: attention.flash_bwd_dkv_reference(
                q, k, v, do, lse, cc, **kw), 3),
            "bwd_library": (lambda: torch.autograd.grad(
                sd_out, (ql, kl, vl), do, retain_graph=True), 20),
        }
        t = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                fn, iters = fns[n]
                if n == "bwd_library":
                    t[n].append(time_ms(fn, iters))
                else:
                    with torch.no_grad():
                        t[n].append(time_ms(fn, iters))
        ms = {n: sum(x) / len(x) for n, x in t.items()}
        row = {}
        for kern, kind in (("flash_fwd", "fwd"), ("flash_bwd_dq", "dq"),
                           ("flash_bwd_dkv", "dkv")):
            flops, nbytes = attention_work(b, h, c, c, d, 2, True, qo, 0,
                                           kind)
            bound, bound_by = bound_of(flops, nbytes)
            row[kern] = {
                "ms": ms[kind], "plain_ms": ms[kind + "_plain"],
                "bound_ms": bound, "bound_by": bound_by,
                "library_ms": ms["fwd_library"] if kind == "fwd" else None,
                "sdpa_backward_ms": None if kind == "fwd"
                else ms["bwd_library"],
                "max_abs_err": max(errs[w + "_abs"] for w in which_of[kind]),
                "max_row_rel_err": max(errs[w] for w in which_of[kind])}
        res[chunk] = row
        print(f"kernels at {label} {chunk} (B,H,S,D)=({b},{h},{c},"
              f"{d}) bf16 q_offset={qo}, dlse random: against the plain "
              f"versions {json.dumps(errs)} (per row {tol}, lse "
              f"{TOL['bfloat16'][1]}); " + "; ".join(
                  f"{k2} {r['ms']:.4f} ms (plain {r['plain_ms']:.4f}, bound "
                  f"{r['bound_ms']:.4f} by {r['bound_by']})"
                  for k2, r in row.items())
              + f"; sdpa forward (is_causal={causal_sdpa}) "
              f"{ms['fwd_library']:.4f} ms, backward "
              f"{ms['bwd_library']:.4f} ms; rounds={json.dumps(t)}",
              flush=True)
        del out, lse, cc, sd_out
    return res


def phase_long(dev, seed, card):
    """The long-context slice (phase 11)."""
    print(f"long context: {LONG_SP} rank processes on cuda:0 (gloo), mesh "
          f"dp 1 x sp {LONG_SP}; TransformerLM({VOCAB}, {DIM}, {HEADS}, "
          f"{LAYERS}, bf16) at B {LONG_BATCH}, S {LONG_SEQ}; "
          f"{LONG_WINDOWS} windows of {LONG_SEQ + 1} tokens in a TCP store",
          flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks("long", LONG_SP, seed)
    wall = time.perf_counter() - t0
    for r, res in enumerate(ranks):
        print(f"long ring rank {r} | {card}: {json.dumps(res['ring'])}",
              flush=True)
    fs = ranks[0]["first_step"]
    msg = (f"long first step | {card}: ring loss {fs['ring_loss']:.6f} "
           f"against one process sp 1 {fs['ref_loss']:.6f} (tol "
           f"{LONG_LOSS_TOL}); worst gradient L2 error over its norm "
           f"{fs['worst_grad']:.3e} ({fs['worst_grad_name']}; tol "
           f"{LONG_GRAD_TOL}); seq ranges "
           f"{[x['first_step']['seq_range'] for x in ranks]}")
    print(msg, flush=True)
    check(abs(fs["ring_loss"] - fs["ref_loss"]) <= LONG_LOSS_TOL and
          fs["worst_grad"] <= LONG_GRAD_TOL, msg)
    check(ranks[1]["first_step"]["ring_loss"] == fs["ring_loss"],
          "the ranks' first-step losses differ")
    flops = lm_flops_per_step(VOCAB, DIM, LAYERS, LONG_BATCH, LONG_SEQ)
    summary = {}
    for name, _ in LONG_REMAT:
        per = [r["train"][name] for r in ranks]
        meds = [float(np.median(x["step_s"][LONG_WARMUP:])) for x in per]
        med = max(meds)
        summary[name] = {"median_ms": med * 1e3,
                         "tokens_per_s": LONG_BATCH * LONG_SEQ / med,
                         "mfu": flops / med / PEAK_BF16_FLOPS,
                         "peak_gib": [x["peak_bytes"] / 2**30 for x in per],
                         "first_loss": per[0]["losses"][0]}
        print(f"long dp x sp train {name} ({dict(LONG_REMAT)[name]}) | "
              f"{card}: losses {per[0]['losses']}; step ms per rank "
              f"{[[round(s * 1e3, 3) for s in x['step_s']] for x in per]}; "
              f"median after {LONG_WARMUP} warm-up {med * 1e3:.3f} ms = "
              f"{LONG_BATCH * LONG_SEQ / med:.1f} tokens/s in total, MFU "
              f"{flops / med / PEAK_BF16_FLOPS:.4f}; peak GiB per rank "
              f"{[round(g, 3) for g in summary[name]['peak_gib']]}; "
              f"input_pipeline_efficiency "
              f"{[round(x['efficiency'], 4) for x in per]}, fetch p50 ms "
              f"{[round(x['fetch_p50_ms'], 3) for x in per]}; shifts "
              f"{[x['shifts'] for x in per]}; launches "
              f"{[x['launches'] for x in per]}; busy (rank 0, counted "
              f"steps) {per[0]['busy']}", flush=True)
        check(all(math.isfinite(x) for x in per[0]["losses"]),
              f"long {name}: losses {per[0]['losses']}")
        check(per[0]["losses"] == per[1]["losses"],
              f"long {name}: the ranks' losses differ")
        check(len(set(per[0]["digests"])) == 1 and
              per[0]["digests"] == per[1]["digests"],
              f"long {name}: the ranks' parameters differ")
        steps = LONG_WARMUP + LONG_STEPS
        replay = 2 if dict(LONG_REMAT)[name] else 1
        shifts = ring_shifts_want(steps, LONG_BATCH, LONG_SEQ // LONG_SP,
                                  replay)
        summary[name]["shifts"] = [x["shifts"] for x in per]
        summary[name]["shifts_want"] = shifts
        for r, x in enumerate(per):
            n = LAYERS * (r + 1) * steps
            want = {"flash_fwd": n * replay, "flash_bwd_dq": n,
                    "flash_bwd_dkv": n}
            check(x["launches"] == want, f"long {name} rank {r}: launches "
                  f"{x['launches']} != {want}")
            check(x["steps"] == steps, f"long {name}: state.step")
            check(x["shifts"] == shifts, f"long {name} rank {r}: shifts "
                  f"{x['shifts']} != {shifts}")
    print(f"long peaks and shifts | {card}: peak GiB per rank "
          + "; ".join(f"{n} {[round(g, 3) for g in summary[n]['peak_gib']]}"
                      for n, _ in LONG_REMAT)
          + "; shifts per rank (count and bytes) "
          + "; ".join(f"{n} {summary[n]['shifts']} (want "
                      f"{summary[n]['shifts_want']})" for n, _ in LONG_REMAT),
          flush=True)
    firsts = [summary[n]["first_loss"] for n, _ in LONG_REMAT]
    check(max(firsts) - min(firsts) <= LONG_LOSS_TOL,
          f"long: the remat settings' first losses differ: {firsts}")
    for r in range(LONG_SP):
        check(summary["remat"]["peak_gib"][r] < summary["off"]["peak_gib"][r],
              f"long: remat did not lower rank {r}'s peak: "
              f"{summary['remat']['peak_gib']} vs "
              f"{summary['off']['peak_gib']}")
    alone = [r["alone"] for r in ranks]
    print(f"long alone | {card}: gloo all-reduce of {alone[0]['grad_elements']}"
          f" f32 gradients on the card {[round(a['allreduce_grads_ms'], 3) for a in alone]}"
          f" ms per rank; one ring shift of {alone[0]['shift_bytes']} B "
          f"(through pinned host buffers) "
          f"{[round(a['ring_shift_ms'], 3) for a in alone]} ms per rank",
          flush=True)
    pf = [r["prefill"] for r in ranks]
    msg = (f"long ring prefill | {card}: {LONG_BATCH} prompts of {LONG_SEQ}"
           f" + {LONG_NEW_TOKENS} tokens over sp {LONG_SP}: prefill s "
           f"{[round(p['prefill_s'], 4) for p in pf]} (mesh-free on rank 0 "
           f"{pf[0]['meshfree_prefill_s']:.4f}); decode ms per step "
           f"{[round(p['decode_ms'], 3) for p in pf]}; first-token logits "
           f"L2 error over norm {pf[0]['first_logits_rel']:.3e} (tol "
           f"{ROW_REL_TOL['bfloat16']}), max abs "
           f"{pf[0]['first_logits_abs']:.3e}; equal tokens "
           f"{pf[0]['equal_share']:.3f}; small f32 model tokens equal "
           f"{[p['small_equal'] for p in pf]}; launches "
           f"{[p['launches'] for p in pf]}")
    print(msg, flush=True)
    check(pf[0]["first_logits_rel"] <= ROW_REL_TOL["bfloat16"], msg)
    check(all(p["small_equal"] for p in pf), msg)
    for r, p in enumerate(pf):
        check(p["launches"]["flash_fwd"] == LAYERS * (r + 1) and
              p["launches"]["flash_bwd_dq"] == 0, msg)
    single = long_single(dev, seed, card)
    chunks = long_chunk_kernels(dev)
    print(f"long context phase wall {wall:.1f} s (rank processes)",
          flush=True)
    return {"ranks": ranks, "summary": summary, "single": single,
            "chunks": chunks,
            "launches": {k: sum(r["train"]["off"]["launches"][k]
                                for r in ranks)
                         for k in ranks[0]["train"]["off"]["launches"]},
            "launches_by_rank": [r["train"]["off"]["launches"]
                                 for r in ranks]}


# ---------------------------------------------------------------------------
# Phase 12: MoE with expert parallelism, Megatron TP and FSDP/ZeRO-3
# (ROADMAP items 13 and 14).


@contextlib.contextmanager
def plain_attention():
    """The LM's attention through its plain version (``mha_reference``)
    instead of the kernels, for a reference run on the card."""
    saved = ttr.flash_attention

    def plain(q, k, v, causal=False, **kw):
        return attention.mha_reference(q, k, v, causal=causal, **kw)

    ttr.flash_attention = plain
    try:
        yield
    finally:
        ttr.flash_attention = saved


@contextlib.contextmanager
def no_plain_path():
    """Inside, the plain versions of the three kernels and SDPA raise: a
    run of the kernels' path that reached any of them would fail, so the
    launch counters alone stand for the work done."""
    def refuse(name):
        def fn(*a, **k):
            raise RuntimeError(f"chip_smoke: {name} reached on the kernels' "
                               f"path")
        return fn

    names = ("mha_reference", "flash_bwd_dq_reference",
             "flash_bwd_dkv_reference")
    saved = [getattr(attention, n) for n in names]
    saved_sdpa = torch.nn.functional.scaled_dot_product_attention
    for n in names:
        setattr(attention, n, refuse(n))
    torch.nn.functional.scaled_dot_product_attention = refuse("SDPA")
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(attention, n, fn)
        torch.nn.functional.scaled_dot_product_attention = saved_sdpa


def moe_model(dev, seed, dtype=torch.bfloat16, mesh=None):
    model = ttr.TransformerLM(vocab=VOCAB, dim=DIM, heads=HEADS,
                              layers=LAYERS, compute_dtype=dtype, device=dev,
                              mesh=mesh, n_experts=MOE_EXPERTS,
                              moe_top_k=MOE_TOP_K)
    return model.init_weights(torch.Generator(device=dev).manual_seed(seed))


def moe_flops_per_step(b, s):
    """Routed model FLOPs of one MoE train step, counted as
    :func:`lm_flops_per_step` counts the dense one but with the MLP's
    16Td^2 a layer replaced by the router (2TdE) and k experts a token
    (k x 16Td^2): the work the routing asks for, not the capacity-padded
    buffers the experts run over."""
    t = b * s
    fwd = LAYERS * (8 * t * DIM * DIM + 2 * t * DIM * MOE_EXPERTS
                    + MOE_TOP_K * 16 * t * DIM * DIM + 2 * b * s * s * DIM) \
        + 2 * t * DIM * VOCAB
    return 3 * fwd


def moe_routing_stats(model):
    """Per layer: tokens routed to each expert (all k choices), the drop
    share and the aux of the model's last forward."""
    out = []
    for blk in model.blocks:
        st = blk.moe.stats
        routed = st["routed"].tolist()
        out.append({"routed": routed,
                    "drop_share": 1 - float(st["kept"].sum())
                    / max(1, sum(routed)),
                    "aux": float(st["aux"])})
    return out


def phase_moe(dev, seed, ds, card):
    """Phase 12 (a): the MoE LM at full width, one process, store-fed."""
    print(f"moe: TransformerLM({VOCAB}, {DIM}, {HEADS}, {LAYERS}, bf16) with "
          f"{MOE_EXPERTS} experts, top-{MOE_TOP_K}, at ({BATCH}, {SEQ})",
          flush=True)
    loader = DeviceLoader(ds, DistributedSampler(WINDOWS, 1, 0,
                                                 seed=seed + 30),
                          BATCH, device=dev)
    model = moe_model(dev, seed + 30)
    n_params = sum(p.numel() for p in model.parameters())
    state, opt = ttr.create_train_state(model, lr=TRAIN_LR)
    step = ttr.make_train_step(model, opt, state=state)
    positions = torch.arange(SEQ, dtype=torch.int32,
                             device=dev).expand(BATCH, SEQ)
    batches = iter(loader)
    tok, tgt = next(batches)
    # the first step's loss against the same weights in f32 on the card
    # through the plain attention
    ref = moe_model(dev, seed + 30, torch.float32)
    with torch.no_grad(), plain_attention():
        ref_loss = float(ttr.lm_loss(ref, tok, tgt, positions))
    pad = moe_padding_check(ref, tok)
    del ref
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count the main path alone
    t_start = time.perf_counter()
    losses, step_s = [], []
    for i in range(MOE_WARMUP + MOE_STEPS):
        if i:
            tok, tgt = next(batches)
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, positions)))  # syncs
        step_s.append(time.perf_counter() - t1)
    routing = moe_routing_stats(model)
    prompts = next(batches)[0]
    batches.close()
    train_peak = torch.cuda.max_memory_allocated(dev) / 2**30
    stats = {}
    out = tdec.generate(model, prompts, NEW_TOKENS, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    steps = MOE_WARMUP + MOE_STEPS
    want = {"flash_fwd": LAYERS * (steps + 1),
            "flash_bwd_dq": LAYERS * steps, "flash_bwd_dkv": LAYERS * steps}
    med = float(np.median(step_s[MOE_WARMUP:]))
    flops = moe_flops_per_step(BATCH, SEQ)
    msg = (f"moe train | {card}: {n_params / 1e6:.1f} M params; first step "
           f"loss {losses[0]:.6f} against f32 with plain attention "
           f"{ref_loss:.6f} (tol {MOE_LOSS_TOL}); losses {losses}; step ms "
           f"{[round(x * 1e3, 3) for x in step_s]}; median after "
           f"{MOE_WARMUP} warm-up {med * 1e3:.3f} ms = "
           f"{BATCH * SEQ / med:.1f} tokens/s; routed FLOPs {flops:.4e} a "
           f"step (k = {MOE_TOP_K} experts a token), MFU "
           f"{flops / med / PEAK_BF16_FLOPS:.4f} of {PEAK_BF16_FLOPS:.3e}; "
           f"peak memory (train) {train_peak:.3f} GiB; input_pipeline_"
           f"efficiency {loader.metrics.efficiency:.4f}")
    print(msg, flush=True)
    check(all(math.isfinite(x) for x in losses), msg)
    check(abs(losses[0] - ref_loss) <= MOE_LOSS_TOL, msg)
    check(state.step == steps, f"moe state.step {state.step}")
    for i, r in enumerate(routing):
        print(f"moe routing layer {i} (last step, {BATCH * SEQ} tokens x "
              f"{MOE_TOP_K}): routed per expert {r['routed']}, drop share "
              f"{r['drop_share']:.4f}, aux {r['aux']:.5f}", flush=True)
        check(sum(r["routed"]) == BATCH * SEQ * MOE_TOP_K,
              f"moe layer {i}: {sum(r['routed'])} assignments")
    first = out[:, SEQ]
    with torch.no_grad():
        full = model(prompts, positions)[:, -1].argmax(-1)
    msg = (f"moe serve | {card}: generate {tuple(out.shape)}; prefill "
           f"{stats['prefill_s']:.4f} s = "
           f"{BATCH * SEQ / stats['prefill_s']:.1f} tokens/s (one sample, "
           f"cache allocation included); decode "
           f"{stats['decode_s'] / stats['decode_steps'] * 1e3:.3f} ms per "
           f"step ({BATCH} sequences); first token equal to the full "
           f"forward's argmax {int((first == full).sum())}/{BATCH}; "
           f"launches {launches} (want {want}); wall {wall:.3f} s")
    print(msg, flush=True)
    check(torch.equal(first, full), msg)
    check(launches == want, msg)
    del full
    dec = moe_decode_variants(model, dev)
    del model, opt, state, step
    torch.cuda.empty_cache()
    return {"launches": launches, "median_ms": med * 1e3,
            "tokens_per_s": BATCH * SEQ / med,
            "mfu": flops / med / PEAK_BF16_FLOPS, "peak_gib": train_peak,
            "routing": routing, "pad": pad, "decode_variants": dec}


def moe_padding_check(model, prompts):
    """``generate`` with ``prompt_lengths`` on 2 prompts of SEQ / 2 real
    tokens (1,024), padded to 3/4 SEQ and to SEQ: the prefill's routing
    (tokens routed to each expert, every layer) and the new tokens must not
    change with the padding. On the f32 model (the kernels in f32): in
    bf16 the products' rounding may differ with the row count, and a
    token near a tie between two experts would then flip whatever the
    padding."""
    real, runs = SEQ // 2, {}
    for total in (SEQ * 3 // 4, SEQ):
        p = prompts[:2, :total].clone()
        p[:, real:] = VOCAB - 1
        toks = tdec.generate(model, p, 8, prompt_lengths=[real, real])
        runs[total] = (toks[:, total:], [b.moe.stats["routed"].tolist()
                                         for b in model.blocks])
    (ta, ra), (tb, rb) = runs.values()
    msg = (f"moe prefill with prompt_lengths (f32): 2 prompts of {real} "
           f"tokens padded to {list(runs)}: new tokens equal "
           f"{bool(torch.equal(ta, tb))}, routing equal {ra == rb} (layer 0 "
           f"routed {ra[0]})")
    print(msg, flush=True)
    check(torch.equal(ta, tb) and ra == rb, msg)
    return {"tokens_equal": True, "routing_equal": True}


def moe_decode_gather(moe, h):
    """The decode step's MoE the other way (a yardstick, not the port's
    path): each token's k experts' weights gathered and run alone; the
    same function as ``decode.moe_decode``."""
    dt, k = moe.compute_dtype, moe.top_k
    b, d = h.shape
    probs = torch.softmax(h.float() @ moe.router.weight.float().t(), -1)
    topv, topi = torch.topk(probs, k, dim=-1)
    gates = topv if k == 1 else topv / topv.sum(-1, keepdim=True)
    e = topi.reshape(-1)
    x = h.to(dt).repeat_interleave(k, 0)[:, None]
    he = torch.relu(torch.bmm(x, moe.w1[e].to(dt))
                    + moe.b1[e][:, None].to(dt))
    oe = (torch.bmm(he, moe.w2[e].to(dt))
          + moe.b2[e][:, None].to(dt))[:, 0].view(b, k, d)
    return (oe.float() * gates[..., None]).sum(1).to(dt)


def moe_decode_variants(model, dev):
    """The decode step's MoE at batch 8 both ways: every expert on every
    token (``decode.moe_decode``, the port's) and a gather of each
    token's k experts' weights; the same output, timed in turns."""
    moe = model.blocks[0].moe
    g = torch.Generator(device=dev).manual_seed(3)
    h = torch.randn((BATCH, DIM), generator=g, device=dev) \
        .to(torch.bfloat16)
    fns = {"all_experts": lambda: tdec.moe_decode(moe, h),
           "gather": lambda: moe_decode_gather(moe, h)}
    with torch.no_grad():
        err = float((fns["all_experts"]().float()
                     - fns["gather"]().float()).abs().max())
        t = {n: [] for n in fns}
        for order in (list(fns), list(fns)[::-1]):
            for n in order:
                t[n].append(time_ms(fns[n], 20))
    ms = {n: sum(x) / len(x) for n, x in t.items()}
    print(f"moe decode step's MoE at batch {BATCH} (one layer): all experts "
          f"{ms['all_experts']:.4f} ms, gather of each token's "
          f"{MOE_TOP_K} {ms['gather']:.4f} ms (rounds {json.dumps(t)}); "
          f"max abs difference {err:.3e}", flush=True)
    check(err <= 2e-2, f"moe decode variants differ by {err}")
    return ms


def layout_store(store, rank, seed):
    """This rank's half of the slices' windows (``make_store``'s corpus)
    in the TCP store."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, VOCAB, size=64)
    corpus = np.tile(base, WINDOWS * SEQ // 64 + 2)
    starts = rng.integers(0, len(corpus) - SEQ - 1, size=WINDOWS)
    counts = nsplit(WINDOWS, store.world)
    lo = sum(counts[:rank])
    at = starts[lo:lo + counts[rank], None] + np.arange(SEQ)
    return ShardedDataset(store, corpus[at].astype(np.int32),
                          corpus[at + 1].astype(np.int32), pre_sharded=True)


def _grads_at_step(model, opt):
    """The gathered gradients (``weights.to_flax``, a collective) of the
    next time ``opt`` steps, in ``seen``; the hook then removes itself
    (no reference cycle keeps the model and its optimizer alive)."""
    seen = {}

    def hooked(*a, **k):
        seen["grads"] = to_flax({n: p.grad
                                 for n, p in model.named_parameters()})
        del opt.step
        return opt.step(*a, **k)

    opt.step = hooked
    return seen


def _flat_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _worst_rel(got, want, only=None):
    """(worst L2 error over L2 norm, its leaf) of two flat trees, over
    the leaves ``only`` names (default all)."""
    worst, name = 0.0, ""
    for k, w in want.items():
        if only is not None and k not in only:
            continue
        w64 = np.asarray(w, np.float64)
        e = float(np.linalg.norm(np.asarray(got[k], np.float64) - w64)
                  / max(np.linalg.norm(w64), 1e-30))
        if e > worst:
            worst, name = e, k
    return worst, name


def _worst_flip(got, want, before, only):
    """(worst share of elements the step moved the other way from
    ``want``'s step, its leaf), over the leaves ``only`` names."""
    worst, name = 0.0, ""
    for k in only:
        a = np.sign(np.asarray(got[k]) - before[k])
        b = np.sign(np.asarray(want[k]) - before[k])
        share = float((a != b).mean())
        if share > worst:
            worst, name = share, k
    return worst, name


def layout_collectives(name, mesh, dev):
    """The layout's collectives timed alone, at the main path's sizes
    (host clock; gloo is synchronous): ep, the per-assignment expert
    outputs summed over ep (k x B x S x dim f32); tp, a row-parallel
    product's output summed over tp (B x S x dim f32); fsdp, one block's
    f32 parameters all-gathered and their gradients reduce-scattered
    (through pinned host memory)."""
    t = LAYOUT_BATCH * SEQ
    if name == "ep2":
        x = torch.zeros((MOE_TOP_K * t, DIM), device=dev)
        g = mesh.get_group("ep")
        return {"all_reduce_moe_out_ms": median_ms(
            lambda: collectives.all_reduce(x, g), 5),
            "bytes": x.numel() * 4}
    if name == "tp2":
        x = torch.zeros((t, DIM), device=dev)
        g = mesh.get_group("tp")
        return {"all_reduce_row_parallel_ms": median_ms(
            lambda: collectives.all_reduce(x, g), 5),
            "bytes": x.numel() * 4}
    n = 12 * DIM * DIM + 4 * DIM * 2 + 5 * DIM  # one dense block, f32
    n -= n % 2
    g = mesh.get_group("fsdp")
    full = torch.zeros(n, device=dev)
    half = torch.zeros(n // 2, device=dev)
    return {"all_gather_block_ms": median_ms(
        lambda: collectives.all_gather_into(full, half, g), 5),
        "reduce_scatter_block_ms": median_ms(
            lambda: collectives.reduce_scatter(half, full, g), 5),
        "bytes": full.numel() * 4}


def layout_run(rank, group, ds, dev, seed, name, axes, moe):
    """One layout: LAYOUT_WARMUP + LAYOUT_STEPS steps of the full-width LM
    (the MoE one for ``moe``) placed over ``make_mesh(axes)`` on the two
    ranks, store-fed through ``DeviceLoader(spec=...)``; the first step's
    loss, gathered gradients and gathered parameters against one
    process's step from the same weights and batch on rank 0."""
    mesh = make_mesh(axes)
    make = moe_model if moe else long_model
    model = make(dev, seed + 40)
    state, opt = ttr.create_train_state(model, lr=TRAIN_LR, mesh=mesh)
    step = ttr.make_train_step(model, opt, state=state)
    seen = _grads_at_step(model, opt)
    data = data_axes(mesh)
    slots, slot = (2, rank) if data else (1, 0)
    per = LAYOUT_BATCH // slots
    loader = DeviceLoader(ds, DistributedSampler(len(ds), slots, slot,
                                                 seed=seed + 40),
                          per, device=dev, mesh=mesh, spec=(data,))
    pos = torch.arange(SEQ, dtype=torch.int32, device=dev).expand(per, SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    collective_stats.update(calls=0, bytes=0)
    losses, step_s = [], []
    batches = iter(loader)
    for i in range(LAYOUT_WARMUP + LAYOUT_STEPS):
        tok, tgt = next(batches)
        if i == 0:
            first = (tok, tgt)
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, pos)))  # syncs
        step_s.append(time.perf_counter() - t1)
        if i == 0:
            params = to_flax(model)
            calls = dict(collective_stats)
    batches.close()
    torch.cuda.synchronize()
    out = {"losses": losses, "step_s": step_s,
           "launches": launch_counts(), "steps": state.step,
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "collectives_first_step": calls,
           "efficiency": loader.metrics.efficiency,
           "placements": {n: [tuple(p.to_local().shape),
                              str(tuple(p.placements))]
                          for n, p in list(model.named_parameters())[:8]
                          if hasattr(p, "placements")}}
    grads = seen["grads"]
    # the global batch of the first step, for the reference
    if data:
        parts = [[torch.empty_like(t.cpu()) for _ in range(2)]
                 for t in first]
        for p, t in zip(parts, first):
            dist.all_gather(p, t.cpu())
        first = tuple(torch.cat(p).to(dev) for p in parts)
    del model, opt, state, step
    torch.cuda.empty_cache()
    out["alone"] = layout_collectives(name, mesh, dev)
    if rank == 0:
        torch.cuda.reset_peak_memory_stats()
        ref = make(dev, seed + 40)
        before = _flat_tree(to_flax(ref))
        _, ropt = ttr.create_train_state(ref, lr=TRAIN_LR)
        rseen = _grads_at_step(ref, ropt)
        full_pos = torch.arange(SEQ, dtype=torch.int32,
                                device=dev).expand(LAYOUT_BATCH, SEQ)
        ref_loss = float(ttr.make_train_step(ref, ropt)(*first, full_pos))
        out["one_process_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        rgrads = _flat_tree(rseen["grads"])
        rparams = _flat_tree(to_flax(ref))
        del ref, ropt
        torch.cuda.empty_cache()
        out["ref_loss"] = ref_loss
        out["worst_grad"] = _worst_rel(_flat_tree(grads), rgrads)
        # the leaves zero before the step hold Adam's +-lr alone, whose
        # sign is what a step can get wrong; the others by their values
        zero = {k for k, v in before.items() if not np.any(v)}
        flat = _flat_tree(params)
        out["worst_param"] = _worst_rel(flat, rparams, set(before) - zero)
        out["worst_flip"] = _worst_flip(flat, rparams, before, zero)
    del grads, params
    dist.barrier()
    return out


def _layouts_rank(rank, group, store, dev, seed):
    t0 = time.perf_counter()
    ds = layout_store(store, rank, seed)
    out = {"setup_s": time.perf_counter() - t0}
    for name, axes, moe in LAYOUTS:
        out[name] = layout_run(rank, group, ds, dev, seed, name, axes, moe)
    return out


def phase_layouts(seed, card, moe_peak_gib):
    """Phase 12 (b): the ep2, tp2 and fsdp2 layouts on two ranks."""
    print(f"layouts: {LAYOUT_RANKS} rank processes on cuda:0 (gloo), "
          f"{', '.join(n for n, _, _ in LAYOUTS)} at B {LAYOUT_BATCH}, S "
          f"{SEQ}; {WINDOWS} windows in a TCP store", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks("layouts", LAYOUT_RANKS, seed)
    wall = time.perf_counter() - t0
    res = {}
    for name, axes, moe in LAYOUTS:
        per = [r[name] for r in ranks]
        r0 = per[0]
        med = max(float(np.median(x["step_s"][LAYOUT_WARMUP:]))
                  for x in per)
        msg = (f"layout {name} ({axes}, {'MoE' if moe else 'dense'} LM) | "
               f"{card}: losses {r0['losses']}; step ms per rank "
               f"{[[round(s * 1e3, 3) for s in x['step_s']] for x in per]}"
               f"; median after {LAYOUT_WARMUP} warm-up {med * 1e3:.3f} ms "
               f"= {LAYOUT_BATCH * SEQ / med:.1f} tokens/s; first step loss "
               f"{r0['losses'][0]:.6f} against one process "
               f"{r0['ref_loss']:.6f} (tol {LONG_LOSS_TOL}); worst "
               f"gradient L2 error over its norm {r0['worst_grad'][0]:.3e} "
               f"({r0['worst_grad'][1]}), worst updated parameter "
               f"{r0['worst_param'][0]:.3e} ({r0['worst_param'][1]}) (tol "
               f"{LONG_GRAD_TOL}); zero-initialised leaves' share moved "
               f"the other way {r0['worst_flip'][0]:.4f} "
               f"({r0['worst_flip'][1]}; tol {LAYOUT_FLIP_TOL}); peak GiB "
               f"per rank "
               f"{[round(x['peak_bytes'] / 2**30, 3) for x in per]} beside "
               f"one process's "
               f"{r0['one_process_peak_bytes'] / 2**30:.3f}"
               + (f" (the MoE LM at B {BATCH}: {moe_peak_gib:.3f})"
                  if moe else "")
               + f"; first step's collectives per rank "
               f"{[x['collectives_first_step'] for x in per]}; alone "
               f"{[x['alone'] for x in per]}; launches "
               f"{[x['launches'] for x in per]}; placements (rank 0) "
               f"{json.dumps(r0['placements'])}")
        print(msg, flush=True)
        check(all(math.isfinite(v) for x in per for v in x["losses"]), msg)
        check(per[0]["losses"] == per[1]["losses"], msg)
        check(abs(r0["losses"][0] - r0["ref_loss"]) <= LONG_LOSS_TOL, msg)
        check(r0["worst_grad"][0] <= LONG_GRAD_TOL and
              r0["worst_param"][0] <= LONG_GRAD_TOL and
              r0["worst_flip"][0] <= LAYOUT_FLIP_TOL, msg)
        n = LAYERS * (LAYOUT_WARMUP + LAYOUT_STEPS)
        want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        check(all(x["launches"] == want for x in per), msg)
        check(all(x["steps"] == LAYOUT_WARMUP + LAYOUT_STEPS for x in per),
              msg)
        res[name] = {"median_ms": med * 1e3,
                     "tokens_per_s": LAYOUT_BATCH * SEQ / med,
                     "launches": {k: sum(x["launches"][k] for x in per)
                                  for k in want}}
    print(f"layouts phase wall {wall:.1f} s (rank processes)", flush=True)
    return res


def pp_batches(ds, dev, seed, rows):
    """Batches of ``rows`` rows of the dp slot (dp 1: both stages read the
    same rows) through the loader."""
    loader = DeviceLoader(ds, DistributedSampler(len(ds), 1, 0, seed=seed),
                          rows, device=dev)
    return loader, iter(loader)


def pp_stage_step(model, mesh, schedule, nv, m, lr=TRAIN_LR):
    """This rank's stage of ``model`` over ``mesh`` and its step (the
    model's modules move into the stage)."""
    state, opt = ttr.create_pp_train_state(model, PP_RANKS, lr=lr, mesh=mesh,
                                           n_virtual=nv)
    step = ttr.make_pp_train_step(state.model, opt, mesh, PP_RANKS, m,
                                  schedule=schedule, n_virtual=nv,
                                  state=state)
    return state, opt, step


def pp_flat(pieces, stage):
    """The flat tree of every stage's ``weights.stage_tree`` piece, pads
    dropped."""
    from ddstore_tpu_torch import weights

    outer, stages = weights.join_stage_trees(pieces, stage.layers,
                                             stage.n_stages, stage.n_virtual)
    return _flat_tree(weights.tree_from_stages(
        outer, stages, stage.layers, stage.n_stages, stage.n_virtual))


def pp_gathered(stage, mesh, tensors=None):
    """On rank 0 the flat tree of every stage's ``tensors`` (default its
    parameters); None on rank 1 (a collective)."""
    from ddstore_tpu_torch import weights

    pieces = [None] * PP_RANKS
    dist.all_gather_object(pieces, weights.stage_tree(stage, tensors))
    return pp_flat(pieces, stage) if dist.get_rank() == 0 else None


def pp_reference(make, dev, seed, first, m=None):
    """One process's first step on the same weights and batch: with ``m``
    the pp 1 pipeline over ``m`` microbatches (1F1B), else
    ``make_train_step``. (loss, gradients, parameters before, after)."""
    torch.cuda.reset_peak_memory_stats()
    ref = make(dev, seed)
    before = _flat_tree(to_flax(ref))
    pos = torch.arange(SEQ, dtype=torch.int32,
                       device=dev).expand(first[0].shape[0], SEQ)
    if m is None:
        _, opt = ttr.create_train_state(ref, lr=TRAIN_LR)
        seen = _grads_at_step(ref, opt)
        loss = float(ttr.make_train_step(ref, opt)(*first, pos))
        grads, after = _flat_tree(seen["grads"]), _flat_tree(to_flax(ref))
    else:
        state, opt = ttr.create_pp_train_state(ref, 1, lr=TRAIN_LR)
        stage = state.model
        seen = {}
        step_ = opt.step

        def hooked(*a, **k):
            seen["g"] = {n: p.grad for n, p in stage.named_parameters()}
            return step_(*a, **k)

        opt.step = hooked
        loss = float(ttr.make_pp_train_step(stage, opt, None, 1, m,
                                            schedule="1f1b")(*first, pos))
        from ddstore_tpu_torch.weights import stage_tree
        grads = pp_flat([stage_tree(stage, seen["g"])], stage)
        after = pp_flat([stage_tree(stage)], stage)
    peak = torch.cuda.max_memory_allocated(dev)
    del ref
    torch.cuda.empty_cache()
    return {"loss": loss, "grads": grads, "before": before, "after": after,
            "peak_bytes": peak}


def pp_against(ref, loss, grads, params):
    """The first pp step against one process's: the loss difference, the
    worst gradient and updated parameter (L2 error over L2 norm), and the
    zero-initialised leaves' share moved the other way."""
    zero = {k for k, v in ref["before"].items() if not np.any(v)}
    return {"loss_diff": abs(loss - ref["loss"]), "ref_loss": ref["loss"],
            "worst_grad": _worst_rel(grads, ref["grads"]),
            "worst_param": _worst_rel(params, ref["after"],
                                      set(ref["before"]) - zero),
            "worst_flip": _worst_flip(params, ref["after"], ref["before"],
                                      zero)}


def pp_hop_ms(mesh, dev):
    """One activation hand-off (2, 2048, 1024) bf16 to the other stage and
    back from it, timed alone (median of 5, host clock; gloo through
    pinned host memory)."""
    from ddstore_tpu_torch.parallel.pipeline import _FWD_TAG, _Stage

    st = _Stage(mesh, "pp", 1, 1)
    x = torch.zeros((PP_MB, SEQ, DIM), dtype=torch.bfloat16, device=dev)
    return median_ms(lambda: st.exchange([(x, 1, _FWD_TAG)],
                                         [(x, 1, _FWD_TAG)]), 5)


def pp_run(rank, mesh, ds, dev, seed, schedule, nv, ref):
    """PP_WARMUP + PP_STEPS steps of the full-width LM under ``schedule``
    (launches zeroed just before, read just after), one more step under
    torch.profiler on rank 0; the first step against ``ref``."""
    from ddstore_tpu_torch.parallel.pipeline import pipeline_stats

    state, opt, step = pp_stage_step(long_model(dev, seed + 50), mesh,
                                     schedule, nv, PP_M)
    stage = state.model
    seen = {}
    step_ = opt.step

    def hooked(*a, **k):
        if "g" not in seen:
            seen["g"] = {n: p.grad for n, p in stage.named_parameters()}
        return step_(*a, **k)

    opt.step = hooked
    loader, batches = pp_batches(ds, dev, seed + 50, PP_M * PP_MB)
    pos = torch.arange(SEQ, dtype=torch.int32,
                       device=dev).expand(PP_M * PP_MB, SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    pipeline_stats.update(hops=0, bytes=0, stash_high_water=0)
    losses, step_s = [], []
    for i in range(PP_WARMUP + PP_STEPS):
        tok, tgt = next(batches)
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, pos)))  # syncs
        step_s.append(time.perf_counter() - t1)
        if i == 0:
            first = (tok, tgt)
            grads = pp_gathered(stage, mesh, seen["g"])
            params = pp_gathered(stage, mesh)
            hops = dict(pipeline_stats)
    torch.cuda.synchronize()
    out = {"losses": losses, "step_s": step_s, "launches": launch_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "hops_first_step": hops, "steps": state.step,
           "stash_high_water": pipeline_stats["stash_high_water"],
           "efficiency": loader.metrics.efficiency}
    tok, tgt = next(batches)
    if rank == 0:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            float(step(tok, tgt, pos))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, by_name = device_busy(prof)
        top = sorted(by_name.items(), key=lambda r: -r[1][0])[:6]
        out["busy"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                       "share": busy_ms / wall_ms,
                       "top": [(k[:50], round(ms, 3), n)
                               for k, (ms, n) in top]}
    else:
        float(step(tok, tgt, pos))
    batches.close()
    if rank == 0:
        out.update(pp_against(ref, losses[0], grads, params))
    if schedule == "gpipe":
        out["decode"] = pp_decode(rank, stage, mesh, first[0], dev)
    del stage, state, opt, step, grads, params
    torch.cuda.empty_cache()
    return out


@torch.no_grad()
def pp_decode(rank, stage, mesh, tokens, dev):
    """``lm_from_stages`` then ``generate`` on rank 0: the first token
    against the full forward's argmax at the prompt's end."""
    whole = ttr.lm_from_stages(stage, mesh)
    if rank != 0:
        return None
    prompt = tokens[:2].long()
    pos = torch.arange(SEQ, device=dev).expand(2, SEQ)
    want = whole(prompt, pos)[:, -1].argmax(-1)
    t0 = time.perf_counter()
    out = tdec.generate(whole, prompt, PP_NEW_TOKENS)
    torch.cuda.synchronize()
    got = out[:, SEQ]
    res = {"first_tokens": got.tolist(), "argmax": want.tolist(),
           "s": time.perf_counter() - t0}
    del whole
    torch.cuda.empty_cache()
    return res


def pp_memory(mesh, ds, dev, seed):
    """GPipe and 1F1B at M = PP_MEM_M (remat off): the peak of a step
    after one warm-up step, per rank."""
    out = {}
    for schedule in ("gpipe", "1f1b"):
        state, opt, step = pp_stage_step(long_model(dev, seed + 50), mesh,
                                         schedule, 1, PP_MEM_M)
        loader, batches = pp_batches(ds, dev, seed + 50, PP_MEM_M * PP_MB)
        pos = torch.arange(SEQ, dtype=torch.int32, device=dev).expand(
            PP_MEM_M * PP_MB, SEQ)
        float(step(*next(batches), pos))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        float(step(*next(batches), pos))
        out[schedule] = {"peak_bytes": torch.cuda.max_memory_allocated(dev),
                         "step_s": time.perf_counter() - t0}
        batches.close()
        del state, opt, step
        torch.cuda.empty_cache()
    return out


def pp_moe(rank, mesh, ds, dev, seed):
    """The MoE LM under 1F1B over pp 2, 1 warm-up and PP_MOE_STEPS steps;
    its first step against one process's pp 1 1F1B over the same
    microbatches on rank 0."""
    state, opt, step = pp_stage_step(moe_model(dev, seed + 60), mesh, "1f1b",
                                     1, PP_M)
    stage = state.model
    seen = {}
    step_ = opt.step

    def hooked(*a, **k):
        if "g" not in seen:
            seen["g"] = {n: p.grad for n, p in stage.named_parameters()}
        return step_(*a, **k)

    opt.step = hooked
    loader, batches = pp_batches(ds, dev, seed + 60, PP_M * PP_MB)
    pos = torch.arange(SEQ, dtype=torch.int32,
                       device=dev).expand(PP_M * PP_MB, SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    losses, step_s = [], []
    for i in range(1 + PP_MOE_STEPS):
        tok, tgt = next(batches)
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, pos)))
        step_s.append(time.perf_counter() - t1)
        if i == 0:
            first = (tok, tgt)
            grads = pp_gathered(stage, mesh, seen["g"])
            params = pp_gathered(stage, mesh)
    batches.close()
    out = {"losses": losses, "step_s": step_s, "launches": launch_counts(),
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "steps": state.step}
    del stage, state, opt, step
    torch.cuda.empty_cache()
    if rank == 0:
        ref = pp_reference(moe_model, dev, seed + 60, first, m=PP_M)
        out.update(pp_against(ref, losses[0], grads, params))
    dist.barrier()
    return out


def _pp_rank(rank, group, store, dev, seed):
    t0 = time.perf_counter()
    ds = layout_store(store, rank, seed)
    mesh = make_mesh({"pp": PP_RANKS})
    check(mesh.get_local_rank("pp") == rank, "mesh position")
    out = {"setup_s": time.perf_counter() - t0}
    ref = None
    if rank == 0:  # one process's first step, shared by the schedules
        loader, batches = pp_batches(ds, dev, seed + 50, PP_M * PP_MB)
        first = next(batches)
        batches.close()
        ref = pp_reference(long_model, dev, seed + 50, first)
    dist.barrier()
    out["runs"] = {name: pp_run(rank, mesh, ds, dev, seed, name, nv, ref)
                   for name, nv in PP_SCHEDULES}
    del ref
    out["hop_ms"] = pp_hop_ms(mesh, dev)
    out["memory"] = pp_memory(mesh, ds, dev, seed)
    out["moe"] = pp_moe(rank, mesh, ds, dev, seed)
    return out


def phase_pp(seed, card):
    """Phase 13: the LM's pipeline schedules over pp 2 on two ranks."""
    names = ", ".join(n for n, _ in PP_SCHEDULES)
    print(f"pp: {PP_RANKS} rank processes on cuda:0 (gloo), the LM over pp "
          f"{PP_RANKS} at M {PP_M} x {PP_MB} x {SEQ} ({names}; interleaved "
          f"V {PP_V}); {WINDOWS} windows in a TCP store", flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks("pp", PP_RANKS, seed)
    wall = time.perf_counter() - t0
    flops = lm_flops_per_step(VOCAB, DIM, LAYERS, PP_M * PP_MB, SEQ)
    hop = [r["hop_ms"] for r in ranks]
    res = {"runs": {}, "hop_ms": hop}
    for name, nv in PP_SCHEDULES:
        per = [r["runs"][name] for r in ranks]
        r0 = per[0]
        med = max(float(np.median(x["step_s"][PP_WARMUP:])) for x in per)
        bubble = (PP_RANKS - 1) / (PP_M * nv + PP_RANKS - 1)
        msg = (f"pp {name} (V {nv}) | {card}: losses {r0['losses']}; step "
               f"ms per rank {[[round(s * 1e3, 3) for s in x['step_s']] for x in per]}"
               f"; median after {PP_WARMUP} warm-up {med * 1e3:.3f} ms = "
               f"{PP_M * PP_MB * SEQ / med:.1f} tokens/s, MFU "
               f"{flops / med / PEAK_BF16_FLOPS:.4%}; expected bubble "
               f"(S-1)/(M*V+S-1) {bubble:.4f}; first step loss "
               f"{r0['losses'][0]:.6f} against one process "
               f"{r0['ref_loss']:.6f} (tol {LONG_LOSS_TOL}); worst gradient "
               f"{r0['worst_grad'][0]:.3e} ({r0['worst_grad'][1]}), worst "
               f"updated parameter {r0['worst_param'][0]:.3e} "
               f"({r0['worst_param'][1]}) (tol {LONG_GRAD_TOL}); zero-"
               f"initialised leaves moved the other way "
               f"{r0['worst_flip'][0]:.4f} ({r0['worst_flip'][1]}; tol "
               f"{LAYOUT_FLIP_TOL}); peak GiB per rank "
               f"{[round(x['peak_bytes'] / 2**30, 3) for x in per]}; stash "
               f"high-water per rank {[x['stash_high_water'] for x in per]}; "
               f"first step's hand-offs {[x['hops_first_step'] for x in per]}"
               f"; one hop alone (2, {SEQ}, {DIM}) bf16 ms per rank "
               f"{[round(h, 3) for h in hop]}; rank 0 busy "
               f"{r0['busy']['share']:.1%} of {r0['busy']['wall_ms']:.1f} ms "
               f"(top {r0['busy']['top']}); efficiency "
               f"{[round(x['efficiency'], 4) for x in per]}; launches "
               f"{[x['launches'] for x in per]}")
        print(msg, flush=True)
        check(all(math.isfinite(v) for x in per for v in x["losses"]), msg)
        check(per[0]["losses"] == per[1]["losses"], msg)
        check(r0["loss_diff"] <= LONG_LOSS_TOL, msg)
        check(r0["worst_grad"][0] <= LONG_GRAD_TOL and
              r0["worst_param"][0] <= LONG_GRAD_TOL and
              r0["worst_flip"][0] <= LAYOUT_FLIP_TOL, msg)
        # each rank's 4 layers, every microbatch, forward and backward
        n = LAYERS // PP_RANKS * PP_M * (PP_WARMUP + PP_STEPS)
        want = {"flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        check(all(x["launches"] == want for x in per), msg)
        check(all(x["steps"] == PP_WARMUP + PP_STEPS for x in per), msg)
        res["runs"][name] = {
            "median_ms": med * 1e3, "bubble": bubble,
            "launches_by_rank": [x["launches"] for x in per]}
    dec = ranks[0]["runs"]["gpipe"]["decode"]
    msg = (f"pp decode | {card}: generate {PP_NEW_TOKENS} tokens after 2 "
           f"prompts of {SEQ} on the stages reassembled on rank 0 in "
           f"{dec['s']:.3f} s; first tokens {dec['first_tokens']} against "
           f"the full forward's argmax {dec['argmax']}")
    print(msg, flush=True)
    check(dec["first_tokens"] == dec["argmax"], msg)
    mem = [r["memory"] for r in ranks]
    msg = (f"pp memory at M {PP_MEM_M} (remat off) | {card}: peak GiB per "
           f"rank gpipe {[round(x['gpipe']['peak_bytes'] / 2**30, 3) for x in mem]}"
           f", 1f1b {[round(x['1f1b']['peak_bytes'] / 2**30, 3) for x in mem]}"
           f"; step s gpipe {[round(x['gpipe']['step_s'], 3) for x in mem]}, "
           f"1f1b {[round(x['1f1b']['step_s'], 3) for x in mem]}")
    print(msg, flush=True)
    check(all(x["1f1b"]["peak_bytes"] < x["gpipe"]["peak_bytes"]
              for x in mem), msg)
    moe = [r["moe"] for r in ranks]
    m0 = moe[0]
    msg = (f"pp moe (1f1b, {MOE_EXPERTS} experts, top-{MOE_TOP_K}) | "
           f"{card}: losses {m0['losses']}; step ms per rank "
           f"{[[round(s * 1e3, 3) for s in x['step_s']] for x in moe]}; "
           f"first step loss {m0['losses'][0]:.6f} against one process at "
           f"pp 1 {m0['ref_loss']:.6f}; worst gradient "
           f"{m0['worst_grad'][0]:.3e} ({m0['worst_grad'][1]}), parameter "
           f"{m0['worst_param'][0]:.3e} ({m0['worst_param'][1]}), flips "
           f"{m0['worst_flip'][0]:.4f}; peak GiB per rank "
           f"{[round(x['peak_bytes'] / 2**30, 3) for x in moe]}; launches "
           f"{[x['launches'] for x in moe]}")
    print(msg, flush=True)
    check(all(math.isfinite(v) for x in moe for v in x["losses"]), msg)
    check(moe[0]["losses"] == moe[1]["losses"], msg)
    check(m0["loss_diff"] <= LONG_LOSS_TOL, msg)
    check(m0["worst_grad"][0] <= LONG_GRAD_TOL and
          m0["worst_param"][0] <= LONG_GRAD_TOL and
          m0["worst_flip"][0] <= LAYOUT_FLIP_TOL, msg)
    n = LAYERS // PP_RANKS * PP_M * (1 + PP_MOE_STEPS)
    check(all(x["launches"] == {"flash_fwd": n, "flash_bwd_dq": n,
                                "flash_bwd_dkv": n} for x in moe), msg)
    res["moe_launches_by_rank"] = [x["launches"] for x in moe]
    print(f"pp phase wall {wall:.1f} s (rank processes)", flush=True)
    return res



# ---------------------------------------------------------------------------
# Phase 14: MoE and fsdp over a split sequence (ROADMAP item 20).


def msp_first_step(rank, mesh, ds, dev, seed):
    """The MoE LM's first step over the ring: its loss and all-reduced
    gradients, and each layer's global routing, held on rank 0 against one
    process's on the same weights and batch on the card."""
    model = moe_model(dev, seed + 50, mesh=mesh)
    ttr.create_train_state(model, mesh=mesh)  # digests; routing over sp
    sampler, loader = long_loader(ds, mesh, dev, seed + 50)
    batches = iter(loader)
    tok, tgt = next(batches)
    batches.close()
    pos = loader.seq_positions(LONG_BATCH)
    loss = ttr.lm_loss(model, tok, tgt, pos)
    loss.backward()
    ttr.all_reduce_gradients(list(model.parameters()), MSP_SP)
    ring_loss = loss.detach().float().clone()
    dist.all_reduce(ring_loss)
    out = {"ring_loss": float(ring_loss) / MSP_SP,
           "routing": moe_routing_stats(model)}
    if rank == 0:
        idx = sampler.epoch_indices()[:LONG_BATCH]
        full_tok, full_tgt = (torch.from_numpy(a).to(dev)
                              for a in ds.fetch(idx))
        ref = moe_model(dev, seed + 50)
        full_pos = torch.arange(LONG_SEQ, dtype=torch.int32,
                                device=dev).expand(LONG_BATCH, LONG_SEQ)
        ref_loss = ttr.lm_loss(ref, full_tok, full_tgt, full_pos)
        ref_loss.backward()
        worst, worst_name = 0.0, ""
        for (n, p), pr in zip(model.named_parameters(), ref.parameters()):
            e = rel_l2(p.grad, pr.grad)
            if e > worst:
                worst, worst_name = e, n
        out.update(ref_loss=float(ref_loss.detach()), worst_grad=worst,
                   worst_grad_name=worst_name,
                   ref_routing=moe_routing_stats(ref))
        del ref
    del model
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def msp_train(rank, group, mesh, ds, dev, seed):
    """MSP_WARMUP + MSP_STEPS steps of the MoE LM over the ring (the
    counts zeroed just before, read just after)."""
    model = moe_model(dev, seed + 50, mesh=mesh)
    state, opt = ttr.create_train_state(model, lr=LONG_LR, mesh=mesh)
    step = ttr.make_train_step(model, opt, state=state)
    _, loader = long_loader(ds, mesh, dev, seed + 50)
    pos = loader.seq_positions(LONG_BATCH)
    losses, step_s = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    for key in ring_shift_stats:
        ring_shift_stats[key] = 0
    batches = iter(loader)
    for _ in range(MSP_WARMUP + MSP_STEPS):
        tok, tgt = next(batches)
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, pos)))  # syncs
        step_s.append(time.perf_counter() - t1)
    batches.close()
    torch.cuda.synchronize()
    out = {"losses": losses, "step_s": step_s, "launches": launch_counts(),
           "shifts": dict(ring_shift_stats),
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "efficiency": loader.metrics.efficiency, "steps": state.step,
           "routing": moe_routing_stats(model),
           "digests": group.allgather(param_digest(model))}
    # the step's gradient all-reduce over sp alone, after the counted run
    params = list(model.parameters())
    out["grad_allreduce_ms"] = median_ms(lambda: ttr.all_reduce_gradients(
        params, MSP_SP, mesh.get_group("sp")), 3)
    out["grad_allreduce_bytes"] = 4 * sum(p.numel() for p in params)
    del model, opt, state, step, params
    torch.cuda.empty_cache()
    return out


def msp_prefill(rank, mesh, ds, dev, seed):
    """generate with the MoE ring prefill over sp (2 prompts of LONG_SEQ,
    LONG_NEW_TOKENS new tokens): its first-token logits against the
    mesh-free prefill's on rank 0."""
    model = moe_model(dev, seed + 55)
    prompts = torch.from_numpy(ds.fetch(np.arange(LONG_BATCH) * 5)[0]) \
        .to(dev).long()
    zero_launch_counts()
    st = {}
    got = tdec.generate(model, prompts, LONG_NEW_TOKENS, stats=st,
                        prefill_mesh=mesh)
    torch.cuda.synchronize()
    out = {"launches": launch_counts(), "prefill_s": st["prefill_s"],
           "decode_ms": st["decode_s"] / st["decode_steps"] * 1e3,
           "routing": moe_routing_stats(model)}
    check(got.shape == (LONG_BATCH, LONG_SEQ + LONG_NEW_TOKENS) and
          torch.equal(got[:, :LONG_SEQ], prompts), "MoE ring generate shape")
    if rank == 0:
        st0 = {}
        want = tdec.generate(model, prompts, LONG_NEW_TOKENS, stats=st0)
        out.update(
            first_logits_rel=max(rel_l2(a, b) for a, b in zip(
                st["first_logits"], st0["first_logits"])),
            first_logits_abs=float((st["first_logits"]
                                    - st0["first_logits"]).abs().max()),
            equal_share=float((got[:, LONG_SEQ:] == want[:, LONG_SEQ:])
                              .float().mean()),
            meshfree_prefill_s=st0["prefill_s"])
    del model
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _moesp_rank(rank, group, store, dev, seed):
    mesh = make_mesh({"dp": 1, "sp": MSP_SP})
    t0 = time.perf_counter()
    ds = long_store(store, rank, seed)
    out = {"setup_s": time.perf_counter() - t0}
    out["first_step"] = msp_first_step(rank, mesh, ds, dev, seed)
    out["train"] = msp_train(rank, group, mesh, ds, dev, seed)
    # the routing all-gather of a layer alone: (k, B_local, E) row counts,
    # the valid count and the place
    counts = torch.zeros(MOE_TOP_K * LONG_BATCH * MOE_EXPERTS + 2,
                         dtype=torch.int64, device=dev)
    out["route_gather_ms"] = median_ms(lambda: collectives.all_gather_counts(
        counts, mesh.get_group("sp")), 20)
    out["prefill"] = msp_prefill(rank, mesh, ds, dev, seed)
    return out


def fsp_run(rank, group, ds, dev, seed):
    """The dense LM over fsdp 2 x sp 2: FSP_WARMUP + FSP_STEPS steps
    store-fed through ``DeviceLoader(spec=("fsdp", "sp"))``; the first
    step's loss, gathered gradients and gathered parameters against one
    process's step from the same weights and global batch on rank 0."""
    mesh = make_mesh({"sp": MSP_SP, "fsdp": 2})
    fi, j = mesh.get_local_rank("fsdp"), mesh.get_local_rank("sp")
    model = long_model(dev, seed + 60, mesh)
    state, opt = ttr.create_train_state(model, lr=TRAIN_LR, mesh=mesh)
    step = ttr.make_train_step(model, opt, state=state)
    seen = _grads_at_step(model, opt)
    per = LAYOUT_BATCH // 2
    loader = DeviceLoader(ds, DistributedSampler(len(ds), 2, fi,
                                                 seed=seed + 60),
                          per, device=dev, mesh=mesh, spec=("fsdp", "sp"))
    pos = loader.seq_positions(per)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    for key in ring_shift_stats:
        ring_shift_stats[key] = 0
    losses, step_s = [], []
    batches = iter(loader)
    for i in range(FSP_WARMUP + FSP_STEPS):
        tok, tgt = next(batches)
        if i == 0:
            first = (tok, tgt)
        t1 = time.perf_counter()
        losses.append(float(step(tok, tgt, pos)))  # syncs
        step_s.append(time.perf_counter() - t1)
        if i == 0:
            params = to_flax(model)
    batches.close()
    torch.cuda.synchronize()
    out = {"losses": losses, "step_s": step_s, "launches": launch_counts(),
           "shifts": dict(ring_shift_stats), "steps": state.step,
           "at": (fi, j),
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "efficiency": loader.metrics.efficiency}
    # the step's sp all-reduce of this rank's gradient shards alone, after
    # the counted run (FSDP2's own collectives are not timed apart)
    sharded = [p for p in model.parameters() if ttr._fsdp_managed(p)]
    out["sp_allreduce_ms"] = median_ms(lambda: ttr.all_reduce_gradients(
        sharded, MSP_SP, mesh.get_group("sp")), 3)
    out["sp_allreduce_bytes"] = 4 * sum(ttr._local(p).numel()
                                        for p in sharded)
    del sharded
    grads = seen["grads"]
    # the first step's global batch: each rank's (row block, chunk)
    parts = [[torch.empty_like(t.cpu()) for _ in range(FSP_RANKS)]
             for t in first]
    for p, t in zip(parts, first):
        dist.all_gather(p, t.cpu())
    coords = [None] * FSP_RANKS
    dist.all_gather_object(coords, (fi, j))
    full = []
    for p in parts:
        rows = [torch.cat([p[coords.index((f, c))] for c in range(MSP_SP)],
                          dim=1) for f in range(2)]
        full.append(torch.cat(rows).to(dev))
    del model, opt, state, step
    torch.cuda.empty_cache()
    if rank == 0:
        ref = long_model(dev, seed + 60)
        before = _flat_tree(to_flax(ref))
        _, ropt = ttr.create_train_state(ref, lr=TRAIN_LR)
        rseen = _grads_at_step(ref, ropt)
        full_pos = torch.arange(FSP_SEQ, dtype=torch.int32,
                                device=dev).expand(LAYOUT_BATCH, FSP_SEQ)
        out["ref_loss"] = float(ttr.make_train_step(ref, ropt)(*full,
                                                                full_pos))
        rgrads = _flat_tree(rseen["grads"])
        rparams = _flat_tree(to_flax(ref))
        del ref, ropt
        torch.cuda.empty_cache()
        out["worst_grad"] = _worst_rel(_flat_tree(grads), rgrads)
        zero = {k for k, v in before.items() if not np.any(v)}
        flat = _flat_tree(params)
        out["worst_param"] = _worst_rel(flat, rparams, set(before) - zero)
        out["worst_flip"] = _worst_flip(flat, rparams, before, zero)
    del grads, params
    dist.barrier()
    return out


def _fsdpsp_rank(rank, group, store, dev, seed):
    t0 = time.perf_counter()
    ds = long_store(store, rank, seed, FSP_SEQ)
    out = {"setup_s": time.perf_counter() - t0}
    out["run"] = fsp_run(rank, group, ds, dev, seed)
    return out


def _routing_line(stats):
    return [(s["routed"], round(s["drop_share"], 4)) for s in stats]


def phase_moe_sp(seed, card):
    """Phase 14: (a) the MoE LM over dp 1 x sp 2; (b) the dense LM over
    fsdp 2 x sp 2."""
    print(f"moe sp: {MSP_SP} rank processes on cuda:0 (gloo), mesh dp 1 x "
          f"sp {MSP_SP}; TransformerLM({VOCAB}, {DIM}, {HEADS}, {LAYERS}, "
          f"bf16) with {MOE_EXPERTS} experts, top-{MOE_TOP_K}, at B "
          f"{LONG_BATCH}, S {LONG_SEQ}; {LONG_WINDOWS} windows of "
          f"{LONG_SEQ + 1} tokens in a TCP store", flush=True)
    print(f"moe sp host capabilities | {card}: "
          f"{json.dumps(diag.capability_report(), sort_keys=True)}",
          flush=True)
    t0 = time.perf_counter()
    ranks = run_ranks("moesp", MSP_SP, seed)
    wall = time.perf_counter() - t0
    fs = ranks[0]["first_step"]
    msg = (f"moe sp first step | {card}: ring loss {fs['ring_loss']:.6f} "
           f"against one process sp 1 {fs['ref_loss']:.6f} (tol "
           f"{LONG_LOSS_TOL}); worst gradient L2 error over its norm "
           f"{fs['worst_grad']:.3e} ({fs['worst_grad_name']}; tol "
           f"{LONG_GRAD_TOL}); per layer global (routed per expert, drop "
           f"share) over sp {_routing_line(fs['routing'])} beside one "
           f"process's {_routing_line(fs['ref_routing'])}")
    print(msg, flush=True)
    check(abs(fs["ring_loss"] - fs["ref_loss"]) <= LONG_LOSS_TOL and
          fs["worst_grad"] <= LONG_GRAD_TOL, msg)
    # the routing is global: every rank counts the same assignments
    # (its aux is its own share)
    check(ranks[1]["first_step"]["ring_loss"] == fs["ring_loss"] and
          _routing_line(ranks[1]["first_step"]["routing"])
          == _routing_line(fs["routing"]),
          "moe sp: the ranks' first steps differ")
    per = [r["train"] for r in ranks]
    med = max(float(np.median(x["step_s"][MSP_WARMUP:])) for x in per)
    flops = moe_flops_per_step(LONG_BATCH, LONG_SEQ)
    steps = MSP_WARMUP + MSP_STEPS
    msp_shifts = ring_shifts_want(steps, LONG_BATCH, LONG_SEQ // MSP_SP,
                                  sp=MSP_SP)
    msg = (f"moe sp train | {card}: losses {per[0]['losses']}; step ms per "
           f"rank {[[round(s * 1e3, 3) for s in x['step_s']] for x in per]}"
           f"; median after {MSP_WARMUP} warm-up {med * 1e3:.3f} ms = "
           f"{LONG_BATCH * LONG_SEQ / med:.1f} tokens/s in total, MFU on "
           f"routed FLOPs {flops / med / PEAK_BF16_FLOPS:.4f}; peak GiB per "
           f"rank {[round(x['peak_bytes'] / 2**30, 3) for x in per]}; "
           f"input_pipeline_efficiency "
           f"{[round(x['efficiency'], 4) for x in per]}; last step's "
           f"routing {_routing_line(per[0]['routing'])}; routing all-gather "
           f"alone ms per rank "
           f"{[round(r['route_gather_ms'], 4) for r in ranks]}; the "
           f"gradient all-reduce over sp alone "
           f"({per[0]['grad_allreduce_bytes']} bytes f32) ms per rank "
           f"{[round(x['grad_allreduce_ms'], 3) for x in per]}; launches "
           f"{[x['launches'] for x in per]}; shifts per rank "
           f"{[x['shifts'] for x in per]} (want {msp_shifts})")
    print(msg, flush=True)
    check(all(math.isfinite(v) for v in per[0]["losses"]), msg)
    check(per[0]["losses"] == per[1]["losses"], msg)
    check(len(set(per[0]["digests"])) == 1 and
          per[0]["digests"] == per[1]["digests"], msg)
    for r, x in enumerate(per):
        n = LAYERS * (r + 1) * steps
        check(x["launches"] == {"flash_fwd": n, "flash_bwd_dq": n,
                                "flash_bwd_dkv": n}, msg)
        check(x["steps"] == steps, msg)
        check(x["shifts"] == msp_shifts, msg)
    pf = [r["prefill"] for r in ranks]
    msg = (f"moe sp ring prefill | {card}: {LONG_BATCH} prompts of "
           f"{LONG_SEQ} + {LONG_NEW_TOKENS} tokens over sp {MSP_SP}: "
           f"prefill s {[round(p['prefill_s'], 4) for p in pf]} (mesh-free "
           f"on rank 0 {pf[0]['meshfree_prefill_s']:.4f}); decode ms per "
           f"step {[round(p['decode_ms'], 3) for p in pf]}; first-token "
           f"logits L2 error over norm {pf[0]['first_logits_rel']:.3e} (tol"
           f" {ROW_REL_TOL['bfloat16']}), max abs "
           f"{pf[0]['first_logits_abs']:.3e}; equal tokens "
           f"{pf[0]['equal_share']:.3f}; launches "
           f"{[p['launches'] for p in pf]}")
    print(msg, flush=True)
    check(pf[0]["first_logits_rel"] <= ROW_REL_TOL["bfloat16"], msg)
    for r, p in enumerate(pf):
        check(p["launches"]["flash_fwd"] == LAYERS * (r + 1) and
              p["launches"]["flash_bwd_dq"] == 0, msg)
    print(f"moe sp wall {wall:.1f} s (rank processes)", flush=True)

    print(f"fsdp sp: {FSP_RANKS} rank processes on cuda:0 (gloo), mesh sp "
          f"{MSP_SP} x fsdp 2; the dense LM at B {LAYOUT_BATCH}, S "
          f"{FSP_SEQ}; {LONG_WINDOWS} windows of {FSP_SEQ + 1} tokens in a "
          f"TCP store", flush=True)
    t0 = time.perf_counter()
    franks = [r["run"] for r in run_ranks("fsdpsp", FSP_RANKS, seed)]
    fwall = time.perf_counter() - t0
    r0 = franks[0]
    fmed = max(float(np.median(x["step_s"][FSP_WARMUP:])) for x in franks)
    fflops = lm_flops_per_step(VOCAB, DIM, LAYERS, LAYOUT_BATCH, FSP_SEQ)
    fsteps = FSP_WARMUP + FSP_STEPS
    fsp_shifts = ring_shifts_want(fsteps, LAYOUT_BATCH // 2,
                                  FSP_SEQ // MSP_SP, sp=MSP_SP)
    msg = (f"fsdp sp train | {card}: losses {r0['losses']}; step ms per "
           f"rank {[[round(s * 1e3, 3) for s in x['step_s']] for x in franks]}"
           f"; median after {FSP_WARMUP} warm-up {fmed * 1e3:.3f} ms = "
           f"{LAYOUT_BATCH * FSP_SEQ / fmed:.1f} tokens/s in total, MFU "
           f"{fflops / fmed / PEAK_BF16_FLOPS:.4f}; first step loss "
           f"{r0['losses'][0]:.6f} against one process {r0['ref_loss']:.6f}"
           f" (tol {LONG_LOSS_TOL}); worst gradient L2 error over its norm "
           f"{r0['worst_grad'][0]:.3e} ({r0['worst_grad'][1]}), worst "
           f"updated parameter {r0['worst_param'][0]:.3e} "
           f"({r0['worst_param'][1]}) (tol {LONG_GRAD_TOL}); zero-initialised"
           f" leaves' share moved the other way {r0['worst_flip'][0]:.4f} "
           f"({r0['worst_flip'][1]}; tol {LAYOUT_FLIP_TOL}); peak GiB per "
           f"rank {[round(x['peak_bytes'] / 2**30, 3) for x in franks]}; "
           f"(fsdp, sp) per rank {[x['at'] for x in franks]}; "
           f"input_pipeline_efficiency "
           f"{[round(x['efficiency'], 4) for x in franks]}; the sp "
           f"all-reduce of the gradient shards alone (bytes f32 per rank "
           f"{[x['sp_allreduce_bytes'] for x in franks]}) ms per rank "
           f"{[round(x['sp_allreduce_ms'], 3) for x in franks]}; launches "
           f"{[x['launches'] for x in franks]}; shifts per rank "
           f"{[x['shifts'] for x in franks]} (want {fsp_shifts})")
    print(msg, flush=True)
    check(all(math.isfinite(v) for x in franks for v in x["losses"]), msg)
    check(all(x["losses"] == r0["losses"] for x in franks), msg)
    check(abs(r0["losses"][0] - r0["ref_loss"]) <= LONG_LOSS_TOL, msg)
    check(r0["worst_grad"][0] <= LONG_GRAD_TOL and
          r0["worst_param"][0] <= LONG_GRAD_TOL and
          r0["worst_flip"][0] <= LAYOUT_FLIP_TOL, msg)
    for x in franks:
        n = LAYERS * (x["at"][1] + 1) * fsteps
        check(x["launches"] == {"flash_fwd": n, "flash_bwd_dq": n,
                                "flash_bwd_dkv": n}, msg)
        check(x["steps"] == fsteps, msg)
        check(x["shifts"] == fsp_shifts, msg)
    print(f"fsdp sp wall {fwall:.1f} s (rank processes)", flush=True)
    by_rank = [x["launches"] for x in per]
    return {"moe_sp_launches_by_rank": by_rank,
            "fsdp_sp_launches_by_rank": [x["launches"] for x in franks],
            "launches": {k: sum(x[k] for x in by_rank)
                         + sum(x["launches"][k] for x in franks)
                         for k in by_rank[0]}}


# ---------------------------------------------------------------------------
# Phase 15: the kernels at every head dim up to 256 (the reference's
# flash_attention takes any D), the LM at other head dims, and the
# long-context example at the reference's defaults (hd = 128 // 4 = 32).


def head_dim_case(g, dev, d, name, shape, dt, causal, qo, ko,
                  label="head dims", out_abs=True, with_dlse=True):
    """The three kernels against their plain versions on one case at head
    dim d, with an lse cotangent (unless ``with_dlse`` is False) and do as
    autograd hands it over (a (B, H, S, D) view of a (B, S, H, D) buffer);
    returns {kernel: (max abs error, max row relative error)}. out is held
    by row and, where ``out_abs``, by its largest error at TOL too."""
    b, h, sq, sk = shape
    q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dt)
    k, v = (torch.randn((b, h, sk, d), generator=g, device=dev).to(dt)
            for _ in range(2))
    do = torch.randn((b, sq, h, d), generator=g, device=dev).to(dt) \
        .transpose(1, 2)
    dlse = torch.randn((b, h, sq), generator=g, device=dev)
    kw = dict(causal=causal, q_offset=qo, kv_offset=ko, scale=d ** -0.5)
    before = launch_counts()
    with torch.no_grad():
        with no_plain_path():
            out, lse = attention.flash_attention(q, k, v, causal=causal,
                                                 q_offset=qo, kv_offset=ko)
            c = attention.flash_bwd_prep(do, out,
                                         dlse if with_dlse else None)
            got = {"dq": attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                      **kw)}
            got["dk"], got["dv"] = attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, c, **kw)
            again = {"dq": attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                        **kw)}
            again["dk"], again["dv"] = attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, c, **kw)
            torch.cuda.synchronize()
        moved = {n: v2 - before[n] for n, v2 in launch_counts().items()}
        ref_out, ref_lse = attention.mha_reference(
            q, k, v, causal=causal, q_offset=qo, kv_offset=ko)
        want = {"dq": attention.flash_bwd_dq_reference(q, k, v, do, lse, c,
                                                       **kw)}
        want["dk"], want["dv"] = attention.flash_bwd_dkv_reference(
            q, k, v, do, lse, c, **kw)
    tag = f"{label} d={d} {name}"
    check(moved == {"flash_fwd": 1, "flash_bwd_dq": 2, "flash_bwd_dkv": 2},
          f"{tag}: launch counters moved {moved}")
    dname = str(dt).split(".")[-1]
    tol = ROW_REL_TOL[dname]
    live = torch.isfinite(ref_lse)
    check(out.shape == q.shape and out.dtype == dt and
          not torch.isnan(out).any() and not torch.isnan(lse).any(),
          f"{tag}: out shape/dtype/NaN")
    check(bool((torch.isfinite(lse) == live).all()) and
          bool((out[~live] == 0).all()), f"{tag}: fully-masked rows")
    diff = out.float() - ref_out.float()
    e_out = float(diff.abs().max())
    e_lse = float((lse[live] - ref_lse[live]).abs().max()) \
        if live.any() else 0.0
    _, e_rel, _ = row_errors(out, ref_out, ~live)
    t_out, t_lse = TOL[dname]
    res = {"flash_fwd": (max(e_out, e_lse), e_rel), "moved": moved}
    line = [f"out max_abs_err={e_out:.3e} lse={e_lse:.3e} "
            f"max_row_rel_err={e_rel:.3e}"]
    check((e_out <= t_out or not out_abs) and e_lse <= t_lse and
          e_rel <= tol,
          f"{tag}: forward disagrees with the plain version ({line[0]})")
    dead = {"dq": ~live, "dk": dead_keys(b, h, sq, sk, causal, qo, ko, dev)}
    dead["dv"] = dead["dk"]
    for which, kern in (("dq", "flash_bwd_dq"), ("dk", "flash_bwd_dkv"),
                        ("dv", "flash_bwd_dkv")):
        t = got[which]
        check(t.shape == want[which].shape and t.dtype == dt and
              not torch.isnan(t).any(), f"{tag}: {which} shape/NaN")
        e_abs, e_row, nonzero_dead = row_errors(t, want[which], dead[which])
        line.append(f"{which} max_abs_err={e_abs:.3e} "
                    f"max_row_rel_err={e_row:.3e}")
        check(nonzero_dead == 0 and e_row <= tol,
              f"{tag}: {which} disagrees with the plain version ({e_row:.3e}"
              f" > {tol} or {nonzero_dead} dead rows not 0)")
        prev = res.get(kern, (0.0, 0.0))
        res[kern] = (max(prev[0], e_abs), max(prev[1], e_row))
    same = all(torch.equal(again[x], got[x]) for x in got)
    check(same, f"{tag}: dq or dk/dv differs between two launches")
    print(f"{tag}: b,h,sq,sk={b},{h},{sq},{sk} {dname} causal={causal} "
          f"q_offset={qo} kv_offset={ko} "
          f"dlse={'yes' if with_dlse else 'no'}; {'; '.join(line)}; "
          f"bit-identical over two launches {same}; launches moved {moved} "
          f"(tol per row {tol})", flush=True)
    return res


def head_dim_timing(g, dev, d, dt=torch.bfloat16, iters=20):
    """Each kernel at the LM's (8, 2048) with DIM // d heads of d (H D =
    DIM where d divides it; the main path's qkv-view layout, causal, in
    ``dt``) held row by row against its plain version (out, lse, dq, dk,
    dv on the same inputs), then timed against it and SDPA, in turns
    (``iters`` launches a round for the kernels and SDPA)."""
    b, h, s = BATCH, DIM // d, SEQ
    dname = str(dt).split(".")[-1]
    width = h * d
    base = torch.randn((b, s, 3 * width), generator=g, device=dev) \
        .to(dt).requires_grad_()
    ql, kl, vl = (t.reshape(b, s, h, d).transpose(1, 2)
                  for t in base.split(width, dim=-1))
    q, k, v = (t.detach() for t in (ql, kl, vl))
    do = torch.randn((b, s, h, d), generator=g, device=dev) \
        .to(dt).transpose(1, 2)
    kw = dict(causal=True, q_offset=0, kv_offset=0, scale=d ** -0.5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    with torch.no_grad():
        with no_plain_path():
            out, lse = attention.flash_attention(q, k, v, causal=True)
            c = attention.flash_bwd_prep(do, out)
            got = {"out": out,
                   "dq": attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                      **kw)}
            got["dk"], got["dv"] = attention._flash_bwd_dkv_cuda(
                q, k, v, do, lse, c, **kw)
        want_out, want_lse = attention.mha_reference(q, k, v, causal=True)
        want = {"out": want_out,
                "dq": attention.flash_bwd_dq_reference(q, k, v, do, lse, c,
                                                       **kw)}
        want["dk"], want["dv"] = attention.flash_bwd_dkv_reference(
            q, k, v, do, lse, c, **kw)
    torch.cuda.synchronize()
    tag = f"head dims timing d={d} at (B,H,S,D)=({b},{h},{s},{d})"
    tol = ROW_REL_TOL[dname]
    live = torch.isfinite(want_lse)
    check(bool((torch.isfinite(lse) == live).all()) and
          not torch.isnan(lse).any(), f"{tag}: lse's fully-masked rows")
    e_lse = float((lse[live] - want_lse[live]).abs().max())
    check(e_lse <= TOL[dname][1],
          f"{tag}: lse disagrees with the plain version ({e_lse:.3e})")
    dead = {"out": ~live, "dq": ~live,
            "dk": dead_keys(b, h, s, s, True, 0, 0, dev)}
    dead["dv"] = dead["dk"]
    errs = {}
    for which, t in got.items():
        check(t.shape == want[which].shape and t.dtype == dt
              and not torch.isnan(t).any(), f"{tag}: {which} shape/NaN")
        e_abs, e_rel, nonzero_dead = row_errors(t, want[which], dead[which])
        errs[which] = (e_abs, e_rel)
        check(nonzero_dead == 0 and e_rel <= tol,
              f"{tag}: {which} disagrees with the plain version ({e_rel:.3e}"
              f" per row > {tol}, or {nonzero_dead} dead rows not 0)")
    print(f"{tag} {dname} causal, the LM's qkv views (q strides "
          f"{q.stride()}):"
          f" against the plain versions lse max_abs_err={e_lse:.3e}; "
          + "; ".join(f"{w} max_abs_err={a:.3e} max_row_rel_err={r:.3e}"
                      for w, (a, r) in errs.items())
          + f" (tol per row {tol})", flush=True)
    del got, want, want_out, want_lse
    sd_out = sdpa(ql, kl, vl, is_causal=True)
    fns = {
        "fwd": (lambda: attention.flash_attention(q, k, v, causal=True),
                iters),
        "dq": (lambda: attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                    **kw), iters),
        "dkv": (lambda: attention._flash_bwd_dkv_cuda(q, k, v, do, lse, c,
                                                      **kw), iters),
        "fwd_plain": (lambda: attention.mha_reference(q, k, v, causal=True),
                      3),
        "dq_plain": (lambda: attention.flash_bwd_dq_reference(
            q, k, v, do, lse, c, **kw), 2),
        "dkv_plain": (lambda: attention.flash_bwd_dkv_reference(
            q, k, v, do, lse, c, **kw), 2),
        "sdpa": (lambda: sdpa(q, k, v, is_causal=True), iters),
        "sdpa_backward": (lambda: torch.autograd.grad(
            sd_out, (ql, kl, vl), do, retain_graph=True), iters),
    }
    if dname == "float32":  # the forward's split pass alone
        fns["split"] = (lambda: attention._tf32_planes(q, k, v), iters)
    t = {n: [] for n in fns}
    for order in (list(fns), list(fns)[::-1]):
        for n in order:
            fn, iters = fns[n]
            with contextlib.nullcontext() if n == "sdpa_backward" \
                    else torch.no_grad():
                t[n].append(time_ms(fn, iters))
    ms = {n: sum(x) / len(x) for n, x in t.items()}
    res = {}
    for kern, kind, lib in (("flash_fwd", "fwd", "sdpa"),
                            ("flash_bwd_dq", "dq", None),
                            ("flash_bwd_dkv", "dkv", None)):
        flops, nbytes = attention_work(b, h, s, s, d, q.element_size(),
                                       True, 0, 0, kind)
        bound, bound_by = bound_of(flops, nbytes, dname)
        extra = {}
        if dname == "float32":
            # on the tensor cores; the CUDA cores' bound beside it
            extra["cuda_core_bound_ms"] = bound
            bound, bound_by = tf32_bound(flops, nbytes, kind)
            if kind == "fwd":
                extra["split_ms"] = ms["split"]
        checked = [errs[w] for w in {"fwd": ("out",), "dq": ("dq",),
                                     "dkv": ("dk", "dv")}[kind]]
        res[kern] = {"shape": [b, h, s, d], "ms": ms[kind],
                     "plain_ms": ms[kind + "_plain"], "bound_ms": bound,
                     "bound_by": bound_by, **extra,
                     "library_ms": ms[lib] if lib else None,
                     "max_abs_err": max(max(a for a, _ in checked),
                                        e_lse if kind == "fwd" else 0.0),
                     "max_row_rel_err": max(r for _, r in checked)}
        print(f"head dims timing {kern} at (B,H,S,D)=({b},{h},{s},{d}) "
              f"{dname} causal: kernel_ms={ms[kind]:.4f} plain_ms="
              f"{ms[kind + '_plain']:.4f} bound_ms={bound:.4f} ({bound_by}:"
              f" {flops:.4e} FLOP, {nbytes:.4e} B) "
              + "".join(f"{k}={v:.4f} " for k, v in extra.items())
              + f"library_ms="
              f"{ms[lib] if lib else None} achieved_TFLOPs="
              f"{flops / ms[kind] / 1e9:.1f}", flush=True)
    res["sdpa_backward_ms"] = ms["sdpa_backward"]
    print(f"head dims timing d={d} {dname}: dq + dkv = "
          f"{ms['dq'] + ms['dkv']:.4f} ms against library_ms(sdpa "
          f"backward)={ms['sdpa_backward']:.4f}; rounds={json.dumps(t)}",
          flush=True)
    del base, ql, kl, vl, q, k, v, do, out, lse, c, sd_out
    torch.cuda.empty_cache()
    return res


def head_dim_lm(dev, seed, ds, heads, card, dtype=torch.bfloat16):
    """The LM at bench.py:3169's width with ``heads`` heads (head dim
    DIM // heads) in ``dtype``, store-fed: the eval loss, HD_STEPS Adam
    steps and ``generate`` of HD_NEW_TOKENS tokens, launches zeroed just
    before and read just after (no plain attention or SDPA reachable in
    between); the first step's loss against the same weights and batch
    under the plain attention."""
    hd = DIM // heads
    dname = str(dtype).split(".")[-1]
    loader = DeviceLoader(ds, DistributedSampler(WINDOWS, 1, 0,
                                                 seed=seed + 50 + heads),
                          BATCH, device=dev)
    model = ttr.TransformerLM(vocab=VOCAB, dim=DIM, heads=heads,
                              layers=LAYERS, compute_dtype=dtype,
                              device=dev)
    model.init_weights(torch.Generator(device=dev).manual_seed(seed + heads))
    state, opt = ttr.create_train_state(model, lr=TRAIN_LR)
    step = ttr.make_train_step(model, opt, state=state)
    positions = torch.arange(SEQ, dtype=torch.int32,
                             device=dev).expand(BATCH, SEQ)
    batches = iter(loader)
    tok, tgt = next(batches)
    with torch.no_grad(), plain_attention():
        ref_loss = float(ttr.lm_loss(model, tok, tgt, positions))
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()  # count this path alone
    t_start = time.perf_counter()
    with no_plain_path():
        with torch.no_grad():
            eval_loss = float(ttr.lm_loss(model, tok, tgt, positions))
        losses, step_s = [], []
        for i in range(HD_STEPS):
            if i:
                tok, tgt = next(batches)
            t1 = time.perf_counter()
            losses.append(float(step(tok, tgt, positions)))  # syncs
            step_s.append(time.perf_counter() - t1)
        prompts = next(batches)[0]
        batches.close()
        out = tdec.generate(model, prompts, HD_NEW_TOKENS)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2**30
    want = {"flash_fwd": LAYERS * (HD_STEPS + 2),
            "flash_bwd_dq": LAYERS * HD_STEPS,
            "flash_bwd_dkv": LAYERS * HD_STEPS}
    med = float(np.median(step_s[1:]))
    msg = (f"head dims LM hd={hd} {dname} | {card}: TransformerLM({VOCAB}, "
           f"{DIM}, heads={heads}, {LAYERS}, {dname}) at ({BATCH}, {SEQ}); "
           f"eval loss "
           f"{eval_loss:.6f}; first step loss {losses[0]:.6f} against the "
           f"plain attention's {ref_loss:.6f} (tol {MOE_LOSS_TOL}); losses "
           f"{losses}; step ms {[round(x * 1e3, 3) for x in step_s]}; "
           f"median after the first {med * 1e3:.3f} ms = "
           f"{BATCH * SEQ / med:.1f} tokens/s; generate {tuple(out.shape)}; "
           f"peak memory {peak_gib:.3f} GiB; wall {wall:.3f} s; launches "
           f"{launches} (want {want})")
    print(msg, flush=True)
    check(all(math.isfinite(x) for x in losses + [eval_loss]), msg)
    check(abs(losses[0] - ref_loss) <= MOE_LOSS_TOL, msg)
    check(state.step == HD_STEPS, msg)
    check(out.shape == (BATCH, SEQ + HD_NEW_TOKENS) and
          bool(torch.equal(out[:, :SEQ], prompts)) and
          bool(((out >= 0) & (out < VOCAB)).all()), msg)
    check(launches == want, msg)
    del model, opt, state, step
    torch.cuda.empty_cache()
    return {"launches": launches, "median_ms": med * 1e3,
            "step_ms": [x * 1e3 for x in step_s], "peak_gib": peak_gib,
            "first_loss": losses[0], "plain_loss": ref_loss}


# Each rank of the example: its ``main`` with the arguments given, then
# one line of this rank's result (head_dim_example reads it from the log).
HD_EX_RANK = """\
import json, sys
from ddstore_tpu_torch.examples import lm_longcontext
from ddstore_tpu_torch.ops import attention
res = lm_longcontext.main(sys.argv[1:])
res["launches"] = {n: getattr(attention, n + "_launches")
                   for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
print("example result " + json.dumps(res), flush=True)
"""


def head_dim_example(seed, card):
    """The port's ``examples/lm_longcontext.py`` (its ``main``, as
    ``python -m`` runs it) at the reference's defaults (dim 128, heads
    dim // 32: head dim 32) over dp 2 x sp 2, four rank processes sharing
    the card through a file rendezvous (gloo), one epoch of HD_EX_WINDOWS
    windows a rank: each rank's losses finite and equal across the ranks,
    and every kernel launched on every rank (the ring's chunks)."""
    work = tempfile.mkdtemp(prefix="hd_example_")
    rdv = os.path.join(work, "rdv")
    os.makedirs(rdv)
    args = ["--epochs", "1", "--windows", str(HD_EX_WINDOWS), "--seed",
            str(seed)]
    cmd = [sys.executable, "-c", HD_EX_RANK] + args
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, DDSTORE_WORLD=str(HD_EX_RANKS),
               DDSTORE_RDV_DIR=rdv, DDSTORE_HOST="127.0.0.1",
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    logs = [open(os.path.join(work, f"rank{r}.log"), "w+")
            for r in range(HD_EX_RANKS)]
    procs = [subprocess.Popen(cmd, env=dict(env, DDSTORE_RANK=str(r)),
                              cwd=root, stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(HD_EX_RANKS)]
    try:
        deadline = time.monotonic() + HD_EX_DEADLINE_S
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    shutil.rmtree(work, ignore_errors=True)
    codes = [p.returncode for p in procs]
    results = [[json.loads(ln[len("example result "):])
                for ln in text.splitlines()
                if ln.startswith("example result ")] for text in texts]
    if codes != [0] * HD_EX_RANKS or any(len(r) != 1 for r in results):
        for r, text in enumerate(texts):
            print(f"head dims example rank {r} (exit {codes[r]}):\n"
                  f"{text[-3000:]}", flush=True)
    check(codes == [0] * HD_EX_RANKS and
          all(len(r) == 1 for r in results),
          f"head dims example: exit codes {codes} after {wall:.1f} s, "
          f"result lines a rank {[len(r) for r in results]}")
    ranks = [r[0] for r in results]
    epoch_line = [ln for ln in texts[0].splitlines()
                  if ln.startswith("epoch")]
    msg = (f"head dims example | {card}: lm_longcontext.main({args}) over "
           f"{HD_EX_RANKS} ranks, axes {ranks[0]['axes']}, heads "
           f"{ranks[0]['heads']} (head dim {128 // ranks[0]['heads']}); "
           f"{len(ranks[0]['losses'])} steps a rank, losses (rank 0) "
           f"{[round(x, 4) for x in ranks[0]['losses']]}; rank 0 printed "
           f"{epoch_line}; launches per rank "
           f"{[x['launches'] for x in ranks]}; wall {wall:.1f} s")
    print(msg, flush=True)
    check(ranks[0]["axes"]["dp"] == 2 and ranks[0]["axes"]["sp"] == 2 and
          ranks[0]["heads"] == 4, msg)
    check(len(ranks[0]["losses"]) > 0 and
          all(math.isfinite(x) for x in ranks[0]["losses"]), msg)
    # the step's loss is reduced over the world: every rank's is the same
    check(all(x["losses"] == ranks[0]["losses"] for x in ranks), msg)
    check(all(n > 0 for x in ranks for n in x["launches"].values()), msg)
    return {"launches": {k: sum(x["launches"][k] for x in ranks)
                         for k in ranks[0]["launches"]},
            "launches_by_rank": [x["launches"] for x in ranks],
            "losses": ranks[0]["losses"], "wall_s": wall}


def phase_head_dims(dev, seed, card):
    """Phase 15."""
    g = torch.Generator(device=dev).manual_seed(5678)
    errs, launched = {}, {}
    for d in HD_DIMS:
        for name, shape, dt, causal, qo, ko in HD_CASES:
            res = head_dim_case(g, dev, d, name, shape, dt, causal, qo, ko)
            seen = launched.setdefault(
                (str(dt).split(".")[-1], wide_class(d)),
                dict.fromkeys(res["moved"], 0))
            for kern, n in res.pop("moved").items():
                seen[kern] += n
            for kern, (e_abs, e_rel) in res.items():
                prev = errs.get(kern, (0.0, 0.0))
                errs[kern] = (max(prev[0], e_abs), max(prev[1], e_rel))
    torch.cuda.empty_cache()
    timing = {d: head_dim_timing(g, dev, d) for d in HD_TIMED}
    b, h, c, d = HD_EX_CHUNK
    chunks = long_chunk_kernels(dev, b=b, h=h, c=c, d=d,
                                label="the example's")
    for kern in errs:
        checked = [t[kern] for t in timing.values()] + \
            [chunks[x][kern] for x in ("diagonal", "past")]
        errs[kern] = (max([errs[kern][0]] +
                          [x["max_abs_err"] for x in checked]),
                      max([errs[kern][1]] +
                          [x["max_row_rel_err"] for x in checked]))
    store, ds = make_store(seed)
    lms = {DIM // heads: head_dim_lm(dev, seed, ds, heads, card)
           for heads in HD_LM_HEADS}
    store.close()
    ex = head_dim_example(seed, card)
    return {"errs": errs, "launched": launched, "timing": timing,
            "example_chunks": chunks, "lm": lms, "example": ex}


# Phase 16: the kernels in fp16 and at head dims past 256 (the reference's
# kernels take any float dtype and any D), and the LM in fp16 and at hd 512.


def sdpa_route(q, k, v):
    """SDPA's route at these inputs (causal): which backends take them,
    each tried alone under ``sdpa_kernel``, the one a default call picks
    (PyTorch's own choice, ``torch._fused_sdp_choice``), and the largest
    kernels of one default call under the profiler (empty where the
    profiler caught no device events). The library yardstick only."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    took = []
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION",
                 "CUDNN_ATTENTION", "MATH"):
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            continue
        try:
            with warnings.catch_warnings(), torch.no_grad(), \
                    sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                sdpa(q, k, v, is_causal=True)
            torch.cuda.synchronize()
            took.append(name)
        except RuntimeError:
            pass
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        sdpa(q, k, v, is_causal=True)
        torch.cuda.synchronize()
    _, by_name = device_busy(prof)
    top = [k2 for k2, _ in sorted(by_name.items(), key=lambda r: -r[1][0])]
    chosen = SDPBackend(torch._fused_sdp_choice(q, k, v, is_causal=True))
    return {"backends_that_take_it": took, "default": chosen.name,
            "default_kernels": top[:3]}


def wide_class(d):
    """The kernels' instantiation class of head dim d: its tile width,
    or "chunks" past 256 (the chunk loop)."""
    width, tile, chunks = attention._kernel_width(d)
    return "chunks" if chunks > 1 else str(tile)


def phase_fp16_wide(dev, seed, card):
    """Phase 16."""
    g = torch.Generator(device=dev).manual_seed(4321)
    errs, launched, n_cases = {}, {}, 0
    for dt, dims in ((torch.float16, HD_DIMS),) + tuple(
            (dt, FW_DIMS) for dt in FW_DTYPES):
        dname = str(dt).split(".")[-1]
        for d in dims:
            for name, shape, _, causal, qo, ko in HD_CASES:
                # HD_CASES' shapes, flags and offsets, in dtype dt
                tag = f"{dname}_{name.split('_', 1)[1]}"
                res = head_dim_case(g, dev, d, tag, shape, dt, causal, qo, ko)
                key = (dname, wide_class(d))
                seen = launched.setdefault(key, dict.fromkeys(res["moved"],
                                                              0))
                for kern, n in res.pop("moved").items():
                    seen[kern] += n
                for kern, (e_abs, e_rel) in res.items():
                    prev = errs.setdefault(dname, {}).get(kern, (0.0, 0.0))
                    errs[dname][kern] = (max(prev[0], e_abs),
                                         max(prev[1], e_rel))
                n_cases += 1
    print(f"fp16 and wide head dims: {n_cases} cases held to the plain "
          f"versions; worst (max abs, max row rel) per dtype {errs}; "
          f"launches per (dtype, tile or chunks) {launched}", flush=True)
    torch.cuda.empty_cache()
    timing = {}
    for dt, d in FW_TIMED:
        dname = str(dt).split(".")[-1]
        t = head_dim_timing(g, dev, d, dt, iters=FW_ITERS[dname])
        if d > 256:
            b, h, s = BATCH, DIM // d, SEQ
            q, k, v = qkv_views(g, dev, b, h, s, d, dt)
            t["sdpa_route"] = sdpa_route(q, k, v)
            print(f"fp16 and wide head dims: SDPA at (B,H,S,D)=({b},{h},{s},"
                  f"{d}) {dname} causal: {t['sdpa_route']}", flush=True)
            del q, k, v
        timing[(dname, d)] = t
        torch.cuda.empty_cache()
    store, ds = make_store(seed)
    lms = {name: head_dim_lm(dev, seed, ds, heads, card, dt)
           for name, dt, heads in FW_LMS}
    store.close()
    return {"errs": errs, "launched": launched, "n_cases": n_cases,
            "timing": timing, "lm": lms}


# Phase 17: launch grids past 65,535 blocks on an axis CUDA caps at that.


def grid_long_case(g, dev, name, sq, sk, qo, held, d=GRID_LONG_D,
                   dt=torch.bfloat16):
    """The forward and the backward kernels ``held`` at b = h = 1, head
    dim d, causal, on a long axis whose chunked tile blocks pass 65,535,
    against their plain versions taken GRID_PLAIN_CHUNK queries (forward,
    dq) or keys (dk/dv) at a time; returns {kernel: (max abs error, max
    row relative error)}."""
    q = torch.randn((1, 1, sq, d), generator=g, device=dev, dtype=dt)
    k, v = (torch.randn((1, 1, sk, d), generator=g, device=dev, dtype=dt)
            for _ in range(2))
    do = torch.randn((1, sq, 1, d), generator=g, device=dev,
                     dtype=dt).transpose(1, 2)
    kw = dict(causal=True, q_offset=qo, kv_offset=0, scale=d ** -0.5)
    tag = f"launch grid d={d} {name}"
    dname = str(dt).split(".")[-1]
    tol = ROW_REL_TOL[dname]
    res = {}

    def hold(kern, what, got, want, dead):
        e_abs, e_rel, bad = row_errors(got, want, dead)
        check(bad == 0 and e_rel <= tol,
              f"{tag}: {what} disagrees with the plain version ({e_rel:.3e}"
              f" per row > {tol}, or {bad} dead rows not 0)")
        prev = res.get(kern, (0.0, 0.0))
        res[kern] = (max(prev[0], e_abs), max(prev[1], e_rel))

    before = launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        with no_plain_path():
            out, lse = attention.flash_attention(q, k, v, causal=True,
                                                 q_offset=qo)
            c = attention.flash_bwd_prep(do, out)
            got = {}
            if "flash_bwd_dq" in held:
                got["dq"] = attention._flash_bwd_dq_cuda(q, k, v, do, lse, c,
                                                         **kw)
            if "flash_bwd_dkv" in held:
                got["dk"], got["dv"] = attention._flash_bwd_dkv_cuda(
                    q, k, v, do, lse, c, **kw)
            torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        moved = {n: v2 - before[n] for n, v2 in launch_counts().items()}
        check(moved == {n: int(n in held or n == "flash_fwd")
                        for n in moved},
              f"{tag}: launch counters moved {moved}")
        check(not any(torch.isnan(t).any() for t in (out, lse, *got.values())),
              f"{tag}: NaN in the kernels' output")
        for i in range(0, sq, GRID_PLAIN_CHUNK) if held != (
                "flash_bwd_dkv",) else ():
            rows = slice(i, i + GRID_PLAIN_CHUNK)
            dead = ~torch.isfinite(lse[:, :, rows])
            if "flash_fwd" in held:
                ref, ref_lse = attention.mha_reference(
                    q[:, :, rows], k, v, causal=True, q_offset=qo + i)
                check(bool((torch.isfinite(ref_lse) == ~dead).all()),
                      f"{tag}: fully-masked rows differ")
                e_lse = float((lse[:, :, rows][~dead] - ref_lse[~dead])
                              .abs().max())
                check(e_lse <= TOL[dname][1], f"{tag}: lse disagrees with "
                      f"the plain version ({e_lse:.3e})")
                hold("flash_fwd", "out", out[:, :, rows], ref, dead)
                prev = res["flash_fwd"]
                res["flash_fwd"] = (max(prev[0], e_lse), prev[1])
            if "dq" in got:
                want = attention.flash_bwd_dq_reference(
                    q[:, :, rows], k, v, do[:, :, rows], lse[:, :, rows],
                    c[:, :, rows], **dict(kw, q_offset=qo + i))
                hold("flash_bwd_dq", "dq", got["dq"][:, :, rows], want, dead)
        for j in range(0, sk, GRID_PLAIN_CHUNK) if "dk" in got else ():
            keys = slice(j, j + GRID_PLAIN_CHUNK)
            want = dict(zip(("dk", "dv"), attention.flash_bwd_dkv_reference(
                q, k[:, :, keys], v[:, :, keys], do, lse, c,
                **dict(kw, kv_offset=j))))
            dead = dead_keys(1, 1, sq, want["dk"].shape[2], True, qo, j, dev)
            for which in ("dk", "dv"):
                hold("flash_bwd_dkv", which, got[which][:, :, keys],
                     want[which], dead)
    print(f"{tag}: b,h,sq,sk=1,1,{sq},{sk} {dname} causal q_offset={qo}; "
          f"the kernels in {kernel_s:.2f} s (launches moved {moved}); "
          f"against the plain versions in chunks of {GRID_PLAIN_CHUNK} "
          + "; ".join(f"{k2} max_abs_err={a:.3e} max_row_rel_err={r:.3e}"
                      for k2, (a, r) in res.items())
          + f" (tol per row {tol})", flush=True)
    del q, k, v, do, out, lse, c, got
    torch.cuda.empty_cache()
    return res


def phase_launch_grid(dev, card):
    """Phase 17."""
    g = torch.Generator(device=dev).manual_seed(1717)
    errs = {}
    for name, shape, d, dt, causal in GRID_CASES:
        f32 = dt == torch.float32
        res = head_dim_case(g, dev, d, name, shape, dt, causal, 0, 0,
                            label="launch grid", out_abs=False,
                            with_dlse=not f32)
        res.pop("moved")
        if f32:
            print(f"launch grid {name}: f32 dq worst row "
                  f"{res['flash_bwd_dq'][1]:.3e} of the plain version's "
                  f"(tol {ROW_REL_TOL['float32']}) | {card}", flush=True)
        for kern, (e_abs, e_rel) in res.items():
            prev = errs.get(kern, (0.0, 0.0))
            errs[kern] = (max(prev[0], e_abs), max(prev[1], e_rel))
        torch.cuda.empty_cache()
    for name, sq, sk, qo, held in GRID_LONG:
        for kern, (e_abs, e_rel) in grid_long_case(g, dev, name, sq, sk, qo,
                                                   held).items():
            prev = errs.get(kern, (0.0, 0.0))
            errs[kern] = (max(prev[0], e_abs), max(prev[1], e_rel))
    print(f"launch grid: {len(GRID_CASES) + len(GRID_LONG)} cases (past "
          f"65,535 blocks on a capped axis, and f32 single-key rows) held "
          f"to the plain versions; worst (max abs, max row rel) per kernel "
          f"{errs}", flush=True)
    return {"errs": errs}


# DeepSeek-V3's block as the Moonlight cell runs it: the published widths,
# one rank of 8-way expert parallelism (experts 0-7 of 64 held, an eighth
# of the vocabulary), and the cell's step of 2 rows of the published 8,192
MOON = dict(vocab=20480, dim=2048, heads=16, kv_rank=512, qk_nope=128,
            qk_rope=64, v_dim=128, dense_hidden=11264, experts=64,
            held=(0, 8), top_k=6, expert_hidden=1408, shared=2,
            scale=2.446, bias_rate=1e-3, balance=1e-4, norm_eps=1e-5,
            rope_theta=50000.0)
MOON_ROWS, MOON_SEQ = 2, 8192
MOON_CUT_LAYERS = 3    # the cut model: the dense layer and two expert ones
MOON_CUT_SEQ = 1024
MOON_TOL = 2e-2        # bf16 products against f32: each output's L2 error


def _moon_routed(m):
    from ddstore_tpu_torch.models.moe import RoutedSpec

    return RoutedSpec(m["experts"], m["top_k"], m["expert_hidden"],
                      held=tuple(m["held"]), shared=m["shared"],
                      scale=m["scale"], bias_rate=m["bias_rate"],
                      balance=m["balance"])


def _moon_spec(m):
    return ttr.DeepSeekSpec(
        mla=ttr.MlaSpec(m["kv_rank"], m["qk_nope"], m["qk_rope"],
                        m["v_dim"]),
        routed=_moon_routed(m), dense_hidden=m["dense_hidden"],
        dense_layers=1, norm_eps=m["norm_eps"], rope_theta=m["rope_theta"])


def moon_attention_check(dev, m):
    """Latent attention's shapes at the cell's step, (2, 16, 8192) with q
    and k 192 wide and v 128, through ``flash_attention`` against the
    plain f32 attention (by blocks of 1,024 queries), out and every
    gradient (each tensor's L2 error over its L2 norm)."""
    g = torch.Generator(device=dev).manual_seed(1818)
    dqk, dv = m["qk_nope"] + m["qk_rope"], m["v_dim"]
    shape = (MOON_ROWS, m["heads"], MOON_SEQ)
    q, k = (torch.randn(*shape, dqk, generator=g, device=dev)
            .bfloat16().requires_grad_() for _ in range(2))
    v = torch.randn(*shape, dv, generator=g, device=dev).bfloat16() \
        .requires_grad_()
    do = torch.randn(*shape, dv, generator=g, device=dev).bfloat16()
    n0 = (attention.flash_fwd_launches, attention.flash_bwd_dq_launches,
          attention.flash_bwd_dkv_launches)
    out, _ = attention.flash_attention(q, k, v, causal=True)
    out.backward(do)
    n1 = (attention.flash_fwd_launches, attention.flash_bwd_dq_launches,
          attention.flash_bwd_dkv_launches)
    check(out.shape[-1] == dv and all(b - a == 1 for a, b in zip(n0, n1)),
          f"moonlight attention: out {tuple(out.shape)}, launches "
          f"{n0} -> {n1}")
    got = [out.detach().float(), q.grad.float(), k.grad.float(),
           v.grad.float()]
    qf, kf, vf = (t.detach().float().requires_grad_() for t in (q, k, v))
    outs = []
    for lo in range(0, MOON_SEQ, 1024):
        sc = (qf[:, :, lo:lo + 1024] @ kf[:, :, :lo + 1024].transpose(-1, -2)
              ) / math.sqrt(dqk)
        mask = torch.ones(1024, lo + 1024, dtype=torch.bool,
                          device=dev).triu(lo + 1)
        outs.append(torch.softmax(sc.masked_fill(mask, float("-inf")), -1)
                    @ vf[:, :, :lo + 1024])
    ref = torch.cat(outs, dim=2)
    ref.backward(do.float())
    want = [ref.detach(), qf.grad, kf.grad, vf.grad]
    errs = {n: float((a - b).norm() / b.norm())
            for n, a, b in zip(("out", "dq", "dk", "dv"), got, want)}
    print(f"moonlight attention {shape + (dqk,)}/{dv} bf16, kernels vs "
          f"plain f32: {errs}", flush=True)
    check(all(e <= MOON_TOL for e in errs.values()),
          f"moonlight attention: {errs} past {MOON_TOL}")
    return errs


def moon_plain_experts(x, P, m, bias, rows):
    """DeepSeek-V3's expert layer of the held experts, plainly in f32, from
    the parameters ``P`` (a :class:`RoutedExperts`'s names): sigmoid scores
    of f32 logits, the top k of score plus ``bias``, gates scale * s / the
    chosen's sum, each held expert's SwiGLU on its tokens, the shared
    experts on every token; (output, balance loss, counts a layer)."""
    first, count = m["held"]
    k, e = m["top_k"], m["experts"]
    s = torch.sigmoid(x @ P["router.weight"].t())
    idx = torch.topk(s.detach() + bias, k, dim=-1).indices
    chosen = s.gather(1, idx)
    gates = m["scale"] * chosen / chosen.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for i in range(count):
        tok, j = (idx == first + i).nonzero(as_tuple=True)
        gu = x[tok] @ P["w_in"][i]
        g, u = gu.chunk(2, dim=-1)
        out = (torch.nn.functional.silu(g) * u) @ P["w_out"][i]
        y = y.index_add(0, tok, out * gates[tok, j][:, None])
    g, u = (x @ P["shared_gate_up.weight"].t()).chunk(2, dim=-1)
    y = y + (torch.nn.functional.silu(g) * u) @ P["shared_down.weight"].t()
    t = x.shape[0] // rows
    hits = torch.stack([torch.bincount(r.reshape(-1), minlength=e)
                        for r in idx.view(rows, t, k)]).float()
    p = (s / s.sum(-1, keepdim=True)).view(rows, t, e).mean(1)
    balance = m["balance"] * (hits * (e / (k * t)) * p).sum(-1).mean()
    return y, balance, torch.bincount(idx.reshape(-1), minlength=e)


def _sync_free(fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode("error")``: None, or
    the message of the first operation that waited on the host."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return None
    except RuntimeError as exc:
        return str(exc).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)


def moon_expert_check(dev, m, seed):
    """The held experts' layer at the cell's 16,384 tokens (the row
    kernels and grouped products on the card, bf16) against
    :func:`moon_plain_experts` in f32 on the same weights: output, balance
    loss, and the gradients of the input and every weight; its forward and
    backward again with no operation that waits on the host."""
    from ddstore_tpu_torch.models.moe import RoutedExperts
    from ddstore_tpu_torch.ops import held

    layer = RoutedExperts(m["dim"], _moon_routed(m), torch.bfloat16,
                          device=dev)
    g = torch.Generator(device=dev).manual_seed(seed + 18)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=dev) * 0.02)
    x = torch.randn(MOON_ROWS * MOON_SEQ, m["dim"], generator=g, device=dev)
    xb = x.bfloat16().requires_grad_()
    n0 = held.held_launches
    y, bal = layer(xb, rows=MOON_ROWS)
    dy = torch.randn_like(y)
    ((y * dy).sum() + bal * 1e3).backward()
    launches = held.held_launches - n0
    got = {"y": y.detach(), "balance": bal.detach(), "x": xb.grad.float()}
    got.update({n: p.grad for n, p in layer.named_parameters()})
    P = {n: p.detach().clone().requires_grad_()
         for n, p in layer.named_parameters()}
    xf = xb.detach().float().requires_grad_()
    yr, balr, counts = moon_plain_experts(xf, P, m, layer.score_bias,
                                          MOON_ROWS)
    ((yr * dy).sum() + balr * 1e3).backward()
    want = {"y": yr.detach(), "balance": balr.detach(), "x": xf.grad}
    want.update({n: P[n].grad for n in P})
    errs = {n: float((got[n].float() - want[n]).norm() / want[n].norm())
            for n in want}
    sizes = layer.stats["held"].tolist()

    def again():
        yy, bb = layer(xb, rows=MOON_ROWS)
        ((yy * dy).sum() + bb).backward()

    waited = _sync_free(again)
    print(f"moonlight experts ({MOON_ROWS * MOON_SEQ} tokens, "
          f"{len(sizes)} of {m['experts']} held, {sum(sizes)} assignments "
          f"{sizes}, {launches} row-kernel launches) bf16 vs plain f32: "
          f"{errs}; counts equal "
          f"{bool((counts == layer.stats['counts']).all())}; waits on the "
          f"host: {waited}", flush=True)
    check(all(e <= MOON_TOL for e in errs.values()) and launches == 8,
          f"moonlight experts: {errs} past {MOON_TOL}, or {launches} "
          f"launches of the row kernels (8 a forward and backward)")
    errs["rows"] = moon_row_kernels_check(dev, m, g)
    errs["empty_group"] = moon_empty_group_check(dev, g)
    errs["waited"] = waited
    return errs


def moon_row_kernels_check(dev, m, g):
    """Each row kernel of ``ops/held.py`` at the cell's shapes against its
    plain version on the CPU, over the n rows the assignments fill of a
    buffer of tokens x top_k rows (the rest are never written)."""
    from ddstore_tpu_torch.ops import held

    t, k, d = MOON_ROWS * MOON_SEQ, m["top_k"], m["dim"]
    h = m["expert_hidden"]
    rows = t * k
    mine = torch.rand(t, k, generator=g, device=dev) < 0.25
    n = int(mine.sum())
    pos = torch.full((t, k), -1, dtype=torch.int64, device=dev)
    pos[mine] = torch.randperm(n, generator=g, device=dev)
    offs = torch.tensor([n // 3, n // 3, n], dtype=torch.int32, device=dev)
    gates = torch.rand(t, k, generator=g, device=dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    x, ys, dy = rnd(t, d), rnd(rows, d), rnd(t, d).float()
    gu, da = rnd(rows, 2 * h), rnd(rows, h)
    cpu = [a.cpu() for a in (x, pos, gates, ys, dy, gu, da, offs)]
    xc, pc, gc, ysc, dyc, guc, dac, oc = cpu
    sel = pc[pc >= 0]
    pairs = {
        "scatter": (held.scatter_rows(x, pos, rows)[:n],
                    held.scatter_rows(xc, pc, rows)[:n]),
        "combine": (held.combine(ys, pos, gates, torch.float32),
                    held.combine(ysc, pc, gc, torch.float32)),
        "combine_ones_bf16": (held.combine(ys, pos, None, torch.bfloat16),
                              held.combine(ysc, pc, None, torch.bfloat16)),
        "swiglu": (held.swiglu_rows(gu, offs)[:n],
                   held.swiglu_rows(guc, oc)[:n]),
        "swiglu_bwd": (held.swiglu_bwd(gu, da, offs)[:n],
                       held.swiglu_bwd(guc, dac, oc)[:n]),
    }
    dys, dg = held.combine_bwd(dy, ys, pos, gates)
    dysc, dgc = held.combine_bwd(dyc, ysc, pc, gc)
    pairs["combine_bwd_rows"] = (dys[pos[pos >= 0]], dysc[sel])
    pairs["combine_bwd_gates"] = (dg, dgc)
    errs = {name: float((a.cpu().float() - b.float()).norm()
                        / b.float().norm())
            for name, (a, b) in pairs.items()}
    # each kernel's time (CUDA events, mean of 20 after 3) beside its
    # bound: the bytes it must move at 3.35 TB/s
    runs = {"scatter": (lambda: held.scatter_rows(x, pos, rows),
                        2 * t * d + 2 * n * d),
            "combine": (lambda: held.combine(ys, pos, gates, torch.float32),
                        2 * n * d + 4 * t * d),
            "combine_bwd": (lambda: held.combine_bwd(dy, ys, pos, gates),
                            4 * t * d + 4 * n * d),
            "swiglu": (lambda: held.swiglu_rows(gu, offs), 6 * n * h),
            "swiglu_bwd": (lambda: held.swiglu_bwd(gu, da, offs),
                           10 * n * h)}
    times = {}
    for name, (fn, nbytes) in runs.items():
        for _ in range(3):
            fn()
        e0, e1 = torch.cuda.Event(True), torch.cuda.Event(True)
        e0.record()
        for _ in range(20):
            fn()
        e1.record()
        e1.synchronize()
        times[name] = {"ms": e0.elapsed_time(e1) / 20,
                       "bound_ms": nbytes / 3.35e9}
    print(f"moonlight row kernels ({t} tokens x {k}, {n} held rows of "
          f"{rows}) vs their plain versions: {errs}; ms and bound ms "
          f"{times}", flush=True)
    check(all(e <= 1e-3 for e in errs.values()),
          f"moonlight row kernels: {errs} past 1e-3")
    return {"errs": errs, "times": times}


def moon_empty_group_check(dev, g):
    """The grouped products with a held expert that got no token and rows
    past the last group holding NaN, against one product a group: the
    groups' rows and the weights' gradients (the empty expert's exactly
    0); the NaN rows reach neither."""
    from ddstore_tpu_torch.models import moe

    sizes = [96, 0, 160, 32]
    n = sum(sizes)
    offs = torch.tensor(sizes, device=dev).cumsum(0).to(torch.int32)
    tail = torch.full((64, 256), float("nan"), device=dev).bfloat16()
    a = torch.randn(n, 256, generator=g, device=dev).bfloat16()
    w = torch.randn(len(sizes), 256, 128, generator=g,
                    device=dev).bfloat16()
    dy = torch.randn(n, 128, generator=g, device=dev).bfloat16()
    y = moe._grouped(torch.cat([a, tail]), w, offs)[:n]
    dw = moe._grouped_wgrad(torch.cat([a, tail]),
                            torch.cat([dy, tail[:, :128]]), offs)
    y_want = torch.cat([p.float() @ w[i].float()
                        for i, p in enumerate(a.split(sizes))])
    dw_want = torch.stack([p.float().t() @ q.float() for p, q in
                           zip(a.split(sizes), dy.split(sizes))])
    err = max(float((y.float() - y_want).norm() / y_want.norm()),
              float((dw.float() - dw_want).norm() / dw_want.norm()))
    print(f"moonlight grouped products, sizes {sizes} and 64 NaN rows "
          f"past them: error {err:.3g}, empty expert's gradient "
          f"{float(dw[1].abs().max())}", flush=True)
    check(err <= MOON_TOL and float(dw[1].abs().max()) == 0.0,
          f"moonlight grouped products with an empty expert: {err}")
    return err


def moon_cut_model_check(dev, seed):
    """The model at a cut depth through ``create_train_state`` and
    ``make_train_step``, 3 Adam steps of (1, MOON_CUT_SEQ) on the card in
    bf16 against the same model's plain paths on the CPU in f32, on the
    same weights: losses within 1e-3, step 1's counts within 5 %. The
    card's steps again under the sync debug mode, which names each
    operation of the step that waits on the host."""
    m = dict(MOON)
    spec = _moon_spec(m)

    def build(device, dtype):
        return ttr.TransformerLM(
            vocab=m["vocab"], dim=m["dim"], heads=m["heads"],
            layers=MOON_CUT_LAYERS, compute_dtype=dtype, device=device,
            deepseek=spec)

    plain = build("cpu", torch.float32)
    g = torch.Generator().manual_seed(seed + 1818)
    with torch.no_grad():
        for n, p in plain.named_parameters():
            if n.endswith(("ln1.weight", "ln2.weight", "kv_norm.weight",
                           "lnf.weight")):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
    batches = [tuple(torch.randint(0, m["vocab"], (1, MOON_CUT_SEQ),
                                   generator=g) for _ in range(2))
               for _ in range(3)]
    pos = torch.arange(MOON_CUT_SEQ)[None]
    res = {}
    for side, device, dtype in (("card", dev, torch.bfloat16),
                                ("plain", "cpu", torch.float32)):
        model = build(device, dtype)
        model.load_state_dict(plain.state_dict())
        state, opt = ttr.create_train_state(model, lr=TRAIN_LR)
        step = ttr.make_train_step(model, opt, state=state)
        losses, counts = [], None
        for i, (tok, tgt) in enumerate(batches):
            losses.append(step(tok.to(device), tgt.to(device),
                               pos.to(device)))
            if i == 0:
                counts = [blk.moe.stats["counts"].tolist()
                          for blk in model.blocks if blk.routed is not None]
        waits = []
        if side == "card":
            tok, tgt = (t.to(dev) for t in batches[0])
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    step(tok, tgt, pos.to(dev))
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            waits = sorted({str(w.message).splitlines()[0]
                            for w in caught if "synchroniz" in
                            str(w.message)})
        res[side] = ([float(x) for x in losses], counts, waits)
        del model, opt, state, step
    torch.cuda.empty_cache()
    (losses, counts, waits), (ref_losses, ref_counts, _) = \
        res["card"], res["plain"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    rgap = sum(abs(a - b) for x, y in zip(counts, ref_counts)
               for a, b in zip(x, y)) / sum(map(sum, ref_counts))
    print(f"moonlight cut to {MOON_CUT_LAYERS} layers, 3 steps of (1, "
          f"{MOON_CUT_SEQ}): losses {losses} vs plain f32 {ref_losses}, "
          f"loss gap {gap:.3g}, routing gap {rgap:.3g}; a step's waits on "
          f"the host: {len(waits)} {waits}", flush=True)
    check(gap <= 1e-3 and rgap <= 0.05,
          f"moonlight cut model: loss gap {gap}, routing gap {rgap}")
    return gap, rgap, waits


def phase_moonlight(dev, seed, card):
    """Phase 18."""
    m = dict(MOON)
    att = moon_attention_check(dev, m)
    torch.cuda.empty_cache()
    exp = moon_expert_check(dev, m, seed)
    torch.cuda.empty_cache()
    cut = moon_cut_model_check(dev, seed)
    check(exp["waited"] is None,
          f"moonlight experts waited on the host: {exp['waited']}")
    print(f"phase 18 on {card}", flush=True)
    return {"attention": att, "experts": exp, "cut_model": cut}


def kernel_design(name, dname, d):
    """The design of kernel ``name`` at dtype ``dname`` and head dim ``d``:
    TMA + wgmma for all three in 16 bits at every head dim (in chunks of
    256 past 256); in f32 TMA + wgmma in three TF32 products for all three,
    dq's dP on the FP64 tensor cores, the forward's operands split once a
    call by
    a pass of their own."""
    if dname == "float32":
        design = {"flash_fwd": "wgmma+tma, 3xtf32, split pass",
                  "flash_bwd_dq": "wgmma+tma, 3xtf32, dP on fp64 mma.sync",
                  "flash_bwd_dkv": "wgmma+tma, 3xtf32"}[name]
    else:
        design = "wgmma+tma"
    return design + (", chunks of 256" if wide_class(d) == "chunks" else "")


def fp16_wide_rows(fw, hd):
    """The kernels' JSON rows of phase 16's variants: each kernel at each
    timed (dtype, head dim), its launches those of the LM that runs the
    variant (fp16 and f32 at hd 64, bf16 at hd 512), else those of phase
    16's cases of its dtype and tile (or chunks), or of phase 15's (f32 up
    to 256)."""
    lm_of = {("float16", "64"): "fp16", ("bfloat16", "chunks"): "hd512",
             ("float32", "64"): "f32"}
    rows = []
    for (dname, d), t in fw["timing"].items():
        cls = wide_class(d)
        lm = lm_of.get((dname, cls))
        phase, cases = (16, fw["launched"]) if (dname, cls) in \
            fw["launched"] else (15, hd["launched"])
        for name, line, fn, src in (
                ("flash_fwd", 92, "_flash_kernel", "flash_fwd.cu"),
                ("flash_bwd_dq", 213, "_bwd_dq_kernel", "flash_bwd.cu"),
                ("flash_bwd_dkv", 263, "_bwd_dkv_kernel", "flash_bwd.cu")):
            r = t[name]
            rows.append({
                "name": f"{name}[{dname} d{d}]",
                "route": "cuda",
                "design": kernel_design(name, dname, d),
                "source": f"ddstore_tpu_torch/ops/csrc/{src}",
                "replaces": f"ddstore_tpu/ops/attention.py:{line}",
                "replaces_function": fn,
                "launches": (fw["lm"][lm]["launches"][name] if lm else
                             cases[(dname, cls)][name]),
                "launches_from": (
                    f"phase 16 LM {lm}" if lm else
                    f"phase {phase} cases, {dname} "
                    + ("chunks of 256" if cls == "chunks" else f"tile {cls}")),
                "max_abs_err": r["max_abs_err"],
                "max_row_rel_err": r["max_row_rel_err"],
                "shape": r["shape"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"],
                **{x: r[x] for x in ("cuda_core_bound_ms", "split_ms")
                   if x in r},
                # the backward of one SDPA call gives dq, dk and dv:
                # sdpa_backward_ms
                "library_ms": r["library_ms"],
                "sdpa_backward_ms": t["sdpa_backward_ms"],
                **({"sdpa_route": t["sdpa_route"]}
                   if "sdpa_route" in t else {})})
    return rows



def kernel_table(kern, bwd, sl, tr, va, gn, co, el, lc, mo, lay, tpk, ppr,
                 msp, fsk, hd, fw):
    """The kernels' JSON line: launches are the training path's (the
    path that runs all three), with each path's counts beside them; the
    long-context ring's launches (both ranks, remat off; and per rank),
    each kernel at the ring's chunk shapes, and at tensor parallelism's
    heads (phase 12); the pipeline's (phase 13: both ranks, every
    schedule and the MoE run; and per schedule and rank); the split
    sequence's (phase 14: the MoE over sp 2 and the dense LM over fsdp 2 x
    sp 2, in total and per rank), and each kernel at fsdp 2 x sp 2's ring
    chunks; the head dims' (phase 15: the LM at each head dim and the
    long-context example, each kernel's largest error over the head-dim
    cases, the timed shapes and the example's chunks, each kernel at H D
    = 1024 with head dims 32, 128, 256, and at 10 heads of 96, and at the
    example's ring chunks); phase 16's LMs (fp16, hd 512) by path, its
    worst errors per dtype, and a row of each of its timed variants
    (``fp16_wide_rows``)."""
    def pp_total(k):
        runs = [r["launches_by_rank"] for r in ppr["runs"].values()]
        return sum(x[k] for per in runs + [ppr["moe_launches_by_rank"]]
                   for x in per)

    by_path = {k: {"serving": sl["launches"][k], "training": v,
                   "vae_ddp": va["launches"][k],
                   "gnn_ddp": gn["launches"][k],
                   "vae_collective": va["collective_launches"][k],
                   "collective_nccl": co["launches"][k],
                   "elastic": el["launches"][k],
                   "long_context": lc["launches"][k],
                   "moe": mo["launches"][k],
                   **{f"layout_{n}": lay[n]["launches"][k]
                      for n, _, _ in LAYOUTS},
                   "pp": pp_total(k),
                   "moe_fsdp_sp": msp["launches"][k],
                   **{f"head_dims_lm_hd{d}": r["launches"][k]
                      for d, r in hd["lm"].items()},
                   "lm_longcontext_example": hd["example"]["launches"][k],
                   **{f"lm_{n}": r["launches"][k]
                      for n, r in fw["lm"].items()}}
               for k, v in tr["launches"].items()}
    ms = kern["ms"]
    rows = [{
        "name": "flash_fwd",
        "route": "cuda",
        "design": "wgmma+tma",
        "source": "ddstore_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ddstore_tpu/ops/attention.py:92",
        "replaces_function": "_flash_kernel",
        "launches": tr["launches"]["flash_fwd"],
        "launches_by_path": by_path["flash_fwd"],
        "max_abs_err": max(kern["errs"].values()),
        "lm_shape_max_abs_err": kern["errs"]["lm_causal"],
        "max_row_rel_err": max(kern["rel_errs"].values()),
        "ms": ms["kernel"],
        "plain_ms": ms["plain"],
        "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
        "library_ms": ms["library"],
    }]
    for name, line, fn, design in (
            ("flash_bwd_dq", 213, "_bwd_dq_kernel", "wgmma+tma"),
            ("flash_bwd_dkv", 263, "_bwd_dkv_kernel", "wgmma+tma")):
        rows.append({
            "name": name,
            "route": "cuda",
            "design": design,
            "source": "ddstore_tpu_torch/ops/csrc/flash_bwd.cu",
            "replaces": f"ddstore_tpu/ops/attention.py:{line}",
            "replaces_function": fn,
            "launches": tr["launches"][name],
            "launches_by_path": by_path[name],
            "max_abs_err": max(bwd["errs"][name].values()),
            "lm_shape_max_abs_err": bwd["errs"][name]["lm_causal"],
            "max_row_rel_err": max(bwd["rel_errs"][name].values()),
            **bwd[name],
            # no single PyTorch call computes dq (or dk, dv) alone; the
            # backward of one SDPA call gives all three: sdpa_backward_ms
            "library_ms": None,
        })
    for row in rows:
        row["ring_launches_by_rank"] = [r[row["name"]]
                                        for r in lc["launches_by_rank"]]
        row["ring_chunks"] = {c: lc["chunks"][c][row["name"]]
                              for c in ("diagonal", "past")}
        row["tp_heads"] = tpk["tp_heads"][row["name"]]
        row["fsdp_sp_chunks"] = {c: fsk[c][row["name"]]
                                 for c in ("diagonal", "past")}
        row["pp_launches_by_rank"] = {
            **{n: [x[row["name"]] for x in r["launches_by_rank"]]
               for n, r in ppr["runs"].items()},
            "moe_1f1b": [x[row["name"]]
                         for x in ppr["moe_launches_by_rank"]]}
        row["sp_launches_by_rank"] = {
            n: [x[row["name"]] for x in msp[f"{n}_launches_by_rank"]]
            for n in ("moe_sp", "fsdp_sp")}
        e_abs, e_rel = hd["errs"][row["name"]]
        row["head_dims"] = {
            "dims": list(HD_DIMS), "max_abs_err": e_abs,
            "max_row_rel_err": e_rel,
            "timing": {str(d): t[row["name"]]
                       for d, t in hd["timing"].items()},
            "example_chunks": {c: hd["example_chunks"][c][row["name"]]
                               for c in ("diagonal", "past")},
            "example_launches_by_rank": [
                x[row["name"]] for x in hd["example"]["launches_by_rank"]]}
        row["fp16_wide"] = {
            "cases": fw["n_cases"],
            "worst_by_dtype": {dn: e[row["name"]]
                               for dn, e in fw["errs"].items()}}
    rows += fp16_wide_rows(fw, hd)
    return {"kernels": rows, "sdpa_backward_ms": bwd["ms"]["sdpa_backward"],
            "flash_bwd_dq_plus_dkv_ms": bwd["ms"]["dq"] + bwd["ms"]["dkv"],
            "head_dims_sdpa_backward_ms": {
                str(d): t["sdpa_backward_ms"]
                for d, t in hd["timing"].items()}}


# One tree's side of the kernel A/B, run as ``python -c AB_RUN root seed
# timed heads steps`` from that tree's root: its kernels built, then its
# own head_dim_timing at each (dtype, head dim) and head_dim_lm at each
# number of heads.
AB_RUN = """\
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from ddstore_tpu_torch.ops import _build
dev = torch.device("cuda", 0)
torch.cuda.set_device(dev)
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
g = torch.Generator(device=dev).manual_seed(int(sys.argv[2]))
out = {}
for dname, d in json.loads(sys.argv[3]):
    r = cs.head_dim_timing(g, dev, d, getattr(torch, dname),
                           iters=json.loads(sys.argv[6])[dname])
    out[f"{dname} {d}"] = {
        **{k: {x: v[x] for x in ("ms", "plain_ms", "bound_ms",
                                 "library_ms", "split_ms") if x in v}
           for k, v in r.items() if isinstance(v, dict)},
        "sdpa_backward_ms": r["sdpa_backward_ms"]}
store, ds = cs.make_store(int(sys.argv[2]))
cs.HD_STEPS = int(sys.argv[5])
out["lm"] = {}
for dname, heads in json.loads(sys.argv[4]):
    r = cs.head_dim_lm(dev, int(sys.argv[2]), ds, heads, cs.card_line(),
                       getattr(torch, dname))
    out["lm"][f"{dname} {cs.DIM // heads}"] = {
        x: r[x] for x in ("median_ms", "step_ms", "peak_gib")}
store.close()
print("ab result " + json.dumps(out), flush=True)
"""


def kernel_ab(parent, seed):
    """The kernels of the tree at ``parent`` against this checkout's, in
    turns (parent, change, change, parent), each side in a process of its
    own; prints each kernel's times from both and returns them."""
    here = os.path.dirname(os.path.abspath(__file__))
    runs = []
    for tag, root in (("parent", parent), ("change", here),
                      ("change", here), ("parent", parent)):
        root = os.path.abspath(root)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", AB_RUN, root, str(seed),
             json.dumps(AB_TIMED), json.dumps(AB_LMS),
             str(AB_LM_STEPS), json.dumps(AB_ITERS)], cwd=root,
            capture_output=True, text=True, timeout=AB_DEADLINE_S)
        got = [ln for ln in res.stdout.splitlines()
               if ln.startswith("ab result ")]
        check(res.returncode == 0 and got,
              f"kernel A/B: the {tag} run at {root} failed (exit "
              f"{res.returncode}): {res.stderr[-4000:]}")
        runs.append((tag, json.loads(got[-1][len("ab result "):])))
        print(f"kernel A/B: {tag} ({root}) in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    table = {}
    for key in runs[0][1]["lm"]:
        dname, hd = key.split()
        row = {tag: [x["lm"][key]["median_ms"] for t, x in runs
                     if t == tag] for tag in ("parent", "change")}
        row["peak_gib"] = [x["lm"][key]["peak_gib"] for _, x in runs]
        table[f"lm {key}"] = row
        print(f"kernel A/B LM at hd {hd} ({DIM // int(hd)} heads, {dname}, "
              f"{BATCH} x {SEQ}): median train step ms (of "
              f"{AB_LM_STEPS - 1}) parent {row['parent']} change "
              f"{row['change']}; peak GiB {row['peak_gib']}; steps "
              + "; ".join(
                  f"{t} {[round(v, 3) for v in x['lm'][key]['step_ms']]}"
                  for t, x in runs), flush=True)
    for shape in (s for s in runs[1][1] if s != "lm"):
        for kern, r in runs[1][1][shape].items():
            if not isinstance(r, dict):
                continue
            row = {tag: [x[shape][kern]["ms"] for t, x in runs if t == tag]
                   for tag in ("parent", "change")}
            row.update(bound_ms=r["bound_ms"], library_ms=r["library_ms"],
                       plain_ms=r["plain_ms"])
            if "split_ms" in r:  # the change's split pass alone
                row["split_ms"] = [x[shape][kern]["split_ms"]
                                   for t, x in runs if t == "change"]
            table[f"{kern} {shape}"] = row
            print(f"kernel A/B {kern} at {shape} (8, 2048, H = {DIM} // d) "
                  f"causal: parent ms {row['parent']} change ms "
                  f"{row['change']} bound_ms={r['bound_ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']}"
                  + (f" split_ms {row['split_ms']}" if "split_ms" in row
                     else ""), flush=True)
        print(f"kernel A/B sdpa backward at {shape}: " + ", ".join(
            f"{t} {x[shape]['sdpa_backward_ms']:.4f}" for t, x in runs),
              flush=True)
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="PARENT", default=None,
                    help="time the kernels of the tree at PARENT against "
                         "this checkout's and run nothing else")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda} | "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
    if args.ab is not None:
        print(json.dumps({"kernel_ab": kernel_ab(args.ab, args.seed)}),
              flush=True)
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 2. build: the kernels, and the store's native core beside them
    def timed_native_build():
        t0 = time.perf_counter()
        return native_build.build(), time.perf_counter() - t0

    with ThreadPoolExecutor(1) as ex:
        native = ex.submit(timed_native_build)
        build_s = _build.build_all()
        native_path, native_s = native.result()
    print(f"build native store core: {native_s:.2f} s "
          f"({len(native_build.SOURCES)} translation units) -> "
          f"{native_path}", flush=True)
    for name in _build.SOURCES:
        _build.load(name)
        # per kernel: its entry, registers, spills, and any advisory of
        # ptxas about wgmma (C75xx: a product it serialised, or a wait it
        # injected before registers a product defines)
        regs = [ln.strip() for ln in _build.build_logs.get(name, "")
                .splitlines() if any(w in ln for w in (
                    "entry function", "registers", "spill", "wgmma",
                    "C75"))]
        print(f"build {name}: {regs}", flush=True)
        spills = [ln for ln in regs if "spill" in ln and
                  "0 bytes spill stores, 0 bytes spill loads" not in ln]
        check(not spills, f"build {name}: register spills {spills}")
        advisories = [ln for ln in regs if "C75" in ln]
        check(not advisories, f"build {name}: ptxas wgmma advisories "
              f"{advisories}")
    print(f"build: {len(_build.SOURCES)} kernel(s) in {build_s:.2f} s",
          flush=True)

    # 3. kernels against their plain versions
    kern = phase_kernels(dev)
    bwd = phase_bwd_kernels(dev)

    # 4.-9. the small reference check, then the slices on the store
    small_reference_check(dev, args.seed)
    store, ds = make_store(args.seed)
    sl = phase_slice(dev, args.seed, ds)
    tr = phase_train(dev, args.seed, ds)
    store.close()
    va = phase_vae(dev, args.seed, card)
    gn = phase_gnn(dev, args.seed, card)
    co = phase_collective(dev, args.seed, card, va, gn)
    annotate_cost(card)
    guard_cost(card)
    el = phase_elastic(args.seed, card)
    lc = phase_long(dev, args.seed, card)

    # 12. MoE, expert and tensor parallelism, FSDP/ZeRO-3
    t12 = time.perf_counter()
    store, ds = make_store(args.seed)
    mo = phase_moe(dev, args.seed, ds, card)
    store.close()
    lay = phase_layouts(args.seed, card, mo["peak_gib"])
    tpk = long_chunk_kernels(dev, b=LAYOUT_BATCH, h=HEADS // 2, c=SEQ,
                             chunks=(("tp_heads", 0, True),),
                             label="tp 2's heads")
    print(f"phase 12 wall {time.perf_counter() - t12:.1f} s", flush=True)

    # 13. pipeline parallelism
    t13 = time.perf_counter()
    ppr = phase_pp(args.seed, card)
    print(f"phase 13 wall {time.perf_counter() - t13:.1f} s", flush=True)

    # 14. MoE and fsdp over a split sequence
    t14 = time.perf_counter()
    msp = phase_moe_sp(args.seed, card)
    # fsdp 2 x sp 2's ring chunks: one row of a rank's, S / sp positions
    fsk = long_chunk_kernels(dev, b=LAYOUT_BATCH // 2, h=HEADS,
                             c=FSP_SEQ // MSP_SP, label="fsdp sp's")
    print(f"phase 14 wall {time.perf_counter() - t14:.1f} s", flush=True)

    # 15. head dims
    t15 = time.perf_counter()
    hd = phase_head_dims(dev, args.seed, card)
    print(f"phase 15 wall {time.perf_counter() - t15:.1f} s", flush=True)

    # 16. fp16 and head dims past 256
    t16 = time.perf_counter()
    fw = phase_fp16_wide(dev, args.seed, card)
    print(f"phase 16 wall {time.perf_counter() - t16:.1f} s", flush=True)

    # 17. launch grids past 65,535 blocks on grid y's or z's axis
    t17 = time.perf_counter()
    phase_launch_grid(dev, card)
    print(f"phase 17 wall {time.perf_counter() - t17:.1f} s", flush=True)

    # 18. DeepSeek-V3's block: latent attention and held experts
    t18 = time.perf_counter()
    phase_moonlight(dev, args.seed, card)
    print(f"phase 18 wall {time.perf_counter() - t18:.1f} s", flush=True)

    print(json.dumps(kernel_table(kern, bwd, sl, tr, va, gn, co, el, lc, mo,
                                  lay, tpk, ppr, msp, fsk, hd, fw)),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
