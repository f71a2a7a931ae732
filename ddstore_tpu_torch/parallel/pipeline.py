"""Pipeline parallelism over the ``pp`` axis of a mesh: the GPipe, 1F1B
and interleaved schedules (the port of ``ddstore_tpu/parallel/pipeline.py``).

The reference runs each schedule as one SPMD ``lax.scan`` whose ticks
``ppermute`` the activation round the ``pp`` ring, and gets GPipe's
backward from autodiff of the scan. Here every rank runs its own stage and
walks the same tick decode:

* the forward of tick ``t`` on stage ``d``: ``rel = t - d``, group ``g =
  rel // (V·S)``, local chunk ``v = (rel mod V·S) // S``, microbatch ``i =
  g·S + rel mod S`` (``pipeline.py:241-246``); with ``V = 1`` that is
  microbatch ``t - d``;
* the 1F1B backward of tick ``t``: ``r = t + d - 2(C-1)``, ``j = r mod
  S``, ``u = (r - j) / S``, ``g = ceil(u / V)``, ``w = g·V - u``,
  microbatch ``g·S + j`` of local chunk ``w`` (``:453-461``).

A tick's hand-offs go to the neighbours in the pp group (``StageRing``)
in one ``batch_isend_irecv``; CUDA tensors cross through pinned host
buffers over gloo (gloo's send and receive take host memory), as the ring
attention's shifts do. The reference computes garbage on idle fill and
drain ticks and masks it; here an idle tick computes nothing and sends
nothing, and a rank posts a receive exactly when its neighbour's decode of
the same tick sends, so every send has its receive. The pp group carries a
timeout (``stage_ring``): a hand-off whose peer never comes raises.

Autograd does not cross processes, so the backward is a schedule too.
Each stage input is a leaf; its output and the input are stashed, and the
backward of that microbatch calls ``torch.autograd.backward`` on the
stashed graph (or on a re-run of the stage under ``remat``) with the
cotangent that came from downstream, and sends the input's gradient
upstream. GPipe runs the forward ticks, then the backward ticks in reverse
(the transposed scan). 1F1B runs one forward and one backward half a tick:
it keeps the autograd graph of its in-flight microbatches instead of the
reference's input stash re-run under ``jax.vjp``, and an entry lives from
its forward tick to its backward tick, so at most ``2C - 1`` graphs are
live whatever M is (``pipeline_stats["stash_high_water"]``).

**Arrays.** As in the reference, ``x``, ``aux``, the outputs, ``dx`` and
the loss parameters are global arrays, whole on every rank: with
``dp_axis`` a rank computes its dp shard of every microbatch (rows ``[j·mb
/ dp, (j + 1)·mb / dp)``) and the results are gathered over dp. The stage
parameters are stacked along a leading dim: the whole stack (``V·S``
rows, every rank taking its ``V`` rows ``[d·V, (d + 1)·V)``, gradients
returned for the whole stack) or this rank's shard alone (``V`` rows,
gradients for them). A stack is a pytree (dicts, lists, tuples) of
tensors. Every call is a collective of the mesh's ranks.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from .collectives import all_reduce
from .mesh import axes_group, axis_index, axis_size, stage_ring

__all__ = ["pipeline_apply", "pipeline_1f1b", "pipeline_interleaved",
           "pipeline_interleaved_1f1b", "stack_stage_params",
           "interleave_stage_params", "interleave_order", "pipeline_stats"]

_FWD_TAG, _BWD_TAG = 0x5400, 0x5500  # activation and cotangent hand-offs

#: hand-offs sent by this process and their bytes, and the most stage
#: graphs (or stashed inputs) the last schedule held at once; plain
#: counts that callers reset to measure a run
pipeline_stats = {"hops": 0, "bytes": 0, "stash_high_water": 0}


def stack_stage_params(per_stage_params):
    """Stack a list of identically-structured stage pytrees along a new
    leading dim."""
    flats = [pytree.tree_flatten(p) for p in per_stage_params]
    spec = flats[0][1]
    leaves = [torch.stack(ls) for ls in zip(*(f[0] for f in flats))]
    return pytree.tree_unflatten(leaves, spec)


def interleave_order(n_stages: int, n_virtual: int) -> List[int]:
    """The device-major chunk order of the interleaved schedules:
    ``order[p]`` is the model-order chunk held at stack position ``p``,
    position ``d·V + v`` holding chunk ``v·S + d``. The model-side
    splitters (``lm_to_stages``, ``lm_from_stages``) use this same list.
    Identity at V=1."""
    return [v * n_stages + d for d in range(n_stages)
            for v in range(n_virtual)]


def interleave_stage_params(per_chunk_params, n_stages: int):
    """Stack V·S per-chunk pytrees (model order) device-major (see
    :func:`interleave_order`), so stage ``d`` holds rows ``[d·V, (d +
    1)·V)``: chunks ``d, d + S, ...``."""
    c = len(per_chunk_params)
    if c % n_stages:
        raise ValueError(f"{c} chunks do not divide over {n_stages} stages")
    order = interleave_order(n_stages, c // n_stages)
    return stack_stage_params([per_chunk_params[k] for k in order])


# ---------------------------------------------------------------------------
# The schedule engine: one rank's part of a schedule.
# ---------------------------------------------------------------------------


def _fwd_decode(t: int, d: int, s: int, v: int, m: int):
    """(local chunk, microbatch) stage ``d`` runs forward at tick ``t``,
    or None when idle."""
    rel = t - d
    if rel < 0 or rel >= m * v:
        return None
    c = v * s
    return (rel % c) // s, (rel // c) * s + rel % s


def _bwd_decode(t: int, d: int, s: int, v: int, m: int):
    """(local chunk, microbatch) stage ``d`` runs backward at tick ``t``
    of the fused schedules, or None when idle."""
    c = v * s
    r = t + d - 2 * (c - 1)
    j = r % s
    u = (r - j) // s
    g = -((-u) // v)  # ceil(u / V): forces w into [0, V)
    w, i = g * v - u, g * s + j
    if g < 0 or i >= m:
        return None
    return w, i


class _Stage:
    """This rank's position in a schedule over ``m`` microbatches and its
    hand-offs."""

    def __init__(self, mesh, axis: str, n_virtual: int, m: int):
        ring = stage_ring(mesh, axis) if mesh is not None else None
        self.s = 1 if ring is None else ring.size
        self.d = 0 if ring is None else ring.index
        self.ring = ring
        self.v, self.m, self.c = n_virtual, m, n_virtual * self.s

    def fwd(self, t: int, d: Optional[int] = None):
        return _fwd_decode(t, self.d if d is None else d % self.s, self.s,
                           self.v, self.m)

    def bwd(self, t: int, d: Optional[int] = None):
        return _bwd_decode(t, self.d if d is None else d % self.s, self.s,
                           self.v, self.m)

    def final(self, vv: int, d: Optional[int] = None) -> bool:
        """Whether local chunk ``vv`` of stage ``d`` is the model's last."""
        d = self.d if d is None else d % self.s
        return d == self.s - 1 and vv == self.v - 1

    def first(self, vv: int, d: Optional[int] = None) -> bool:
        """Whether local chunk ``vv`` of stage ``d`` is the model's first
        (it takes the microbatch itself)."""
        d = self.d if d is None else d % self.s
        return d == 0 and vv == 0

    def exchange(self, sends, recvs):
        """One tick's hand-offs: ``sends`` [(tensor, +1 or -1, tag)] to the
        next or previous stage, ``recvs`` [(like, +1 or -1, tag)] from
        them (``like`` gives shape, dtype and device). Returns the
        received tensors in ``recvs``' order."""
        if not sends and not recvs:
            return []
        if self.s == 1:  # one stage: the ring is a loop onto itself
            by_tag = {tag: t for t, _, tag in sends}
            return [by_tag[tag] for _, _, tag in recvs]
        ring = self.ring
        staged = any(t.is_cuda for t, _, _ in sends) or any(
            like.is_cuda for like, _, _ in recvs)
        staged = staged and \
            str(dist.get_backend(ring.group)).lower() == "gloo"
        ops, outs = [], []
        for t, way, tag in sends:
            t = t.detach().contiguous()
            if staged:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t)
                t = h
            ops.append(dist.P2POp(dist.isend, t,
                                  ring.next if way > 0 else ring.prev,
                                  ring.group, tag))
            pipeline_stats["hops"] += 1
            pipeline_stats["bytes"] += t.numel() * t.element_size()
        for like, way, tag in recvs:
            buf = torch.empty(like.shape, dtype=like.dtype,
                              pin_memory=True) if staged \
                else torch.empty_like(like)
            outs.append(buf)
            ops.append(dist.P2POp(dist.irecv, buf,
                                  ring.prev if way > 0 else ring.next,
                                  ring.group, tag))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged:
            outs = [o.to(like.device) for o, (like, _, _) in zip(outs, recvs)]
        return outs


def _run(fn, params, a, with_aux: bool):
    """(y, side) of one chunk; side None without aux."""
    out = fn(params, a)
    return out if with_aux else (out, None)


def _backward(y, side, dy, side_cot):
    ts, gs = [y], [dy]
    if side is not None and side_cot is not None and \
            getattr(side, "requires_grad", False):
        ts.append(side)
        gs.append(torch.full_like(side, float(side_cot)))
    torch.autograd.backward(ts, gs)


class GPipe:
    """The GPipe/interleaved schedule on this rank: :meth:`forward` runs
    the forward ticks and keeps each tick's stage graph (under ``remat``
    its input alone), :meth:`backward` the backward ticks in reverse.

    ``chunks[v]`` are local chunk ``v``'s parameters for ``fn(params, a)``
    (``-> a``, or ``(a, side)`` with ``with_aux``); ``inject(i)`` is
    microbatch ``i``'s input on the first stage; ``like`` a tensor of the
    activation's shape, dtype and device."""

    def __init__(self, st: _Stage, fn: Callable, chunks, inject: Callable,
                 like: torch.Tensor, *, with_aux: bool = False,
                 remat: bool = False):
        self.st, self.fn, self.chunks, self.inject = st, fn, chunks, inject
        self.like, self.with_aux, self.remat = like, with_aux, remat
        self.ticks = st.m * st.v + st.s - 1
        self.stash: Dict[int, tuple] = {}

    def forward(self, on_final: Optional[Callable] = None) -> torch.Tensor:
        """The forward ticks. ``on_final(i, y)`` sees each microbatch's
        output on the last stage. Returns the sum of this rank's chunks'
        side losses over the microbatches (f32; 0 without aux)."""
        st, d = self.st, self.st.d
        side_sum = torch.zeros((), dtype=torch.float32,
                               device=self.like.device)
        buf = None
        for t in range(self.ticks):
            f = st.fwd(t)
            y = None
            if f is not None:
                vv, i = f
                a = self.inject(i) if st.first(vv) else buf
                if self.remat:
                    with torch.no_grad():
                        y, side = _run(self.fn, self.chunks[vv], a,
                                       self.with_aux)
                    self.stash[t] = (a.detach(), None, None)
                else:
                    a = a.detach().requires_grad_()
                    with torch.enable_grad():
                        y, side = _run(self.fn, self.chunks[vv], a,
                                       self.with_aux)
                    self.stash[t] = (a, y, side)
                if side is not None:
                    side_sum = side_sum + side.detach().float()
                if st.final(vv) and on_final is not None:
                    on_final(i, y)
            pipeline_stats["stash_high_water"] = max(
                pipeline_stats["stash_high_water"], len(self.stash))
            sends = [(y, 1, _FWD_TAG)] if f is not None and \
                not st.final(f[0]) else []
            pf = st.fwd(t, d - 1)
            recvs = [(self.like, 1, _FWD_TAG)] if pf is not None and \
                not st.final(pf[0], d - 1) else []
            got = st.exchange(sends, recvs)
            buf = got[0] if got else None
        return side_sum

    def backward(self, cot_of: Callable, side_cot: float = 0.0
                 ) -> Dict[int, torch.Tensor]:
        """The backward ticks, in reverse: ``cot_of(i)`` is microbatch
        ``i``'s output cotangent on the last stage, ``side_cot`` each
        chunk's side loss's. Gradients accumulate into the parameters'
        ``.grad``; returns on the first stage ``dx[i]``, the gradient of
        microbatch ``i``'s input."""
        st, d = self.st, self.st.d
        dx: Dict[int, torch.Tensor] = {}
        bbuf = None
        for t in reversed(range(self.ticks)):
            f = st.fwd(t)
            da = None
            if f is not None:
                vv, i = f
                cot = cot_of(i) if st.final(vv) else bbuf
                a, y, side = self.stash.pop(t)
                if self.remat:
                    a = a.requires_grad_()
                    with torch.enable_grad():
                        y, side = _run(self.fn, self.chunks[vv], a,
                                       self.with_aux)
                _backward(y, side, cot.to(y.dtype), side_cot)
                da = a.grad
                if st.first(vv):
                    dx[i] = da
            sends = [(da, -1, _BWD_TAG)] if f is not None and \
                not st.first(f[0]) else []
            nf = st.fwd(t, d + 1)
            recvs = [(self.like, -1, _BWD_TAG)] if nf is not None and \
                not st.first(nf[0], d + 1) else []
            got = st.exchange(sends, recvs)
            bbuf = got[0] if got else None
        return dx


def run_1f1b(st: _Stage, fn: Callable, chunks, inject: Callable,
             like: torch.Tensor, head: Callable, *, with_aux: bool = False,
             side_cot: float = 0.0):
    """The fused (interleaved) 1F1B schedule on this rank: each tick one
    chunk forward and one chunk backward. ``head(i, y) -> dy`` runs on the
    last stage the tick microbatch ``i``'s output is made, and returns its
    cotangent; the rest as :class:`GPipe`. The stage graphs of the
    microbatches in flight are kept: at most ``2·V·S - 1`` at once."""
    s, m, d = st.s, st.m, st.d
    ticks = m * st.v + st.c + s - 2
    stash: Dict[tuple, tuple] = {}
    side_sum = torch.zeros((), dtype=torch.float32, device=like.device)
    dx: Dict[int, torch.Tensor] = {}
    fbuf = bbuf = None
    for t in range(ticks):
        f = st.fwd(t)
        y = dy_last = None
        if f is not None:
            vv, i = f
            a = (inject(i) if st.first(vv) else fbuf).detach() \
                .requires_grad_()
            with torch.enable_grad():
                y, side = _run(fn, chunks[vv], a, with_aux)
            stash[(i, vv)] = (a, y, side)
            if side is not None:
                side_sum = side_sum + side.detach().float()
            if st.final(vv):
                dy_last = head(i, y)
        pipeline_stats["stash_high_water"] = max(
            pipeline_stats["stash_high_water"], len(stash))
        b = st.bwd(t)
        da = None
        if b is not None:
            w, bi = b
            a, yb, side = stash.pop((bi, w))
            cot = dy_last if st.final(w) else bbuf
            _backward(yb, side, cot.to(yb.dtype), side_cot)
            da = a.grad
            if st.first(w):
                dx[bi] = da
        sends, recvs = [], []
        if f is not None and not st.final(f[0]):
            sends.append((y, 1, _FWD_TAG))
        if b is not None and not st.first(b[0]):
            sends.append((da, -1, _BWD_TAG))
        pf, nb = st.fwd(t, d - 1), st.bwd(t, d + 1)
        if pf is not None and not st.final(pf[0], d - 1):
            recvs.append((like, 1, _FWD_TAG))
        if nb is not None and not st.first(nb[0], d + 1):
            recvs.append((like, -1, _BWD_TAG))
        got = st.exchange(sends, recvs)
        fbuf = bbuf = None
        for (_, way, _), g in zip(recvs, got):
            if way > 0:
                fbuf = g
            else:
                bbuf = g
    return side_sum, dx


# ---------------------------------------------------------------------------
# The reference's entry points: global arrays, stacked stage parameters.
# ---------------------------------------------------------------------------


def _dp(mesh, dp_axis: Optional[str]):
    """(group, size, index) of the dp axis; (None, 1, 0) without one."""
    if dp_axis is None or axis_size(mesh, dp_axis) == 1:
        return None, 1, 0
    return axes_group(mesh, (dp_axis,)), axis_size(mesh, dp_axis), \
        axis_index(mesh, dp_axis)


def _check_mb(x, mesh, dp_axis):
    if dp_axis is not None and x.shape[1] % axis_size(mesh, dp_axis):
        raise ValueError(
            f"dp axis size {axis_size(mesh, dp_axis)} must divide "
            f"microbatch size {x.shape[1]}")


def _rows(stage_params, s: int, v: int, d: int):
    """(rows of this rank's chunks, whether the stack is whole): a whole
    stack has ``V·S`` rows, this rank's shard ``V`` (the entry points
    have checked that it is one of the two)."""
    n = {int(leaf.shape[0]) for leaf in pytree.tree_leaves(stage_params)}
    if len(n) != 1:
        raise ValueError(f"stage_params leading dims differ: {sorted(n)}")
    if n.pop() == v * s:
        return list(range(d * v, (d + 1) * v)), True
    return list(range(v)), False


def _gather_dp(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The whole of ``t`` (this rank's dp shard along dim 1)."""
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, 1)


def _aliases(tree):
    """``tree`` with every tensor a fresh leaf that requires grad (the
    stage graphs are built on these, so their gradients are read off
    them)."""
    return pytree.tree_map(
        lambda t: t.detach().requires_grad_() if isinstance(
            t, torch.Tensor) and t.is_floating_point() else t, tree)


def _grads(alias_tree, like_tree):
    return pytree.tree_map(
        lambda a, p: torch.zeros_like(p) if a.grad is None
        else a.grad.to(p.dtype), alias_tree, like_tree)


def _sum_over(tree, group):
    for t in pytree.tree_leaves(tree):
        all_reduce(t, group)
    return tree


class _Pipe:
    """One call's set-up: the stage, the rows of its chunks, its dp shard
    of ``x`` and the chunks' parameters (aliases)."""

    def __init__(self, mesh, axis, dp_axis, n_virtual, stage_params, x):
        self.st = _Stage(mesh, axis, n_virtual, x.shape[0])
        st = self.st
        rows, self.whole = _rows(stage_params, st.s, st.v, st.d)
        self.dp_group, self.n_dp, self.j = _dp(mesh, dp_axis)
        sub = x.shape[1] // self.n_dp
        self.xs = x[:, self.j * sub:(self.j + 1) * sub]
        self.like = self.xs[0]
        self.alias = _aliases(stage_params)
        self.chunks = [pytree.tree_map(lambda t, r=r: t[r], self.alias)
                       for r in rows]
        self.pp_group = st.ring.group if st.ring is not None else None

    def stage_grads(self, stage_params, dp_op):
        g = _grads(self.alias, stage_params)
        if self.n_dp > 1:
            for t in pytree.tree_leaves(g):
                all_reduce(t, self.dp_group)
                if dp_op == "mean":
                    t.div_(self.n_dp)
        if self.whole:  # the other rows come from their stages
            _sum_over(g, self.pp_group)
        return g


class _GPipeFn(torch.autograd.Function):
    """The forward schedule, with the backward schedule as its autograd
    backward. The outputs and the aux are whole on every rank; the
    output cotangent used is the last stage's (every rank computes the
    same loss of the same whole outputs)."""

    @staticmethod
    def forward(ctx, pipe, x, *leaves):
        st, eng = pipe.st, pipe.engine
        outs = {}
        with torch.enable_grad():
            side = eng.forward(lambda i, y: outs.__setitem__(i, y.detach()))
        local = torch.stack([outs[i] for i in range(st.m)]) if outs \
            else torch.zeros_like(pipe.xs)
        out = _gather_dp(all_reduce(local.clone(), pipe.pp_group),
                         pipe.dp_group, pipe.n_dp)
        aux = all_reduce(side.clone(), pipe.pp_group) / st.m
        if pipe.n_dp > 1:
            aux = all_reduce(aux, pipe.dp_group) / pipe.n_dp
        ctx.pipe = pipe
        return out, aux

    @staticmethod
    def backward(ctx, g_out, g_aux):
        pipe = ctx.pipe
        st = pipe.st
        sub = pipe.xs.shape[1]
        g_local = g_out[:, pipe.j * sub:(pipe.j + 1) * sub]
        side_cot = float(g_aux) / (st.m * pipe.n_dp) \
            if pipe.engine.with_aux else 0.0
        dx = pipe.engine.backward(lambda i: g_local[i], side_cot)
        dxs = torch.stack([dx[i] for i in range(st.m)]) if dx \
            else torch.zeros_like(pipe.xs)
        dxs = _gather_dp(all_reduce(dxs.clone(), pipe.pp_group),
                         pipe.dp_group, pipe.n_dp)
        grads = pytree.tree_leaves(pipe.stage_grads(pipe.params, "sum"))
        ctx.pipe = None
        return (None, dxs) + tuple(grads)


def _gpipe(stage_fn, stage_params, x, mesh, axis, dp_axis, remat, with_aux,
           n_virtual):
    pipe = _Pipe(mesh, axis, dp_axis, n_virtual, stage_params, x)
    pipe.params = stage_params
    pipe.engine = GPipe(pipe.st, stage_fn, pipe.chunks,
                        lambda i: pipe.xs[i], pipe.like, with_aux=with_aux,
                        remat=remat)
    pipeline_stats["stash_high_water"] = 0
    out, aux = _GPipeFn.apply(pipe, x, *pytree.tree_leaves(stage_params))
    return (out, aux) if with_aux else out


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   mesh, axis: str = "pp", dp_axis: Optional[str] = None,
                   remat: bool = False, with_aux: bool = False):
    """Run ``x`` through S pipeline stages of ``stage_fn`` (GPipe: fill,
    steady state, drain; idle share ``(S-1)/(M+S-1)``).

    stage_fn: ``(params, act) -> act`` (``(act, side)`` with
        ``with_aux``, ``side`` a scalar side loss); the activation shape
        is stage-invariant.
    stage_params: the stage stack (leading dim S; or 1, this rank's
        stage).
    x: ``(M, mb, ...)`` microbatches; with ``dp_axis`` a rank computes
        its dp shard of each.
    remat: keep each stage's input alone and re-run the stage in the
        backward.
    Returns the ``(M, mb, ...)`` outputs, whole on every rank; with
    ``with_aux``, ``(outputs, aux)``, ``aux`` the microbatch mean of the
    stages' summed side losses (dp-averaged). Differentiable in ``x`` and
    the stage parameters: the backward is the reverse schedule, and a
    stage's parameter gradients are summed over dp.
    """
    s = axis_size(mesh, axis)
    for leaf in pytree.tree_leaves(stage_params):
        if leaf.shape[0] not in (s, 1):
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} != pp axis size "
                f"{s}")
    _check_mb(x, mesh, dp_axis)
    return _gpipe(stage_fn, stage_params, x, mesh, axis, dp_axis, remat,
                  with_aux, 1)


def _check_interleave_args(s: int, n_virtual, stage_params, x, mesh,
                           dp_axis: Optional[str]):
    """The interleaved schedules' argument checks, as the reference's
    (``pipeline.py:166-191``), with a rank's own V-row shard of the stack
    taken too. Returns ``(v, c, m)``."""
    v = int(n_virtual)
    if v < 1:
        raise ValueError(f"n_virtual must be >= 1, got {n_virtual}")
    c = v * s
    m = x.shape[0]
    for leaf in pytree.tree_leaves(stage_params):
        if leaf.shape[0] not in (c, v):
            raise ValueError(
                f"stage_params leading dim {leaf.shape[0]} != "
                f"n_virtual*pp = {c}")
    if v > 1 and m % s:
        raise ValueError(
            f"microbatch count {m} must be a multiple of the pp axis "
            f"size {s} (groups of S share a V·S-tick span)")
    _check_mb(x, mesh, dp_axis)
    return v, c, m


def pipeline_interleaved(stage_fn: Callable, stage_params, x: torch.Tensor,
                         *, mesh, n_virtual: int, axis: str = "pp",
                         dp_axis: Optional[str] = None, remat: bool = False,
                         with_aux: bool = False):
    """Interleaved virtual stages (Megatron's looping pipeline): the model
    in ``C = V·S`` chunks, stage ``d`` holding chunks ``d, d + S, ...``,
    so every hop is the same +1 ring hand-off, the wrap from the last
    stage to the first included. Microbatches enter in groups of S, group
    ``g`` offset by ``g·V·S`` ticks. The idle share ``(S-1)/(M+S-1)``
    shrinks to ``(S-1)/(M·V+S-1)``; ``n_virtual=1`` is
    :func:`pipeline_apply`'s schedule.

    stage_params: the ``V·S`` device-major chunk stack
        (:func:`interleave_stage_params`), or this rank's ``V`` rows;
        ``x``: ``(M, mb, ...)``, M a multiple of S when ``V > 1``.
    Returns as :func:`pipeline_apply`."""
    s = axis_size(mesh, axis)
    _check_interleave_args(s, n_virtual, stage_params, x, mesh, dp_axis)
    return _gpipe(stage_fn, stage_params, x, mesh, axis, dp_axis, remat,
                  with_aux, int(n_virtual))


def pipeline_1f1b(stage_fn: Callable, loss_fn: Callable, stage_params,
                  loss_params, x: torch.Tensor, aux, *, mesh,
                  axis: str = "pp", dp_axis: Optional[str] = None,
                  with_aux: bool = False, aux_weight: float = 0.0):
    """The 1F1B schedule: a microbatch's backward starts as soon as its
    loss cotangent exists, so each stage holds at most ``2S - 1``
    microbatches' stage graphs, whatever M is (GPipe holds M).

    loss_fn: ``(loss_params, act, aux_mb) -> scalar mean loss`` of the
        last stage's output (the head); its parameters' gradients are
        taken on the last stage.
    stage_params: the stage stack (or this rank's row); loss_params: a
        pytree, whole on every rank.
    x / aux: ``(M, mb, ...)`` inputs and loss targets, dp-sharded inside.
    with_aux / aux_weight: ``stage_fn`` returns ``(act, side)`` and the
        loss adds ``aux_weight`` times the microbatch mean of the summed
        side losses; each chunk's backward gets ``aux_weight / M`` as the
        side loss's cotangent.

    Returns ``(loss, stage_grads, loss_grads, dx)``: the mean microbatch
    loss; the gradients of the stage parameters passed (the whole stack's
    or this rank's rows), of ``loss_params``, and of ``x`` (whole), all
    averaged over dp as the loss is."""
    return pipeline_interleaved_1f1b(
        stage_fn, loss_fn, stage_params, loss_params, x, aux, mesh=mesh,
        n_virtual=1, axis=axis, dp_axis=dp_axis, with_aux=with_aux,
        aux_weight=aux_weight)


def pipeline_interleaved_1f1b(stage_fn: Callable, loss_fn: Callable,
                              stage_params, loss_params, x: torch.Tensor,
                              aux, *, mesh, n_virtual: int,
                              axis: str = "pp",
                              dp_axis: Optional[str] = None,
                              with_aux: bool = False,
                              aux_weight: float = 0.0):
    """Fused interleaved 1F1B: the interleaved forward (chunk ``k`` of
    microbatch ``i = g·S + j`` at tick ``g·C + j + k``) and its backward
    at tick ``g·C + j + 2(C-1) - k`` on the same stage, the cotangent
    hopping the ring backwards one chunk a tick. Fill and drain take
    ``(V+1)S - 2`` ticks of 1/V of a stage's work; at most ``2C - 1``
    chunk graphs are live on a stage. ``n_virtual=1`` is
    :func:`pipeline_1f1b`. Arguments and returns as
    :func:`pipeline_1f1b`, with the device-major chunk stack."""
    s = axis_size(mesh, axis)
    v, c, m = _check_interleave_args(s, n_virtual, stage_params, x, mesh,
                                     dp_axis)
    pipe = _Pipe(mesh, axis, dp_axis, v, stage_params, x)
    st = pipe.st
    sub = pipe.xs.shape[1]
    auxs = aux[:, pipe.j * sub:(pipe.j + 1) * sub]
    lp = _aliases(loss_params)
    head_loss = torch.zeros((), dtype=torch.float32, device=x.device)

    def head(i, y):
        nonlocal head_loss
        yl = y.detach().requires_grad_()
        with torch.enable_grad():
            loss = loss_fn(lp, yl, auxs[i])
            (loss / m).backward()
        head_loss = head_loss + loss.detach().float()
        return yl.grad

    pipeline_stats["stash_high_water"] = 0
    side, dx = run_1f1b(st, stage_fn, pipe.chunks, lambda i: pipe.xs[i],
                        pipe.like, head, with_aux=with_aux,
                        side_cot=aux_weight / m)
    loss = all_reduce(torch.stack([head_loss, side]), pipe.pp_group) / m
    loss = loss[0] + aux_weight * loss[1]
    lgrads = _sum_over(_grads(lp, loss_params), pipe.pp_group)
    dxs = torch.stack([dx[i] for i in range(m)]) if dx \
        else torch.zeros_like(pipe.xs)
    dxs = all_reduce(dxs.clone(), pipe.pp_group)
    grads = pipe.stage_grads(stage_params, "mean")
    if pipe.n_dp > 1:
        loss = all_reduce(loss, pipe.dp_group) / pipe.n_dp
        for t in pytree.tree_leaves(lgrads):
            all_reduce(t, pipe.dp_group).div_(pipe.n_dp)
        dxs = dxs / pipe.n_dp
    return loss, grads, lgrads, _gather_dp(dxs, pipe.dp_group, pipe.n_dp)
