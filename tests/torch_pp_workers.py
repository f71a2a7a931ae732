"""Rank functions of the pipeline parity tests (``tests/test_torch_pipeline.py``,
``tests/test_torch_pp_lm.py``), run by ``torch_workers.spawn`` in one gloo
world a file. They import only the port (and numpy/torch): the reference's
results are computed in the test process and compared there."""

import numpy as np

from torch_workers import torch_world


def _t(tree):
    """numpy tree -> torch tree (f32 leaves that require grad)."""
    import torch

    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32)).requires_grad_()


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().numpy().copy()


def mlp_stage(p, a):
    """The reference tests' ``StageMLP`` (``tests/test_pipeline.py:15``)
    on its flax tree: ``a + Dense(tanh(Dense(a)))``."""
    import torch

    p = p["params"]
    h = torch.tanh(a @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"])
    return a + h @ p["Dense_1"]["kernel"] + p["Dense_1"]["bias"]


def mlp_stage_aux(p, a):
    y = mlp_stage(p, a)
    return y, (y ** 2).mean()


def dense_stage(p, a):
    """``tanh(a @ w + b) + a`` (``tests/test_pipeline.py:224``)."""
    import torch

    return torch.tanh(a @ p["w"] + p["b"]) + a


def dense_stage_aux(p, a):
    y = dense_stage(p, a)
    return y, (y ** 2).mean()


def head_loss(lp, y, t):
    return ((y @ lp["head"] - t) ** 2).mean()


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.detach().numpy().copy()


def _apply_case(c, mesh):
    """A GPipe/interleaved case: outputs, and with ``tgt`` the gradients
    of ``mean((out - tgt)^2)`` in the stage stack and in ``x``."""
    import torch

    from ddstore_tpu_torch.parallel import pipeline as pp

    params, x = _t(c["params"]), _t(c["x"])
    fn = mlp_stage_aux if c.get("with_aux") else mlp_stage
    kw = dict(mesh=mesh, dp_axis=c.get("dp_axis"), remat=c.get("remat",
                                                                False),
              with_aux=c.get("with_aux", False))
    if c.get("n_virtual") is None:
        out = pp.pipeline_apply(fn, params, x, **kw)
    else:
        out = pp.pipeline_interleaved(fn, params, x,
                                      n_virtual=c["n_virtual"], **kw)
    res = {}
    if c.get("with_aux"):
        out, aux = out
        res["aux"] = float(aux)
    res["out"] = out.detach().numpy().copy()
    if "tgt" in c:
        loss = ((out - torch.from_numpy(c["tgt"])) ** 2).mean()
        loss.backward()
        res["grads"] = _grads(params)
        res["gx"] = x.grad.detach().numpy().copy()
    return res


def _fused_case(c, mesh):
    from ddstore_tpu_torch.parallel import pipeline as pp

    params, lp = _t(c["params"]), _t(c["lparams"])
    x, tgt = _t(c["x"]), _t(c["tgt"])
    fn = dense_stage_aux if c.get("with_aux") else dense_stage
    pp.pipeline_stats["stash_high_water"] = 0
    if c.get("plain_1f1b"):
        loss, gst, glp, dx = pp.pipeline_1f1b(
            fn, head_loss, params, lp, x, tgt, mesh=mesh,
            dp_axis=c.get("dp_axis"), with_aux=c.get("with_aux", False),
            aux_weight=c.get("aux_weight", 0.0))
    else:
        loss, gst, glp, dx = pp.pipeline_interleaved_1f1b(
            fn, head_loss, params, lp, x, tgt, mesh=mesh,
            n_virtual=c["n_virtual"], dp_axis=c.get("dp_axis"),
            with_aux=c.get("with_aux", False),
            aux_weight=c.get("aux_weight", 0.0))
    return {"loss": float(loss), "grads": _np(gst), "lgrads": _np(glp),
            "dx": dx.detach().numpy().copy(),
            "high_water": pp.pipeline_stats["stash_high_water"]}


def _train_case(c, mesh):
    """``tests/test_pipeline.py:70``: 60 Adam steps of a pipelined
    4-stage MLP on a regression target."""
    import torch

    from ddstore_tpu_torch.parallel import pipeline as pp

    params = _t(c["params"])
    leaves = []

    def collect(tree):
        for v in tree.values():
            collect(v) if isinstance(v, dict) else leaves.append(v)

    collect(params)
    x = torch.from_numpy(c["x"])
    y = x * 0.5 + 1.0
    opt = torch.optim.Adam(leaves, lr=1e-2, eps=1e-8)

    def lossf():
        return ((pp.pipeline_apply(mlp_stage, params, x, mesh=mesh) - y)
                ** 2).mean()

    l0 = float(lossf())
    for _ in range(60):
        opt.zero_grad()
        lossf().backward()
        opt.step()
    return {"l0": l0, "last": float(lossf())}


def _stash_case(c, mesh):
    """The stash high-water of GPipe's and 1F1B's gradients at S stages
    and each M of ``c["ms"]`` (``tests/test_pp_lm.py:193-236``'s
    shapes)."""
    import torch

    from ddstore_tpu_torch.parallel import pipeline as pp

    g = torch.Generator().manual_seed(0)
    s, mb, d = c["s"], c["mb"], c["d"]
    stages = {"w": torch.randn(s, d, d, generator=g) * 0.1}
    lp = {"wo": torch.randn(d, 1, generator=g) * 0.1}

    def stage_fn(p, a):
        return torch.tanh(a @ p["w"])

    def loss(lp_, y, t):
        return ((y @ lp_["wo"] - t) ** 2).mean()

    out = {}
    for m in c["ms"]:
        x = torch.randn(m, mb, d, generator=g)
        aux = torch.randn(m, mb, 1, generator=g)
        st = {"w": stages["w"].clone().requires_grad_()}
        pp.pipeline_stats["stash_high_water"] = 0
        y = pp.pipeline_apply(stage_fn, st, x, mesh=mesh)
        sum(loss(lp, y[i], aux[i]) for i in range(m)).backward()
        gp = pp.pipeline_stats["stash_high_water"]
        pp.pipeline_stats["stash_high_water"] = 0
        pp.pipeline_1f1b(stage_fn, loss, stages, lp, x, aux, mesh=mesh)
        out[m] = (gp, pp.pipeline_stats["stash_high_water"])
    return out


def pipeline_cases(rank, world, tmp, cases):
    """Each of ``cases`` ({name: {"kind", "axes", ...}}) on a mesh of its
    axes in one gloo world: a dict of results by case."""
    from ddstore_tpu_torch.parallel import make_mesh

    dist = torch_world(rank, world, tmp)
    run = {"apply": _apply_case, "fused": _fused_case, "train": _train_case,
           "stash": _stash_case}
    out = {}
    try:
        for name, c in cases.items():
            mesh = make_mesh(c["axes"], "cpu")
            out[name] = run[c["kind"]](c, mesh)
        return out
    finally:
        dist.destroy_process_group()


def _gather_tree(stage, tensors=None):
    """On rank 0 the flat ``{"params": ...}`` tree of every stage's
    ``tensors`` (default its parameters), pads dropped; None elsewhere.
    A collective of the world."""
    import torch.distributed as dist

    from ddstore_tpu_torch import weights

    piece = weights.stage_tree(stage, tensors)
    pieces = [None] * dist.get_world_size()
    dist.all_gather_object(pieces, piece)
    if dist.get_rank() != 0:
        return None
    rows = {}
    for p in pieces:  # a stage's replicas along the other axes agree
        rows.setdefault(tuple(sorted(p["rows"])), p)
    outer, stages = weights.join_stage_trees(
        list(rows.values()), stage.layers, stage.n_stages, stage.n_virtual)
    return weights.tree_from_stages(outer, stages, stage.layers,
                                    stage.n_stages, stage.n_virtual)


def _local_rows(mesh, batch, m):
    """This rank's part of the global batch: its dp slot's rows in
    ``pp_batch_rows`` order, its sequence chunk."""
    import torch

    from ddstore_tpu_torch.models.transformer import pp_batch_rows
    from ddstore_tpu_torch.parallel.mesh import axis_index, axis_size

    n_dp, j = axis_size(mesh, "dp"), axis_index(mesh, "dp")
    sp, k = axis_size(mesh, "sp"), axis_index(mesh, "sp")
    rows = pp_batch_rows(batch[0].shape[0], m, n_dp, j)
    c = batch[0].shape[1] // sp
    return tuple(torch.from_numpy(np.ascontiguousarray(
        t[rows, k * c:(k + 1) * c])) for t in batch)


def _placements(stage):
    return {n: (tuple(p.to_local().shape), str(tuple(p.placements)))
            if hasattr(p, "placements") else (tuple(p.shape), None)
            for n, p in stage.named_parameters()}


def pp_lm_run(mesh, case, run, lr):
    """One pp train step of the LM of ``case`` under ``run`` (schedule,
    n_virtual, remat, fused_xent, xent_block): the loss, on rank 0 the
    gathered gradients and parameters after the step, each rank's stage
    and placements, and the pads' largest weight after the step."""
    import torch

    from ddstore_tpu_torch import weights
    from ddstore_tpu_torch.models import transformer as ttr
    from ddstore_tpu_torch.parallel.mesh import axis_size

    m, nv = case["m"], run.get("n_virtual", 1)
    s = axis_size(mesh, "pp")
    model = ttr.TransformerLM(compute_dtype=torch.float32, device="cpu",
                              **case["cfg"])
    weights.from_flax(case["tree"], model)
    state, opt = ttr.create_pp_train_state(model, s, lr=lr, mesh=mesh,
                                           n_virtual=nv)
    stage = state.model
    seen = {}
    step_ = opt.step

    def hooked(*a, **k):
        seen["grads"] = {n: p.grad for n, p in stage.named_parameters()}
        return step_(*a, **k)

    opt.step = hooked
    step = ttr.make_pp_train_step(
        stage, opt, mesh, s, m, schedule=run["schedule"], n_virtual=nv,
        remat=run.get("remat", False), fused_xent=run.get("fused_xent"),
        xent_block=run.get("xent_block", 8192), state=state)
    loss = float(step(*_local_rows(mesh, case["batch"], m)))
    grads = _gather_tree(stage, seen["grads"])
    whole = ttr.lm_from_stages(stage, mesh)
    pads = [float(p.detach().abs().max()) for c in stage.chunks
            for blk, real in zip(c.layers, c.valid) if not real
            for p in blk.parameters()]
    return {"loss": loss, "grads": grads, "steps": state.step,
            "params": None if whole is None else weights.to_flax(whole),
            "stage": (stage.stage, len(stage.chunks), stage.embed is not None,
                      stage.lmhead is not None),
            "placements": _placements(stage), "pads": pads}


def pp_lm_cases(rank, world, tmp, cases, lr):
    """Every run of each of ``cases`` ({name: {"axes", "cfg", "tree",
    "batch", "m", "runs": {run name: {...}}}}) in one gloo world."""
    from ddstore_tpu_torch.parallel import make_mesh

    dist = torch_world(rank, world, tmp)
    out = {}
    try:
        for name, case in cases.items():
            mesh = make_mesh(case["axes"], "cpu")
            for rname, run in case["runs"].items():
                out[f"{name}/{rname}"] = pp_lm_run(mesh, case, run, lr)
        return out
    finally:
        dist.destroy_process_group()


def pipeline_cuda(rank, world, tmp):
    """Two ranks on card 0 in a gloo world: a small f32 LM over ``{"pp":
    2}`` takes one step under each schedule from the same weights and
    batch; rank 0 also takes the step in one process on the CPU (the plain
    attention). Per schedule: the loss, this rank's attention launches,
    and on rank 0 the CPU loss and the gathered parameters' largest
    ``|card - CPU| - 5e-3 |CPU|`` after the step."""
    import torch

    torch.cuda.set_device(0)
    from ddstore_tpu_torch import weights
    from ddstore_tpu_torch.models import transformer as ttr
    from ddstore_tpu_torch.ops import attention
    from ddstore_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0)
    dist = torch_world(rank, world, tmp)
    cfg = dict(vocab=512, dim=256, heads=4, layers=4,
               compute_dtype=torch.float32)
    g = np.random.default_rng(3)
    tok = torch.from_numpy(g.integers(0, 512, (4, 128)))
    tgt = torch.from_numpy(g.integers(0, 512, (4, 128)))
    pos = torch.arange(128).expand(4, 128)
    out = {}
    try:
        mesh = make_mesh({"pp": 2})
        for sched in ttr.PP_SCHEDULES:
            nv = 2 if sched.startswith("interleaved") else 1
            cpu = ttr.TransformerLM(device="cpu", **cfg)
            cpu.init_weights(torch.Generator().manual_seed(1))
            card = ttr.TransformerLM(device=dev, **cfg)
            card.load_state_dict(cpu.state_dict())
            state, opt = ttr.create_pp_train_state(card, 2, lr=1e-3,
                                                   mesh=mesh, n_virtual=nv)
            step = ttr.make_pp_train_step(state.model, opt, mesh, 2, 2,
                                          schedule=sched, n_virtual=nv)
            before = attention.flash_fwd_launches
            loss = float(step(*(t.to(dev) for t in (tok, tgt, pos))))
            res = {"loss": loss,
                   "launches": attention.flash_fwd_launches - before}
            whole = ttr.lm_from_stages(state.model, mesh)
            if rank == 0:
                _, copt = ttr.create_train_state(cpu, lr=1e-3)
                res["cpu_loss"] = float(ttr.make_train_step(cpu, copt)(
                    tok, tgt, pos))
                want = weights.to_flax(cpu)["params"]
                got = weights.to_flax(whole)["params"]
                from torch_workers import _flat
                want, got = _flat(want), _flat(got)
                res["worst"] = max(float((np.abs(got[k] - w)
                                          - 5e-3 * np.abs(w)).max())
                                   for k, w in want.items())
            out[sched] = res
        return out
    finally:
        dist.destroy_process_group()
