"""Rank function of ``tests/test_torch_moe_sp.py``: MoE and fsdp over a
split sequence in one gloo world of 4 ranks. It imports only the port
(and numpy/torch); the reference's results are computed in the test
process and compared there."""

import numpy as np

from torch_workers import _data_slot, torch_world


def _train(mesh, case, lr):
    """One ``make_train_step`` of the LM of ``case`` placed over ``mesh``,
    each rank passing its data slot's rows and its sequence chunk: the
    loss, and on rank 0 the reduced gradients and the parameters after
    the step, gathered whole."""
    import torch
    import torch.distributed as dist

    from ddstore_tpu_torch import weights
    from ddstore_tpu_torch.models import transformer as ttr
    from ddstore_tpu_torch.parallel.mesh import axis_index, axis_size

    i, n = _data_slot(mesh)
    sp, j = axis_size(mesh, "sp"), axis_index(mesh, "sp")

    def part(t):
        b, s = t.shape[0] // n, t.shape[1] // sp
        return torch.from_numpy(np.ascontiguousarray(
            t[i * b:(i + 1) * b, j * s:(j + 1) * s]))

    model = ttr.TransformerLM(compute_dtype=torch.float32, device="cpu",
                              mesh=mesh, **case["cfg"])
    weights.from_flax(case["tree"], model)
    state, opt = ttr.create_train_state(model, lr=lr, mesh=mesh)
    seen, step_ = {}, opt.step

    def hooked(*a, **k):
        seen["grads"] = weights.to_flax(
            {n_: p.grad for n_, p in model.named_parameters()})
        return step_(*a, **k)

    opt.step = hooked
    loss = ttr.make_train_step(model, opt, state=state)(
        *(part(t) for t in case["batch"]))
    res = {"loss": float(loss), "steps": state.step,
           "grads": seen["grads"], "params": weights.to_flax(model)}
    if model.n_experts > 0:
        res["routed"] = [blk.moe.stats["routed"].numpy().copy()
                         for blk in model.blocks]
    return res if dist.get_rank() == 0 else {"loss": res["loss"],
                                              "steps": res["steps"]}


def _route(mesh, case):
    """One MoE layer's routing and output over a dp x sp mesh, the global
    ``(B, S, d)`` input cut as the step cuts a batch: this rank's expert,
    slot and kept flags in the global order, the kept flags of the
    per-rank order (each rank's tokens after those of the ranks before it,
    which is the order of whole rows only), its output rows and aux."""
    import torch

    from ddstore_tpu_torch.models import moe
    from ddstore_tpu_torch.models.transformer import route_layout
    from ddstore_tpu_torch.parallel.mesh import axis_index, axis_size

    e, h, k, cap = case["experts"], case["hidden"], case["top_k"], \
        case["capacity"]
    x, valid, p = case["x"], case["valid"], case["params"]
    i, n = _data_slot(mesh)
    sp, j = axis_size(mesh, "sp"), axis_index(mesh, "sp")
    b, s = x.shape[0] // n, x.shape[1] // sp
    mine = np.s_[i * b:(i + 1) * b, j * s:(j + 1) * s]
    xl = torch.from_numpy(np.ascontiguousarray(x[mine])).reshape(b * s, -1)
    vl = torch.from_numpy(np.ascontiguousarray(valid[mine])).reshape(-1)
    layer = moe.MoeMlp(x.shape[-1], e, h, top_k=k, capacity=cap,
                       compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        layer.router.weight.copy_(torch.from_numpy(p["router"].T))
        for name in ("w1", "b1", "w2", "b2"):
            getattr(layer, name).copy_(torch.from_numpy(p[name]))
    layer.route_group, layer.route_place = route_layout(mesh, ("dp",))
    r = layer.routing(xl, vl, rows=b)
    y, aux = layer(xl, vl, rows=b)
    per_rank = moe.route(r.probs.log(), k, r.capacity, vl,
                         layer.route_group)
    return {"expert": r.expert.view(k, b, s).numpy(),
            "slot": r.slot.view(k, b, s).numpy(),
            "kept": r.kept.view(k, b, s).numpy(),
            "kept_per_rank": per_rank.kept.view(k, b, s).numpy(),
            "y": y.detach().view(b, s, -1).numpy(), "aux": float(aux),
            "capacity": r.capacity, "at": (i, j)}


def _generate(mesh, case):
    """``generate`` with the MoE ring prefill over the mesh's sp axis: the
    tokens and the first token's logits of each prompt set."""
    import torch

    from ddstore_tpu_torch import weights
    from ddstore_tpu_torch.models import decode
    from ddstore_tpu_torch.models import transformer as ttr

    model = ttr.TransformerLM(compute_dtype=torch.float32, device="cpu",
                              **case["cfg"])
    weights.from_flax(case["tree"], model)
    out = {}
    for name, (prompt, n_new, lengths) in case["prompts"].items():
        stats = {}
        toks = decode.generate(model, torch.from_numpy(prompt).long(), n_new,
                               prompt_lengths=lengths, stats=stats,
                               prefill_mesh=mesh)
        out[name] = (toks.numpy(), stats["first_logits"].numpy())
    return out


def _pp(mesh, case, lr):
    from torch_pp_workers import pp_lm_run

    return {r: pp_lm_run(mesh, case, run, lr)
            for r, run in case["runs"].items()}


def moe_sp_cases(rank, world, tmp, cases, lr):
    """Each of ``cases`` ({name: {"kind": "train", "route", "generate" or
    "pp", "axes", ...}}) on a mesh of its axes in one gloo world."""
    from ddstore_tpu_torch.parallel import make_mesh

    dist = torch_world(rank, world, tmp)
    out = {}
    try:
        for name, case in cases.items():
            mesh = make_mesh(case["axes"], "cpu")
            kind = case["kind"]
            if kind == "train":
                out[name] = _train(mesh, case, lr)
            elif kind == "route":
                out[name] = _route(mesh, case)
            elif kind == "generate":
                out[name] = _generate(mesh, case)
            else:
                out[name] = _pp(mesh, case, lr)
        return out
    finally:
        dist.destroy_process_group()

