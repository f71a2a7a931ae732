"""The train step's profiler ranges (``utils/profile.annotate``): under a
``torch.profiler`` every step records ``ddstore:zero_grad``,
``ddstore:forward`` (holding each layer's ``ddstore:attention`` and the
fused head's ``ddstore:head_fwd``),
``ddstore:backward`` (holding ``ddstore:head_bwd``) and
``ddstore:optimizer``, forward and backward once a chunk under
accumulation; with no profiler the step enters no range; and a step
recorded is bitwise the step not recorded."""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ddstore_tpu_torch.models import transformer as ttr

pytestmark = pytest.mark.tier1_required

STEP_SPANS = ("ddstore:zero_grad", "ddstore:forward", "ddstore:attention",
              "ddstore:head_fwd", "ddstore:backward", "ddstore:head_bwd",
              "ddstore:optimizer")
VOCAB, B, S, LAYERS = 64, 4, 16, 2
INNER = ("ddstore:attention", "ddstore:head_fwd", "ddstore:head_bwd")


def _setup(seed=3, accum_steps=1):
    torch.manual_seed(seed)
    model = ttr.TransformerLM(vocab=VOCAB, dim=32, heads=4, layers=LAYERS,
                              device="cpu")
    state, opt = ttr.create_train_state(model, lr=1e-3)
    step = ttr.make_train_step(model, opt, fused_xent=True,
                               accum_steps=accum_steps, state=state)
    g = torch.Generator().manual_seed(seed + 1)
    tok = torch.randint(0, VOCAB, (B, S), generator=g)
    tgt = torch.randint(0, VOCAB, (B, S), generator=g)
    pos = torch.arange(S).expand(B, S)
    return model, step, (tok, tgt, pos)


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("ddstore:")]


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_each_step_records_its_spans(accum_steps):
    _, step, batch = _setup(accum_steps=accum_steps)
    step(*batch)  # the first step builds Adam's state outside the trace
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(*batch)
        step(*batch)
    spans = _spans(prof)
    counts = collections.Counter(e.name for e in spans)
    per_chunk = {"ddstore:forward", "ddstore:attention", "ddstore:head_fwd",
                 "ddstore:backward", "ddstore:head_bwd"}
    per_layer = {"ddstore:attention": LAYERS}
    assert counts == {n: 2 * (accum_steps if n in per_chunk else 1)
                      * per_layer.get(n, 1) for n in STEP_SPANS}
    by = collections.defaultdict(list)
    for e in sorted(spans, key=lambda e: e.time_range.start):
        by[e.name].append(e)
    for head, trunk in (("ddstore:head_fwd", "ddstore:forward"),
                        ("ddstore:head_bwd", "ddstore:backward")):
        for inner, outer in zip(by[head], by[trunk]):
            assert _inside(inner, outer), (head, trunk)
    for inner in by["ddstore:attention"]:
        assert any(_inside(inner, outer)
                   for outer in by["ddstore:forward"])
    # one step's top-level spans in order, none overlapping the next
    top = [e for e in sorted(spans, key=lambda e: e.time_range.start)
           if e.name not in INNER]
    want = (["ddstore:zero_grad"]
            + ["ddstore:forward", "ddstore:backward"] * accum_steps
            + ["ddstore:optimizer"]) * 2
    assert [e.name for e in top] == want
    for a, b in zip(top, top[1:]):
        assert a.time_range.end <= b.time_range.start


def _counting_record_function(monkeypatch):
    entered = collections.Counter()
    real = torch.profiler.record_function

    def counting(name, *args, **kwargs):
        entered[name] += 1
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return entered


def test_no_profiler_no_range(monkeypatch):
    _, step, batch = _setup()
    entered = _counting_record_function(monkeypatch)
    step(*batch)
    step(*batch)
    assert not entered
    # the same count, under a profiler, sees every range
    with profile(activities=[ProfilerActivity.CPU]):
        step(*batch)
    assert sorted(entered) == sorted(STEP_SPANS)


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_a_recorded_step_is_bitwise_the_same(accum_steps):
    plain_model, plain_step, batch = _setup(accum_steps=accum_steps)
    traced_model, traced_step, _ = _setup(accum_steps=accum_steps)
    plain = [plain_step(*batch) for _ in range(2)]
    traced = [traced_step(*batch)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced.append(traced_step(*batch))
    assert _spans(prof)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
    for (name, p), q in zip(plain_model.named_parameters(),
                            traced_model.parameters()):
        assert torch.equal(p, q), name
