"""The port's program spans (`vitrs_tpu_torch/utils/trace.py`) and the
benchmark's readers of them (`portbench/readers/spans.py`): the shared
null context with no profiler, the ranges and records the engine, the
training step and the ViT forward leave under torch.profiler on the CPU,
and each reader on synthetic kineto events."""

import collections
import contextlib
import time
import types

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from portbench import tracing
from portbench.readers import spans as R
from vitrs_tpu_torch import ViT, get_config
from vitrs_tpu_torch import params as PRM
from vitrs_tpu_torch.models import model as M
from vitrs_tpu_torch.parallel import data_parallel as dp
from vitrs_tpu_torch.serving_gen import GenerationEngine
from vitrs_tpu_torch.utils import trace

from test_torch_helpers import one_torch_thread  # noqa: F401

NAMES = ("gen.admit", "gen.prefill", "gen.decode", "gen.sample",
         "train.step", "train.batch", "train.forward", "train.backward",
         "train.clip", "train.optimizer", "model.vit_forward",
         "data.normalize", "op.layernorm", "op.gelu")


def _ranges(prof):
    """{thread id: [(start, end, name)]} of the program's ranges."""
    out = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if R.PROGRAM.match(e.name()) and e.device_type() == DeviceType.CPU:
            out[e.start_thread_id()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def test_span_without_a_profiler_is_the_shared_null_context():
    before = len(trace.records(0, 2 ** 63))
    assert not torch.autograd.profiler._is_profiler_enabled
    assert trace.span("op.gelu") is trace.span("gen.prefill", rids=[1])
    with trace.span("gen.prefill", rids=[1]):
        trace.event("gen.submit", rid=1)
    assert len(trace.records(0, 2 ** 63)) == before


def test_program_span_names_are_not_the_harness_spans():
    assert not set(NAMES) & set(tracing.SPANS)
    assert all(R.PROGRAM.match(n) for n in NAMES)
    assert not any(R.PROGRAM.match(n) for n in tracing.SPANS)


def _engine_run(profiled):
    """gpt-nano's engine on 4 slots and buckets (8, 16), prompts of 3, 8,
    12, 5 and 16 tokens, one new token each; (prof, rids, t0, t1)."""
    cfg = get_config("gpt-nano").replace(num_layers=2, num_heads=2,
                                         channels=32, max_seq_len=32,
                                         dtype="float32")
    eng = GenerationEngine(ViT.from_config(cfg, seed=0, device="cpu").params,
                           cfg, max_slots=4, max_len=32,
                           prompt_buckets=(8, 16))
    rng = np.random.default_rng(0)
    with (profile(activities=[ProfilerActivity.CPU]) if profiled
          else contextlib.nullcontext()) as prof:
        t0 = time.time_ns()
        rids = [eng.submit(rng.integers(0, cfg.vocab_size, n), max_new=1)
                for n in (3, 8, 12, 5, 16)]
        eng.run()
        t1 = time.time_ns()
    return prof, rids, t0, t1


def test_engine_without_a_profiler_keeps_no_records(one_torch_thread):
    _, _, t0, t1 = _engine_run(profiled=False)
    assert trace.records(t0, t1) == []


def test_engine_spans_and_prefill_records(one_torch_thread):
    prof, rids, t0, t1 = _engine_run(profiled=True)
    recs = trace.records(t0, t1)
    assert [r[4]["rid"] for r in recs if r[3] == "gen.submit"] == rids
    # slots 4: bucket 8 takes (3, 8, 5), padded to 4 rows; the last slot
    # takes 12 from bucket 16; 16 waits for a slot
    pre = [r[4] for r in recs if r[3] == "gen.prefill"]
    assert pre == [dict(real_tokens=16, computed_tokens=32),
                   dict(real_tokens=12, computed_tokens=16),
                   dict(real_tokens=16, computed_tokens=16)]
    samples = [r[4] for r in recs if r[3] == "gen.sample"]
    # one new token each: the first tick serves the four admitted
    assert samples == [dict(first=[0, 1, 3, 2]), dict(first=[4])]
    (main,) = _ranges(prof).values()
    count = collections.Counter(n for _, _, n in main)
    assert count["gen.prefill"] == 3 and count["gen.decode"] == 2
    assert count["gen.sample"] == 2 and count["gen.admit"] == 2
    admits = [r for r in main if r[2] == "gen.admit"]
    for r in main:
        if r[2] == "gen.prefill":
            assert any(_inside(r, a) for a in admits)


def _train_ranges(cfg, inputs, targets, normalize=None, steps=2):
    params = PRM.unflatten_params(PRM.flatten_params(
        PRM.init_params(cfg, torch.Generator().manual_seed(0)), cfg), cfg)
    mesh = dp.make_mesh(devices=["cpu"])
    m, v = dp.init_sharded_opt_state(cfg, mesh)
    step = dp.make_dp_train_step(cfg, mesh, normalize=normalize,
                                 clip_norm=1.0, decay_2d_only=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(1, steps + 1):
            params, m, v, loss = step(params, m, v, inputs, targets, i,
                                      1e-3, 0.1)
    (main,) = _ranges(prof).values()
    return main


@pytest.mark.parametrize("mode", ["gpt", "vit"])
def test_train_step_spans_count_and_nest(mode, one_torch_thread):
    L = 2
    rng = np.random.default_rng(1)
    if mode == "gpt":
        cfg = get_config("gpt-nano").replace(num_layers=L, num_heads=2,
                                             channels=32, max_seq_len=16,
                                             dtype="float32")
        x = rng.integers(0, cfg.vocab_size, (2, 16))
        main = _train_ranges(cfg, x, np.roll(x, -1, axis=1))
    else:
        cfg = get_config("vit-tiny-4-cifar10").replace(
            num_layers=L, channels=32, num_heads=2, dtype="float32")
        x = rng.integers(0, 256, (2, cfg.img_size, cfg.img_size, 3),
                         dtype=np.uint8)
        main = _train_ranges(cfg, x, rng.integers(0, 10, 2),
                             normalize=((0.5, 0.5, 0.5), (0.25, 0.25, 0.25)))
    steps = 2
    count = collections.Counter(n for _, _, n in main)
    assert count["train.step"] == steps
    for name in ("train.batch", "train.forward", "train.backward",
                 "train.clip", "train.optimizer"):
        assert count[name] == steps, name
    # forward and backward alike: 2L + 1 LayerNorms, L GELUs a step
    assert count["op.layernorm"] == 2 * (2 * L + 1) * steps
    assert count["op.gelu"] == 2 * L * steps
    assert count["model.vit_forward"] == (steps if mode == "vit" else 0)
    assert count["data.normalize"] == (steps if mode == "vit" else 0)
    outer = {n: [r for r in main if r[2] == n] for n in count}
    parent = {"train.batch": "train.step", "train.forward": "train.step",
              "train.backward": "train.step", "train.clip": "train.step",
              "train.optimizer": "train.step",
              "model.vit_forward": "train.forward",
              "data.normalize": "train.batch"}
    for child, up in parent.items():
        for r in outer.get(child, []):
            assert any(_inside(r, o) for o in outer[up]), child
    # on the CPU autograd runs the backward on the calling thread
    for name, where in (("op.layernorm", (2 * L + 1) * steps),
                        ("op.gelu", L * steps)):
        assert sum(any(_inside(r, b) for b in outer["train.backward"])
                   for r in outer[name]) == where
        assert sum(any(_inside(r, f) for f in outer["train.forward"])
                   for r in outer[name]) == where


def test_vit_forward_spans_in_inference(one_torch_thread):
    cfg = get_config("vit-tiny-4-cifar10").replace(
        num_layers=2, channels=32, num_heads=2, dtype="float32")
    pp = M.prepare_params(ViT.from_config(cfg, seed=0, device="cpu").params,
                          cfg)
    x = torch.randint(0, 256, (2, cfg.img_size, cfg.img_size, 3),
                      dtype=torch.uint8)
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            torch.inference_mode():
        M.vit_forward(pp, dp.normalize_images(x, (0.5,) * 3, (0.25,) * 3),
                      cfg)
    (main,) = _ranges(prof).values()
    count = collections.Counter(n for _, _, n in main)
    assert count == {"data.normalize": 1, "model.vit_forward": 1,
                     "op.layernorm": 5, "op.gelu": 2}
    fwd = [r for r in main if r[2] == "model.vit_forward"][0]
    assert all(_inside(r, fwd) for r in main if r[2].startswith("op."))


# ------------------------------------------------- readers, synthetic trace

class _Event:
    def __init__(self, name, t0, t1, tid=1, cuda=False, annotation=False,
                 corr=0, linked=0):
        self._v = (name, t0, t1 - t0, tid, cuda, annotation, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def device_type(self):
        return DeviceType.CUDA if self._v[4] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[5]

    def correlation_id(self):
        return self._v[6]

    def linked_correlation_id(self):
        return self._v[7]


def _span(name, t0, t1, tid=1):
    return _Event(name, t0, t1, tid, annotation=True)


class _Prof:
    """What the readers take of a torch.profiler.profile."""

    def __init__(self, events):
        results = types.SimpleNamespace(events=lambda: events)
        self.profiler = types.SimpleNamespace(kineto_results=results)


def _ctx(events):
    return types.SimpleNamespace(tracer=types.SimpleNamespace(
        _prof=_Prof(events)))


# main thread 1: train.step [100, 600] holding op.layernorm [150, 200];
# gen.sample [700, 900]; the autograd thread 2: op.layernorm [300, 400]
EVENTS = [
    _span("window", 0, 1000), _span("step", 90, 610),
    _span("train.step", 100, 600), _span("op.layernorm", 150, 200),
    _span("gen.sample", 700, 900), _span("op.layernorm", 300, 400, tid=2),
    # a span's range drawn on the device's row is no kernel
    _Event("op.layernorm", 170, 230, cuda=True, annotation=True),
    # launches: in LN on thread 1; in LN on thread 2 while thread 1 is in
    # train.step; in train.step on thread 1; a CPU op whose correlation id
    # is a launch's must not be taken for it
    _Event("cudaLaunchKernel", 160, 165, corr=11),
    _Event("cudaLaunchKernel", 350, 355, tid=2, corr=12),
    _Event("cudaLaunchKernel", 350, 356, corr=13),
    _Event("aten::mul", 40, 60, tid=2, corr=11),
    _Event("aten::add", 705, 712, corr=99),
    _Event("k_ln_fwd", 170, 230, cuda=True, corr=11),
    _Event("k_ln_bwd", 360, 400, cuda=True, corr=12),
    _Event("k_step", 400, 500, cuda=True, corr=13),
    # no launch recorded: the kernel's linked CPU op says where
    _Event("k_sample", 720, 740, cuda=True, corr=77, linked=99),
    # syncs: in gen.sample, between spans (the harness's), in LN on 2
    _Event("cudaStreamSynchronize", 800, 810),
    _Event("cudaEventSynchronize", 650, 660),
    _Event("cudaDeviceSynchronize", 390, 395, tid=2),
]


def _metric(reader, **args):
    return getattr(R, reader)(_ctx(EVENTS), None, None, {"args": args})


def test_device_share_puts_kernels_down_to_the_launching_thread():
    assert _metric("device_share_in", spans=["op.layernorm"]) == \
        pytest.approx(100.0 * 100 / 220)
    # every span open at the launch: train.step holds thread 1's LN
    assert _metric("device_share_in", spans=["train.step"]) == \
        pytest.approx(100.0 * 160 / 220)
    # a kernel under two of the asked spans counts once
    assert _metric("device_share_in",
                   spans=["train.step", "op.layernorm"]) == \
        pytest.approx(100.0 * 200 / 220)
    assert _metric("device_share_in", spans=["gen.sample"]) == \
        pytest.approx(100.0 * 20 / 220)
    # a span the trace does not hold: the parent's program has none
    assert _metric("device_share_in", spans=["op.gelu"]) is None


def test_idle_is_put_down_to_the_main_threads_span_at_each_gap():
    # gaps [0, 170] outside any span, [230, 360] and [500, 720] in
    # train.step, [740, 1000] in gen.sample
    assert _metric("idle_in", spans=["gen.sample"]) == pytest.approx(26.0)
    assert _metric("idle_in", spans=["train.step"]) == pytest.approx(35.0)
    assert _metric("idle_in", spans=["op.layernorm"]) == pytest.approx(0.0)


def test_syncs_count_only_inside_program_spans():
    assert _metric("syncs_per", per="train.step") == pytest.approx(2.0)
    assert _metric("syncs_per", per="op.layernorm") == pytest.approx(1.0)
    assert _metric("syncs_per", per="gen.decode") is None
    cpu_only = [e for e in EVENTS if not e.name().startswith("cuda")
                and e.device_type() == DeviceType.CPU]
    assert R.syncs_per(_ctx(cpu_only), None, None,
                       {"args": {"per": "train.step"}}) is None


def test_pad_share_and_the_p95_join_by_request_id(monkeypatch):
    recs = collections.deque()
    monkeypatch.setattr(trace, "_RECORDS", recs)
    ms = 1_000_000
    for rid in range(20):
        recs.append((10 + rid, 10 + rid, 1, "gen.submit", {"rid": rid}))
    # submitted before the window: left out of the join
    recs.append((-5, -5, 1, "gen.submit", {"rid": 99}))
    for rid in range(20):
        t = 10 + rid + (rid + 1) * ms
        recs.append((t - 7, t, 1, "gen.sample",
                     {"rids": [rid], "first": [rid, 99]}))
    recs.append((20, 30, 1, "gen.prefill",
                 dict(real_tokens=18, computed_tokens=32)))
    recs.append((40, 50, 1, "gen.prefill",
                 dict(real_tokens=28, computed_tokens=32)))
    events = [_span("window", 0, 10 ** 9),
              _Event("k", 5, 9, cuda=True, corr=1)]
    p95 = R.request_p95_ms(_ctx(events), None, None, {"args": {}})
    assert p95 == pytest.approx(19.0)
    assert R.pad_share(_ctx(events), None, None, {"args": {}}) == \
        pytest.approx(100.0 * (1 - 46 / 64))
    # a run that drove no device reports neither
    cpu = events[:1]
    assert R.request_p95_ms(_ctx(cpu), None, None, {"args": {}}) is None
    assert R.pad_share(_ctx(cpu), None, None, {"args": {}}) is None
    recs.clear()
    assert R.request_p95_ms(_ctx(events), None, None, {"args": {}}) is None
    assert R.pad_share(_ctx(events), None, None, {"args": {}}) is None


def test_records_dropped_inside_a_window_read_as_none(monkeypatch):
    monkeypatch.setattr(trace, "_RECORDS", collections.deque(maxlen=3))
    monkeypatch.setattr(trace, "_dropped_t1", -1)
    for rid in range(5):
        trace._keep((10 * rid, 10 * rid + 5, 1, "gen.submit", {"rid": rid}))
    assert trace.records(0, 2 ** 63) is None
    # rid 1, the last dropped, ended at 15: a window from 16 is whole
    assert trace.records(15, 2 ** 63) is None
    assert [r[4]["rid"] for r in trace.records(16, 2 ** 63)] == [2, 3, 4]
    events = [_span("window", 0, 2 ** 62),
              _Event("k", 5, 9, cuda=True, corr=1)]
    assert R.request_p95_ms(_ctx(events), None, None, {"args": {}}) is None
    assert R.pad_share(_ctx(events), None, None, {"args": {}}) is None
