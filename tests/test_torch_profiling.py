"""The span recorder of ``sinddm_tpu_torch/utils/profiling.py``, on the CPU.

Spans are recorded only inside a ``torch.profiler`` session, each session's
afresh; outside one, :func:`span` hands back one shared null context. Under
a CPU session every span is also a ``record_function`` range, and its
in-memory times sit on the profiler's own clock. A tiny walk (dim 8, two
scales of 12x16 and 17x23, T = 6) and a tiny trainer record the spans the
program places, and the walk's outputs do not change with the recorder on.
"""

import gc
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sinddm_tpu_torch.apps.sampling import sample_scales
from sinddm_tpu_torch.config import DiffusionConfig, TrainConfig
from sinddm_tpu_torch.models.denoiser import SinDDMNet
from sinddm_tpu_torch.pyramid import Pyramid
from sinddm_tpu_torch.schedules import make_schedules
from sinddm_tpu_torch.training.trainer import MultiscaleTrainer
from sinddm_tpu_torch.utils import profiling
from sinddm_tpu_torch.utils.profiling import span, spans

from torch_clip_draws import one_torch_thread  # noqa: F401

SIZES_HW = ((12, 16), (17, 23))
LOSSES = (0.5,)
T = 6


def _session():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(recorded, name):
    return [r for r in recorded if r.name == name]


def _walk(model, sched, seed=0):
    return sample_scales(model, sched, SIZES_HW, scale_factor=1.41, n_scales=2, batch_size=2,
                         generator=torch.Generator().manual_seed(seed), device="cpu")


@pytest.fixture(scope="module")
def tiny(one_torch_thread):  # noqa: F811
    torch.manual_seed(0)
    model = SinDDMNet(dim=8, device="cpu").eval().requires_grad_(False)
    sched = make_schedules(timesteps=T, scale_losses=LOSSES, n_scales=2, device="cpu")
    return model, sched


def _trainer(tmp_path, fused_mode="grouped"):
    rng = np.random.default_rng(0)
    images = tuple(rng.uniform(-1, 1, hw + (3,)).astype(np.float32) for hw in SIZES_HW)
    pyramid = Pyramid(sizes_hw=SIZES_HW, sizes_wh=tuple((w, h) for h, w in SIZES_HW), images=images,
                      recon_images=images, rescale_losses=LOSSES, scale_factor=1.41, n_scales=2)
    sched = make_schedules(timesteps=T, scale_losses=LOSSES, n_scales=2, device="cpu")
    cfg = TrainConfig(train_batch_size=2, steps_per_chunk=4, fused_mode=fused_mode)
    return MultiscaleTrainer(SinDDMNet(dim=8, device="cpu"), sched, pyramid, cfg, DiffusionConfig(), tmp_path,
                             device="cpu")


def test_off_records_nothing_and_returns_the_shared_null_context():
    with _session():
        with span("sinddm.test"):
            pass
    before = spans()
    first, second = span("sinddm.a", x=1), span("sinddm.b")
    assert first is second
    with first as rec, span("sinddm.c"):
        assert rec is None
    assert [(r.name, r.id) for r in spans()] == [(r.name, r.id) for r in before] == [("sinddm.test", 0)]


def test_on_records_nesting_parents_roots_and_attrs():
    with _session():
        with span("sinddm.outer", n=2) as outer:
            with span("sinddm.mid", s=1):
                with span("sinddm.inner", t=5):
                    pass
            with span("sinddm.mid", s=2):
                pass
        with span("sinddm.second"):
            pass
    got = [(r.name, r.id, r.parent, r.root, r.attrs) for r in spans()]
    assert got == [("sinddm.outer", 0, None, 0, {"n": 2}), ("sinddm.mid", 1, 0, 0, {"s": 1}),
                   ("sinddm.inner", 2, 1, 0, {"t": 5}), ("sinddm.mid", 3, 0, 0, {"s": 2}),
                   ("sinddm.second", 4, None, 4, {})]
    assert outer is spans()[0]
    for r in spans():
        assert r.start_ns <= r.end_ns and r.counts_open is None and r.counts_close is None
    outer, mid, inner = spans()[:3]
    assert outer.start_ns <= mid.start_ns <= inner.start_ns <= inner.end_ns <= mid.end_ns <= outer.end_ns


def test_counters_are_read_as_a_span_opens_and_closes():
    count = {"n": 3}
    with _session():
        with span("sinddm.counted", counters=lambda: dict(count)):
            count["n"] += 4
    (rec,) = spans()
    assert rec.counts_open == {"n": 3} and rec.counts_close == {"n": 7}


def test_a_new_session_clears_the_last_ones_spans():
    with _session():
        with span("sinddm.first"):
            pass
    assert [r.name for r in spans()] == ["sinddm.first"]
    with _session():
        pass
    with _session():
        with span("sinddm.second"):
            with span("sinddm.third"):
                pass
    assert [(r.name, r.id, r.root) for r in spans()] == [("sinddm.second", 0, 0), ("sinddm.third", 1, 0)]
    assert profiling.clock_marks() == []  # no CUDA here: nothing to place the spans with


def _offsets(model, sched):
    """Each span's start and end less its profiler range's, trace_start_ns
    plus the event's time relative to it, in ns, by name."""
    with _session() as prof:
        _walk(model, sched)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in prof.events():
        if e.name.startswith("sinddm."):
            ranges.setdefault(e.name, []).append((start_ns + 1000 * e.time_range.start,
                                                  start_ns + 1000 * e.time_range.end))
    recorded = spans()
    assert {r.name for r in recorded} == set(ranges) == {"sinddm.walk", "sinddm.scale", "sinddm.step",
                                                          "sinddm.denoiser"}
    out = []
    for name, got in ranges.items():
        mine = sorted((r.start_ns, r.end_ns) for r in _by_name(recorded, name))
        assert len(mine) == len(got)
        out += [(name, a - c, b - d) for (a, b), (c, d) in zip(mine, sorted(got))]
    return out


def test_each_span_sits_on_its_profiler_range(tiny):
    """Every in-memory span's start and end within 50 us of its profiler
    range's. A host descheduled between the two clocks' readings reads as a
    gap, so of three walks (the collector off) one must hold every span."""
    model, sched = tiny
    gc.disable()
    try:
        walks = [_offsets(model, sched) for _ in range(3)]
    finally:
        gc.enable()
    assert any(all(abs(a) < 50e3 and abs(b) < 50e3 for _, a, b in w) for w in walks), walks


def test_a_walk_records_its_scales_steps_and_denoiser_calls(tiny):
    model, sched = tiny
    with _session():
        _walk(model, sched)
    recorded = spans()
    (walk,) = _by_name(recorded, "sinddm.walk")
    scales = _by_name(recorded, "sinddm.scale")
    steps = _by_name(recorded, "sinddm.step")
    calls = _by_name(recorded, "sinddm.denoiser")
    n_steps = T + sched.num_timesteps_ideal[1]
    assert walk.attrs == {"batch": 2, "n_scales": 2} and walk.id == 0
    assert [r.attrs for r in scales] == [{"s": 0, "H": 12, "W": 16, "steps": T},
                                         {"s": 1, "H": 17, "W": 23, "steps": sched.num_timesteps_ideal[1]}]
    counters = {"conv_block.launches", "conv_block.wgmma_launches", "dw_conv.launches"}
    assert all(r.parent == walk.id and set(r.counts_open) == counters for r in scales)
    assert len(steps) == len(calls) == n_steps
    assert [r.attrs["t"] for r in steps] == list(range(T - 1, -1, -1)) + \
        list(range(sched.num_timesteps_ideal[1] - 1, -1, -1))
    assert all(r.root == walk.id for r in recorded)
    assert all(recorded[c.parent].name == "sinddm.step" for c in calls)
    assert [c.attrs for c in calls[-1:]] == [{"B": 2, "H": 17, "W": 23}]


def test_a_guided_walk_records_a_guidance_span_a_step(tiny):
    model, sched = tiny

    def factory(s, hw):
        return (lambda x_recon, x_t, t, s, carry: (x_recon, carry, {})), None

    with _session():
        sample_scales(model, sched, SIZES_HW, scale_factor=1.41, n_scales=2, batch_size=1,
                      generator=torch.Generator().manual_seed(0), guidance_factory=factory, device="cpu")
    recorded = spans()
    guided, steps = _by_name(recorded, "sinddm.guidance"), _by_name(recorded, "sinddm.step")
    assert len(guided) == len(steps) == T + sched.num_timesteps_ideal[1]
    assert all(recorded[g.parent].name == "sinddm.step" and g.attrs == recorded[g.parent].attrs for g in guided)


def test_a_walk_is_the_same_bit_for_bit_with_the_recorder_on(tiny):
    model, sched = tiny
    off = _walk(model, sched, seed=3)
    with _session():
        on = _walk(model, sched, seed=3)
    assert len(spans()) > 0
    assert all(torch.equal(a, b) for a, b in zip(off, on)) and len(off) == len(on) == 2


@pytest.mark.parametrize("mode", ["grouped", "padded"])
def test_a_chunk_records_its_steps(mode, tmp_path, one_torch_thread):  # noqa: F811
    tr = _trainer(tmp_path, mode)
    with _session():
        (tr.train_chunk_grouped if mode == "grouped" else tr.train_chunk)(4)
    recorded = spans()
    (chunk,) = _by_name(recorded, "sinddm.train_chunk")
    steps = _by_name(recorded, "sinddm.train_step")
    assert chunk.attrs == {"n_steps": 4, "mode": mode}
    assert len(steps) == 4 and all(r.parent == chunk.id == r.root for r in steps)
    keys = [r.attrs["key"] for r in steps]
    if mode == "grouped":
        assert sorted(k[1] for k in keys) == sorted(tr.running_scale) == [0, 0, 1, 1]
    else:
        assert keys == [("canvas",)] * 4
    assert [r.attrs["kind"] for r in steps] == ["eager"] * 4  # the CPU runs no graphs
    assert [r.attrs["ema"] for r in steps] == [True, False, False, False]  # the EMA every 10 steps, from 0
    assert len(_by_name(recorded, "sinddm.denoiser")) == 4


def test_the_trainer_constructor_records_its_phases(tmp_path, one_torch_thread):  # noqa: F811
    with _session():
        _trainer(tmp_path)
    recorded = spans()
    assert recorded[0].name == "sinddm.trainer_init" and recorded[0].attrs == {"device": "cpu"}
    assert [r.name for r in recorded[1:]] == [f"sinddm.trainer_init.{p}"
                                              for p in ("params", "ema", "optimizer", "data", "graphs")]
    assert all(r.parent == 0 for r in recorded[1:])


def test_a_scale_span_reads_the_kernels_launch_counters(tiny, monkeypatch):
    """The CPU runs the plain blocks, which count no launch: the counters
    are set by hand, and each scale reads them as it opens and closes."""
    from sinddm_tpu_torch.ops import conv_block, dw_conv

    model, sched = tiny
    monkeypatch.setattr(conv_block, "launches", 8)
    monkeypatch.setattr(conv_block, "wgmma_launches", 7)
    monkeypatch.setattr(dw_conv, "launches", 4)
    with _session():
        _walk(model, sched)
    want = {"conv_block.launches": 8, "conv_block.wgmma_launches": 7, "dw_conv.launches": 4}
    assert [(r.counts_open, r.counts_close) for r in _by_name(spans(), "sinddm.scale")] == [(want, want)] * 2


def test_trace_writes_the_spans(tiny, tmp_path):
    model, sched = tiny
    with profiling.trace(tmp_path / "prof", device="cpu"):
        _walk(model, sched)
    (path,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = [e.get("name", "") for e in json.loads(path.read_text())["traceEvents"]]
    n_steps = T + sched.num_timesteps_ideal[1]
    assert names.count("sinddm.walk") == 1 and names.count("sinddm.scale") == 2
    assert names.count("sinddm.step") == names.count("sinddm.denoiser") == n_steps
    assert len(spans()) == 1 + 2 + 2 * n_steps
