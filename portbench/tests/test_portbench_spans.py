"""The program's spans on a trace's clock (``yardstick/spans.py``) and the
three readers built on them, on synthetic traces; a tiny traced run of each
cell reading them; and, on the card, one traced walk's spans placed by the
clock calls."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.yardstick import spans, trace as tr, work
from portbench_tiny import run_tiny

ROOT = Path(__file__).resolve().parents[2]
NEW = {"host_ms_per_step.sample": "sample-b16-fp32", "launches_per_step.sample": "sample-b16-fp32",
       "host_ms_per_step.train": "train-b32-graph"}
ZERO = 10**18  # the program's clock, ns, at the synthetic trace's time 0
CALLS = [(10.0, 11.0), (20.0, 21.5), (30.0, 31.0), (40.0, 41.0)]  # cudaStreamQuery, us on the trace


def reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py", "test_reader_" + name.replace(".", "_"))


def rec(i, name, parent, root, start_us, end_us, counts=None, **attrs):
    """A recorded span as the program keeps it, its times on the program's clock."""
    return SimpleNamespace(name=name, id=i, parent=parent, root=root, attrs=attrs, start_ns=ZERO + int(start_us * 1e3),
                           end_ns=ZERO + int(end_us * 1e3), counts_open=counts and counts[0],
                           counts_close=counts and counts[1])


def fake_program(monkeypatch, recorded, marks):
    mod = SimpleNamespace(spans=lambda: list(recorded), clock_marks=lambda: list(marks), CLOCK_CALL="cudaStreamQuery")
    monkeypatch.setitem(sys.modules, spans.PROGRAM, mod)


def marks_for(calls, slack_us=0.5):
    return [(ZERO + int((s - slack_us / 2) * 1e3), ZERO + int((e + slack_us / 2) * 1e3)) for s, e in calls]


def ctx_for(trace, cell, logs):
    f = harness.cell_files(ROOT, cell)
    return SimpleNamespace(trace=trace, spans=[], counters={}, unit_seconds=[0.001], config=f.config,
                           traffic=f.traffic, peaks=work.peaks_for("NVIDIA H100 80GB HBM3"), log=logs.append)


def walk_trace():
    """A walk of one scale and two steps. Step 0 (200-400 us) launches twice;
    step 1 (500-900 us) makes one launch that blocks 130 us on a full queue
    and waits 98 us in a synchronize. Kernels 1 and 2 run twice and once."""
    host = [("cudaStreamQuery", s, e) for s, e in CALLS] + [
        ("cudaLaunchKernel", 260.0, 270.0), ("cudaLaunchKernelExC", 280.0, 290.0),
        ("cudaLaunchKernel", 560.0, 700.0), ("Command Buffer Full", 565.0, 695.0),
        ("cudaDeviceSynchronize", 800.0, 898.0), ("cudaLaunchKernel", 950.0, 960.0)]
    ops = [(300.0, 480.0, "void sinddm::conv3x3_tc_kernel<float, 0>"),
           (600.0, 790.0, "void sinddm::conv3x3_tc_kernel<float, 1>"),
           (480.0, 500.0, "void sinddm::dw5x5_ring_kernel<float>")]
    return tr.Trace(ops=ops, window=(100.0, 1000.0), host=[(s, e, n) for n, s, e in host])


def walk_spans():
    counts = ({"conv_block.launches": 10, "dw_conv.launches": 5}, {"conv_block.launches": 12, "dw_conv.launches": 6})
    return [rec(0, "sinddm.walk", None, 0, 100, 1000, batch=16, n_scales=1),
            rec(1, "sinddm.scale", 0, 0, 100, 1000, counts, s=0, H=48, W=64, steps=2),
            rec(2, "sinddm.step", 1, 0, 200, 400, s=0, t=1),
            rec(3, "sinddm.denoiser", 2, 0, 250, 350, B=16, H=48, W=64),
            rec(4, "sinddm.step", 1, 0, 500, 900, s=0, t=0),
            rec(5, "sinddm.denoiser", 4, 0, 550, 850, B=16, H=48, W=64)]


def test_the_clock_calls_give_the_offset_and_pick_their_run():
    marks = marks_for(CALLS)
    zero, slack = spans.clock_offset(marks, CALLS)
    assert abs(zero - ZERO) <= 1 and slack == pytest.approx(0.5, abs=1e-3)
    # other calls of that name before and after the program's run of four
    zero, _ = spans.clock_offset(marks, [(1.0, 2.0), (3.5, 4.0)] + CALLS + [(90.0, 91.0)])
    assert abs(zero - ZERO) <= 1
    assert spans.clock_offset(marks, CALLS[:3]) is None and spans.clock_offset([], CALLS) is None


def test_a_blocked_launch_and_a_sync_are_not_host_time(monkeypatch):
    fake_program(monkeypatch, walk_spans(), marks_for(CALLS))
    logs = []
    ctx = ctx_for(walk_trace(), "sample-b16-fp32", logs)
    placed = spans.place(ctx.trace, logs.append)
    assert [(p.name, p.start, p.end) for p in placed][2] == ("sinddm.step", pytest.approx(200.0), pytest.approx(400.0))
    assert reader("host_ms_per_step.sample").read(ctx) == pytest.approx((0.200 + 0.172) / 2)
    assert reader("launches_per_step.sample").read(ctx) == pytest.approx(1.5)
    text = "\n".join(logs)
    assert "placed by 4 cudaStreamQuery calls" in text and "to within 0.25 us" in text
    assert "kernel 1 by scale: s=0 48x64 2 steps 0.370 ms" in text
    assert "kernel 2 by scale: s=0 48x64 2 steps 0.020 ms" in text
    assert "headroom" in text and "sinddm.denoiser" in text
    # 20 us in step 0's two launches; step 1's launch less its 130 us on the full queue, 10 us
    assert "0.030 of the steps' 0.372 host ms inside launch calls" in text


def test_idle_gaps_are_named_by_program_span(monkeypatch):
    fake_program(monkeypatch, walk_spans(), marks_for(CALLS))
    trace = walk_trace()
    gaps = dict(spans.idle_by_span(trace, spans.place(trace, lambda m: None)))
    # device idle: 100-300 (its midpoint, 200, opens step 0), 500-600 (550 opens step 1's denoiser call) and
    # 790-1000 (895: step 1, in its synchronize)
    assert gaps == {"sinddm.step | host, outside any CUDA call": pytest.approx(200e-6),
                    "sinddm.denoiser | host, outside any CUDA call": pytest.approx(100e-6),
                    "sinddm.step | cudaDeviceSynchronize": pytest.approx(210e-6)}


def test_the_train_steps_host_time(monkeypatch):
    recorded = [rec(0, "sinddm.train_chunk", None, 0, 0, 1000, n_steps=2, mode="grouped"),
                rec(1, "sinddm.train_step", 0, 0, 100, 300, key=("scale", 0), kind="replay", ema=True),
                rec(2, "sinddm.train_step", 0, 0, 400, 500, key=("scale", 1), kind="replay", ema=False)]
    host = [("cudaStreamQuery", s, e) for s, e in CALLS] + [
        ("cudaGraphLaunch", 110.0, 250.0), ("Command Buffer Full", 120.0, 240.0), ("cudaGraphLaunch", 410.0, 420.0),
        ("cudaMemcpyAsync", 600.0, 610.0), ("cudaStreamSynchronize", 610.0, 990.0)]
    trace = tr.Trace(ops=[(120.0, 980.0, "graph kernel")], window=(0.0, 1000.0), host=[(s, e, n) for n, s, e in host])
    fake_program(monkeypatch, recorded, marks_for(CALLS))
    logs = []
    assert reader("host_ms_per_step.train").read(ctx_for(trace, "train-b32-graph", logs)) == pytest.approx(0.09)
    text = "\n".join(logs)
    assert "EMA steps: host ms mean 0.0800" in text and "other steps: host ms mean 0.1000" in text
    assert "kinds {'replay': 2}" in text
    assert "0.030 of the steps' 0.180 host ms inside launch calls" in text  # 140 - 120 us, and 10 us


@pytest.mark.parametrize("name", sorted(NEW))
def test_no_program_span_gives_none(name, monkeypatch):
    logs = []
    ctx = ctx_for(walk_trace(), NEW[name], logs)
    fake_program(monkeypatch, [], [])
    assert reader(name).read(ctx) is None
    # an older program: its profiling module has no spans at all
    monkeypatch.setitem(sys.modules, spans.PROGRAM, SimpleNamespace(trace=None))
    assert reader(name).read(ctx) is None
    # spans that cannot be placed: no clock marks, and none in the trace by name
    fake_program(monkeypatch, walk_spans(), [])
    assert reader(name).read(ctx) is None and "not placed" in logs[-1]


def test_two_traced_attempts_read_the_last(one_thread):
    """The harness traces a unit again when the first trace misses
    operations: the recorder keeps the last session's spans, which the
    readers place on the last trace by name (a CPU session keeps them)."""
    from sinddm_tpu_torch.utils.profiling import span

    def unit(n):
        with span("sinddm.walk", batch=1, n_scales=1), span("sinddm.scale", s=0, H=4, W=4, steps=n):
            for t in range(n):
                with span("sinddm.step", s=0, t=t), span("sinddm.denoiser", B=1, H=4, W=4):
                    pass

    first = tr.profile(lambda: unit(3), lambda: None)
    last = tr.profile(lambda: unit(2), lambda: None)
    placed = spans.place(last, lambda m: None)
    assert [p.name for p in placed].count("sinddm.step") == 2
    logs = []
    assert spans.place(first, logs.append) is None and "not placed" in logs[0]
    assert reader("launches_per_step.sample").read(ctx_for(last, "sample-b16-fp32", [])) == 0.0
    assert reader("host_ms_per_step.sample").read(ctx_for(last, "sample-b16-fp32", [])) > 0


@pytest.mark.parametrize("cell", ["sample-b16-fp32", "train-b32-graph"])
def test_a_tiny_traced_run_reads_the_span_metrics(cell, one_thread):
    out = run_tiny(cell, trace=True)
    assert out["correct"]
    for name, where in NEW.items():
        if where == cell:
            value = out["metrics"][name]["value"]
            assert isinstance(value, float) and value >= 0, name


def test_a_cell_added_as_files_alone_reports_the_span_metrics(tmp_path):
    """A sample cell added as files alone, as the harness finds it, with the
    span metrics' lists extended, reports them beside the device's."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["moves"] == "sample_images_per_s":
            m["workloads"].append("sample-b2-fp32")
    bench["workloads"].append({"name": "sample-b2-fp32", "config": "sinddm-d160-balloons", "traffic": "walks-b16-fp32",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"][0]["workloads"].append("sample-b2-fp32")
    (tmp_path / "portbench" / "limits").mkdir(parents=True)
    (tmp_path / "portbench" / "limits" / "sample-b2-fp32.json").write_text(json.dumps({"walk_mean_gap": 1e-3}))
    (tmp_path / "portbench" / "traffic").symlink_to(ROOT / "portbench" / "traffic")
    (tmp_path / "portbench" / "configs").symlink_to(ROOT / "portbench" / "configs")
    f = harness.cell_files(tmp_path, "sample-b2-fp32", bench)
    assert {m["name"] for m in f.per_layer} == {"kernel1_roofline.sample", "kernel2_roofline.sample", "mfu.sample",
                                                 "idle_share.sample", "host_ms_per_step.sample",
                                                 "launches_per_step.sample"}


@pytest.mark.cuda
def test_a_traced_walk_on_the_card_places_its_spans(cuda):
    """One walk at dim 16 over two scales, traced as the harness traces a
    unit (device activity alone): every denoiser call's span, placed by the
    clock calls, encloses its 12 launches of kernels 1-2 at least, and no
    two step spans overlap."""
    import torch

    from sinddm_tpu_torch.apps.sampling import sample_scales
    from sinddm_tpu_torch.models.denoiser import SinDDMNet
    from sinddm_tpu_torch.ops import _build
    from sinddm_tpu_torch.schedules import make_schedules
    from sinddm_tpu_torch.utils import profiling

    _build.build(("conv_block", "dw_conv"))
    model = SinDDMNet(dim=16, device="cuda").eval().requires_grad_(False)
    sched = make_schedules(timesteps=8, scale_losses=(0.5,), n_scales=2, device="cuda")

    def walk():
        sample_scales(model, sched, ((48, 64), (67, 90)), scale_factor=1.41, n_scales=2, batch_size=2,
                      generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")

    walk()
    torch.cuda.synchronize()
    trace = tr.profile(walk, torch.cuda.synchronize)
    assert not any(n.startswith("sinddm.") for _, _, n in trace.host)  # a session of device activity alone
    calls = sorted((s, e) for s, e, n in trace.host if n == profiling.CLOCK_CALL)
    _, slack = spans.clock_offset(profiling.clock_marks(), calls)
    assert slack / 2 < 20
    placed = spans.place(trace, print)
    _, steps = spans.last_unit(placed, "sinddm.walk", "sinddm.step")
    _, denoiser = spans.last_unit(placed, "sinddm.walk", "sinddm.denoiser")
    assert len(steps) == len(denoiser) == 8 + sched.num_timesteps_ideal[1]
    assert min(spans.count_inside(denoiser, trace, spans.is_launch)) >= 12
    assert all(a.end <= b.start for a, b in zip(steps, steps[1:]))
