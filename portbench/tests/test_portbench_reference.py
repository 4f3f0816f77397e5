"""Each plain reference against the program's plain path at tiny sizes on
the CPU (the test imports the program; the reference does not), and the
harness's own comparison, run end to end on the CPU, reading ~0."""

import json
import math
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.reference import sinddm as ref
from portbench.yardstick.weights import make_weights
from portbench_tiny import run_tiny, tiny_files

ROOT = Path(__file__).resolve().parents[2]

BALLOONS_LOSSES = (1.0871835898797855, 0.7771932694518568, 0.5452509776707822, 0.3865868564044144)


def test_schedules_and_geometry_match_the_program():
    from sinddm_tpu_torch.pyramid import compute_pyramid_geometry
    from sinddm_tpu_torch.schedules import make_schedules

    geo = ref.geometry((248, 186), 1.411, 50000)
    _, sizes_wh, factor, n = compute_pyramid_geometry((248, 186), 1.411, 50000)
    assert geo["sizes_hw"] == [(h, w) for w, h in sizes_wh] == [(48, 64), (67, 90), (94, 126), (133, 177),
                                                                 (186, 248)]
    assert geo["n_scales"] == n and geo["scale_factor"] == pytest.approx(factor, rel=1e-12)
    sch = ref.schedules(100, BALLOONS_LOSSES, "cpu")
    prog = make_schedules(timesteps=100, scale_losses=BALLOONS_LOSSES, n_scales=5, device="cpu")
    assert tuple(sch["ideal"]) == prog.num_timesteps_ideal == (100, 52, 41, 31, 22)
    for mine, theirs in (("sqrt_abar", "sqrt_alphas_cumprod"), ("recipm1", "sqrt_recipm1_alphas_cumprod"),
                         ("coef1", "posterior_mean_coef1"), ("coef2", "posterior_mean_coef2"),
                         ("logvar", "posterior_log_variance_clipped"), ("gammas", "gammas")):
        assert torch.equal(sch[mine], getattr(prog, theirs)), mine


def test_the_denoiser_matches_the_program(one_thread):
    from sinddm_tpu_torch.models.denoiser import SinDDMNet

    blocks = [[3, 4], [4, 8], [8, 8], [8, 4]]
    w = make_weights(3, {"blocks": blocks, "time_dim": 32, "channels": 3}, "cpu")
    model = SinDDMNet(dim=8, device="cpu")
    model.load_state_dict(w, strict=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((3, 11, 13, 3), generator=g)
    t, s = torch.tensor([0, 5, 99]), torch.tensor([0.0, 1.0, 4.0])
    with torch.no_grad():
        assert torch.allclose(ref.denoise(w, x, t, s, blocks), model(x, t, s), atol=1e-5, rtol=1e-5)


def test_the_walk_matches_the_program(one_thread):
    from sinddm_tpu_torch.apps.sampling import sample_scales
    from sinddm_tpu_torch.models.denoiser import SinDDMNet
    from sinddm_tpu_torch.schedules import make_schedules

    f = tiny_files("sample-b16-fp32")
    cfg = f.config
    w = make_weights(5, cfg, "cpu")
    model = SinDDMNet(dim=8, device="cpu")
    model.load_state_dict(w)
    geo = ref.geometry(cfg["image_wh"], cfg["scale_factor"], cfg["auto_scale"])
    noise = lambda: (lambda g: (lambda shape: torch.randn(shape, generator=g)))(torch.Generator().manual_seed(9))
    prog = sample_scales(model, make_schedules(timesteps=10, scale_losses=[0.5], n_scales=2, device="cpu"),
                         geo["sizes_hw"], scale_factor=geo["scale_factor"], n_scales=2, batch_size=2,
                         custom_sample=True, noise_fn=noise(), device="cpu")
    want = ref.walk(lambda x, t, s: ref.denoise(w, x, t, s, cfg["blocks"]), ref.schedules(10, [0.5], "cpu"),
                    geo["sizes_hw"], 2, noise(), channels=3, device="cpu")
    assert [tuple(o.shape) for o in prog] == [(2, 48, 64, 3), (2, 72, 96, 3)]
    for o, r in zip(prog, want):
        assert float((o - r).abs().max()) < 1e-5


def test_the_chunk_order_matches_the_trainer(one_thread):
    f = tiny_files("train-b32-graph")
    d = harness.load_module(f.driver_path, "portbench_driver_train").Driver(f.config, f.traffic, 2**31 + 1, "cpu",
                                                                          lambda msg: None)
    d.setup()
    assert d.chunks == [4, 2]
    assert d.trainer.running_scale == ref.chunk_scales(d.trainer_seed, 2, d.chunks)
    assert sorted(d.trainer.running_scale[:4]) == [0, 0, 1, 1] and sorted(d.trainer.running_scale[4:]) == [0, 1]
    assert d.prog["replay"]["scales"] == d.trainer.running_scale[4:]


def test_the_configuration_is_what_the_benchmark_runs():
    """Every configuration's reference is the file its ``reference`` names,
    its weights have its widths, and its stated ``num_timesteps_ideal`` is
    what the reference works out from its rescale losses."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        cfg = json.loads((ROOT / entry["file"]).read_text())
        mod = harness.load_reference(cfg)
        assert Path(mod.__file__) == ROOT / cfg["reference"]
        assert mod.schedules(cfg["timesteps"], cfg["rescale_losses"], "cpu")["ideal"] == cfg["num_timesteps_ideal"]
        assert mod.geometry(cfg["image_wh"], cfg["scale_factor"], cfg["auto_scale"])["sizes_hw"] == \
            [tuple(v) for v in cfg["sizes_hw"]]
        w = make_weights(1, cfg, "cpu")
        assert w["time_mlp2.bias"].shape == (cfg["time_dim"],)
        assert w["final_conv.weight"].shape[-1] == cfg["channels"] == cfg["blocks"][0][0]
        assert w["l1.net_conv1.weight"].shape[-1] == cfg["dim"] // 2


@pytest.mark.parametrize("cell", ["sample-b16-fp32", "train-b32-graph"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_run_is_correct_and_reads_about_zero(cell, trace, one_thread):
    out = run_tiny(cell, trace=trace)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    for name, c in out["checks"].items():
        assert math.isfinite(c["value"]) and c["value"] < 1e-4, name
    if trace:
        assert out["device"]["window_s"] > 0 and "breakdown" in out
    else:
        assert out["metrics"]["setup_s"]["value"] > 0
