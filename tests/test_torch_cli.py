"""The port's CLI: ``--mode sample --device cpu`` on a tiny synthetic image
writes the JAX CLI's ``final_samples/`` layout (and, with ``--save_interm``,
its ``interm_samples_scale_{s}/`` frames, pixel for pixel as the JAX
package's ``save_interm_frames`` writes them); shared flags keep the JAX
CLI's defaults. ``--mode harmonization|style_transfer|roi`` write the JAX
CLI's files (``i2i_final_samples/``, ``unbatched_i2i_*/``,
``roi_patches.png``, ``final_samples/roi_out.png``); ``--profile`` writes a
trace; every flag of the JAX CLI is taken and parses as the JAX CLI parses
it."""

import numpy as np
import pytest
import torch
from PIL import Image

from sinddm_tpu.cli import build_parser as jax_build_parser
from sinddm_tpu_torch import cli
from sinddm_tpu_torch.models.convert import flatten_tree, random_flax_params
from torch_clip_draws import one_torch_thread  # noqa: F401  (fixture)

# the JAX CLI's flags that the port does not take: none
NOT_TAKEN = set()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = tmp_path_factory.mktemp("torch_cli_data")
    img = np.random.default_rng(0).uniform(0, 255, (96, 128, 3)).astype(np.uint8)
    Image.fromarray(img).save(folder / "tiny.png")
    return folder


@pytest.mark.parametrize("with_checkpoint", [False, True])
def test_sample_mode_writes_final_samples(dataset, tmp_path, with_checkpoint):
    argv = [
        "--mode", "sample", "--device", "cpu", "--dataset_folder", str(dataset),
        "--image_name", "tiny.png", "--results_folder", str(tmp_path), "--scope", "tiny",
        "--dim", "16", "--timesteps", "10", "--sample_batch_size", "2",
    ]
    if with_checkpoint:
        ckpt = tmp_path / "ema.npz"
        np.savez(ckpt, **flatten_tree(random_flax_params(dim=16, seed=4)))
        argv += ["--load_checkpoint", str(ckpt)]
    outs = cli.run(cli.build_parser().parse_args(argv))
    assert [tuple(o.shape[1:3]) for o in outs] == [(48, 64), (68, 91), (96, 128)]
    final = sorted(p.name for p in (tmp_path / "tiny" / "final_samples").iterdir())
    assert [n.split("_sample_")[0] for n in final] == ["out_s0", "out_s1", "out_s2"]
    (unbatched,) = (tmp_path / "tiny").glob("final_samples_unbatched_sample_*")
    assert sorted(p.name for p in unbatched.iterdir()) == ["out_b0.png", "out_b1.png"]
    assert (dataset / "scale_2" / "tiny.png").exists()  # pyramid saved beside the image


def test_sample_mode_save_interm_writes_every_step(dataset, tmp_path):
    argv = [
        "--mode", "sample", "--device", "cpu", "--dataset_folder", str(dataset),
        "--image_name", "tiny.png", "--results_folder", str(tmp_path), "--scope", "tiny",
        "--dim", "16", "--timesteps", "10", "--sample_batch_size", "1", "--sample_t_list", "2", "3",
        "--save_interm",
    ]
    cli.run(cli.build_parser().parse_args(argv))
    for s, n_steps in ((0, 10), (1, 2), (2, 3)):
        names = sorted(p.name for p in (tmp_path / "tiny" / f"interm_samples_scale_{s}").iterdir())
        assert names == [f"output_t-{t:03d}_s-{s}.png" for t in range(n_steps)]


def test_save_interm_frames_matches_jax(tmp_path):
    from PIL import Image as PILImage

    from sinddm_tpu.ops.image_io import save_interm_frames as jax_save_interm_frames
    from sinddm_tpu_torch.ops.image_io import save_interm_frames

    frames = np.random.default_rng(1).uniform(-1.1, 1.1, (3, 2, 5, 6, 3)).astype(np.float32)
    save_interm_frames(torch.tensor(frames), tmp_path / "ours", s=1, t_min=4)
    jax_save_interm_frames(frames, tmp_path / "theirs", s=1, t_min=4)
    names = sorted(p.name for p in (tmp_path / "theirs").iterdir())
    assert names == ["output_t-004_s-1.png", "output_t-005_s-1.png", "output_t-006_s-1.png"]
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == names
    for n in names:
        np.testing.assert_array_equal(np.asarray(PILImage.open(tmp_path / "ours" / n)),
                                      np.asarray(PILImage.open(tmp_path / "theirs" / n)))


def test_shared_flags_keep_the_jax_defaults():
    ours = vars(cli.build_parser().parse_args(["--mode", "sample"]))
    theirs = vars(jax_build_parser().parse_args(["--mode", "sample"]))
    shared = set(ours) & set(theirs)
    assert shared >= {"dim", "timesteps", "scale_factor", "sample_batch_size", "scale_mul",
                      "sample_t_list", "sample_limited_t", "omega", "seed", "compute_dtype",
                      "load_checkpoint", "dataset_folder", "image_name", "results_folder", "scope"}
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}
    assert ours["device"] == "cuda"


def test_configs_keep_the_jax_defaults():
    import dataclasses

    from sinddm_tpu import config as jax_config
    from sinddm_tpu_torch import config

    for name in ("DiffusionConfig", "SampleConfig"):
        assert dataclasses.asdict(getattr(config, name)()) == dataclasses.asdict(getattr(jax_config, name)())


def test_train_flags_keep_the_jax_defaults():
    """The training flags are the JAX CLI's, with its defaults, the mesh
    flags and the chunk flags among them."""
    ours = vars(cli.build_parser().parse_args(["--mode", "train"]))
    theirs = vars(jax_build_parser().parse_args(["--mode", "train"]))
    train = {"train_batch_size", "grad_accumulate", "train_num_steps", "save_and_sample_every", "avg_window",
             "train_lr", "sched_k_milestones", "load_milestone", "loss_factor", "load_reference_ckpt",
             "mesh_data", "mesh_spatial", "coordinator", "num_processes", "process_id", "steps_per_chunk",
             "fused_mode"}
    assert train <= set(ours) and {k: ours[k] for k in train} == {k: theirs[k] for k in train}


def test_train_mode_writes_checkpoints_and_resumes(dataset, tmp_path, capsys):
    """--mode train on the CPU (dim 8, 4 steps, a milestone every 2): the
    reference-layout checkpoints, the loss JSON, the EMA's scale-0 samples
    and the post-train walk; --load_milestone -1 resumes at step 4 and
    trains on to 6."""
    import json

    argv = [
        "--mode", "train", "--device", "cpu", "--dataset_folder", str(dataset), "--image_name", "tiny.png",
        "--results_folder", str(tmp_path), "--scope", "tiny", "--dim", "8", "--timesteps", "10",
        "--train_batch_size", "2", "--save_and_sample_every", "2", "--avg_window", "2", "--sample_batch_size", "1",
    ]
    outs = cli.run(cli.build_parser().parse_args(argv + ["--train_num_steps", "4"]))
    folder = tmp_path / "tiny"
    assert [tuple(o.shape) for o in outs] == [(1, 48, 64, 3), (1, 68, 91, 3), (1, 96, 128, 3)]
    for name in ("model-1.pt", "model-2.pt", "model-2.loss.json", "sample-1.png", "sample-2.png"):
        assert (folder / name).exists(), name
    assert len(json.loads((folder / "model-2.loss.json").read_text())["running_loss"]) == 2
    assert Image.open(folder / "sample-1.png").size == (4 * 64 + 10, 4 * 48 + 10)  # 16 samples, a 4x4 grid
    assert len(list(folder.glob("final_samples/out_s*_post_train_*.png"))) == 3
    data = torch.load(folder / "model-2.pt", weights_only=True)
    assert data["step"] == 4 and {"model", "ema", "sched", "opt", "running_loss"} <= set(data)
    capsys.readouterr()
    cli.run(cli.build_parser().parse_args(argv + ["--train_num_steps", "6", "--load_milestone", "-1"]))
    assert "resumed at step 4" in capsys.readouterr().out
    data = torch.load(folder / "model-3.pt", weights_only=True)
    assert data["step"] == 6 and len(data["running_loss"]) == 3 and data["sched"]["last_epoch"] == 6
    with pytest.raises(SystemExit, match="float32"):
        cli.run(cli.build_parser().parse_args(argv + ["--compute_dtype", "bfloat16"]))


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("extra,chunks", [(["--fused_mode", "padded", "--precompile"], {"padded": [3]}),
                                          (["--steps_per_chunk", "0"], {})])
def test_train_mode_takes_the_chunk_flags(dataset, tmp_path, capsys, monkeypatch, extra, chunks):
    """--fused_mode padded trains in padded chunks (3 steps, cut at the
    milestone), --steps_per_chunk 0 step by step; --precompile has nothing
    to build on the CPU and says so."""
    from sinddm_tpu_torch.training.trainer import MultiscaleTrainer

    seen = {}
    for name, method in (("grouped", "train_chunk_grouped"), ("padded", "train_chunk")):
        real = getattr(MultiscaleTrainer, method)
        monkeypatch.setattr(MultiscaleTrainer, method,
                            lambda self, n, real=real, name=name: (seen.setdefault(name, []).append(n),
                                                                   real(self, n))[1])
    argv = ["--mode", "train", "--device", "cpu", "--dataset_folder", str(dataset), "--image_name", "tiny.png",
            "--results_folder", str(tmp_path), "--scope", "tiny", "--dim", "8", "--timesteps", "10",
            "--train_batch_size", "1", "--train_num_steps", "3", "--save_and_sample_every", "3",
            "--sample_batch_size", "1"]
    cli.run(cli.build_parser().parse_args(argv + extra))
    assert seen == chunks
    assert len(torch.load(tmp_path / "tiny" / "model-1.pt", weights_only=True)["running_scale"]) == 3
    assert ("precompile: nothing to build on the CPU" in capsys.readouterr().out) == ("--precompile" in extra)


def test_modes_take_a_reference_checkpoint(dataset, tmp_path, capsys):
    """--load_reference_ckpt: a model-{milestone}.pt written by the JAX
    package's exporter is sampled from, and trained on from its step."""
    from sinddm_tpu.models.export_reference import save_reference_checkpoint
    from sinddm_tpu.schedules import make_schedules as jax_make_schedules

    ckpt = tmp_path / "model-7.pt"
    save_reference_checkpoint(str(ckpt), random_flax_params(dim=8, seed=1), random_flax_params(dim=8, seed=2),
                              jax_make_schedules(timesteps=10, scale_losses=(0.5, 0.4), n_scales=3), step=6)
    argv = ["--device", "cpu", "--dataset_folder", str(dataset), "--image_name", "tiny.png", "--results_folder",
            str(tmp_path), "--scope", "tiny", "--dim", "8", "--timesteps", "10", "--sample_batch_size", "1",
            "--load_reference_ckpt", str(ckpt)]
    cli.run(cli.build_parser().parse_args(["--mode", "sample"] + argv))
    assert "imported reference checkpoint at step 6" in capsys.readouterr().out
    cli.run(cli.build_parser().parse_args(["--mode", "train", "--train_batch_size", "1", "--train_num_steps", "8",
                                           "--save_and_sample_every", "4"] + argv))
    assert "imported reference checkpoint at step 6" in capsys.readouterr().out
    assert torch.load(tmp_path / "tiny" / "model-2.pt", weights_only=True)["step"] == 8


@pytest.mark.parametrize("mode", ["sample", "harmonization", "style_transfer", "roi", "clip_roi"])
def test_every_mode_keeps_the_jax_flags_and_defaults(mode):
    """The port takes every JAX CLI flag but NOT_TAKEN, with its default,
    in every mode; its --mode choices are the JAX CLI's nine."""
    ours = vars(cli.build_parser().parse_args(["--mode", mode]))
    theirs = vars(jax_build_parser().parse_args(["--mode", mode]))
    assert set(theirs) - set(ours) == NOT_TAKEN and set(ours) - set(theirs) == {"device"}
    shared = set(ours) & set(theirs)
    assert {k: ours[k] for k in shared} == {k: theirs[k] for k in shared}

    def choices(parser):
        (action,) = [a for a in parser._actions if a.dest == "mode"]
        return set(action.choices)

    assert choices(cli.build_parser()) == choices(jax_build_parser())


@pytest.mark.parametrize("argv", [["--precompile"], ["--fused_mode", "padded"], ["--steps_per_chunk", "4"]])
def test_flags_not_taken_are_refused(argv):
    """The three flags the port once refused parse as the JAX CLI parses
    them (the name is kept from then)."""
    dest = argv[0][2:]
    ours = vars(cli.build_parser().parse_args(["--mode", "train"] + argv))
    theirs = vars(jax_build_parser().parse_args(["--mode", "train"] + argv))
    assert ours[dest] == theirs[dest] != vars(cli.build_parser().parse_args(["--mode", "train"]))[dest]


@pytest.fixture(scope="module")
def i2i_dataset(dataset):
    """``{dataset}/i2i/``: a 70x100 input and a mask PNG with a box."""
    folder = dataset / "i2i"
    folder.mkdir(exist_ok=True)
    rng = np.random.default_rng(1)
    Image.fromarray(rng.integers(0, 256, (70, 100, 3), dtype=np.uint8)).save(folder / "input.png")
    mask = np.zeros((70, 100, 3), np.uint8)
    mask[20:40, 30:60] = 255
    Image.fromarray(mask).save(folder / "mask.png")
    return dataset


def _argv(dataset, tmp_path, mode, *extra):
    return ["--mode", mode, "--device", "cpu", "--dataset_folder", str(dataset), "--image_name", "tiny.png",
            "--results_folder", str(tmp_path), "--scope", "tiny", "--dim", "8", "--timesteps", "10",
            "--sample_batch_size", "2", "--input_image", "input.png", "--harm_mask", "mask.png", *extra]


@pytest.mark.usefixtures("one_torch_thread")
@pytest.mark.parametrize("mode,start_t", [("harmonization", 5), ("style_transfer", 3)])
def test_i2i_modes_write_the_jax_cli_files(i2i_dataset, tmp_path, mode, start_t):
    argv = _argv(i2i_dataset, tmp_path, mode, "--start_t_style", "3", "--save_interm")
    (final,) = cli.run(cli.build_parser().parse_args(argv))
    assert tuple(final.shape) == (2, 70, 100, 3) and 0.0 <= final.min() and final.max() <= 1.0
    folder = tmp_path / "tiny"
    grid = Image.open(folder / "i2i_final_samples" / f"input_i2i_{mode}.png")
    assert grid.size == (2 + 2 * 102, 2 + 72)  # two samples in a row, 2 px padding
    assert sorted(p.name for p in (folder / "unbatched_i2i_input").iterdir()) == ["out_b0.png", "out_b1.png"]
    assert Image.open(folder / "unbatched_i2i_input" / "out_b0.png").size == (100, 70)
    # --save_interm: the steps of the finest scale, the only one that runs
    frames = sorted(p.name for p in (folder / "interm_samples_scale_2").iterdir())
    assert frames == [f"output_t-{t:03d}_s-2.png" for t in range(start_t)]
    assert sorted(p.name for p in folder.iterdir() if p.name.startswith("interm")) == ["interm_samples_scale_2"]


@pytest.mark.usefixtures("one_torch_thread")
def test_roi_mode_writes_the_jax_cli_files(dataset, tmp_path):
    argv = _argv(dataset, tmp_path, "roi", "--target_roi", "10", "20", "30", "40", "--roi_bb", "50", "60", "20",
                 "30", "--roi_bb", "0", "0", "8", "8", "--scale_mul", "1", "1.5")
    outs = cli.run(cli.build_parser().parse_args(argv))
    assert [tuple(o.shape[1:3]) for o in outs] == [(48, 96), (68, 136), (96, 192)]
    folder = tmp_path / "tiny"
    preview = np.asarray(Image.open(folder / "roi_patches.png"))
    assert preview.shape == (96, 192, 3)  # the scale_mul canvas
    src = np.asarray(Image.open(dataset / "scale_2" / "tiny.png"))[10:40, 20:60]
    np.testing.assert_array_equal(preview[50:70, 60:90], np.asarray(Image.fromarray(src).resize((30, 20),
                                                                                                Image.NEAREST)))
    assert (preview[80:, 100:] == 255).all()
    final = Image.open(folder / "final_samples" / "roi_out.png")
    assert final.size == (2 + 2 * 194, 2 + 98)


def test_roi_mode_without_boxes_is_refused(dataset, tmp_path):
    for extra in ([], ["--target_roi", "1", "2", "3", "4"], ["--roi_bb", "1", "2", "3", "4"]):
        with pytest.raises(SystemExit, match="--roi mode needs --target_roi and --roi_bb"):
            cli.run(cli.build_parser().parse_args(_argv(dataset, tmp_path, "roi", *extra)))


def test_device_num_is_refused_with_the_cpu(dataset, tmp_path):
    with pytest.raises(SystemExit, match="--device_num"):
        cli.run(cli.build_parser().parse_args(_argv(dataset, tmp_path, "sample", "--device_num", "1")))


@pytest.mark.usefixtures("one_torch_thread")
def test_profile_writes_a_trace(dataset, tmp_path, capsys):
    import json

    argv = _argv(dataset, tmp_path, "sample", "--timesteps", "3", "--profile", str(tmp_path / "prof"))
    cli.run(cli.build_parser().parse_args(argv))
    assert f"profiler trace written to {tmp_path / 'prof'}" in capsys.readouterr().out
    (trace,) = (tmp_path / "prof").glob("*.pt.trace.json")
    names = {e.get("name", "") for e in json.loads(trace.read_text())["traceEvents"]}
    assert any("conv" in n for n in names)  # the denoiser's CPU ops are in it
