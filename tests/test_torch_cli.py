"""The port's CLI: ``--mode sample --device cpu`` on a tiny synthetic image
writes the JAX CLI's ``final_samples/`` layout (and, with ``--save_interm``,
its ``interm_samples_scale_{s}/`` frames, pixel for pixel as the JAX
package's ``save_interm_frames`` writes them); shared flags keep the JAX
CLI's defaults."""

import numpy as np
import pytest
import torch
from PIL import Image

from sinddm_tpu.cli import build_parser as jax_build_parser
from sinddm_tpu_torch import cli
from sinddm_tpu_torch.models.convert import flatten_tree, random_flax_params


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
