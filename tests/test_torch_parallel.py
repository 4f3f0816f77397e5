"""The port's ('data', 'spatial') mesh on ``torch.distributed``: a world equals one process.

The JAX package holds its mesh to "sharded == one device"
(``tests/test_parallel.py``, ``tests/test_distributed.py``); the port takes
over that contract. Each world here is a set of gloo processes on the CPU
(``tests/torch_dist_worker.py``, one launch a world running all of its
checks), started together by one module fixture beside a CLI world:

* 2 x 2 (data x spatial): the split denoiser on an uneven batch and height,
  with the halo one row short as a control; ``sample_scales``; three train
  steps at ``l1`` and ``l1_pred_img``, the first also held against the JAX
  package's step sharded over a 2 x 2 mesh of its CPU devices; a grouped and
  a padded training chunk;
* data = 2: ``sample_scales``; one CLIP loss and gradient; the per-scale and
  the bucketed guided walk;
* spatial = 2: ``sample_scales``;
* ``--mode sample --mesh_data 2`` through the CLI on two processes against
  one; and a world that passes ``--device_num``, which must be refused.

Where the numbers come from: the port splits the work and keeps the state
whole (``parallel/mesh.py``), so every rank draws the single process's
random numbers. A split over image rows is bit-exact on the CPU (the
convolutions of a row crop sum as the whole image's do). A split over the
batch is not: PyTorch's CPU convolution picks its algorithm by batch size
(one 3x3 conv of 8 channels moved by 1.3e-5 from batch 1 to 2), so the
denoiser call moves by ~2e-6 and a 3-scale walk by ~8e-5; the bounds below
hold those. The CLIP loss split over the batch is exact here. The guided
walk carries the denoiser's differences through its thresholds, and is held
to the JAX package's two-process bounds (``tests/test_distributed.py``).

The JAX package is held in two places: the slabs of a spatial split,
computed in this process, against the JAX ``SinDDMNet``'s rows on its
8-device CPU mesh, as ``tests/test_parallel.py`` holds its own sharded call;
and the 2 x 2 world's first train step against the JAX trainer's loss and
gradients, jitted over a 2 x 2 mesh of those devices. The walks under a mesh
are held against the port's single process, which its own tests hold against
the JAX package's walks.
"""

from __future__ import annotations

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JaxNamedSharding, PartitionSpec as P
from PIL import Image

from sinddm_tpu.config import MeshConfig as JaxMeshConfig
from sinddm_tpu.diffusion.core import p_losses as jax_p_losses
from sinddm_tpu.models import SinDDMNet as FlaxSinDDMNet
from sinddm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from sinddm_tpu.schedules import make_schedules as jax_make_schedules
from sinddm_tpu_torch import cli
from sinddm_tpu_torch.config import MeshConfig
from sinddm_tpu_torch.models.convert import denoiser_from_flax, denoiser_params_from_flax, random_flax_params
from sinddm_tpu_torch.models.denoiser import RECEPTIVE_RADIUS
from sinddm_tpu_torch.parallel import distributed
from sinddm_tpu_torch.parallel.mesh import (
    Mesh,
    batch_sharding,
    halo_slab,
    replicated_sharding,
    require_named_sharding,
    split_model_fn,
    split_range,
)

import torch_dist_worker as worker
from torch_clip_draws import one_torch_thread  # noqa: F401  (fixture)

WORKER = Path(__file__).with_name("torch_dist_worker.py")
ROOT = WORKER.parents[1]
# name: (data, spatial, checks)
WORLDS = {
    "2x2": (2, 2, "split,sample,train,chunk"),
    "data2": (2, 1, "sample,clip,guided"),
    "spatial2": (1, 2, "sample"),
}
CLI_ARGS = ["--mode", "sample", "--device", "cpu", "--image_name", "tiny.png", "--scope", "tiny", "--dim", "8",
            "--timesteps", "10", "--sample_batch_size", "2"]
# bounds: the denoiser call, a walk (module docstring), train steps as tests/test_parallel.py holds them
SPLIT_ATOL, WALK_ATOL = 1e-5, 2e-4
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-5, 1e-6
# a chunk's parameters: within 1e-2 lr (lr 1e-3) of the single process's, the
# bound tests/test_torch_train.py holds steps to (Adam divides by sqrt(v), so
# a gradient near zero carries the batch split's ~1e-6 to a share of lr)
CHUNK_PARAM_ATOL = 1e-2 * 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("SINDDM_") and k not in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                                                        "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _cli_argv(dataset: Path, results: Path, *extra) -> list:
    return [sys.executable, "-m", "sinddm_tpu_torch.cli", *CLI_ARGS, "--dataset_folder", str(dataset),
            "--results_folder", str(results), *extra]


def _world_argv(port, n, extra_of_rank):
    return [["--coordinator", f"127.0.0.1:{port}", "--num_processes", str(n), "--process_id", str(r),
             *extra_of_rank] for r in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start every world and the CLI runs together; wait for all; return the
    workers' results, the CLI folders and the refused world's output."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    img = np.random.default_rng(0).uniform(0, 255, (96, 128, 3)).astype(np.uint8)
    procs = {}
    for name, (data, spatial, checks) in WORLDS.items():
        (tmp / name).mkdir()
        port, n = _free_port(), data * spatial
        for r in range(n):
            procs[f"{name}/{r}"] = [sys.executable, str(WORKER), str(port), str(r), str(n), str(data), str(spatial),
                                    str(tmp / name), checks]
    for run in ("cli_single", "cli_world", "cli_refused"):
        (tmp / run / "data").mkdir(parents=True)
        Image.fromarray(img).save(tmp / run / "data" / "tiny.png")
    procs["cli_single"] = _cli_argv(tmp / "cli_single" / "data", tmp / "cli_single")
    port = _free_port()
    for r, extra in enumerate(_world_argv(port, 2, ["--mesh_data", "2"])):
        procs[f"cli_world/{r}"] = _cli_argv(tmp / "cli_world" / "data", tmp / "cli_world", *extra)
    port = _free_port()
    for r, extra in enumerate(_world_argv(port, 2, ["--mesh_data", "2", "--device_num", "1"])):
        procs[f"cli_refused/{r}"] = _cli_argv(tmp / "cli_refused" / "data", tmp / "cli_refused", *extra)
    running = {k: subprocess.Popen(argv, cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                   text=True) for k, argv in procs.items()}
    outputs, codes = {}, {}
    try:
        for k, p in running.items():
            outputs[k], _ = p.communicate(timeout=300)
            codes[k] = p.returncode
    finally:
        for p in running.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = {k: f"rc={c}\n{outputs[k][-3000:]}" for k, c in codes.items() if c != 0 and "refused" not in k}
    assert not failed, "\n====\n".join(f"{k}: {v}" for k, v in failed.items())
    results = {name: [torch.load(tmp / name / f"rank{r}.pt", weights_only=False) for r in range(d * s)]
               for name, (d, s, _) in WORLDS.items()}
    return {"results": results, "tmp": tmp, "outputs": outputs, "codes": codes}


# ---- the layout, without a world ------------------------------------------


@pytest.mark.parametrize("n,parts", [(45, 2), (3, 2), (79, 4), (2, 4), (16, 16)])
def test_split_range_tiles_the_rows(n, parts):
    """Parts in order, each row once, sizes within one of each other."""
    ranges = [split_range(n, parts, i) for i in range(parts)]
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    sizes = [hi - lo for lo, hi in ranges]
    assert max(sizes) - min(sizes) <= 1
    for i, (lo, hi) in enumerate(ranges):
        assert halo_slab(n, parts, i, 16) == (lo, hi, max(0, lo - 16), min(n, hi + 16))


def test_receptive_radius_is_the_denoisers(one_torch_thread):  # noqa: F811
    """A change of one input row reaches exactly RECEPTIVE_RADIUS = 16 rows
    each side of the output (4 blocks of 5x5 + 3x3 + 3x3), not 17 as the
    JAX package's "35-px receptive field" would have it."""
    assert RECEPTIVE_RADIUS == 16
    model = denoiser_from_flax(random_flax_params(dim=8, seed=2), device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 65, 9, 3)).astype(np.float32))
    t, s = torch.tensor([20]), torch.tensor([1.0])
    bumped = x.clone()
    bumped[:, 32] += 1.0
    with torch.no_grad():
        diff = (model(bumped, t, s) - model(x, t, s)).abs().amax(dim=(0, 2, 3))
    changed = torch.nonzero(diff > 0).flatten().tolist()
    assert changed == list(range(32 - RECEPTIVE_RADIUS, 32 + RECEPTIVE_RADIUS + 1))


def test_mesh_config_keeps_the_jax_fields_and_messages():
    assert MeshConfig().n_devices == 1 and MeshConfig(2, 3).n_devices == 6
    assert MeshConfig().build(world_size=1) is None
    for cfg in (MeshConfig(2, 1), MeshConfig(4, 2)):
        for batch in (7, 8):
            theirs = ours = None
            try:
                JaxMeshConfig(cfg.data, cfg.spatial).validate_batch(batch, "--sample_batch_size")
            except ValueError as e:
                theirs = str(e)
            try:
                cfg.validate_batch(batch, "--sample_batch_size")
            except ValueError as e:
                ours = str(e)
            assert ours == theirs


@pytest.mark.parametrize("cfg,world", [(MeshConfig(2, 1), 1), (MeshConfig(1, 1), 2), (MeshConfig(2, 2), 2),
                                       (MeshConfig(1, 2), 4)])
def test_mesh_config_refuses_a_world_of_another_size(cfg, world):
    """More ranks than the mesh uses, or fewer: an error that says how many."""
    with pytest.raises(ValueError, match=f"needs {cfg.n_devices} ranks; the world has {world}"):
        cfg.build(world_size=world)


def test_cli_refuses_mesh_flags_without_a_world(tmp_path):
    """No silent fall-back to one process when a mesh was asked for."""
    with pytest.raises(SystemExit, match="needs 2 ranks; the world has 1"):
        cli.run(cli.build_parser().parse_args(["--mode", "sample", "--device", "cpu", "--mesh_data", "2",
                                               "--results_folder", str(tmp_path)]))


@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cpu", 2, 0, ("gloo", "cpu")),
    ("cpu", 2, 4, ("gloo", "cpu")),
    ("cuda", 4, 4, ("nccl", "cuda:3")),
    ("cuda", 2, 1, ("gloo", "cuda:0")),
])
def test_backend_rule(device, local_world, cards, want):
    """NCCL with a card a local rank, gloo where ranks share a card, gloo on
    the CPU when asked (here local rank 3 of 4, or 1 of 2)."""
    backend, dev, why = distributed.choose_backend(device, local_world - 1, local_world, cards)
    assert (backend, str(dev)) == want and why


@pytest.mark.parametrize("device,world,cards,coordinator,local,want", [
    ("cuda", 8, 4, "10.0.0.1:1234", None, None),  # 2 hosts x 4 cards, flags alone: ask
    ("cuda", 8, 4, "10.0.0.1:1234", (1, 4), (1, 4)),
    ("cuda", 2, 1, "127.0.0.1:1234", None, (1, 2)),  # loopback: one host, ranks share the card
    ("cuda", 4, 4, "10.0.0.1:1234", None, (1, 4)),  # a card for each rank, on any host
    ("cpu", 8, 0, "10.0.0.1:1234", None, (1, 8)),
])
def test_local_layout_is_known_or_asked_for(monkeypatch, device, world, cards, coordinator, local, want):
    """Rank 1's local rank and local world: LOCAL_RANK / LOCAL_WORLD_SIZE,
    or the flags where they cannot be wrong; a CUDA world whose hosts the
    flags do not tell apart stops rather than run gloo where NCCL could."""
    for name, value in zip(("LOCAL_RANK", "LOCAL_WORLD_SIZE"), local or (None, None)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, str(value))
    if want is None:
        with pytest.raises(ValueError, match="Set LOCAL_RANK and LOCAL_WORLD_SIZE"):
            distributed.local_layout(1, world, device, cards, coordinator)
    else:
        assert distributed.local_layout(1, world, device, cards, coordinator) == want


def test_backend_rule_never_falls_back_to_the_cpu():
    with pytest.raises(RuntimeError, match="CUDA card"):
        distributed.choose_backend("cuda", 0, 2, 0)


def test_outside_a_world_nothing_is_joined():
    assert not distributed.initialize(device="cpu")
    assert not distributed.is_initialized() and distributed.process_count() == 1 and distributed.is_primary()
    distributed.barrier()  # a no-op
    np.testing.assert_array_equal(distributed.fetch(torch.arange(3.0)), [0.0, 1.0, 2.0])


@pytest.mark.parametrize("wrong", [object(), "data", JaxNamedSharding(jax_make_mesh(), P("data"))])
def test_require_named_sharding_rejects_other_types(wrong):
    assert require_named_sharding(None) is None
    with pytest.raises(TypeError, match="NamedSharding"):
        require_named_sharding(wrong)


def test_a_sharding_with_nothing_to_split_leaves_the_call_alone():
    """Replicated, or split over axes of one rank: no collective, the call
    itself (a mesh object stands in for a world here)."""
    fn = lambda x, t, s: x  # noqa: E731
    assert split_model_fn(fn, replicated_sharding(Mesh(2, 2, 3, {}))) is fn
    assert split_model_fn(fn, batch_sharding(Mesh(1, 1, 0, {}))) is fn
    assert Mesh(2, 2, 3, {}).coords == (1, 1) and Mesh(4, 1, 2, {}).coords == (2, 0)


def test_slabs_match_the_jax_denoisers_rows(one_torch_thread):  # noqa: F811
    """Each of four spatial slabs (with the halo) computed here against the
    rows of the JAX denoiser sharded ('data' 2, 'spatial' 4) over its
    8-device CPU mesh (tests/test_parallel.py's bound); one row less of halo
    breaks it."""
    params = random_flax_params(dim=8, seed=9)
    h, w = 64, 48
    x = np.random.default_rng(10).standard_normal((2, h, w, 3)).astype(np.float32)
    t = np.asarray([5, 50])
    flax_model = FlaxSinDDMNet(dim=8)
    mesh = jax_make_mesh(spatial=4)
    x_sh = jax.device_put(jnp.asarray(x), JaxNamedSharding(mesh, P("data", "spatial", None, None)))
    theirs = np.asarray(jax.jit(lambda xx: flax_model.apply({"params": params}, xx, jnp.asarray(t),
                                                            jnp.asarray(1.0)))(x_sh))
    model = denoiser_from_flax(params, device="cpu")
    worst, worst_short = 0.0, 0.0
    with torch.no_grad():
        for i in range(4):
            for halo in (RECEPTIVE_RADIUS, RECEPTIVE_RADIUS - 1):
                lo, hi, in_lo, in_hi = halo_slab(h, 4, i, halo)
                ours = model(torch.from_numpy(x[:, in_lo:in_hi]), torch.from_numpy(t), 1.0)[:, lo - in_lo : hi - in_lo]
                err = np.abs(ours.numpy() - theirs[:, lo:hi]).max()
                if halo == RECEPTIVE_RADIUS:
                    worst = max(worst, err)
                else:
                    worst_short = max(worst_short, err)
    assert worst <= 1e-5, worst
    assert worst_short > 1e-4, worst_short


# ---- the worlds ----------------------------------------------------------------


def test_mesh_lays_ranks_out_data_major(runs):
    """Coordinates rank by rank, and the rows of a batch of 5 each owns."""
    assert [r["coords"] for r in runs["results"]["2x2"]] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert [r["rows"] for r in runs["results"]["2x2"]] == [slice(0, 3), slice(0, 3), slice(3, 5), slice(3, 5)]
    assert [r["coords"] for r in runs["results"]["data2"]] == [(0, 0), (1, 0)]
    assert [r["coords"] for r in runs["results"]["spatial2"]] == [(0, 0), (0, 1)]


def test_split_denoiser_matches_the_single_call(runs):
    """data 2 x spatial 2 on a 3 x 45 x 13 input (rows 2 + 1, 23 + 22), on
    every rank; each rank's block computed with a halo one row short must
    break the bound."""
    ranks = [r["split"] for r in runs["results"]["2x2"]]
    single = ranks[0]["single"]
    for r in ranks:
        assert torch.equal(r["split"], ranks[0]["split"])
    err = (ranks[0]["split"] - single).abs().max().item()
    short = max((block - single[rows, cols]).abs().max().item() for rows, cols, block in
                (r["short_halo"] for r in ranks))
    assert err <= SPLIT_ATOL, err
    assert short > 10 * SPLIT_ATOL, short


@pytest.mark.parametrize("world", sorted(WORLDS))
def test_sample_scales_matches_the_single_process(runs, world):
    """Every rank returns the whole outputs; a split over rows alone is exact."""
    ranks = [r["sample"] for r in runs["results"][world]]
    single = ranks[0]["single"]
    for r in ranks:
        for a, b in zip(r["split"], ranks[0]["split"]):
            assert torch.equal(a, b)
    for ours, ref in zip(ranks[0]["split"], single):
        assert ours.shape == ref.shape
        if WORLDS[world][0] == 1:
            assert torch.equal(ours, ref)
        else:
            assert (ours - ref).abs().max().item() <= WALK_ATOL


@pytest.mark.parametrize("loss_type", ["l1", "l1_pred_img"])
def test_train_steps_match_the_single_process(runs, loss_type):
    """Three steps at data 2 x spatial 2: the losses (the first step's
    whole-batch t[0] is 0, the other batch part's first row is not: the
    l1_pred_img target must test the batch's) and the parameters."""
    rank0 = runs["results"]["2x2"][0]["train"][loss_type]
    np.testing.assert_allclose(rank0["split"]["losses"], rank0["single"]["losses"], rtol=TRAIN_LOSS_RTOL, atol=0)
    for k, v in rank0["single"]["params"].items():
        np.testing.assert_allclose(rank0["split"]["params"][k].numpy(), v.numpy(), atol=TRAIN_PARAM_ATOL, rtol=0,
                                   err_msg=k)


def test_train_parameters_are_equal_across_ranks(runs):
    ranks = [r["train"] for r in runs["results"]["2x2"]]
    for loss_type in ("l1", "l1_pred_img"):
        first = ranks[0][loss_type]["split"]
        for r in ranks[1:]:
            assert r[loss_type]["split"]["losses"] == first["losses"]
            for k, v in first["params"].items():
                assert torch.equal(r[loss_type]["split"]["params"][k], v), k


@pytest.mark.parametrize("mode", ["grouped", "padded"])
def test_train_chunk_matches_the_single_process(runs, mode):
    """A grouped chunk of 3 steps and a padded chunk of 2 (its canvas split
    over rows and the batch, the valid mask on each rank's rows) at data 2 x
    spatial 2: the scales visited, the losses and the parameters against the
    single process's chunk; the parameters equal across ranks."""
    ranks = [r["chunk"][mode] for r in runs["results"]["2x2"]]
    split, single = ranks[0]["split"], ranks[0]["single"]
    assert split["scales"] == single["scales"] and len(single["scales"]) == (3 if mode == "grouped" else 2)
    np.testing.assert_allclose(split["losses"], single["losses"], rtol=TRAIN_LOSS_RTOL, atol=0)
    for k, v in single["params"].items():
        np.testing.assert_allclose(split["params"][k].numpy(), v.numpy(), atol=CHUNK_PARAM_ATOL, rtol=0, err_msg=k)
    for r in ranks[1:]:
        assert r["split"]["losses"] == split["losses"]
        assert all(torch.equal(r["split"]["params"][k], v) for k, v in split["params"].items())


@pytest.fixture(scope="module")
def jax_sharded_step():
    """The JAX trainer's loss and gradients of one step (``_build_step_fn``'s
    ``loss_fn``: the denoiser's input constrained to B over 'data', H over
    'spatial') at the finest scale, with the worker's first draws, jitted
    over a 2 x 2 mesh of the JAX package's CPU devices; both loss types."""
    pyr = worker.pyramid()
    jsched = jax_make_schedules(timesteps=100, scale_losses=worker.LOSSES, n_scales=3)
    model = FlaxSinDDMNet(dim=worker.DIM)
    mesh = jax_make_mesh(jax.devices()[:4], spatial=2)
    batch, repl = (JaxNamedSharding(mesh, spec) for spec in (P("data", "spatial", None, None), P()))

    @jax.jit
    def steps(params, x_orig, x_blur, t, noise):
        def model_fn(p):
            return lambda x, tt, sc: model.apply({"params": p}, jax.lax.with_sharding_constraint(x, batch), tt, sc)

        return {loss_type: jax.value_and_grad(lambda p: jnp.mean(jnp.stack([jax_p_losses(
            model_fn(p), jsched, x_blur, t, noise, s=2, x_orig=x_orig, loss_type=loss_type)])))(params)
            for loss_type in ("l1", "l1_pred_img")}

    t, noise = worker.train_draws()
    args = [random_flax_params(dim=worker.DIM, seed=worker.TRAIN_PARAMS_SEED), pyr.images[2][None],
            pyr.recon_images[2][None], t, noise]
    out = steps(*(jax.device_put(jax.tree.map(jnp.asarray, a), repl) for a in args))
    return {k: (float(loss), denoiser_params_from_flax(jax.tree.map(np.asarray, grads)))
            for k, (loss, grads) in out.items()}


@pytest.mark.parametrize("loss_type", ["l1", "l1_pred_img"])
def test_train_step_matches_the_jax_sharded_step(runs, jax_sharded_step, loss_type):
    """The 2 x 2 world's first step (whole-batch denominator, the batch's
    t[0], the gradients summed over the ranks) against the JAX package's
    step on its own 2 x 2 mesh, from the same parameters and draws: the
    loss and the gradients at tests/test_torch_train.py's bounds."""
    loss, grads = jax_sharded_step[loss_type]
    for rank in runs["results"]["2x2"]:
        ours = rank["train"][loss_type]["split_from_flax"]
        np.testing.assert_allclose(ours["loss"], loss, rtol=TRAIN_LOSS_RTOL, atol=0)
        assert ours["grads"].keys() == grads.keys()
        g_max = max(g.abs().max().item() for g in grads.values())
        g_err = max((ours["grads"][k] - grads[k]).abs().max().item() for k in grads)
        assert g_err <= 1e-5 * g_max, g_err / g_max


def test_clip_loss_split_over_data_matches_the_single_call(runs):
    """A batch of 3 over two ranks (2 + 1 images): the summed loss and the
    gathered gradient, on both ranks."""
    ranks = [r["clip"] for r in runs["results"]["data2"]]
    loss, grad = ranks[0]["single"]
    for r in ranks:
        assert r["split"][0].item() == pytest.approx(loss.item(), rel=1e-6)
        assert (r["split"][1] - grad).abs().max().item() <= 1e-6 * grad.abs().max().item()


@pytest.mark.parametrize("walk", ["per_scale", "bucketed"])
def test_guided_walk_matches_the_single_process(runs, walk):
    """data 2, batch 2, guidance at the via scales; the JAX package's
    two-process bounds on every output and the clip scores."""
    ranks = runs["results"]["data2"]
    split = ranks[0]["guided"][walk]["split"]
    single = ranks[0 if walk == "per_scale" else 1]["guided"][walk]["single"]
    assert torch.equal(ranks[1]["guided"][walk]["split"]["outs"][-1], split["outs"][-1])
    for ours, ref in zip(split["outs"], single["outs"]):
        diff = (ours - ref).abs()
        assert bool(torch.isfinite(ours).all())
        assert (diff > 1e-4).float().mean().item() < 0.05
        assert (diff > 0.1).float().mean().item() < 0.005
        assert diff.max().item() < 0.5
    assert sum(s.numel() for s in single["scores"]) > 0
    for ours, ref in zip(split["scores"], single["scores"]):
        np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=1e-3)


def _pngs(folder: Path) -> list:
    return sorted(p.relative_to(folder).as_posix() for p in folder.rglob("*.png"))


def test_cli_on_two_processes_writes_one_set_of_files(runs):
    """--mode sample --mesh_data 2 on two processes: the primary writes the
    one process's files (the same names, one set), equal within a level of
    8 bits (the walk's WALK_ATOL on [-1, 1] may round a value the other way)."""
    single, world = runs["tmp"] / "cli_single" / "tiny", runs["tmp"] / "cli_world" / "tiny"
    def unstamped(name):  # the file names carry the run's time
        return re.sub(r"_sample_[^/]+?(\.png$|/)", r"_sample\1", name)

    names = _pngs(single)
    assert len(names) == 3 + 2  # a grid a scale, and the two samples of the finest
    assert sorted(map(unstamped, _pngs(world))) == sorted(map(unstamped, names))
    for a, b in zip(sorted(names, key=unstamped), sorted(_pngs(world), key=unstamped)):
        pa, pb = (np.asarray(Image.open(f / n), np.int16) for f, n in ((single, a), (world, b)))
        assert np.abs(pa - pb).max() <= 1, (a, b)
    out = runs["outputs"]["cli_world/0"]
    assert "mesh: {'data': 2, 'spatial': 1} backend gloo" in out
    assert "saved 3 scales" in out and "saved 3 scales" not in runs["outputs"]["cli_world/1"]


def test_cli_refuses_device_num_in_a_world(runs):
    for r in range(2):
        assert runs["codes"][f"cli_refused/{r}"] != 0
        assert "--device_num is refused in a world" in runs["outputs"][f"cli_refused/{r}"]
