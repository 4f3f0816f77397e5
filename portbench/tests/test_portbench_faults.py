"""A run on the CPU at a tiny size, past the harness's look for a card,
with the timed path broken underneath: each fault a cell can have makes
``correct`` come out false. (The exchange between cards is no fault these
one-card cells can have.)"""

import pytest
import torch

from portbench_tiny import run_tiny


def finest_unchanged(monkeypatch):
    """A reverse step that returns its state unchanged (the finest scale's last)."""
    from sinddm_tpu_torch.diffusion import core

    orig = core.p_sample_step

    def step(model_fn, sched, x, t, noise_fn, *, s, **kw):
        out = orig(model_fn, sched, x, t, noise_fn, s=s, **kw)
        return (x,) + tuple(out[1:]) if (s == sched.n_scales - 1 and t == 0) else out
    monkeypatch.setattr(core, "p_sample_step", step)


def half_batch_left_out(monkeypatch):
    """The denoiser computes the first half of the batch; the rest stays zero."""
    from sinddm_tpu_torch.models.denoiser import SinDDMNet

    orig = SinDDMNet.forward

    def forward(self, x, t, s, mask=None):
        eps = orig(self, x, t, s, mask)
        h = x.shape[0] // 2
        return torch.cat([eps[:h], torch.zeros_like(eps[h:])])
    monkeypatch.setattr(SinDDMNet, "forward", forward)


def answer_altered(monkeypatch):
    """One image of the finest scale's output altered where it is produced."""
    from sinddm_tpu_torch.apps import sampling

    orig = sampling.sample_via_scale

    def via(model_fn, sched, img_prev, *, s, **kw):
        x, carry, aux = orig(model_fn, sched, img_prev, s=s, **kw)
        if s == sched.n_scales - 1:
            x = x.clone()
            x[0] = -x[0]
        return x, carry, aux
    monkeypatch.setattr(sampling, "sample_via_scale", via)


def state_unchanged(monkeypatch):
    """Adam's update does nothing: every step returns the parameters unchanged."""
    import importlib

    monkeypatch.setattr(importlib.import_module("torch.optim.adam"), "adam", lambda *args, **kwargs: None)


def half_batch_mean(monkeypatch):
    """A step's loss over the first half of its batch, the mean taken over the rest."""
    from sinddm_tpu_torch.diffusion import core
    from sinddm_tpu_torch.training import trainer

    orig = trainer.training_loss

    def loss(model_fn, sched, x_orig, x_blurry, *, s, batch_size, generator=None, t=None, noise=None, **kw):
        t, noise = core.training_draws(sched, x_orig, s=s, batch_size=batch_size, generator=generator, t=t,
                                       noise=noise)
        h = batch_size // 2
        return orig(model_fn, sched, x_orig, x_blurry, s=s, batch_size=h, t=t[:h], noise=noise[:h], **kw)
    monkeypatch.setattr(trainer, "training_loss", loss)


@pytest.mark.parametrize("cell, fault", [
    ("sample-b16-fp32", finest_unchanged),
    ("sample-b16-fp32", half_batch_left_out),
    ("sample-b16-fp32", answer_altered),
    ("train-b32-graph", state_unchanged),
    ("train-b32-graph", half_batch_mean),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault, monkeypatch, one_thread):
    fault(monkeypatch)
    out = run_tiny(cell)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
