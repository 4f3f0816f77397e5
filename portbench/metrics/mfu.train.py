"""The traced chunk's share of the card's dense bf16 peak, in %: 3x the
denoiser's forward FLOPs of each step at its scale's size (forward and
backward, ``yardstick/work.py``), over the traced window."""

from portbench.yardstick import work


def read(ctx):
    steps = [s for s in ctx.spans if s[0] == "train_step"]
    if not steps:
        return None
    per_px = work.denoiser_flops_per_pixel(ctx.config["blocks"])
    flops = sum(3 * b * h * w * per_px for _, _s, b, h, w in steps)
    ctx.log(f"[mfu.train] {len(steps)} steps, {flops / 1e12:.4f} TFLOP in {ctx.trace.window_s:.5f} s")
    return 100 * flops / ctx.trace.window_s / ctx.peaks["bf16"]
