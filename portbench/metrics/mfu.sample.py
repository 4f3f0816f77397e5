"""The whole walk's share of the card's dense bf16 peak, in %: the
denoiser's forward FLOPs of every traced call (``yardstick/work.py``
``denoiser_flops_per_pixel``, the walk's count) over the traced window."""

from portbench.yardstick import work


def read(ctx):
    calls = [s for s in ctx.spans if s[0] == "denoiser"]
    if not calls:
        return None
    per_px = work.denoiser_flops_per_pixel(ctx.config["blocks"])
    flops = sum(b * h * w * per_px for _, b, h, w in calls)
    ctx.log(f"[mfu.sample] {len(calls)} denoiser calls, {flops / 1e12:.4f} TFLOP in {ctx.trace.window_s:.5f} s")
    return 100 * flops / ctx.trace.window_s / ctx.peaks["bf16"]
