"""Kernel 2 (``csrc/dw_conv.cu``, the conv block's depthwise 5x5 with its
bias and condition) in a walk: the least time its launches could take
(bytes over HBM's peak, or FLOPs over the bf16 peak, whichever is larger)
over its device time, in %. Work from the traced denoiser calls' shapes
(``yardstick/work.py`` ``dw_work``)."""

from portbench.yardstick import work

KERNEL = "dw5x5"


def read(ctx):
    secs = ctx.trace.seconds_where(lambda n: KERNEL in n)
    calls = [s for s in ctx.spans if s[0] == "denoiser"]
    if secs <= 0 or not calls:
        return None
    item = 2 if ctx.traffic["compute_dtype"] == "bfloat16" else 4
    flops = nbytes = 0.0
    for _, b, h, w in calls:
        for c, _co in ctx.config["blocks"]:
            f, m = work.dw_work(b, h, w, c, item)
            flops, nbytes = flops + f, nbytes + m
    share, bound = work.roofline_share(flops, nbytes, secs, ctx.peaks, "bf16")
    ctx.log(f"[kernel2_roofline.sample] {flops / 1e9:.4f} GFLOP, {nbytes / 1e9:.4f} GB in {secs:.5f} s: "
            f"{100 * share:.4f}% of its roofline ({bound})")
    return 100 * share
