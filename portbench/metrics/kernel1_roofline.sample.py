"""Kernel 1 (``csrc/conv_block.cu``, the conv block's two 3x3 stages) in a
walk: the least time its launches could take, FLOPs over the dense bf16
peak or bytes over HBM's, whichever is larger, over the kernel's device
time, in %. The peak is bf16's whatever the walk's type, so that no split
of fp32 products can read over 100%; the share of the 3xTF32 ceiling
(TF32 / 3) goes to the log as information. Work from the traced denoiser
calls' shapes (``yardstick/work.py`` ``conv3x3_stage_work``)."""

from portbench.yardstick import work

KERNEL = "conv3x3_tc_kernel"


def read(ctx):
    secs = ctx.trace.seconds_where(lambda n: KERNEL in n)
    calls = [s for s in ctx.spans if s[0] == "denoiser"]
    if secs <= 0 or not calls:
        return None
    item = 2 if ctx.traffic["compute_dtype"] == "bfloat16" else 4
    flops = nbytes = 0.0
    for _, b, h, w in calls:
        for c, co in ctx.config["blocks"]:
            f, m = work.conv3x3_stage_work(b, h, w, c, co, item)
            flops, nbytes = flops + f, nbytes + m
    share, bound = work.roofline_share(flops, nbytes, secs, ctx.peaks, "bf16")
    ctx.log(f"[kernel1_roofline.sample] {flops / 1e12:.4f} TFLOP, {nbytes / 1e9:.4f} GB in {secs:.5f} s: "
            f"{100 * share:.4f}% of the bf16/HBM roofline ({bound}); "
            f"{100 * flops / (ctx.peaks['tf32'] / 3) / secs:.3f}% of the 3xTF32 ceiling")
    return 100 * share
