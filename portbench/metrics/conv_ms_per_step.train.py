"""Device ms a train step in cuDNN's and cuBLAS's convolution and product
kernels (forward and backward, their FFT, layout and pointwise complex
products included), picked by name, over the traced chunk."""

from portbench.yardstick.trace import matcher

CONV = ("conv", "cudnn", "xmma", "implicit", "winograd", "dgrad", "wgrad", "fprop", "cutlass", "sm90", "gemm",
        "nvjet", "fft", "complex")


def read(ctx):
    steps = [s for s in ctx.spans if s[0] == "train_step"]
    secs = ctx.trace.seconds_where(matcher(*CONV))
    if not steps or secs <= 0:
        return None
    ctx.log(f"[conv_ms_per_step.train] {secs:.5f} s of {ctx.trace.busy_s:.5f} s busy in convolutions, "
            f"{len(steps)} steps")
    return 1e3 * secs / len(steps)
