"""Launch calls a reverse step of the traced walk: the CUDA calls that put
work on the card (kernel and graph launches, async copies and fills) that
start inside the walk's ``sinddm.step`` spans (``yardstick/spans.py``), per
step. A count: it moves only when the program's code changes. The log
gives, for each ``sinddm.scale`` span, kernel 1's and kernel 2's device ms
and kernel 1's share of its roofline, from the trace's kernel-1 and
kernel-2 operations in order, sliced by the scale span's snapshots of
``conv_block.launches`` and ``dw_conv.launches``."""

from portbench.yardstick import spans, work

KERNELS = (("kernel 1", "conv3x3_tc_kernel", "conv_block.launches"), ("kernel 2", "dw5x5", "dw_conv.launches"))


def by_scale(ctx, walk, scales):
    """Each scale's kernel-1 and kernel-2 device ms, and kernel 1's share of
    its roofline there, as log lines; None where the counters do not cover
    the trace's operations."""
    item = 2 if ctx.traffic["compute_dtype"] == "bfloat16" else 4
    b = walk.attrs.get("batch")
    lines = []
    for label, kernel, counter in KERNELS:
        ops = sorted((s, e) for s, e, n in ctx.trace.ops if kernel in n)
        base = scales[0].counts_open[counter]
        if scales[-1].counts_close[counter] - base != len(ops):
            return None
        parts = []
        for sc in scales:
            secs = sum(e - s for s, e in ops[sc.counts_open[counter] - base:sc.counts_close[counter] - base]) / 1e6
            part = f"s={sc.attrs['s']} {sc.attrs['H']}x{sc.attrs['W']} {sc.attrs['steps']} steps {1e3 * secs:.3f} ms"
            if kernel == KERNELS[0][1] and secs > 0:
                flops = nbytes = 0.0
                for c, co in ctx.config["blocks"]:
                    f, m = work.conv3x3_stage_work(b, sc.attrs["H"], sc.attrs["W"], c, co, item)
                    flops, nbytes = flops + f * sc.attrs["steps"], nbytes + m * sc.attrs["steps"]
                share, _ = work.roofline_share(flops, nbytes, secs, ctx.peaks, "bf16")
                part += f" ({100 * share:.3f}% of its roofline)"
            parts.append(part)
        lines.append(f"{label} by scale: " + "; ".join(parts))
    return lines


def read(ctx):
    placed = spans.place(ctx.trace, ctx.log)
    if not placed:
        return None
    walk, steps = spans.last_unit(placed, "sinddm.walk", "sinddm.step")
    if not steps:
        return None
    counts = spans.count_inside(steps, ctx.trace, spans.is_launch)
    _, calls = spans.last_unit(placed, "sinddm.walk", "sinddm.denoiser")
    in_calls = sum(spans.count_inside(calls, ctx.trace, spans.is_launch))
    ctx.log(f"[launches_per_step.sample] {sum(counts)} launch calls in {len(steps)} sinddm.step spans "
            f"({min(counts)}-{max(counts)} a step), {in_calls} of them in {len(calls)} sinddm.denoiser spans")
    _, scales = spans.last_unit(placed, "sinddm.walk", "sinddm.scale")
    lines = by_scale(ctx, walk, scales) if scales and scales[0].counts_open else None
    for line in lines or ["kernels by scale: the launch counters do not cover the trace's operations"]:
        ctx.log(f"[launches_per_step.sample] {line}")
    return sum(counts) / len(steps)
