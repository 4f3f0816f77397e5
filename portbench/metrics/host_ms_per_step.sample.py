"""The host's own ms a reverse step of the traced walk: the mean, over its
``sinddm.step`` spans (``diffusion/core.py`` ``p_sample_step``, the denoiser
call inside it), of each span's duration less the parts in which the host
waits: for a full launch queue, in a synchronizing CUDA call, or on CUPTI's
buffers (``yardstick/spans.py``). Once the launch queue is full a step's
span lasts as long as the card's pace, whatever the host costs; this is
what is left. The log gives the median and p90, the ``sinddm.denoiser``
spans' share, the device's busy ms a step and the headroom (device ms over
host ms a step), and the walk's idle gaps named by program span."""

from portbench.yardstick import spans


def read(ctx):
    placed = spans.place(ctx.trace, ctx.log)
    if not placed:
        return None
    walk, steps = spans.last_unit(placed, "sinddm.walk", "sinddm.step")
    if not steps:
        return None
    waits = spans.host_ranges(ctx.trace, spans.is_wait)
    host = spans.host_us(steps, waits)
    _, calls = spans.last_unit(placed, "sinddm.walk", "sinddm.denoiser")
    in_calls = sum(spans.host_us(calls, waits))
    mean_ms = sum(host) / len(host) / 1e3
    busy_ms = 1e3 * ctx.trace.busy_s / len(steps)
    ctx.log(f"[host_ms_per_step.sample] host ms a step: {spans.summary([h / 1e3 for h in host])} sinddm.step "
            f"spans of the walk (batch {walk.attrs.get('batch')}); spans' own ms {sum(s.us for s in steps) / 1e3:.3f},"
            f" waits inside them {(sum(s.us for s in steps) - sum(host)) / 1e3:.3f}; sinddm.denoiser "
            f"{100 * in_calls / max(sum(host), 1e-9):.2f}% of the steps' host time over {len(calls)} calls")
    ctx.log(f"[host_ms_per_step.sample] {spans.in_launches_us(steps, ctx.trace, waits) / 1e3:.3f} of the steps' "
            f"{sum(host) / 1e3:.3f} host ms inside launch calls, the rest between them")
    ctx.log(f"[host_ms_per_step.sample] device busy {busy_ms:.4f} ms a step ({ctx.trace.busy_s:.6f} s over "
            f"{len(steps)} steps); headroom {busy_ms / max(mean_ms, 1e-9):.3f}x (device ms / host ms a step)")
    ctx.log(f"[host_ms_per_step.sample] idle by program span | CUDA call: {spans.idle_by_span(ctx.trace, placed)}")
    return mean_ms
