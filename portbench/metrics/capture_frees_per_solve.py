"""Inner loop (solver/inner.py): the CUDA caching allocator's device
frees (``cudaFree``) per traced solve inside the port's
``sdplr.inner.capture`` spans, from its ``inner.capture_frees`` counter.
A port that captures into a kept memory pool counts
``inner.pooled_captures`` beside it; where it counts none in the traced
solves (a port without the pool, or no capture), there is nothing to
read."""


def read(ctx):
    if ctx.counts is None or not ctx.traced:
        return None
    if not ctx.counts["inner.pooled_captures"]:
        return None
    return ctx.counts["inner.capture_frees"] / len(ctx.traced)
