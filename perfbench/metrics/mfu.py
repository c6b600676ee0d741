"""mfu.replay / mfu.served: the count's FLOPs of the inferences or requests
completed in the window over the window times the card's float32 peak
(67 TFLOP/s without tensor cores), in %."""
from perfbench.counts import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    if not w.in_window:
        return None
    return 100.0 * ctx.flops * w.in_window / (w.seconds * PEAK_FLOPS)
