"""The model operations of the completed work (``yardstick.forward_flops``
or ``train_step_flops``, reckoned from shapes) over the window's seconds
times the bf16 peak, in percent."""

from bench.yardstick import PEAK_BF16_FLOPS


def read(rec, run):
    return 100.0 * sum(c.flops for c in rec.completions) / (rec.window_s * PEAK_BF16_FLOPS)
