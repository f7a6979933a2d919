"""The median, over every request completed in the window, of the
milliseconds from its dispatch to its first token on the host."""

from bench.yardstick import percentile


def read(rec, run):
    return percentile([(c.done - c.dispatched) * 1e3 for c in rec.completions], 50)
