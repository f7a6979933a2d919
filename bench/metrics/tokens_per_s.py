"""Prompt tokens of every request completed in the window over the time
from the window's start to the last completion."""


def read(rec, run):
    return sum(c.tokens for c in rec.completions) / rec.window_s
