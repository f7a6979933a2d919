"""Tokens (batch x sequence) of every train step completed in the window
over the time from the window's start to the last step's completion (its
loss read on the host)."""


def read(rec, run):
    return sum(c.tokens for c in rec.completions) / rec.window_s
