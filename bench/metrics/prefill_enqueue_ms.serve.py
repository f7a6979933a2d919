"""The median over the window's requests of the host milliseconds of the
program's ``serve.prefill`` span: the time the host takes to launch a
prefill's work, up to the device."""

from bench.spans import host_ms


def read(rec, run):
    return host_ms("serve.prefill")
