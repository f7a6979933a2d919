"""The attention forward of training (``kernels/flash_attention.py::
flash_attention_lse``: the flash kernel's launch that also writes the row
log-sum-exp; forward and recompute): the least time its calls' work needs
at the H100's peaks over their device time (CUDA events), in percent."""

from bench.yardstick import attention_fwd_work, bound_s

WRAP = ("repro_torch.kernels.flash_attention", "flash_attention_lse")
KERNELS = ("flash_tc_kernel", "flash_kernel")


def work(args, kwargs):
    q, k = args[0], args[1]
    return attention_fwd_work(q.shape, k.shape, kwargs.get("causal", True), q.element_size(),
                              kwargs.get("q_offset", 0), lse=True)


def read(rec, run):
    calls = rec.calls.get("repro_torch.kernels.flash_attention:flash_attention_lse")
    if not calls:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b, *_ in calls) / sum(c[2] for c in calls)
