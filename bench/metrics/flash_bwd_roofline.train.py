"""The attention backward of training (``kernels/flash_attention.py::
flash_attention_bwd``, ``csrc/flash_attention_bwd.cu``): the least time
its calls' work needs at the H100's peaks (five products) over their
device time (CUDA events), in percent."""

from bench.yardstick import attention_bwd_work, bound_s

WRAP = ("repro_torch.kernels.flash_attention", "flash_attention_bwd")
KERNELS = ("dkdv_kernel", "dq_kernel", "stats_kernel", "delta_kernel")


def work(args, kwargs):
    q, k = args[1], args[2]
    return attention_bwd_work(q.shape, k.shape, kwargs.get("causal", True), q.element_size(),
                              kwargs.get("q_offset", 0))


def read(rec, run):
    calls = rec.calls.get("repro_torch.kernels.flash_attention:flash_attention_bwd")
    if not calls:
        return None
    return 100.0 * sum(bound_s(f, b) for f, b, *_ in calls) / sum(c[2] for c in calls)
