"""The share of the traced window in which no operation ran on the device
(``torch.profiler``'s device activity, joined by the CUDA-event intervals
of hand kernels its trace did not see), in percent."""


def read(rec, run):
    if rec.device is None:
        return None
    return 100.0 * (1.0 - rec.device.busy_s / rec.device.window_s)
