"""The augmentation kernel's share of its roofline: the least time its
bytes need at the card's published bandwidth (the image sectors its taps
read under the window's draws, both views out, the parameters in) over
the kernel's mean device time in the trace. The kernel is bound by bytes:
its float work is a few operations a byte."""


def read(run):
    if run.trace is None or not run.peaks or not run.kernel_bytes_per_launch:
        return None
    total_ns, launches = run.trace.time_by(lambda name: "two_view_augment" in name)
    if not launches or not total_ns:
        return None
    least_s = run.kernel_bytes_per_launch / run.peaks[1]
    return 100.0 * least_s / (total_ns / launches / 1e9)
