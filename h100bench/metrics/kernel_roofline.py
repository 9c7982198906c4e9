"""kernel_roofline: the kernel layer's calls against the HBM roofline, in
%: the sum over calls of their bytes (each input read once, each output
written once) over the card's peak rate, divided by the device time inside
those calls."""


def read(run):
    t = run.trace
    if t is None or t.layer_s <= 0 or not run.hbm_bytes_per_s:
        return None
    return t.layer_bytes / run.hbm_bytes_per_s / t.layer_s * 100
