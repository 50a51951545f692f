"""``device.idle_share.train``: the share of the traced window, in %, in which
no operation ran on the card: 1 − (the union of the device operations'
intervals) / (the window)."""


def read(run):
    if not run.trace.device_ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
