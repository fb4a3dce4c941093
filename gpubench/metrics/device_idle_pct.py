"""Share of the traced window in which no kernel or copy ran on the
card, in %: one minus the union of the device events over the window."""


def read(w):
    if w.trace is None or w.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - w.trace.busy_s() / w.trace.window_s)
