"""The device's idle share of the traced train window: one minus the union of
its operations' intervals over the window's length, in percent."""


def read(rec):
    if rec["kind"] != "train" or rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
