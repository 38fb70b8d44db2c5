"""Device kernels launched a training step (the launcher's layer): the kernels
the traced window ran, divided by the steps it ran."""


def read(rec):
    if rec["kind"] != "train" or not rec["kernels"] or not rec["steps"]:
        return None
    return sum(count for count, _ in rec["kernels"].values()) / rec["steps"]
