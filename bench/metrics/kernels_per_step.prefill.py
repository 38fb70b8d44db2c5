"""Device kernels launched a prefill request (the launcher's layer): the kernels
the traced window ran, divided by the requests it ran."""


def read(rec):
    if rec["kind"] != "prefill" or not rec["kernels"] or not rec["steps"]:
        return None
    return sum(count for count, _ in rec["kernels"].values()) / rec["steps"]
