"""The device's idle share of the traced window, in %: the time in which
no kernel, copy or fill ran."""


def read(spec: dict, ctx: dict):
    records = ctx["records"]
    return 100.0 * (1.0 - records.busy_s() / records.window_s)
