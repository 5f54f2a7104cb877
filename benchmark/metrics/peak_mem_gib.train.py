"""The device's peak allocated memory over the run, GiB."""


def read(run):
    peak = run.totals.get("memory_peak_bytes")
    return peak / 2 ** 30 if peak else None
