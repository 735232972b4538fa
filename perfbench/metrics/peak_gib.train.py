"""Peak device memory allocated over the window (reset at its start),
in GiB."""
from harness.readers import peak_gib


def read(rec):
    return peak_gib(rec)
