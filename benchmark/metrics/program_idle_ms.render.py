"""Milliseconds a render in which the device is idle while the host is
inside one of the program's ``rayz.*`` spans: the spans' union less its
overlap with the device operations. ``device_idle_pct`` less this is the
idle time that the caller holds."""

from benchmark import spans


def read(run):
    return spans.idle_ms(run)
