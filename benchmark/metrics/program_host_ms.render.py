"""Host milliseconds a render inside any of the program's ``rayz.*``
spans (their union): dispatch, tables, queue and fold launches, finish."""

from benchmark import spans


def read(run):
    return spans.host_ms(run)
