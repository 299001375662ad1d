"""Host milliseconds a render inside the program's ``rayz.tables`` span:
the scene's tables, camera vector and packed records built for the
launch."""

from benchmark import spans


def read(run):
    return spans.host_ms(run, "rayz.tables")
