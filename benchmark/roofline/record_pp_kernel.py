"""The persistent-path recorder's work in one train step: every segment
the reference traces over all pixels at the step's samples per pixel,
each testing every primitive (the recorder's brute-force sweep)."""

from benchmark.roofline import scene_work


def work(run):
    segments = run.counts.get("segments_per_step")
    if segments is None:
        return None
    return scene_work(run.cell.config, segments)
