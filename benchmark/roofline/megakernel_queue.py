"""The queue megakernel's work in one render: the segments the reference
traces a camera ray over the checked pixels, times the render's camera
rays, each testing every primitive (the brute-force sweep of the resident
queue)."""

from benchmark.roofline import scene_work


def work(run):
    per_ray = run.counts.get("segments_per_ray")
    if per_ray is None:
        return None
    return scene_work(run.cell.config, per_ray * run.rays[0])
