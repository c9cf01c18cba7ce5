"""Valid ORB keypoints a view: the program's counter "orb keypoints"
(cli/photogrammetrie.py adds each job's valid keypoints over its views)
over the views of the window's sets (the configuration's views a set)."""

from h100bench.metrics._program import counter


def read(ctx: dict) -> float | None:
    n = counter("orb keypoints")
    return None if n is None else n / (ctx["sets"] * ctx["config"]["images"]["views"])
