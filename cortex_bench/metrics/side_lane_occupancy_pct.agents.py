"""Live side lanes over the side lanes the window's ticks decoded, in %:
the engine's own counters ``live_side_lane_ticks`` over
``side_lane_ticks`` (a tick that steps side agents decodes the whole side
batch; a lane with no live agent decodes garbage harmlessly). None where
the program keeps no such counters."""


def read(d):
    stats = d.engine.get("stats", {})
    n = stats.get("side_lane_ticks")
    return 100.0 * stats["live_side_lane_ticks"] / n if n else None
