"""lane_occupancy.render: the share of the render loop's lane slots that
held a live path entering a full step, in %: the alive lanes summed on
the device (`lanes_alive`) over n_lanes x sub-iterations (`lane_slots`),
over the window's renders."""
from pbh import spans


def read(run):
    got = spans.split(run)
    if got is None or not spans.counter(got[1], "lane_slots"):
        return None
    window = got[1]
    return (100.0 * spans.counter(window, "lanes_alive")
            / spans.counter(window, "lane_slots"))
