"""The 95th percentile of every decode step's wall time in the window
(host clock, each step ending in a device synchronise): the gap between
a user's tokens. Taken over all the window's steps."""

LAYER = "end to end"
UNIT = "ms"
MOVES = None


def read(run):
    import statistics
    walls = sorted(e - s for s, e, _ in run.calls)
    if len(walls) < 2:
        return 1e3 * walls[0]
    return 1e3 * statistics.quantiles(walls, n=20, method="inclusive")[18]
