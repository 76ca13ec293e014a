"""Tokens generated in the window (first tokens included) over the
window's seconds.  Host clock."""
import stats

SOURCE = "host_clock"


def read(run):
    n = sum(1 for r in run.requests for t in r.stamps if run.in_window(t))
    return stats.rate(n, run.window_s)
