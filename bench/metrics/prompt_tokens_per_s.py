"""Prompt tokens prefilled in the window over the window's seconds: the
whole prompt of every request whose first token came in the window.  Host
clock."""
import stats

SOURCE = "host_clock"


def read(run):
    n = sum(len(r.prompt) for r in run.requests if run.in_window(r.first))
    return stats.rate(n, run.window_s)
