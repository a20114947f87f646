"""qps: the queries answered by the requests sent in the window, over the
time from the window's start to its last answer (a request of Q queries
counts Q; a failed request is attempted, not answered)."""


def read(run):
    return run.queries_answered / run.window_s if run.window_s > 0 else None
