"""case_s (s, host clock): the window's wall time over the load cases
completed in it; a batched request counts its B cases."""


def read(run):
    return run.window_s / run.cases_done
