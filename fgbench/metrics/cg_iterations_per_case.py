"""cg_iterations_per_case (iterations, program counter): len(residuals) of
the solver after each request, averaged over the window's requests; a
batch's cases step together, so a batch counts its history once."""


def read(run):
    if not run.requests:
        return None
    return sum(r.iterations for r in run.requests) / len(run.requests)
