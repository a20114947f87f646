"""setup_s: from the start of the run's process to its first timed
request: making and writing the data, starting the server, building the
index, the cold request and the warm-up."""


def read(run):
    return run.setup_s
