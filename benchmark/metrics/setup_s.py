"""setup_s: seconds from the process's start to the first timed pass:
imports, the libraries' build or load, the scene and its tables, the
state the traffic needs, and the warm pass at the cell's shapes."""


def read(ctx):
    return ctx.setup_s
