"""``setup_s``: seconds from the process's start to the first timed unit
(loading, weights, inputs, warm-up and, in a first run, kernel builds), on
the host clock."""


def read(ctx):
    return ctx["setup_s"]
