"""``train_images_per_s``: images trained in the window's whole periods
(``period_batches`` batches of the CLI's phase cycle, ``batch`` rows
each) over those periods' seconds on the host clock, each period timed
between device synchronisations at its boundaries; the window ends with the
first period finished at or after ``--seconds``."""


def read(ctx):
    w = ctx["window"]
    if not w.get("images") or w["seconds"] <= 0:
        return None
    return w["images"] / w["seconds"]
