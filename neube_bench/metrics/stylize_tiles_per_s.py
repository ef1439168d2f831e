"""``stylize_tiles_per_s``: tiles of the drawings finished in the window,
each returned to the host as its uint8 canvas, over the window's seconds
(host clock; the window ends with the first drawing finished at or after
``--seconds``)."""


def read(ctx):
    w = ctx["window"]
    if not w.get("tiles"):
        return None
    return w["tiles"] / w["seconds"]
