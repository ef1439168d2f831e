"""``row_fill.stylize``: tiles over the rows the engine rendered in the
traced window, counted by the benchmark around the engine's render calls:
the share of each pass's rows that carry a tile and not the padding of a
wave's last chunk."""


def read(ctx):
    rows = sum(ctx["counters"]["trace_passes"])
    if not rows:
        return None
    return 100.0 * ctx["counters"]["trace_tiles"] / rows
