"""``launches_per_pass.stylize``: device operations (kernels, copies,
sets: every entry of the traced window's device list) per ``bse.render.pass``
span of the program.  Nothing when the trace holds no device activity or no
``bse.render.pass`` span."""


def read(ctx):
    tr = ctx["trace"]
    n = sum(1 for name, _, _ in tr.host if name == "bse.render.pass")
    if not tr.device or not n:
        return None
    return len(tr.device) / n
