"""Device: the share of the traced steps' span in which no kernel, copy
or fill ran on the card, in percent."""


def read(ctx):
    t = ctx["trace"]
    if not t.get("span_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
