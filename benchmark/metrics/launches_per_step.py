"""Train step: device kernels per step in the traced steps."""


def read(ctx):
    t = ctx["trace"]
    if not t.get("kernels") or not t.get("steps"):
        return None
    return len(t["kernels"]) / t["steps"]
