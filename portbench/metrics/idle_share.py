"""The device's idle share in the traced slice (its control steps and its
update phase): 1 − busy ÷ wall, in %."""


def read(ctx):
    parts = [p for p in ctx.parts.values() if p]
    wall = sum(p["wall_s"] for p in parts)
    busy = sum(p["busy_s"] for p in parts)
    return (1.0 - busy / wall) * 100.0 if wall > 0 and busy > 0 else None
