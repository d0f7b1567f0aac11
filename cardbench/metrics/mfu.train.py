"""The whole window's counted operations (``counts/``) over its seconds, as
a share of the card's dense bf16 peak (``peaks.json``), in %."""


def read(r):
    if not r["peaks"] or r["seconds"] <= 0:
        return None
    return 100.0 * r["work"]["flops_per_unit"] * r["units"] / r["seconds"] / r["peaks"]["bf16"]
