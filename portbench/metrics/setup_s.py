"""Seconds from the process's start to the window's: imports, kernel
builds or loads, weights, the traffic made on the card, the warm-up."""


def read(ctx):
    return ctx.get("setup_s")
