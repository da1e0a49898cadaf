"""Real (unpadded) graphs trained in the window, over the window's host
seconds."""


def read(run):
    return run.window["graphs"] / run.window["seconds"]
