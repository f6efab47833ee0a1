"""Tokens of every step completed in the window over the window's
seconds."""


def read(run):
    if "tokens" not in run.work or not run.window["steps"]:
        return None
    return run.work["tokens"] * run.window["steps"] / run.window["seconds"]
