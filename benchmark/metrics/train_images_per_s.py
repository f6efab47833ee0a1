"""Images of every step completed in the window over the window's
seconds."""


def read(run):
    if "images" not in run.work or not run.window["steps"]:
        return None
    return run.work["images"] * run.window["steps"] / run.window["seconds"]
