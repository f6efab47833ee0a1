"""The model's operations a step (the benchmark's own count from the
shapes, no recomputation) times the untraced window's steps, over its
seconds and the card's bf16 peak, in percent."""


def read(run):
    if not run.window["steps"] or "bf16_flops" not in run.peaks:
        return None
    rate = run.model_flops * run.window["steps"] / run.window["seconds"]
    return 100.0 * rate / run.peaks["bf16_flops"]
