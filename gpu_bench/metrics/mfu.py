"""The whole step's share of the card's dense bf16 peak (%): the model
FLOPs of the window's real segments (padding excluded), counted by
``configs/<config>_flops.py``, over the window's host-clock seconds."""


def read(run):
    flops = run.counters.get("model_flops")
    if not flops or not run.window_s:
        return None
    return 100.0 * flops / run.window_s / run.peaks["bf16_flops"]
