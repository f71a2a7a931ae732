"""Tokens of every step the window ran, summed over the ranks, over the
window (host clock, from its start to the device's last step end)."""

KIND = "end_to_end"
UNIT = "tokens/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(run):
    if run.kind != "train":
        return None
    return run.tokens / run.window_s
