"""Share of the traced window in which no kernel, memcpy or memset ran
on the card."""

WRAPS = []


def read(run):
    if run.view.window_s() <= 0:
        return None
    return 100.0 * (1.0 - run.view.busy_s() / run.view.window_s())
