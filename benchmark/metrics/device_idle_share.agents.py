"""Share of the traced window of guided decode in which no kernel, copy
or memset ran on the card, %: one minus the union of the device's
activity intervals over the window."""


def read(m):
    if m.summary is None or not m.summary["window_s"]:
        return None
    return (1 - m.summary["busy_s"] / m.summary["window_s"]) * 100
