"""The share of the window in which nothing ran on the device:
1 - (the union of the device's operation intervals over the window) /
(the window's length), both from the same run's window."""


def read(run):
    if run.activity is None or not run.activity.ops or run.window.seconds <= 0:
        return None
    return 100.0 * (1.0 - run.activity.busy_s / run.window.seconds)
