"""The device's idle share of the traced window: the time no kernel, copy or
fill ran on the card (rank 0's card under several ranks), in percent."""


def read(run):
    tr = run["trace"]
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
