"""The device's idle share of the traced slice: one less the union of its
operations' intervals over the slice's wall time, in percent. Serves every
suffix (``idle_share.train``, ``idle_share.eval``, ...)."""


def read(sl, cell, suffix=None):
    if sl.wall_s <= 0 or not sl.device:
        return None
    return 100.0 * (1.0 - sl.busy_s() / sl.wall_s)
