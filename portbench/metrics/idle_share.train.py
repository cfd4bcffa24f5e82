"""idle_share.train: the share of the traced window of training steps in
which no operation ran on the device (``trace.Trace.idle_share``), in %."""


def read(rec):
    tr = rec["trace"]
    if rec["kind"] != "train" or tr is None or not tr.device:
        return None
    return tr.idle_share()
